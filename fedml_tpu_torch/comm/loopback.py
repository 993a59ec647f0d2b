"""In-process loopback backend, the port of ``fedml_tpu/comm/loopback.py``.

The reference has no fake/in-process backend — its framework tests run real
MPI on localhost (SURVEY §4: "a gap the TPU build should fix with an
in-process loopback comm backend"). This backend gives every rank a queue in
one process; ranks run in threads. It is the unit-test transport for the
manager/algorithm protocol layers and the semantic model for the shm/grpc
backends.

Broadcast fan-outs post two-part ``(head, shared_tail)`` frames: every
receiver of one broadcast decodes zero-copy views into ONE shared payload
buffer (read-only — Message.from_buffers enforces it), so an N-worker model
broadcast materializes the payload bytes once, not N times.
"""

from __future__ import annotations

import queue
import threading

from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.message import FramedMessage, Message
from fedml_tpu_torch.comm.send_pool import SendWorkerPool


class LoopbackFabric:
    """Shared post office: rank -> queue. One instance per simulated cluster."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.queues: dict[int, queue.Queue] = {r: queue.Queue() for r in range(world_size)}

    def post(self, msg: Message) -> None:
        # serialize/deserialize through the real wire format so tests cover it
        self.post_raw(msg.get_receiver_id(), msg.to_bytes())

    def post_raw(self, receiver: int, data) -> None:
        """Queue already-framed wire data: ``bytes`` or a broadcast's
        ``(head, shared_tail)`` pair."""
        self.queues[receiver].put(data)


class OrderedUplinkFabric(LoopbackFabric):
    """Loopback fabric that holds one message type bound for ``receiver``
    until ``expected`` distinct senders posted it, then delivers the batch
    in sender order — pins the server's streaming fold order so bit-identity
    assertions (streaming vs buffered f64 accumulation) are deterministic
    even though client threads race. Used by tools/wire_smoke.py,
    tools/robust_smoke.py, and the wire-path tests."""

    def __init__(self, world_size: int, expected: int, msg_type: int,
                 receiver: int = 0):
        super().__init__(world_size)
        self._expected = expected
        self._type = msg_type
        self._receiver = receiver
        self._held: dict[int, bytes] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def post(self, msg: Message) -> None:
        if (msg.get_receiver_id() == self._receiver
                and msg.get_type() == self._type):
            with self._lock:
                self._held[msg.get_sender_id()] = msg.to_bytes()
                if len(self._held) < self._expected:
                    return
                batch, self._held = sorted(self._held.items()), {}
            for _, data in batch:
                self.post_raw(self._receiver, data)
            return
        super().post(msg)


class LoopbackCommManager(BaseCommunicationManager):
    _STOP = object()

    def __init__(self, fabric: LoopbackFabric, rank: int, send_workers: int = 0):
        super().__init__(send_pool=(
            SendWorkerPool(send_workers, name=f"loopback-send-r{rank}")
            if send_workers else None
        ))
        self.fabric = fabric
        self.rank = rank
        self._running = False

    def send_message(self, msg: Message) -> None:
        self.fabric.post(msg)

    def _send_framed(self, frame: FramedMessage, dst: int,
                     overrides: dict | None = None) -> None:
        # two-part post: per-receiver head, ONE shared payload buffer
        self.fabric.post_raw(dst, (frame.head_for(dst, overrides),
                                   frame.tail_bytes()))

    def handle_receive_message(self) -> None:
        self._running = True
        q = self.fabric.queues[self.rank]
        while self._running:
            item = q.get()
            if item is self._STOP:
                break
            if isinstance(item, tuple):
                self.notify(Message.from_buffers(*item))
            else:
                self.notify(Message.from_bytes(item))

    def stop_receive_message(self) -> None:
        self._running = False
        self._close_send_pool()
        self.fabric.queues[self.rank].put(self._STOP)
