"""Worker-manager runtime (L1): handler registry + run loop, the port of
``fedml_tpu/comm/managers.py``.

Reference: fedml_core/distributed/client/client_manager.py:21-102 and
server/server_manager.py:15-83: backend mux, ``register_message_receive_
handler`` dict keyed by msg type (:87-88), blocking ``run()``, ``finish()``
(a graceful stop, where the reference's MPI ``finish`` aborts the world).
The backend mux has the JAX package's transports: loopback, shm, grpc and
mqtt, each optionally behind an object store (``store_dir``).
"""

from __future__ import annotations

import logging
from typing import Callable

from fedml_tpu_torch.comm.base import BaseCommunicationManager, Observer
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.obs import trace


def create_backend(backend: str, rank: int, world_size: int, **kw) -> BaseCommunicationManager:
    """Backend mux (client_manager.py:28-50 equivalent):
    loopback | shm | grpc | mqtt, each optionally composed with an object
    store for large payloads (``store_dir=...`` — the MQTT_S3 production
    pattern for any transport)."""
    if backend == "loopback":
        from fedml_tpu_torch.comm.loopback import LoopbackCommManager

        mgr = LoopbackCommManager(kw["fabric"], rank)
    elif backend == "shm":
        from fedml_tpu_torch.comm.shm import ShmCommManager

        mgr = ShmCommManager(kw.get("job", "fedml"), rank, world_size)
    elif backend == "grpc":
        from fedml_tpu_torch.comm.grpc_backend import GRPCCommManager, read_ip_config

        ip_config = kw.get("ip_config") or read_ip_config(kw["ip_config_path"])
        mgr = GRPCCommManager(
            rank, ip_config,
            send_timeout=kw.get("grpc_send_timeout", 600.0),
            send_workers=kw.get("grpc_send_workers", 4),
        )
    elif backend == "mqtt":
        from fedml_tpu_torch.comm.mqtt_backend import MqttCommManager

        mgr = MqttCommManager(
            kw.get("mqtt_host", "localhost"), kw.get("mqtt_port", 1883),
            topic=kw.get("job", "fedml"), client_id=rank,
            client_num=world_size - 1, client_factory=kw.get("client_factory"),
        )
    else:
        raise ValueError(f"unknown backend {backend!r}")
    if kw.get("store_dir"):
        from fedml_tpu_torch.comm.object_store import FileSystemStore, OffloadCommManager

        mgr = OffloadCommManager(
            mgr, FileSystemStore(kw["store_dir"]),
            threshold_bytes=kw.get("store_threshold", 1 << 16),
        )
    return mgr


class DistributedManager(Observer):
    """Common base of ClientManager / ServerManager."""

    def __init__(self, comm: BaseCommunicationManager, rank: int, size: int):
        self.comm = comm
        self.rank = rank
        self.size = size
        self._handlers: dict[int, Callable[[Message], None]] = {}
        # this manager's cumulative re-attempt count (comm/retry.py): the
        # per-rank view of the process-wide retry ledger, piggybacked on
        # uploads by the fleet telemetry plane (docs/OBSERVABILITY.md
        # "Fleet telemetry"). Plain int += under the GIL — sends on one
        # manager are serialized anyway.
        self.comm_retries = 0
        comm.add_observer(self)

    # reference API names kept (client_manager.py:55-95)
    def register_message_receive_handler(self, msg_type: int, handler: Callable[[Message], None]) -> None:
        self._handlers[msg_type] = handler

    def receive_message(self, msg_type: int, msg: Message) -> None:
        handler = self._handlers.get(msg_type)
        if handler is None:
            logging.warning("rank %d: no handler for msg type %s", self.rank, msg_type)
            return
        with trace.span("comm/handler", msg_type=msg_type, rank=self.rank):
            handler(msg)

    def send_message(self, msg: Message) -> None:
        # retry/backoff send plane: when the transport carries a policy,
        # unary sends re-attempt on transient failure (comm/retry.py) —
        # each attempt re-runs the full send path (fault wrappers included)
        policy = getattr(self.comm, "retry_policy", None)
        if policy is None:
            send = lambda: self.comm.send_message(msg)  # noqa: E731
        else:
            send = lambda: policy.run(  # noqa: E731
                lambda: self.comm.send_message(msg),
                on_retry=self._note_retry,
                dst=msg.get_receiver_id(), msg_type=msg.get_type(),
            )
        tracer = trace.get()
        if tracer is None:  # disabled path: skip the payload-size walk too
            send()
            return
        with tracer.span("comm/send", msg_type=msg.get_type(),
                         sender=self.rank,
                         receiver=msg.get_receiver_id(),
                         bytes=msg.payload_nbytes()):
            # cross-rank causal tracing: the transport stamps the outgoing
            # header with this send span's context when its trace_wire
            # opt-in is armed (no-op, zero wire bytes otherwise)
            stamp = getattr(self.comm, "stamp_trace_ctx", None)
            if stamp is not None:
                stamp(msg)
            send()

    def broadcast_message(self, msg: Message, receiver_ids: list[int],
                          per_receiver: dict[int, dict] | None = None) -> None:
        """Encode-once downlink fan-out (docs/PERFORMANCE.md "The server
        wire path"): the payload is framed once and every receiver gets a
        header-patched wire copy; ``per_receiver`` carries small header-only
        overrides (e.g. assigned client index). Per-leg ``comm/send`` spans
        are emitted by the backend (on pool worker threads when a send pool
        overlaps the legs); this wrapper adds the enclosing
        ``comm/broadcast`` span on the manager thread."""
        receiver_ids = list(receiver_ids)
        if not receiver_ids:
            return
        tracer = trace.get()
        if tracer is None:
            self.comm.broadcast_message(msg, receiver_ids, per_receiver)
            return
        with tracer.span("comm/broadcast", msg_type=msg.get_type(),
                         sender=self.rank, receivers=len(receiver_ids),
                         bytes=msg.payload_nbytes()):
            self.comm.broadcast_message(msg, receiver_ids, per_receiver)

    def _note_retry(self) -> None:
        self.comm_retries += 1

    def register_message_receive_handlers(self) -> None:
        raise NotImplementedError

    def run(self) -> None:
        self.register_message_receive_handlers()
        self.comm.handle_receive_message()

    def finish(self) -> None:
        self.comm.stop_receive_message()


class ClientManager(DistributedManager):
    pass


class ServerManager(DistributedManager):
    pass
