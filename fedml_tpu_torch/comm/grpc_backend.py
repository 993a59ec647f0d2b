"""gRPC backend for cross-host / cross-silo federation, the port of
``fedml_tpu/comm/grpc_backend.py`` (the same method name, so JAX and port
ranks call each other).

Reference: fedml_core/distributed/communication/gRPC/ — per-rank gRPC server,
ip table from CSV (grpc_comm_manager.py:109-119), 1 GB max message (:37-38).
Reference defects NOT ported (SURVEY §7): the 50000-vs-8888 port-base
mismatch, and the fresh channel per message (:63-75) — channels here are
persistent per destination. Proto-less generic RPC (bytes in/bytes out)
carries the typed Message wire format; no pickles.
"""

from __future__ import annotations

import csv
import logging
import threading
from collections import deque
from concurrent import futures
from pathlib import Path

from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.send_pool import SendWorkerPool

try:
    import grpc

    HAS_GRPC = True
except Exception:  # pragma: no cover
    HAS_GRPC = False

_METHOD = "/fedml_tpu.Comm/Send"
_MAX_LEN = 1024 * 1024 * 1024  # 1 GB, reference parity (grpc_comm_manager.py:37)
_IDENT = lambda b: b  # noqa: E731


def read_ip_config(path: str | Path) -> dict[int, tuple[str, int]]:
    """CSV: receiver_id,ip[,port] (reference grpc_ipconfig.csv; port defaults
    to base 50000 + rank on BOTH sides — the mismatch bug is not ported)."""
    out: dict[int, tuple[str, int]] = {}
    with open(path) as fh:
        for row in csv.reader(fh):
            # fedlint: disable=wire-contract -- CSV header sniff ("receiver_id,ip,port"), not the wire field
            if not row or row[0].strip().startswith("receiver"):
                continue
            rank = int(row[0])
            host = row[1].strip()
            port = int(row[2]) if len(row) > 2 else 50000 + rank
            out[rank] = (host, port)
    return out


class GRPCCommManager(BaseCommunicationManager):
    def __init__(self, rank: int, ip_config: dict[int, tuple[str, int]],
                 send_timeout: float = 600.0, send_workers: int = 4):
        """``send_timeout`` (seconds, per unary send) and ``send_workers``
        (broadcast send-pool width; 0 = serial fan-out on the caller thread)
        are plumbed from the run config (``--grpc_send_timeout`` /
        ``--grpc_send_workers`` on main_fedavg, or ``create_backend`` kw)."""
        if not HAS_GRPC:
            raise RuntimeError("grpcio not available")
        super().__init__(send_pool=(
            SendWorkerPool(send_workers, name=f"grpc-send-r{rank}")
            if send_workers else None
        ))
        self.rank = rank
        self.ip_config = ip_config
        self.send_timeout = float(send_timeout)
        self._queue: deque[bytes] = deque()
        self._cv = threading.Condition()
        self._channels: dict[int, grpc.Channel] = {}  # guarded-by: _stub_lock
        self._stubs: dict[int, object] = {}  # guarded-by: _stub_lock
        self._stub_lock = threading.Lock()
        self._running = False

        host, port = ip_config[rank]
        opts = [
            ("grpc.max_send_message_length", _MAX_LEN),
            ("grpc.max_receive_message_length", _MAX_LEN),
        ]
        # grpcio sets SO_REUSEPORT by default on Linux: two servers on one
        # port would then both bind and split the connections between them.
        # Off, a port that another process holds fails the bind below.
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8),
                                   options=opts + [("grpc.so_reuseport", 0)])

        mgr = self

        class _Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                if handler_call_details.method != _METHOD:
                    return None

                def _recv(request: bytes, context) -> bytes:
                    with mgr._cv:
                        mgr._queue.append(request)
                        mgr._cv.notify()
                    return b"ok"

                return grpc.unary_unary_rpc_method_handler(
                    _recv, request_deserializer=_IDENT, response_serializer=_IDENT
                )

        self._server.add_generic_rpc_handlers((_Handler(),))
        bound = self._server.add_insecure_port(f"[::]:{port}")
        if bound == 0:
            raise OSError(f"grpc bind failed on port {port}")
        self._server.start()
        logging.info("grpc server rank %d listening on %d", rank, port)

    def _stub(self, dst: int):
        # pooled broadcast legs may create stubs concurrently
        with self._stub_lock:
            if dst not in self._stubs:
                host, port = self.ip_config[dst]
                opts = [
                    ("grpc.max_send_message_length", _MAX_LEN),
                    ("grpc.max_receive_message_length", _MAX_LEN),
                ]
                ch = grpc.insecure_channel(f"{host}:{port}", options=opts)
                self._channels[dst] = ch
                self._stubs[dst] = ch.unary_unary(
                    _METHOD, request_serializer=_IDENT, response_deserializer=_IDENT
                )
            return self._stubs[dst]

    def send_message(self, msg: Message) -> None:
        self._stub(msg.get_receiver_id())(msg.to_bytes(), timeout=self.send_timeout)

    def _send_framed(self, frame, dst: int, overrides: dict | None = None) -> None:
        self._stub(dst)(frame.bytes_for(dst, overrides), timeout=self.send_timeout)

    def handle_receive_message(self) -> None:
        self._running = True
        while self._running:
            with self._cv:
                while not self._queue and self._running:
                    self._cv.wait(timeout=0.2)
                if not self._running:
                    break
                data = self._queue.popleft()
            self.notify(Message.from_bytes(data))

    def stop_receive_message(self) -> None:
        self._running = False
        with self._cv:
            self._cv.notify_all()
        self._close_send_pool()
        # snapshot under the stub lock (fedlint guarded-by): a pooled
        # broadcast leg may still be creating stubs while we stop
        with self._stub_lock:
            channels = list(self._channels.values())
        for ch in channels:
            ch.close()
        self._server.stop(grace=0.5)
