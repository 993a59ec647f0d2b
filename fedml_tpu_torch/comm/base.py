"""Communication backend contract, the port of ``fedml_tpu/comm/base.py``.

Reference: fedml_core/distributed/communication/base_com_manager.py:7
(``BaseCommunicationManager``: send_message / add_observer /
handle_receive_message / stop_receive_message) and observer.py:4
(``Observer.receive_message(msg_type, msg_params)``). Contract preserved;
backends here are push-driven (no 0.3 s polling loop — the reference defect
listed in SURVEY §7 'what NOT to port').

On top of the reference surface the contract grows the high-throughput
downlink primitive (docs/PERFORMANCE.md "The server wire path"):
``broadcast_message`` frames a message ONCE (one payload serialization for
the whole fan-out) and emits one wire copy per receiver through the
``_send_framed`` backend hook, optionally overlapping the per-receiver sends
on a bounded :class:`~fedml_tpu_torch.comm.send_pool.SendWorkerPool`.
"""

from __future__ import annotations

import abc
from functools import partial
from typing import TYPE_CHECKING

from fedml_tpu_torch.obs import trace

if TYPE_CHECKING:
    from fedml_tpu_torch.comm.message import FramedMessage, Message
    from fedml_tpu_torch.comm.retry import RetryPolicy
    from fedml_tpu_torch.comm.send_pool import SendWorkerPool


class Observer(abc.ABC):
    @abc.abstractmethod
    def receive_message(self, msg_type: int, msg: "Message") -> None: ...


class BaseCommunicationManager(abc.ABC):
    def __init__(self, send_pool: "SendWorkerPool | None" = None,
                 retry_policy: "RetryPolicy | None" = None):
        self._observers: list[Observer] = []
        self._send_pool = send_pool
        # retry/backoff send plane (docs/ROBUSTNESS.md "Failure recovery"):
        # when set, every broadcast leg (and the manager-layer unary send)
        # is re-attempted under the policy instead of failing the protocol
        # on the first transient transport error. Settable post-construction
        # (``mgr.retry_policy = policy``) so run harnesses can arm it on any
        # backend — including a fault-injection wrapper, whose seeded draws
        # then re-roll per attempt.
        self.retry_policy = retry_policy
        # cross-rank causal tracing opt-in (docs/OBSERVABILITY.md
        # "Cross-rank causal tracing"): when armed by the run harness
        # (same explicit-flag discipline as ``fleet_telemetry`` — never
        # inferred from a tracer being installed), the send/broadcast paths
        # stamp MSG_ARG_KEY_TRACE_CTX on outgoing headers and the receive
        # path links comm/recv spans to the sender's context. Off (the
        # default), wire bytes are identical to a pre-tracing build.
        self.trace_wire = False

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        self._observers.remove(observer)

    def stamp_trace_ctx(self, msg: "Message") -> None:
        """Stamp the calling thread's trace context on ``msg`` when the
        ``trace_wire`` opt-in is armed and a tracer resolves; no-op (and
        zero wire-byte change) otherwise. Callers stamp INSIDE their
        comm/send span so the context's span id names that send leg."""
        if not self.trace_wire:
            return
        ctx = trace.wire_ctx(origin=msg.get_sender_id())
        if ctx is not None:
            from fedml_tpu_torch.comm.message import Message

            msg.add_params(Message.MSG_ARG_KEY_TRACE_CTX, ctx)

    def notify(self, msg: "Message") -> None:
        tracer = trace.get()
        if tracer is None:  # disabled path: skip the payload-size walk too
            for obs in list(self._observers):
                obs.receive_message(msg.get_type(), msg)
            return
        from fedml_tpu_torch.comm.message import Message

        ctx = msg.get(Message.MSG_ARG_KEY_TRACE_CTX)
        ctx_args = {}
        if isinstance(ctx, dict):
            # the incoming context opens this recv as a causal child of the
            # sender's send span: trace_merge matches (ctx_lane, ctx_span)
            # to that span's (lane, span_id) across per-rank files
            ctx_args = {"ctx_span": ctx.get("span"),
                        "ctx_lane": ctx.get("lane"),
                        "ctx_rank": ctx.get("rank"),
                        "ctx_sent_at": ctx.get("sent_at")}
        with tracer.span("comm/recv", msg_type=msg.get_type(),
                         sender=msg.get_sender_id(),
                         receiver=msg.get_receiver_id(),
                         bytes=msg.payload_nbytes(), **ctx_args):
            for obs in list(self._observers):
                obs.receive_message(msg.get_type(), msg)

    @abc.abstractmethod
    def send_message(self, msg: "Message") -> None: ...

    def broadcast_message(self, msg: "Message",
                          receiver_ids: list[int],
                          per_receiver: dict[int, dict] | None = None) -> None:
        """Encode-once fan-out: frame ``msg`` once and send one wire copy to
        every receiver (the per-receiver header is patched, the payload
        segments are shared). ``per_receiver`` carries small header-only
        param overrides keyed by receiver (e.g. each worker's assigned
        client index); array overrides are rejected by the frame.

        With a send pool installed the per-receiver sends run concurrently
        and this call returns after all of them completed — downlink wall
        time is the slowest leg, not the sum.

        Failure handling is per-destination isolated: each leg runs under
        ``retry_policy`` (when set), one dead receiver never aborts or
        masks the other legs, and all exhausted legs are reported together
        as a :class:`~fedml_tpu_torch.comm.send_pool.BroadcastSendError` naming
        the destination ranks.
        """
        frame = msg.frame()
        frame.tail_bytes()  # join the shared payload ONCE, before pooled
        # legs race the lazy cache and each redo the O(payload) join
        msg_type, sender = msg.get_type(), msg.get_sender_id()
        nbytes = frame.payload_nbytes

        def send_one(dst: int) -> None:
            ov = per_receiver.get(dst) if per_receiver else None
            policy = self.retry_policy
            with trace.span("comm/send", msg_type=msg_type, sender=sender,
                            receiver=dst, bytes=nbytes, broadcast=1):
                if self.trace_wire:
                    # stamped inside the span so the context names THIS
                    # leg; rides the header-only override path (the shared
                    # payload segments stay one serialization)
                    ctx = trace.wire_ctx(origin=sender)
                    if ctx is not None:
                        from fedml_tpu_torch.comm.message import Message

                        ov = dict(ov) if ov else {}
                        ov[Message.MSG_ARG_KEY_TRACE_CTX] = ctx
                if policy is None:
                    self._send_framed(frame, dst, ov)
                else:
                    policy.run(partial(self._send_framed, frame, dst, ov),
                               dst=dst, msg_type=msg_type)

        pool = self._send_pool
        if pool is None:
            errors: dict[int, BaseException] = {}
            for dst in receiver_ids:
                try:
                    send_one(dst)
                except Exception as e:
                    if getattr(e, "unretryable", False):
                        raise  # an injected crash is process death, not a leg
                    errors[dst] = e
            if errors:
                from fedml_tpu_torch.comm.send_pool import BroadcastSendError

                raise BroadcastSendError(errors)
        else:
            pool.run_all([(dst, partial(send_one, dst)) for dst in receiver_ids])

    def _send_framed(self, frame: "FramedMessage", dst: int,
                     overrides: dict | None = None) -> None:
        """Backend hook for one leg of a broadcast. The in-repo byte
        transports override this with a ``frame.bytes_for(dst)`` send (no
        payload re-serialization); this default keeps third-party backends
        correct by rebuilding a Message that shares the frame's payload
        buffers (their own ``send_message`` may still re-encode)."""
        self.send_message(frame.to_message(dst, overrides))

    def _close_send_pool(self) -> None:
        """Backends call this from ``stop_receive_message``."""
        if self._send_pool is not None:
            self._send_pool.close()

    @abc.abstractmethod
    def handle_receive_message(self) -> None:
        """Block, dispatching incoming messages to observers, until stopped."""

    @abc.abstractmethod
    def stop_receive_message(self) -> None: ...
