"""The port of ``fedml_tpu/tenancy/comm.py`` (the same wire bytes).

Job-scoped wire plane: N federations multiplexed over one comm fabric.

Layout (docs/MULTITENANCY.md): the runner builds ONE shared fabric and ONE
shared rank-0 endpoint. Every job keeps the single-job harness's view of the
world — a server at local rank 0 and workers at local ranks 1..W — through
two facades over the shared plane:

- :class:`JobServerComm` IS the job's rank-0 transport. Outbound, it stamps
  the job id header (``Message.MSG_ARG_KEY_JOB_ID``), maps job-local
  receiver ranks onto the global fabric ranks, and dispatches every leg
  through the shared :class:`~fedml_tpu_torch.tenancy.scheduler.FairFanoutScheduler`
  (so ALL of the job's egress keeps the per-destination FIFO and competes
  fairly). Inbound, it drains the per-job inbox the :class:`JobRouter`
  feeds, dispatching to the job's observers under a ``tenancy/dispatch``
  span (the shared endpoint's ``comm/recv`` already fired on the router
  thread).
- :class:`JobClientComm` wraps a worker's own per-rank backend (client
  global rank = ``rank_base + local rank``): it stamps the job id on every
  upload and delegates everything else — the client receive loop, observer
  registry, and stop path are the inner backend's, untouched.

The default job (``job_id=None``) stamps NOTHING: its wire bytes are
byte-identical to a single-job run's, and the router sends job-less inbound
messages to it — the zero-behavior-change compatibility contract
(``tests/test_torch_tenancy.py`` holds it).
"""

from __future__ import annotations

import logging
import queue
import threading
from functools import partial
from typing import TYPE_CHECKING

from fedml_tpu_torch.comm.base import BaseCommunicationManager, Observer
from fedml_tpu_torch.comm.loopback import LoopbackFabric
from fedml_tpu_torch.comm.message import FramedMessage, Message
from fedml_tpu_torch.comm.send_pool import BroadcastSendError
from fedml_tpu_torch.obs import jobscope, trace

if TYPE_CHECKING:
    from fedml_tpu_torch.tenancy.scheduler import FairFanoutScheduler

DEFAULT_JOB = "default"


def job_key(job_id: str | None) -> str:
    """Scheduler/obs key for a job: its id, or the implicit default job's."""
    return DEFAULT_JOB if job_id is None else job_id


class JobRouter(Observer):
    """Demux for the shared rank-0 endpoint: one receive loop, routed by the
    ``job_id`` header into per-job inboxes.

    The router is the endpoint's only observer and pumps its blocking
    ``handle_receive_message`` on one daemon thread; each
    :class:`JobServerComm` drains its own inbox on its job's thread.
    Messages with no job id route to the registered default job (the
    job-less compatibility path); messages for an unregistered job are
    dropped and counted — a late upload from a job that already tore down
    must not wedge the shared pump."""

    def __init__(self, endpoint: BaseCommunicationManager,
                 name: str = "tenancy-router"):
        self.endpoint = endpoint
        self._name = name
        self._lock = threading.Lock()
        self._inboxes: dict[str, queue.Queue] = {}  # guarded-by: _lock
        self._thread: threading.Thread | None = None
        self.dropped = 0  # messages for unregistered jobs (diagnostic)
        endpoint.add_observer(self)

    def register(self, job_id: str | None) -> queue.Queue:
        """Create (or return) the inbox for ``job_id``; ``None`` registers
        the implicit default job."""
        key = job_key(job_id)
        with self._lock:
            inbox = self._inboxes.get(key)
            if inbox is None:
                inbox = self._inboxes[key] = queue.Queue()
            return inbox

    def unregister(self, job_id: str | None) -> None:
        with self._lock:
            self._inboxes.pop(job_key(job_id), None)

    def receive_message(self, msg_type: int, msg: Message) -> None:
        key = job_key(msg.get(Message.MSG_ARG_KEY_JOB_ID))
        with self._lock:
            inbox = self._inboxes.get(key)
        if inbox is None:
            self.dropped += 1
            logging.warning(
                "tenancy router: dropping msg type %s from sender %s for "
                "unregistered job %r (%d dropped so far)",
                msg_type, msg.get_sender_id(), key, self.dropped,
            )
            return
        inbox.put(msg)

    def start(self) -> "JobRouter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self.endpoint.handle_receive_message,
                name=self._name, daemon=True,
            )
            self._thread.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        """Stop the shared endpoint's pump (idempotent). Per-job facades
        stop their own inbox loops via ``stop_receive_message``."""
        self.endpoint.stop_receive_message()
        t = self._thread
        if t is not None:
            t.join(timeout)


class JobServerComm(BaseCommunicationManager):
    """A job's rank-0 transport over the shared plane (see module doc)."""

    _STOP = object()

    def __init__(self, endpoint: BaseCommunicationManager,
                 scheduler: "FairFanoutScheduler",
                 inbox: queue.Queue,
                 job_id: str | None = None,
                 rank_base: int = 0):
        super().__init__()
        self._endpoint = endpoint
        self._scheduler = scheduler
        self._inbox = inbox
        self.job_id = job_id
        self.rank_base = rank_base
        self._key = job_key(job_id)
        self._running = False

    # -- outbound -----------------------------------------------------------

    def _to_global(self, local: int) -> int:
        # local 0 is the server itself == global 0; workers shift by base
        return local if local == 0 else self.rank_base + local

    def _stamp(self, msg: Message) -> None:
        if self.job_id is not None:
            msg.add_params(Message.MSG_ARG_KEY_JOB_ID, self.job_id)

    def send_message(self, msg: Message) -> None:
        """Unary send as a single scheduled leg: blocking (the manager layer
        already wraps the span + retry policy), but queued through the
        job's FIFO so it can never overtake a still-dispatching broadcast
        leg to the same destination."""
        self._stamp(msg)
        local = msg.get_receiver_id()
        dst = self._to_global(local)
        if dst != local:
            msg.add_params(Message.MSG_ARG_KEY_RECEIVER, dst)
        fn = jobscope.wrap_target(partial(self._endpoint.send_message, msg))
        try:
            self._scheduler.run_job_legs(
                self._key, [(dst, local, fn, msg.payload_nbytes())])
        except BroadcastSendError as e:
            if len(e.errors) == 1:
                raise next(iter(e.errors.values()))  # unary contract
            raise

    def broadcast_message(self, msg: Message, receiver_ids: list[int],
                          per_receiver: dict[int, dict] | None = None) -> None:
        """Encode-once fan-out through the fair scheduler: framed ONCE,
        per-leg ``comm/send`` span + retry exactly like the single-backend
        path (comm/base.py), legs interleaved with other jobs' under DRR.
        ``receiver_ids`` / ``per_receiver`` are job-LOCAL ranks; the wire
        copy for each receiver carries its global rank."""
        receiver_ids = list(receiver_ids)
        if not receiver_ids:
            return
        self._stamp(msg)
        frame = msg.frame()
        frame.tail_bytes()  # join the shared payload once, before legs race
        legs = []
        for local in receiver_ids:
            dst = self._to_global(local)
            ov = per_receiver.get(local) if per_receiver else None
            fn = jobscope.wrap_target(
                partial(self._send_leg, frame, dst, ov,
                        msg.get_type(), msg.get_sender_id(),
                        frame.payload_nbytes))
            legs.append((dst, local, fn, frame.payload_nbytes))
        self._scheduler.run_job_legs(self._key, legs)

    def _send_leg(self, frame: FramedMessage, dst: int, ov: dict | None,
                  msg_type: int, sender: int, nbytes: int) -> None:
        # mirror of comm/base.py send_one, running on a shared pool worker:
        # the backend _send_framed hook posts the (head, shared_tail) pair
        policy = self.retry_policy
        with trace.span("comm/send", msg_type=msg_type, sender=sender,
                        receiver=dst, bytes=nbytes, broadcast=1):
            if self.trace_wire:
                # same per-leg header-only ride as comm/base.py send_one:
                # the shared payload segments stay one serialization
                ctx = trace.wire_ctx(origin=sender)
                if ctx is not None:
                    ov = dict(ov) if ov else {}
                    ov[Message.MSG_ARG_KEY_TRACE_CTX] = ctx
            if policy is None:
                self._endpoint._send_framed(frame, dst, ov)
            else:
                policy.run(partial(self._endpoint._send_framed, frame, dst, ov),
                           dst=dst, msg_type=msg_type)

    # -- inbound ------------------------------------------------------------

    def handle_receive_message(self) -> None:
        """Drain the job's inbox on the calling (job server) thread. The
        shared endpoint's ``comm/recv`` span fired on the router thread;
        dispatch here runs under a ``tenancy/dispatch`` span so a trace
        shows queue-to-handler residency per job without double-counting
        receives (docs/OBSERVABILITY.md)."""
        self._running = True
        while self._running:
            item = self._inbox.get()
            if item is self._STOP:
                break
            tracer = trace.get()
            if tracer is None:
                for obs in list(self._observers):
                    obs.receive_message(item.get_type(), item)
                continue
            # the shared endpoint's comm/recv fires on the UNBOUND router
            # thread (no per-job tracer resolves there), so the causal link
            # to the sender's context attaches here — the first span the
            # message produces in the job's own lane
            ctx = item.get(Message.MSG_ARG_KEY_TRACE_CTX)
            ctx_args = {}
            if isinstance(ctx, dict):
                ctx_args = {"ctx_span": ctx.get("span"),
                            "ctx_lane": ctx.get("lane"),
                            "ctx_rank": ctx.get("rank"),
                            "ctx_sent_at": ctx.get("sent_at")}
            with tracer.span("tenancy/dispatch", msg_type=item.get_type(),
                             sender=item.get_sender_id(), job=self._key,
                             **ctx_args):
                for obs in list(self._observers):
                    obs.receive_message(item.get_type(), item)

    def stop_receive_message(self) -> None:
        self._running = False
        self._inbox.put(self._STOP)


class JobClientComm(BaseCommunicationManager):
    """A worker's transport in a multi-job run: wraps the worker's own
    per-rank backend (already at its GLOBAL rank), stamping the job id on
    every send so the server-side router can demux the shared rank-0 queue.
    Receive side and observers delegate to the inner backend unchanged."""

    def __init__(self, backend: BaseCommunicationManager,
                 job_id: str | None = None):
        super().__init__()
        self._backend = backend
        self.job_id = job_id

    def _stamp(self, msg: Message) -> None:
        if self.job_id is not None:
            msg.add_params(Message.MSG_ARG_KEY_JOB_ID, self.job_id)

    def add_observer(self, observer: Observer) -> None:
        self._backend.add_observer(observer)

    def remove_observer(self, observer: Observer) -> None:
        self._backend.remove_observer(observer)

    def send_message(self, msg: Message) -> None:
        self._stamp(msg)
        self._backend.send_message(msg)

    def broadcast_message(self, msg: Message, receiver_ids: list[int],
                          per_receiver: dict[int, dict] | None = None) -> None:
        self._stamp(msg)
        self._backend.broadcast_message(msg, receiver_ids, per_receiver)

    def handle_receive_message(self) -> None:
        self._backend.handle_receive_message()

    def stop_receive_message(self) -> None:
        self._backend.stop_receive_message()


class MultiJobOrderedUplinkFabric(LoopbackFabric):
    """Per-job generalization of
    :class:`~fedml_tpu_torch.comm.loopback.OrderedUplinkFabric`: holds each JOB's
    uploads of one message type bound for ``receiver`` until that job's
    expected count arrived, then delivers the batch in job-local sender
    order. Pins every job's streaming fold order to its solo run's, so the
    co-scheduled-vs-solo bit-identity assertions are deterministic even
    though N jobs' client threads race on one fabric. Jobs are keyed by the
    ``job_id`` header (``None`` = the default job)."""

    def __init__(self, world_size: int, expected_by_job: dict[str, int],
                 msg_type: int, receiver: int = 0):
        super().__init__(world_size)
        self._expected = dict(expected_by_job)
        self._type = msg_type
        self._receiver = receiver
        self._held: dict[str, dict[int, bytes]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def post(self, msg: Message) -> None:
        if (msg.get_receiver_id() == self._receiver
                and msg.get_type() == self._type):
            key = job_key(msg.get(Message.MSG_ARG_KEY_JOB_ID))
            expected = self._expected.get(key)
            if expected is not None:
                with self._lock:
                    held = self._held.setdefault(key, {})
                    held[msg.get_sender_id()] = msg.to_bytes()
                    if len(held) < expected:
                        return
                    batch = sorted(held.items())
                    del self._held[key]
                for _, data in batch:
                    self.post_raw(self._receiver, data)
                return
        super().post(msg)
