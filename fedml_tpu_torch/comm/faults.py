"""Seeded fault injection over any communication backend, a copy of
``fedml_tpu/comm/faults.py`` (the same seeded draws in the same order, so
the same (seed, rank, message order) gives the same ``applied`` ledger and
the same corrupted bytes in both packages).

PR 5's wire path grew real failure handling — elastic round timeout with
renormalized weights, ``EmptyRoundError`` on an all-dropped round, duplicate
uploads resolved first-wins, OFFLINE exclusion after consecutive misses —
but until now those paths were only driven by hand-built unit tests.
:class:`FaultyCommManager` wraps one rank's transport and injects faults on
its SEND side (client wrappers fault the uplink, the server wrapper faults
broadcast legs), so the whole failure surface runs end-to-end under the
real protocol on any backend (loopback, shm, grpc, mqtt_s3).

Faults (all seeded — a given (seed, rank, message order) replays exactly):

- ``drop=p``      lose the message with probability p
- ``delay=s[@p]`` deliver s seconds late (prob p, default 1.0) on a timer
                  thread — the sender never blocks, and delayed uploads can
                  arrive after the round timeout (the stale-upload path)
- ``dup=p``       send the message twice (duplicate first-wins path)
- ``corrupt=p``   flip bytes in the model payload (clip/reject defense path)
- ``fail=p``      the send RAISES :class:`TransientSendError` instead of
                  delivering — the retry/backoff plane's test surface
                  (comm/retry.py); each retry attempt re-rolls the draw
- ``recv_drop=p``     lose an ARRIVING message with probability p (downlink
                      loss as seen by the wrapped rank — uplink injection
                      alone cannot exercise receive-side recovery)
- ``recv_delay=s[@p]`` deliver an arriving message s seconds late on a
                      timer thread (receive-side reordering)
- ``crash=r``     raise :class:`InjectedCrash` on the first send carrying a
                  round index >= r — simulates the process dying mid-run;
                  never retried, never isolated to one broadcast leg
                  (tools/ft_smoke.py kills the server with it and restarts
                  from the round checkpoint)

Spec string (the ``--fault_spec`` CLI syntax): ``;``-separated per-rank
entries, ``<rank|*>:<fault>=<val>[,<fault>=<val>...]`` — e.g.
``"2:drop=1.0;3:delay=0.2@0.5,dup=0.3;*:corrupt=0.05"``. ``*`` applies to
every rank without an explicit entry (rank 0 is the server).

Protocol stop messages (``finished``) are never faulted: losing one leaks a
blocked client thread, which tests liveness of the harness rather than the
protocol's failure handling.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.message import FramedMessage, Message
from fedml_tpu_torch.obs import trace

# payload params eligible for corruption (header scalars stay intact: the
# fault models a corrupted model payload, not an unparseable frame)
_CORRUPTIBLE = (Message.MSG_ARG_KEY_MODEL_PARAMS,
                Message.MSG_ARG_KEY_ENCODED_UPDATE)

# the authoritative round index every sync/upload carries since PR 6 —
# now defined at the comm layer (Message), so no algorithm-layer import
# and no second spelling of the wire field
_ROUND_IDX_KEY = Message.MSG_ARG_KEY_ROUND_IDX


class TransientSendError(ConnectionError):
    """Injected send failure (``fail=p``): the transport 'lost the
    connection' for this attempt. The retry plane (comm/retry.py) is
    expected to recover it; without retries it fails the leg."""


class InjectedCrash(RuntimeError):
    """Injected process death (``crash=r``): the wrapped rank 'dies' when
    it first touches round ``r``. Marked unretryable so the retry plane
    propagates it immediately, and re-raised out of per-leg broadcast
    isolation — a crash must kill the protocol loop, that is the point."""

    unretryable = True


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One rank's fault profile. Probabilities in [0, 1]; ``delay``/
    ``recv_delay`` in seconds; ``corrupt_frac`` is the fraction of payload
    bytes flipped per corrupted message; ``crash_round`` < 0 disables the
    crash."""

    drop: float = 0.0
    delay: float = 0.0
    delay_prob: float = 1.0
    dup: float = 0.0
    corrupt: float = 0.0
    corrupt_frac: float = 0.01
    fail: float = 0.0
    recv_drop: float = 0.0
    recv_delay: float = 0.0
    recv_delay_prob: float = 1.0
    crash_round: int = -1

    def __post_init__(self):
        for name in ("drop", "delay_prob", "dup", "corrupt", "fail",
                     "recv_drop", "recv_delay_prob"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultSpec.{name}={v} must be in [0, 1]")
        for name in ("delay", "recv_delay"):
            if getattr(self, name) < 0:
                raise ValueError(f"FaultSpec.{name} must be >= 0")

    @property
    def active(self) -> bool:
        return (self.drop > 0 or self.dup > 0 or self.corrupt > 0
                or self.fail > 0 or self.crash_round >= 0
                or (self.delay > 0 and self.delay_prob > 0)
                or self.recv_active)

    @property
    def recv_active(self) -> bool:
        return (self.recv_drop > 0
                or (self.recv_delay > 0 and self.recv_delay_prob > 0))


def parse_fault_spec(spec: str) -> dict:
    """Parse the ``--fault_spec`` syntax into ``{rank_or_'*': FaultSpec}``.
    Unknown fault names and malformed entries fail loudly — a typo'd fault
    silently running a clean experiment would be worse than a crash."""
    out: dict = {}
    for entry in filter(None, (e.strip() for e in spec.split(";"))):
        target, sep, faults = entry.partition(":")
        if not sep or not faults:
            raise ValueError(
                f"fault spec entry {entry!r}: expected "
                "'<rank|*>:<fault>=<val>[,...]'"
            )
        target = target.strip()
        key: int | str = "*" if target == "*" else int(target)
        if key in out:
            raise ValueError(f"fault spec: duplicate target {target!r}")
        kw: dict = {}
        for f in faults.split(","):
            name, sep, val = f.strip().partition("=")
            if not sep:
                raise ValueError(f"fault {f!r}: expected '<name>=<value>'")
            name = name.strip()
            if name in ("delay", "recv_delay"):
                secs, at, prob = val.partition("@")
                kw[name] = float(secs)
                if at:
                    kw[f"{name}_prob"] = float(prob)
            elif name == "crash":
                kw["crash_round"] = int(val)
            elif name in ("drop", "dup", "corrupt", "corrupt_frac", "fail",
                          "recv_drop"):
                kw[name] = float(val)
            else:
                raise ValueError(
                    f"unknown fault {name!r} (expected drop | delay | dup | "
                    "corrupt | corrupt_frac | fail | recv_drop | recv_delay "
                    "| crash)"
                )
        out[key] = FaultSpec(**kw)
    if not out:
        raise ValueError(f"empty fault spec {spec!r}")
    return out


class FaultyCommManager(BaseCommunicationManager):
    """Wrap ``inner`` and apply ``spec``'s faults to outgoing messages.

    The receive side delegates untouched (observers land on ``inner``), so
    the wrapper composes with any backend and with OffloadCommManager.
    Applied faults are recorded in ``self.applied`` as
    ``(kind, msg_type, receiver)`` tuples and as ``comm/fault`` instant
    events on the process tracer."""

    def __init__(self, inner: BaseCommunicationManager, spec: FaultSpec,
                 rank: int = 0, seed: int = 0):
        super().__init__()
        self.inner = inner
        self.spec = spec
        self.rank = rank
        self._rng = np.random.RandomState((seed * 9176 + rank * 131) % (2**31))  # guarded-by: _rng_lock
        # independent stream for the receive side so adding downlink faults
        # never shifts an existing seeded send-side schedule
        self._recv_rng = np.random.RandomState(  # guarded-by: _rng_lock
            (seed * 9176 + rank * 131 + 0x5EC5) % (2**31)
        )
        self._rng_lock = threading.Lock()
        self.applied: list[tuple[str, int, int]] = []  # guarded-by: _rng_lock
        # per-kind totals maintained at append time so applied_counts()
        # never rescans the ledger (telemetry reads it every round)
        self._applied_counts: dict[str, int] = {}  # guarded-by: _rng_lock
        self._shims: dict[object, "_RecvFaultShim"] = {}
        self._crashed = False  # guarded-by: _rng_lock

    # -- receive side: delegation, optionally through the fault shim ---------

    def add_observer(self, observer) -> None:
        if not self.spec.recv_active:
            self.inner.add_observer(observer)
            return
        shim = _RecvFaultShim(self, observer)
        self._shims[observer] = shim
        self.inner.add_observer(shim)

    def remove_observer(self, observer) -> None:
        self.inner.remove_observer(self._shims.pop(observer, observer))

    def handle_receive_message(self) -> None:
        self.inner.handle_receive_message()

    def stop_receive_message(self) -> None:
        self.inner.stop_receive_message()

    # -- send side: seeded faults --------------------------------------------

    def _decide(self, msg_type: int, receiver: int) -> dict:
        """One seeded draw per enabled fault kind (fixed draw pattern per
        message — outcomes never shift the sequence, so a run replays).
        The ``fail`` draw comes LAST so enabling it never shifts the draws
        of a pre-existing seeded schedule."""
        s = self.spec
        with self._rng_lock:
            r = self._rng
            plan = {
                "drop": s.drop > 0 and r.random_sample() < s.drop,
                "corrupt": s.corrupt > 0 and r.random_sample() < s.corrupt,
                "dup": s.dup > 0 and r.random_sample() < s.dup,
                "delay": (s.delay > 0 and s.delay_prob > 0
                          and r.random_sample() < s.delay_prob),
                "fail": s.fail > 0 and r.random_sample() < s.fail,
            }
            # recorded under the same lock (fedlint guarded-by): send
            # threads and the receive shim both append to ``applied``
            for kind, hit in plan.items():
                if hit:
                    self.applied.append((kind, msg_type, receiver))
                    self._applied_counts[kind] = (
                        self._applied_counts.get(kind, 0) + 1
                    )
        for kind, hit in plan.items():
            if hit:
                trace.event("comm/fault", kind=kind, msg_type=msg_type,
                            sender=self.rank, receiver=receiver)
        return plan

    def applied_counts(self) -> dict:
        """Per-kind totals of the faults applied so far (a consistent
        snapshot taken under the ledger's lock; maintained incrementally
        at append time, O(kinds) per call) — the population adapter's
        clients report their own dropped-upload count from this."""
        with self._rng_lock:
            return dict(self._applied_counts)

    def _maybe_crash(self, round_idx) -> None:
        """``crash=r``: die on the first send touching round >= r, and stay
        dead — once crashed, EVERY later send from this rank raises too
        (heartbeat threads and other round-index-free senders included: a
        dead process sends nothing). Checked before anything else on the
        send path (a dead process does not get to pick which messages
        still leave)."""
        with self._rng_lock:
            if self._crashed:
                raise InjectedCrash(f"rank {self.rank} is crashed (injected)")
            cr = self.spec.crash_round
            crash_now = (cr >= 0 and round_idx is not None
                         and int(round_idx) >= cr)
            if crash_now:
                self._crashed = True
                self.applied.append(("crash", -1, -1))
                self._applied_counts["crash"] = (
                    self._applied_counts.get("crash", 0) + 1
                )
        if crash_now:
            trace.event("comm/fault", kind="crash", sender=self.rank,
                        round=int(round_idx))
            raise InjectedCrash(
                f"rank {self.rank} crashed at round {int(round_idx)} "
                f"(injected crash={cr})"
            )

    def _corrupt_message(self, msg: Message) -> Message:
        """Copy ``msg`` with seeded byte flips in its model payload(s)."""
        out = Message()
        out.msg_params = dict(msg.msg_params)
        with self._rng_lock:
            for key in _CORRUPTIBLE:
                v = out.msg_params.get(key)
                if not isinstance(v, np.ndarray):
                    continue
                buf = np.array(v)  # owned contiguous copy
                raw = buf.reshape(-1).view(np.uint8)
                n_flip = max(1, int(self.spec.corrupt_frac * raw.size))
                pos = self._rng.randint(0, raw.size, size=n_flip)
                raw[pos] ^= 0xFF
                out.msg_params[key] = buf
        return out

    def _deliver(self, thunks, delay: float) -> None:
        if delay > 0:
            t = threading.Timer(delay, lambda: [fn() for fn in thunks])
            t.daemon = True
            t.start()
        else:
            for fn in thunks:
                fn()

    @staticmethod
    def _protected(msg: Message) -> bool:
        return bool(msg.get(Message.MSG_ARG_KEY_FINISHED))

    def send_message(self, msg: Message) -> None:
        self._maybe_crash(msg.get(_ROUND_IDX_KEY))
        if not self.spec.active or self._protected(msg):
            self.inner.send_message(msg)
            return
        plan = self._decide(msg.get_type(), msg.get_receiver_id())
        if plan["fail"]:
            raise TransientSendError(
                f"injected send failure rank {self.rank} -> "
                f"{msg.get_receiver_id()}"
            )
        if plan["drop"]:
            return
        if plan["corrupt"]:
            msg = self._corrupt_message(msg)
        sends = 2 if plan["dup"] else 1
        self._deliver([lambda m=msg: self.inner.send_message(m)] * sends,
                      self.spec.delay if plan["delay"] else 0.0)

    def broadcast_message(self, msg: Message, receiver_ids: list,
                          per_receiver: dict | None = None) -> None:
        # crash is checked at fan-out entry, NOT per leg: process death
        # must escape the broadcast's per-destination fault isolation
        self._maybe_crash(msg.get(_ROUND_IDX_KEY))
        if not self.spec.active or self._protected(msg):
            self.inner.broadcast_message(msg, receiver_ids, per_receiver)
            return
        # base implementation frames once and routes each leg through our
        # _send_framed, where the per-leg faults land
        super().broadcast_message(msg, receiver_ids, per_receiver)

    def _send_framed(self, frame: FramedMessage, dst: int,
                     overrides: dict | None = None) -> None:
        plan = self._decide(frame._header.get(Message.MSG_ARG_KEY_TYPE, 0), dst)
        if plan["fail"]:
            raise TransientSendError(
                f"injected send failure rank {self.rank} -> {dst}"
            )
        if plan["drop"]:
            return
        if plan["corrupt"]:
            # corruption needs a mutable payload copy: rebuild the leg as a
            # Message (faulted legs give up the zero-copy fast path)
            m = self._corrupt_message(frame.to_message(dst, overrides))
            thunk = [lambda: self.inner.send_message(m)]
        else:
            thunk = [lambda: self.inner._send_framed(frame, dst, overrides)]
        self._deliver(thunk * (2 if plan["dup"] else 1),
                      self.spec.delay if plan["delay"] else 0.0)


class _RecvFaultShim:
    """Observer wrapper applying receive-side faults before delivery.

    Wraps each observer registered through a :class:`FaultyCommManager`
    whose spec has receive faults: arriving messages are dropped or
    delivered late on a timer thread (seeded, independent rng stream from
    the send side). ``finished`` stop messages pass through untouched —
    same liveness rationale as the send side."""

    def __init__(self, mgr: "FaultyCommManager", observer):
        self._mgr = mgr
        self._observer = observer

    def receive_message(self, msg_type: int, msg: Message) -> None:
        mgr, s = self._mgr, self._mgr.spec
        if FaultyCommManager._protected(msg):
            self._observer.receive_message(msg_type, msg)
            return
        with mgr._rng_lock:
            r = mgr._recv_rng
            drop = s.recv_drop > 0 and r.random_sample() < s.recv_drop
            delay = (s.recv_delay > 0 and s.recv_delay_prob > 0
                     and r.random_sample() < s.recv_delay_prob)
            # same critical section as the draws: ``applied`` is
            # guarded-by _rng_lock and the send side appends under it too
            for kind, hit in (("recv_drop", drop), ("recv_delay", delay)):
                if hit:
                    mgr.applied.append((kind, msg_type, mgr.rank))
                    mgr._applied_counts[kind] = (
                        mgr._applied_counts.get(kind, 0) + 1
                    )
        for kind, hit in (("recv_drop", drop), ("recv_delay", delay)):
            if hit:
                trace.event("comm/fault", kind=kind, msg_type=msg_type,
                            sender=msg.get_sender_id(), receiver=mgr.rank)
        if drop:
            return
        mgr._deliver(
            [lambda: self._observer.receive_message(msg_type, msg)],
            s.recv_delay if delay else 0.0,
        )


def wrap_make_comm(make_comm, specs, seed: int = 0, registry: list | None = None):
    """Wrap a ``make_comm(rank)`` factory so ranks with a fault spec get a
    :class:`FaultyCommManager`. ``specs`` is a ``{rank|'*': FaultSpec}`` map
    or a :func:`parse_fault_spec` string; ``registry`` (optional list)
    collects the created wrappers so harnesses can assert on
    ``wrapper.applied``."""
    if isinstance(specs, str):
        specs = parse_fault_spec(specs)

    def wrapped(rank: int):
        inner = make_comm(rank)
        spec = specs.get(rank, specs.get("*"))
        if spec is None or not spec.active:
            return inner
        mgr = FaultyCommManager(inner, spec, rank=rank, seed=seed)
        if registry is not None:
            registry.append(mgr)
        return mgr

    return wrapped
