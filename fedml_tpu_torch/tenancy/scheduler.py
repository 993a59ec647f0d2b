"""The port of ``fedml_tpu/tenancy/scheduler.py``.

Fair fan-out scheduler: one send plane shared by N federations.

Without it, N jobs sharing one wire serialize their downlinks in arrival
order: a 4MB-model job's 8-leg broadcast parks a logistic-regression job's
2KB sync behind megabytes of queued payload every round, and the small job's
round rate collapses to the big job's. The scheduler gives every job its own
FIFO of pending send legs and dispatches across jobs with deficit round
robin (DRR): each visit to a non-empty job queue earns the job
``quantum_bytes`` of credit, legs dispatch while credit covers their payload
size, and leftover credit carries to the job's next visit — so byte
bandwidth divides fairly regardless of per-job message sizes, while legs of
one job never reorder.

Dispatch hands each leg to the shared
:class:`~fedml_tpu_torch.comm.send_pool.SendWorkerPool` (``submit``: per-
destination FIFO, cross-destination overlap), so the wire-side ordering
contract the protocol layers rely on survives multiplexing. A job's
``broadcast`` call keeps its synchronous semantics: it blocks until all of
ITS legs completed and raises one
:class:`~fedml_tpu_torch.comm.send_pool.BroadcastSendError` naming the failed
destinations, exactly like the single-job path — per-job isolated: one
job's dead receiver never aborts another job's fan-out.

Per-job accounting (bytes dispatched, legs, DRR turns) snapshots under the
canonical ``Job/*`` keys (obs/metrics.py) for each job's totals.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable

from fedml_tpu_torch.comm.send_pool import BroadcastSendError, SendWorkerPool
from fedml_tpu_torch.obs import metrics as metricslib


class _Batch:
    """One submit()'s legs: completion barrier + per-destination errors."""

    __slots__ = ("done", "errors", "_remaining", "_lock")

    def __init__(self, n: int):
        self.done = threading.Event()
        self.errors: dict[int, BaseException] = {}  # guarded-by: _lock
        self._remaining = n  # guarded-by: _lock
        self._lock = threading.Lock()

    def leg_finished(self, dst_key: int, exc: BaseException | None) -> None:
        with self._lock:
            if exc is not None:
                self.errors[dst_key] = exc
            self._remaining -= 1
            if self._remaining == 0:
                self.done.set()


class _Leg:
    __slots__ = ("dst", "dst_key", "fn", "nbytes", "batch")

    def __init__(self, dst: int, dst_key: int, fn: Callable[[], None],
                 nbytes: int, batch: _Batch):
        self.dst = dst          # wire destination (pool FIFO key)
        self.dst_key = dst_key  # error-report key (the job's local rank)
        self.fn = fn
        self.nbytes = max(0, int(nbytes))
        self.batch = batch


class FairFanoutScheduler:
    """Deficit-round-robin dispatcher from per-job leg queues onto one
    shared send pool."""

    def __init__(self, pool: SendWorkerPool | None = None,
                 quantum_bytes: int = 256 * 1024,
                 name: str = "tenancy-sched"):
        if quantum_bytes <= 0:
            raise ValueError(
                f"quantum_bytes must be > 0, got {quantum_bytes} — a zero "
                "quantum never earns any job credit and the dispatcher "
                "starves everyone")
        self.pool = pool if pool is not None else SendWorkerPool(
            4, name=f"{name}-pool")
        self.quantum_bytes = int(quantum_bytes)
        self._name = name
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queues: dict[str, deque[_Leg]] = {}  # guarded-by: _wake
        self._deficit: dict[str, int] = {}  # guarded-by: _wake
        self._ring: deque[str] = deque()  # guarded-by: _wake; jobs w/ work
        self._stats: dict[str, dict[str, int]] = {}  # guarded-by: _wake
        self._closed = False  # guarded-by: _wake
        self._thread: threading.Thread | None = None  # guarded-by: _wake

    # -- submission ---------------------------------------------------------

    def run_job_legs(self, job: str,
                     legs: list[tuple[int, int, Callable[[], None], int]],
                     timeout: float | None = None) -> None:
        """Dispatch ``(dst, dst_key, fn, nbytes)`` legs for ``job`` and block
        until all of them completed (the job-side synchronous broadcast
        contract). Raises :class:`BroadcastSendError` keyed by ``dst_key``
        when any leg failed; injected-crash (``unretryable``) errors
        re-raise directly, exactly like the single-backend broadcast path."""
        if not legs:
            return
        batch = _Batch(len(legs))
        with self._wake:
            if self._closed:
                raise RuntimeError(f"scheduler {self._name!r} is closed")
            q = self._queues.get(job)
            if q is None:
                q = self._queues[job] = deque()
                self._deficit[job] = 0
                self._stats[job] = {"bytes": 0, "legs": 0, "turns": 0}
            had_work = bool(q)
            for dst, dst_key, fn, nbytes in legs:
                q.append(_Leg(dst, dst_key, fn, nbytes, batch))
            if not had_work:
                self._ring.append(job)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._dispatch_loop, name=self._name, daemon=True)
                self._thread.start()
            self._wake.notify()
        if not batch.done.wait(timeout):
            raise TimeoutError(
                f"job {job!r}: fan-out legs still pending after {timeout}s")
        if batch.errors:
            for e in batch.errors.values():
                if getattr(e, "unretryable", False):
                    raise e
            raise BroadcastSendError(batch.errors)

    # -- dispatch -----------------------------------------------------------

    def _next_dispatch(self) -> list[_Leg] | None:
        """One DRR visit under the lock: rotate to the next job with work,
        earn it a quantum, and pop the legs its credit covers. Returns None
        when closed and drained."""
        with self._wake:
            while True:
                if not self._ring:
                    if self._closed:
                        return None
                    self._wake.wait()
                    continue
                job = self._ring[0]
                q = self._queues[job]
                credit = self._deficit[job] + self.quantum_bytes
                took: list[_Leg] = []
                while q and q[0].nbytes <= credit:
                    leg = q.popleft()
                    credit -= leg.nbytes
                    took.append(leg)
                if q:
                    # head leg exceeds remaining credit: carry it and move
                    # to the back of the ring — credit accumulates until
                    # any payload fits, so big-model jobs progress too
                    self._deficit[job] = credit
                    self._ring.rotate(-1)
                else:
                    # drained: standard DRR drops leftover credit so an
                    # idle job cannot bank bandwidth against the others
                    self._deficit[job] = 0
                    self._ring.popleft()
                if took:
                    st = self._stats[job]
                    st["turns"] += 1
                    st["legs"] += len(took)
                    st["bytes"] += sum(leg.nbytes for leg in took)
                    return took
                # nothing fit this visit (over-credit head): next job

    def _dispatch_loop(self) -> None:
        while True:
            took = self._next_dispatch()
            if took is None:
                return
            for leg in took:
                self.pool.submit(leg.dst, self._leg_runner(leg))

    @staticmethod
    def _leg_runner(leg: _Leg) -> Callable[[], None]:
        def run() -> None:
            exc: BaseException | None = None
            try:
                leg.fn()
            except BaseException as e:  # noqa: BLE001 — reported per-dst
                exc = e
            leg.batch.leg_finished(leg.dst_key, exc)

        return run

    # -- observability / lifecycle ------------------------------------------

    def stats(self) -> dict[str, dict[str, int]]:
        """Per-job dispatch accounting under the canonical Job/* keys."""
        with self._wake:
            return {
                job: {
                    metricslib.JOB_SEND_BYTES: st["bytes"],
                    metricslib.JOB_SEND_LEGS: st["legs"],
                    metricslib.JOB_SCHED_TURNS: st["turns"],
                }
                for job, st in self._stats.items()
            }

    def close(self) -> None:
        """Stop the dispatcher after the queued legs drain (idempotent).
        Does NOT close the shared pool — the runner owns its lifecycle."""
        with self._wake:
            if self._closed:
                return
            self._closed = True
            self._wake.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=5.0)
