"""Bounded send-worker pool for concurrent downlink fan-out, a copy of
``fedml_tpu/comm/send_pool.py``.

The reference server (and this repo's managers until the wire-path rebuild)
sent every downlink message as a blocking unary call on the manager thread:
a broadcast to N workers serialized N round-trips — each with a multi-minute
timeout budget — before the receive loop could run again. The pool runs the
per-receiver sends of one broadcast concurrently so downlink wall time is
the slowest single send, not the sum.

Ordering contract: each destination is hashed to ONE worker thread, so two
sends to the same receiver can never reorder (the per-backend FIFO the
protocol layers rely on survives pooling); sends to different receivers run
concurrently. :meth:`SendWorkerPool.run_all` is a barrier — it returns after
every submitted send completed — so a broadcast call keeps its synchronous
semantics while its legs overlap. Failures are per-destination isolated:
every leg runs to completion regardless of the others, and ALL errors are
collected into one :class:`BroadcastSendError` naming the destination ranks
(a multi-receiver outage used to be reported as a single anonymous failure).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable


class BroadcastSendError(RuntimeError):
    """One or more per-destination sends of a fan-out failed. ``errors``
    maps destination rank -> the exception its send raised; the message
    names every failed rank so a multi-receiver outage is diagnosable from
    the log alone. Raised by :meth:`SendWorkerPool.run_all` and by the
    serial broadcast path in ``comm.base``."""

    def __init__(self, errors: dict[int, BaseException]):
        self.errors = dict(errors)
        detail = "; ".join(
            f"dst {d}: {type(e).__name__}: {e}"
            for d, e in sorted(self.errors.items())
        )
        super().__init__(
            f"broadcast failed to {len(self.errors)} receiver(s) "
            f"{sorted(self.errors)} — {detail}"
        )


class SendWorkerPool:
    """K worker threads, each owning a FIFO; destinations hash to workers."""

    def __init__(self, workers: int = 4, name: str = "comm-send"):
        self.workers = max(1, int(workers))
        self._name = name
        self._queues: list[queue.SimpleQueue] = [
            queue.SimpleQueue() for _ in range(self.workers)
        ]
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._started = False  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock

    def _ensure_started(self) -> None:
        with self._lock:
            if self._closed:
                raise RuntimeError(f"send pool {self._name!r} is closed")
            if self._started:
                return
            for i, q in enumerate(self._queues):
                t = threading.Thread(
                    target=self._worker, args=(q,),
                    name=f"{self._name}-{i}", daemon=True,
                )
                t.start()
                self._threads.append(t)
            self._started = True

    @staticmethod
    def _worker(q: queue.SimpleQueue) -> None:
        while True:
            fn = q.get()
            if fn is None:
                return
            fn()

    def run_all(self, tasks: list[tuple[int, Callable[[], None]]],
                timeout: float | None = None) -> None:
        """Run ``(destination, send_fn)`` tasks on the pool and block until
        all complete. Same-destination tasks run in submission order on one
        worker; distinct destinations overlap. Every task runs to
        completion regardless of other tasks' failures; if any failed, a
        :class:`BroadcastSendError` naming ALL failed destinations is
        raised."""
        if not tasks:
            return
        self._ensure_started()
        errors: dict[int, BaseException] = {}
        done = threading.Event()
        state_lock = threading.Lock()
        remaining = [len(tasks)]

        def wrap(dst: int, fn: Callable[[], None]) -> Callable[[], None]:
            def run() -> None:
                try:
                    fn()
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    with state_lock:
                        errors[dst] = e
                finally:
                    with state_lock:
                        remaining[0] -= 1
                        if remaining[0] == 0:
                            done.set()
            return run

        for dst, fn in tasks:
            self._queues[hash(dst) % self.workers].put(wrap(dst, fn))
        if not done.wait(timeout):
            raise TimeoutError(
                f"{remaining[0]} of {len(tasks)} pooled sends still pending "
                f"after {timeout}s"
            )
        if errors:
            raise BroadcastSendError(errors)

    def submit(self, dst: int, fn: Callable[[], None]) -> None:
        """Non-barrier enqueue: run ``fn`` on ``dst``'s worker, in submission
        order with every other send to ``dst``, and return immediately.
        Completion/error signaling is the caller's job (``fn`` must capture
        its own done/error channel) — the fair fan-out scheduler
        (tenancy/scheduler.py) dispatches its deficit-round-robin legs
        through this, keeping the per-destination FIFO contract while jobs'
        fan-outs interleave."""
        self._ensure_started()
        self._queues[hash(dst) % self.workers].put(fn)

    def close(self, timeout: float = 5.0) -> None:
        """Stop the workers (idempotent). Queued work submitted before close
        still drains; ``run_all`` after close raises."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            started = self._started
        if started:
            for q in self._queues:
                q.put(None)
            for t in self._threads:
                t.join(timeout)

    @property
    def alive_workers(self) -> int:
        return sum(t.is_alive() for t in self._threads)
