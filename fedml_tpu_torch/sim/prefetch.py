"""Pipelined round-driver plumbing, the port of ``fedml_tpu/sim/prefetch.py``:
staging on a background thread and a deferred metrics drain.

A serial driver interleaves three host phases per round — build the
cohort's index map, copy it to the device, then wait for the round's
metrics — so host staging and device work never overlap. This module
overlaps them:

- :class:`Prefetcher` runs the staging function for upcoming rounds (or
  blocks of rounds) on a background thread, keeping up to ``depth`` of them
  staged ahead of the dispatch loop. Staging is a pure function of ``(config, round_idx)`` —
  cohort sampling and shuffling are seeded per round — so prefetch order
  cannot change cohorts or metrics: the pipelined driver is bit-identical
  to the serial one. The staged payload is opaque to this module; under
  packed lanes it is the round's lane plan, so the bin-packing runs on the
  thread too (``fedml_tpu/sim/prefetch.py:18-20``).
- :class:`MetricsDrain` keeps each round's metrics as device tensors in a
  bounded queue. A round that falls off its back is fetched: its metrics
  are copied to pinned host memory with ``non_blocking=True`` and an event
  marks the copy. The driver reads them only after :meth:`MetricsDrain.flush`,
  which waits for every copy in flight, so it synchronises with the device
  only at eval rounds and at the end of the run. JAX's drain blocks on the
  round that falls off; here that would be a host wait between eval rounds,
  so the port defers it to the flush.

The staging thread pins host memory and copies to the device, which a CUDA
graph capture in the global mode refuses from any thread: ``FedSim.run``
captures its round graph or its lane pass graph (``sim/graphs.py``) before
it starts the thread.
The thread's copies go on the device's default stream, on which the
consumer issues its work after taking the payload, so they land before the
round (or the replay) that reads them.

Knob: ``SimConfig.pipeline_depth`` (0 = serial, None = auto depth 1).

Trace points (``obs/trace.py``, the JAX module's): ``prefetch/stage`` (one
staging call on the thread), ``prefetch/producer_blocked`` (the thread waits
on a full queue: the device side is the bottleneck),
``prefetch/consumer_stall`` (the driver waits on staging: the host is),
``prefetch/drain_fetch`` (one metrics fetch, with how long the metrics sat
queued) and the gauge ``prefetch/queue_depth``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Iterable

import torch

from fedml_tpu_torch.obs import trace

THREAD_NAME = "fedsim-prefetch"

_SENTINEL = object()


class Prefetcher:
    """Stage an ordered task list on a background thread.

    ``stage_fn(task)`` is called for each task in order; at most ``depth``
    staged payloads are buffered ahead of the consumer. :meth:`get` returns
    payloads strictly in task order and re-raises any staging exception at
    the consumer's next request. :meth:`close` always stops and joins the
    worker (idempotent) — call it from a ``finally`` so an exception mid-run
    cannot leak the thread or leave a producer blocked on a full queue.
    """

    def __init__(self, tasks: Iterable[Any], stage_fn: Callable[[Any], Any],
                 depth: int = 1):
        self._tasks = list(tasks)
        self._stage = stage_fn
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._exc: BaseException | None = None
        self._thread = threading.Thread(target=self._work, name=THREAD_NAME, daemon=True)
        self._thread.start()

    def _work(self) -> None:
        try:
            for task in self._tasks:
                if self._stop.is_set():
                    return
                with trace.span("prefetch/stage", task=str(task)):
                    payload = self._stage(task)
                if not self._offer((task, payload)):
                    return
        except BaseException as e:  # noqa: BLE001 — must reach the consumer
            self._exc = e
            self._offer((_SENTINEL, None))

    def _offer(self, item) -> bool:
        """Bounded put that never wedges: gives up when close() fires."""
        try:
            # fast path: room in the queue, the producer is ahead
            self._q.put_nowait(item)
        except queue.Full:
            # the producer waits on a full queue: the device side is the
            # bottleneck, and a span per blocked wait shows it
            with trace.span("prefetch/producer_blocked"):
                while True:
                    if self._stop.is_set():
                        return False
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        trace.gauge("prefetch/queue_depth", self._q.qsize())
        return True

    def get(self, task: Any) -> Any:
        """Return the staged payload for ``task`` — which must be the next
        task in submission order (the driver consumes the same plan it
        handed the prefetcher)."""
        try:
            # fast path: the payload is already staged (the pipeline keeps up)
            staged_task, payload = self._q.get_nowait()
        except queue.Empty:
            # the consumer waits on staging: host staging is the bottleneck
            # for this round
            with trace.span("prefetch/consumer_stall", task=str(task)):
                staged_task, payload = self._wait_for_item(task)
        trace.gauge("prefetch/queue_depth", self._q.qsize())
        if staged_task is _SENTINEL:
            raise self._exc
        if staged_task != task:
            raise RuntimeError(
                f"prefetch order violated: staged {staged_task!r}, requested {task!r}")
        return payload

    def _wait_for_item(self, task: Any) -> tuple:
        """Blocking wait for the next staged item, robust to a worker that
        died (re-raises its exception) or exited short."""
        while True:
            try:
                return self._q.get(timeout=0.2)
            except queue.Empty:
                if not self._thread.is_alive():
                    # the worker may have enqueued its final payload and
                    # exited between our timeout and this check — drain
                    # before concluding it died short
                    try:
                        return self._q.get_nowait()
                    except queue.Empty:
                        if self._exc is not None:
                            raise self._exc
                        raise RuntimeError(
                            f"prefetch worker exited before staging {task!r}") from None

    def close(self) -> None:
        """Stop the worker and join it. Safe to call repeatedly, safe to
        call with staged-but-unconsumed rounds in the queue (they are
        dropped — staging is pure, nothing to roll back)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            logging.warning("prefetch worker still alive 10s after close() — staging "
                            "call is blocked; continuing without it")

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MetricsDrain:
    """A bounded queue of not-yet-fetched round metrics (device tensors).

    :meth:`push` enqueues a dispatched round's metrics and returns whatever
    fell off the back, fetched; :meth:`flush` fetches everything still
    queued and waits for every fetch in flight. A fetch of CUDA tensors is a
    non-blocking copy into pinned host memory: the values it returns may be
    read once the next :meth:`flush` has returned. Keeping up to ``depth``
    entries queued means the driver never blocks on the rounds it has just
    dispatched. ``depth=0`` degrades to the serial fetch-every-round
    behavior: each push waits for its own copy.
    """

    def __init__(self, depth: int = 1):
        self.depth = max(0, int(depth))
        self._q: list[tuple[Any, Any, float]] = []
        self._inflight: list[torch.cuda.Event] = []

    def push(self, tag: Any, metrics: Any) -> list[tuple[Any, Any]]:
        self._q.append((tag, metrics, time.perf_counter()))
        out = []
        while len(self._q) > self.depth:
            out.append(self._fetch(self._q.pop(0)))
        if self.depth == 0:
            self._wait()
        return out

    def flush(self) -> list[tuple[Any, Any]]:
        out = [self._fetch(item) for item in self._q]
        self._q.clear()
        self._wait()
        return out

    def _fetch(self, item: tuple[Any, Any, float]) -> tuple[Any, Any]:
        tag, metrics, pushed = item
        # behind_s: how long the metrics sat queued before the fetch
        with trace.span("prefetch/drain_fetch", tag=str(tag),
                        behind_s=round(time.perf_counter() - pushed, 6)):
            return self._fetch_now(tag, metrics)

    def _fetch_now(self, tag: Any, metrics: Any) -> tuple[Any, Any]:
        if not isinstance(metrics, dict):
            return tag, metrics
        host = {}
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                pinned = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                pinned.copy_(v, non_blocking=True)
                host[k] = pinned
            else:
                host[k] = v
        if any(isinstance(v, torch.Tensor) and v.is_cuda for v in metrics.values()):
            event = torch.cuda.Event()
            event.record()
            self._inflight.append(event)
        return tag, host

    def _wait(self) -> None:
        for event in self._inflight:
            event.synchronize()
        self._inflight.clear()
