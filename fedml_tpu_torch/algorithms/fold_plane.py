"""A copy of ``fedml_tpu/algorithms/fold_plane.py``.

Sharded fold plane: chunk-parallel, order-deterministic upload
aggregation off the comm receive thread (docs/PERFORMANCE.md "The server
fold plane").

Every aggregation plane in this repo tallies through ONE flat f64
accumulator folded one upload at a time under the aggregator lock, on the
comm receive thread — at tree fan-ins the fold, not the wire, is the
server's throughput ceiling. The plane splits the accumulator into
fixed-size element chunks owned round-robin by K worker threads. The
receive handler only assigns the upload its global arrival sequence
position (it is still under the aggregator ``_lock``, so enqueue order IS
arrival order) and appends the task to every worker's FIFO; each worker
folds its own chunks of the uploads in queue order. Every accumulator
element therefore sees the exact same f64 addition sequence as the serial
fold — plane-on is **bitwise identical** to plane-off by construction —
while the receive pump returns immediately and K chunks fold concurrently.

Per-upload work that is not elementwise (decode of an encoded upload, the
robust plane's norm/clip decision) runs once per task in
:meth:`FoldTask.ensure_prepared`, memoized under the task's own lock:
whichever thread first needs the prepared form computes it, off the
receive thread, and the result is the same bits regardless of who ran it.

Quiesce is **wait-free by design**: :meth:`FoldPlane.drain` never blocks
on a condition — it *helps*, acquiring each worker's fold lock in turn and
folding whatever is still queued inline. The only ``wait`` in this module
is the worker idle loop parking on the plane condition itself, which is
exactly the shape fedlint's Condition-wait exemption covers
(docs/STATIC_ANALYSIS.md), so drains may run under the aggregator and
round locks with zero blocking-under-lock findings.

Lock order: aggregator ``_round_lock`` -> aggregator ``_lock`` ->
``_flocks[w]`` -> ``_cv`` -> ``FoldTask._prep_lock``. Workers never touch
the aggregator locks; finalize bookkeeping runs on the draining thread,
which already holds the aggregator ``_lock``.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np

from fedml_tpu_torch.obs import metrics as metricslib
from fedml_tpu_torch.obs import registry as registrylib
from fedml_tpu_torch.obs import trace

# 256k f64 elements = 2MB per chunk: big enough that the per-chunk numpy
# dispatch overhead vanishes, small enough that a 4-worker plane load-
# balances a ~10M-element model across dozens of chunks per worker
DEFAULT_CHUNK_ELEMS = 1 << 18


class FoldTask:
    """One upload in flight through the plane.

    Subclasses supply the three family-specific pieces:

    - :meth:`_prepare` — the once-per-upload work (payload view/copy,
      decode, robust norm+clip). Returns the prepared form handed to every
      chunk fold, or ``None`` when the upload contributes no vector mass
      (a robust rejection) — workers then skip the fold entirely.
    - :meth:`fold_slice` — apply the ``[lo, hi)`` slice of the prepared
      contribution to the accumulator. MUST use the serial fold's exact
      per-element arithmetic.
    - :meth:`finalize` — scalar tally bookkeeping (weight sums, defense
      stats). Runs under the aggregator ``_lock`` at drain, in arrival
      order across tasks, so order-sensitive float sums reproduce the
      serial bits. Returns True when the task contributed vector mass.
    """

    __slots__ = ("seq", "first", "acc_elems", "contributed",
                 "_prep_lock", "_prep_state")

    def __init__(self, acc_elems: int):
        self.seq = -1
        # True when this task observed ``_acc is None`` at submit: partial
        # tasks then ASSIGN their first copy instead of adding to zeros,
        # mirroring the serial first-partial copy exactly
        self.first = False
        self.acc_elems = int(acc_elems)
        self.contributed = False
        self._prep_lock = threading.Lock()
        self._prep_state: tuple | None = None  # guarded-by: _prep_lock

    def ensure_prepared(self):
        """Memoized :meth:`_prepare`: first caller computes (off the
        receive thread), everyone else reuses the result. A prepare
        exception is memoized too, so a crashed task fails every chunk —
        and the drain — identically instead of double-counting side
        effects on retry."""
        with self._prep_lock:
            if self._prep_state is None:
                try:
                    prep = self._prepare()
                    self.contributed = prep is not None
                    self._prep_state = ("ok", prep)
                except BaseException as e:
                    self._prep_state = ("err", e)
            kind, val = self._prep_state
        if kind == "err":
            raise val
        return val

    def _prepare(self):
        raise NotImplementedError

    def fold_slice(self, acc: np.ndarray, lo: int, hi: int, prep) -> None:
        raise NotImplementedError

    def finalize(self, agg) -> bool:  # lock-held: _lock
        return self.contributed


class DenseFoldTask(FoldTask):
    """The base ``FedAvgDistAggregator._fold``: ``acc += n * f32(payload)``
    elementwise in f64 — chunked, same ``np.multiply(..., dtype=f64)``
    expression per element."""

    __slots__ = ("payload", "weight")

    def __init__(self, payload, weight: float):
        arr = np.asarray(payload)
        super().__init__(arr.nbytes // 4)
        self.payload = arr
        self.weight = float(weight)

    def _prepare(self):
        # the (possible) contiguity copy + dtype view move off the pump
        return np.ascontiguousarray(self.payload).view(np.float32)

    def fold_slice(self, acc, lo, hi, prep):
        acc[lo:hi] += np.multiply(prep[lo:hi], self.weight, dtype=np.float64)

    def finalize(self, agg) -> bool:  # lock-held: _lock
        agg._wsum += self.weight
        return True


class EncodedFoldTask(FoldTask):
    """``compress.aggregate.accumulate_encoded`` chunked: decode (or the
    top-k index sort) happens once in prepare, each chunk applies its
    slice through ``fold_encoded_slice`` — bincount scatter for top-k,
    the serial per-element expression for dense schemes."""

    __slots__ = ("enc", "weight", "codec")

    def __init__(self, enc, weight: float, codec, acc_elems: int):
        super().__init__(acc_elems)
        self.enc = enc
        self.weight = float(weight)
        self.codec = codec

    def _prepare(self):
        from fedml_tpu_torch.compress.aggregate import prepare_encoded

        return prepare_encoded(self.enc, self.weight, self.codec)

    def fold_slice(self, acc, lo, hi, prep):
        from fedml_tpu_torch.compress.aggregate import fold_encoded_slice

        fold_encoded_slice(acc, prep, lo, hi)

    def finalize(self, agg) -> bool:  # lock-held: _lock
        agg._wsum += self.weight
        return True


class TierPartialFoldTask(FoldTask):
    """``TierAggregator.fold_partial_weighted``: fold a child tier's raw
    f64 partial. The window's first partial is COPIED into the accumulator
    (``first=True`` -> per-chunk assignment), later ones add — the serial
    first-copy-else-add semantics, chunked."""

    __slots__ = ("payload", "wsum", "scale")

    def __init__(self, payload, wsum: float, scale: float = 1.0):
        arr = np.asarray(payload)
        super().__init__(arr.nbytes // 8)
        self.payload = arr
        self.wsum = float(wsum)
        self.scale = float(scale)

    def _prepare(self):
        part = np.ascontiguousarray(self.payload).view(np.float64)
        if self.scale != 1.0:
            part = part * np.float64(self.scale)
        return part

    def fold_slice(self, acc, lo, hi, prep):
        if self.first:
            acc[lo:hi] = prep[lo:hi]
        else:
            acc[lo:hi] += prep[lo:hi]

    def finalize(self, agg) -> bool:  # lock-held: _lock
        agg._wsum += self.wsum * self.scale
        return True


class FoldPlane:
    """K chunk workers + per-worker FIFO task queues.

    ``submit`` runs under the caller's aggregator lock (that is what makes
    queue order arrival order) and only appends + notifies; ``drain``
    helps fold whatever is left and re-raises the first worker error, so a
    crashed fold fails the round loudly instead of wedging the barrier.

    ``autostart=False`` is a test hook: no worker threads are spawned, so
    tasks provably sit queued until a drain folds them inline —
    deterministic coverage for snapshot-with-non-empty-queues schedules.
    """

    def __init__(self, workers: int, chunk_elems: int = DEFAULT_CHUNK_ELEMS,
                 autostart: bool = True):
        if workers < 1:
            raise ValueError(f"fold plane needs >= 1 worker, got {workers}")
        if chunk_elems < 1:
            raise ValueError(f"chunk_elems must be >= 1, got {chunk_elems}")
        self.workers = int(workers)
        self.chunk_elems = int(chunk_elems)
        self._autostart = bool(autostart)
        self._cv = threading.Condition(threading.Lock())
        self._queues = tuple(deque() for _ in range(self.workers))  # guarded-by: _cv
        self._seq = 0        # guarded-by: _cv
        self._depth = 0      # guarded-by: _cv
        self._error = None   # guarded-by: _cv
        self._closed = False  # guarded-by: _cv
        self._started = False  # guarded-by: _cv
        # serializes "pop one task + fold worker w's chunks of it": held by
        # the worker thread while it works, acquired by a draining thread
        # to help — acquisition order is _flocks[w] -> _cv, never reversed
        self._flocks = tuple(threading.Lock() for _ in range(self.workers))

    # -- receive-thread side ------------------------------------------------

    def submit(self, task: FoldTask, acc: np.ndarray) -> None:
        """Enqueue ``task`` against ``acc`` on every chunk worker. Caller
        holds the aggregator lock, so the assigned sequence position is the
        upload's arrival position."""
        with trace.span("fold/enqueue", elems=task.acc_elems):
            with self._cv:
                if self._closed:
                    raise RuntimeError("fold plane is closed")
                task.seq = self._seq
                self._seq += 1
                if not self._started and self._autostart:
                    self._start_locked()
                for q in self._queues:
                    q.append((task, acc))
                self._depth += 1
                depth = self._depth
                self._cv.notify_all()
        # gauge lands after the condition is released (the discipline:
        # telemetry never extends a critical section)
        registrylib.gauge(metricslib.FOLD_QUEUE_DEPTH, depth)

    def _start_locked(self) -> None:  # lock-held: _cv
        self._started = True
        for w in range(self.workers):
            threading.Thread(target=self._run, args=(w,),
                             name=f"fold-w{w}", daemon=True).start()

    # -- worker side --------------------------------------------------------

    def _run(self, w: int) -> None:
        while True:
            with self._cv:
                while not self._queues[w] and not self._closed:
                    self._cv.wait()
                if not self._queues[w] and self._closed:
                    return
            self._fold_pending(w)

    def _fold_pending(self, w: int) -> None:
        """Fold every task currently queued for worker ``w``, in queue
        order. The per-worker fold lock makes pop+fold one serialized unit,
        so a helping drain and the worker thread can interleave calls
        without ever reordering or double-applying a task."""
        with self._flocks[w]:
            while True:
                with self._cv:
                    if not self._queues[w]:
                        return
                    task, acc = self._queues[w].popleft()
                    self._depth -= 1
                try:
                    with trace.span("fold/worker", worker=w, seq=task.seq):
                        prep = task.ensure_prepared()
                        if prep is not None:
                            for lo, hi in self._owned(w, acc.size):
                                task.fold_slice(acc, lo, hi, prep)
                except BaseException as e:
                    with self._cv:
                        if self._error is None:
                            self._error = e

    def _owned(self, w: int, n: int):
        """Worker ``w``'s chunks of an ``n``-element accumulator, ascending:
        the fixed chunk grid dealt round-robin. Depends only on (n, chunk,
        K) — every thread that folds for ``w`` sees the same slices."""
        step = self.workers * self.chunk_elems
        for lo in range(w * self.chunk_elems, n, step):
            yield lo, min(lo + self.chunk_elems, n)

    # -- quiesce side -------------------------------------------------------

    def drain(self) -> None:
        """Fold everything still queued, inline, and surface worker errors.

        Wait-free: helping through the per-worker fold locks instead of
        waiting on a condition, so this is safe (and fedlint-clean) under
        the aggregator and round locks."""
        for w in range(self.workers):
            self._fold_pending(w)
        with self._cv:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                "fold plane worker failed; the round's tally is "
                "unrecoverable"
            ) from err

    def queued(self) -> int:
        """Tasks not yet fully folded (test/observability hook)."""
        with self._cv:
            return max(len(q) for q in self._queues) if self._queues else 0

    def close(self) -> None:
        """Wake idle workers so they exit. Queued tasks are NOT folded —
        call ``drain`` first if the tally still matters."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
