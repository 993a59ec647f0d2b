"""Buffered-asynchronous FedAvg server, the port of
``fedml_tpu/async_agg/server.py``: fold-on-arrival, emit-every-K.

FedBuff (Nguyen et al., 2022) semantics over the streaming wire path: there
is no round barrier. Every client upload folds into the ONE f64 accumulator
the moment it arrives, weighted ``s(staleness) * n``
(:mod:`fedml_tpu_torch.async_agg.staleness`), and the server emits a new
global model every ``buffer_goal`` arrivals: ``round_num`` counts emitted
model versions, not synchronized rounds. Stale uploads are folded (down-
weighted), never discarded; duplicate or replayed uploads (``comm/faults.py``
``dup``) are absorbed by a per-sender (version) idempotence guard.

Dispatch discipline (how the barrier disappears without deadlocking):

- an upload that trained an old version gets the current model back
  immediately: the worker never idles waiting for a round to close;
- an upload that trained the current version parks its worker (re-training
  the same version would reproduce the same update bit for bit);
- an emission bumps the version and dispatches the new model to every
  parked worker plus the triggering uploader.

With ``buffer_goal == worker_num`` every worker parks before the buffer
fills, so the emission broadcast goes to the full cohort: the sync protocol
re-emerges as a special case, and with the constant staleness weight the
fold arithmetic is the same, so async-with-full-buffer is bitwise the sync
streaming server.

Every downlink stamps the model version it carries
(``Message.MSG_ARG_KEY_MODEL_VERSION``, beside the authoritative
``round_idx`` the client trains as), and crash-resume snapshots the
mid-window arrival counter and idempotence guard through the
``RoundCheckpointer`` server-snapshot path. The fold is the JAX package's
host numpy arithmetic, so the same uploads in the same order give the
bitwise-same emitted models. With the downlink delta plane armed
(``compress/downlink.py``) each emission advances the delta chain, the
observed staleness drives the chain's retention, and an object-store
transport keeps its broadcast blobs as long as the chain serves them.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from fedml_tpu_torch.algorithms.fedavg_distributed import (
    CompressedDistAggregator,
    CompressedFedAvgServerManager,
    FedAvgDistAggregator,
    FedAvgServerManager,
    MyMessage,
)
from fedml_tpu_torch.algorithms.robust_distributed import (
    RobustDistAggregator,
    _RobustServerMixin,
)
from fedml_tpu_torch.async_agg.staleness import make_staleness_fn, memoize_staleness
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.obs import metrics as metricslib
from fedml_tpu_torch.obs import registry
from fedml_tpu_torch.obs import trace


class _AsyncTallyMixin:
    """Barrier-free tally surface over any streaming aggregator: versioned
    fold-on-arrival with a per-sender idempotence guard, an arrival counter
    driving emissions, and crash-recoverable window state. Mixed in FIRST
    over :class:`FedAvgDistAggregator` (or its compressed/robust
    subclasses) so ``self._fold``/``self._finish`` resolve to the wrapped
    arithmetic — the async weight simply rides the fold's sample-number
    slot, which is why every defended/encoded fold composes unchanged."""

    def _init_async(self) -> None:
        # folds since the last emission
        self.arrivals = 0  # guarded-by: _lock
        # worker -> newest version folded
        self.last_folded: dict[int, int] = {}  # guarded-by: _lock

    def fold_async(self, index: int, payload, weight: float,
                   upload_version: int) -> bool:
        """Fold one upload with its staleness-resolved ``weight``. Returns
        False when the (sender, version) pair was already folded — a
        duplicated or replayed wire leg — which must NOT advance the
        arrival counter (an attacker or a flaky transport could otherwise
        pump emissions)."""
        with self._lock:
            last = self.last_folded.get(index)
            if last is not None and upload_version <= last:
                return False
            # protocol state (idempotence guard, arrival counter) advances at
            # SUBMIT time; with a fold plane attached the arithmetic rides the
            # chunk workers and lands at the next drain, in arrival order
            self._fold_arrival(payload, weight)
            self.last_folded[index] = int(upload_version)
            self.arrivals += 1
            return True

    def emit(self) -> np.ndarray:
        """Close the buffer window: divide the accumulator and reset the
        arrival counter. The caller (server manager) bumps the version."""
        with self._lock:
            self._drain_locked()
            self.arrivals = 0
            return self._finish()

    def snapshot_state(self) -> dict:
        out = super().snapshot_state()
        # the base released _lock after its snapshot; re-acquire for the
        # window state (fedlint guarded-by: a concurrent fold_async must
        # never land between a torn arrivals/last_folded pair)
        with self._lock:
            out["arrivals"] = int(self.arrivals)
            out["last_folded"] = {str(k): int(v)
                                  for k, v in self.last_folded.items()}
        return out

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        with self._lock:
            self.arrivals = int(state.get("arrivals", 0))
            self.last_folded = {
                int(k): int(v)
                for k, v in state.get("last_folded", {}).items()
            }


class AsyncFedAggregator(_AsyncTallyMixin, FedAvgDistAggregator):
    """Dense async tally (the default)."""

    def __init__(self, worker_num: int):
        super().__init__(worker_num)
        self._init_async()


class AsyncCompressedFedAggregator(_AsyncTallyMixin, CompressedDistAggregator):
    """Async tally over encoded uploads: each EncodedUpdate scatter-folds
    into the dense accumulator on arrival, staleness weight included."""

    def __init__(self, worker_num: int, codec):
        super().__init__(worker_num, codec)
        self._init_async()


class AsyncRobustFedAggregator(_AsyncTallyMixin, RobustDistAggregator):
    """Async tally with the streaming defense folded into the arrival path:
    clip-against-last-emitted + non-finite rejection per upload, seeded
    weak-DP noise per EMISSION (the noise-key counter advances per emitted
    version). Mean rule only — order-statistic rules need a closed cohort
    stack, which a barrier-free window does not have."""

    def __init__(self, worker_num: int, config, model_desc: str | None = None):
        if config.rule != "mean" or config.reservoir_k:
            raise NotImplementedError(
                "async server mode supports the streaming 'mean' defense "
                "(clip + DP noise); order-statistic rules "
                f"({config.rule!r} / reservoir_k={config.reservoir_k}) need "
                "a closed cohort stack and a round barrier"
            )
        super().__init__(worker_num, config, model_desc=model_desc)
        self._init_async()


class AsyncFedAvgServerManager(FedAvgServerManager):
    """Barrier-free server protocol (see module docstring).

    ``round_idx`` is reinterpreted as the GLOBAL MODEL VERSION (number of
    emitted models); ``round_num`` as the number of versions to emit.
    ``on_round_done`` fires once per emission with (version, flat model).
    The elastic round timeout, the buffered A/B tally, and the exclusion
    march are sync-barrier machinery and are rejected loudly — liveness in
    async mode is heartbeats-only (docs/ROBUSTNESS.md)."""

    def __init__(self, *args, buffer_goal: int | None = None,
                 staleness_weight: str = "const",
                 async_stats: dict | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        if self.round_timeout is not None:
            raise ValueError(
                "async server mode has no round barrier: the elastic "
                "round_timeout does not apply"
            )
        self.buffer_goal = int(buffer_goal) if buffer_goal else self.worker_num
        if not (1 <= self.buffer_goal <= self.worker_num):
            raise ValueError(
                f"buffer_goal must be in [1, worker_num={self.worker_num}], "
                f"got {self.buffer_goal}: a window larger than the worker "
                "pool can never fill (every worker parks after its fold) — "
                "the server would deadlock"
            )
        self.staleness_weight = str(staleness_weight)
        self._staleness_fn = memoize_staleness(
            make_staleness_fn(self.staleness_weight))
        self._async_stats = async_stats
        # workers awaiting the next emission
        self._parked: set[int] = set()  # guarded-by: _round_lock
        self._fleet_t0 = time.monotonic()  # liveness epoch for never-seen ranks
        if self.fleet is not None:
            # route tracker transitions through the readmission-aware hook:
            # in async mode a written-off worker's FIRST new contact (a
            # heartbeat) flips it ONLINE via the tracker, and the operator
            # timeline must show the READMITTED event on that path too
            self.status.on_transition = self._fleet_transition
        # per-emission-window counters + run totals (Async/* metrics)
        self._window = {"stale": 0, "dup": 0, "staleness_sum": 0}  # guarded-by: _round_lock
        self._totals = {"stale": 0, "dup": 0, "emitted": 0}  # guarded-by: _round_lock

    def _make_aggregator(self):
        # the base __init__'s single construction call (fedlint:
        # overwrite-after-super): validate-then-delegate, so the async
        # variants keep overriding only _make_async_aggregator
        if self.buffered_aggregation:
            raise ValueError(
                "async server mode has no buffered A/B arm: the tally is "
                "streaming by construction (the sync server keeps the "
                "buffered oracle)"
            )
        return self._make_async_aggregator()

    def _make_async_aggregator(self):
        return AsyncFedAggregator(self.worker_num)

    def _sync_extra_params(self) -> dict:
        # the explicit version stamp: clients train against version
        # round_idx and the upload's echoed round index is the version the
        # staleness weight is computed from
        return {Message.MSG_ARG_KEY_MODEL_VERSION: self.round_idx}

    # -- the barrier-free receive path ---------------------------------------

    def _on_model_from_client(self, msg: Message) -> None:
        from fedml_tpu_torch.comm.status import ClientStatus

        sender = msg.get_sender_id()
        flat = self._decode_upload(msg)
        n = float(msg.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES))
        tel = msg.get(Message.MSG_ARG_KEY_TELEMETRY)
        # prefer the client's explicit version echo (the downlink stamp it
        # verifiably trained against); the authoritative round index it
        # trained AS is the compatible fallback — identical in value, but
        # only the echo survives a future protocol where the two diverge
        u = msg.get(Message.MSG_ARG_KEY_MODEL_VERSION)
        if u is None:
            u = msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
        with self._round_lock:
            current = self.round_idx
            # downlink delta plane: the echo proves which version this
            # worker holds, the base its next delta is served from
            self._note_version_echo(sender, msg)
            if not self.aggregator.is_live(sender - 1):
                logging.info("ignoring upload from non-live worker %d", sender)
                return
            self.status.update(sender, ClientStatus.ONLINE)
            u = current if u is None else int(u)
            if u > current:
                logging.warning(
                    "worker %d uploaded for version %d ahead of the server's "
                    "%d (protocol bug or replayed future leg); folding as "
                    "fresh", sender, u, current,
                )
                u = current
            staleness = current - u
            if self.downlink is not None:
                # the observed lag distribution drives delta-chain (and
                # object-store blob) retention: keep p99 + 1 steps so a
                # deliberately slow client still finds its base
                self.downlink.observe_staleness(staleness)
            weight = float(self._staleness_fn(staleness)) * n
            with trace.span("async/fold", sender=sender, version=u,
                            staleness=staleness):
                folded = self.aggregator.fold_async(sender - 1, flat, weight, u)
            if not folded:
                # duplicate/replayed (sender, version) leg: idempotent drop
                self._window["dup"] += 1
                self._totals["dup"] += 1
                if self.fleet is not None:
                    self.fleet.counter(sender, "dup_uploads")
                logging.info(
                    "absorbed duplicate upload from worker %d (version %d "
                    "already folded)", sender, u,
                )
                return
            if self.fleet is not None:
                # per-rank fold record: the union of these histograms IS
                # the per-emission staleness distribution the fleet report
                # renders (docs/OBSERVABILITY.md "Fleet telemetry")
                self.fleet.counter(sender, "uploads")
                self.fleet.observe(sender, "staleness", staleness)
                self.fleet.merge_report(sender, tel)
            if staleness > 0:
                self._window["stale"] += 1
                self._totals["stale"] += 1
                if self.fleet is not None:
                    self.fleet.counter(sender, "stale_folds")
                self._window["staleness_sum"] += staleness
            emitted = False
            record = None
            ckpt_state = None
            if self.aggregator.arrivals >= self.buffer_goal:
                arrivals = self.aggregator.arrivals
                with trace.span("async/emit", version=current,
                                arrivals=arrivals):
                    self.global_flat = self.aggregator.emit()
                self.round_idx += 1
                if self.downlink is not None:
                    # per-emission delta against the previous DECODED
                    # version; the emitted model of record becomes the
                    # decoded one
                    self.global_flat = self.downlink.advance(self.global_flat, self.round_idx)
                    # generational object-store blobs must outlive the
                    # slowest delta base the chain still serves
                    gens = self.downlink.retention_effective() + 1
                    if getattr(self.comm, "broadcast_generations", 0) \
                            and self.comm.broadcast_generations < gens:
                        logging.info("raising broadcast_generations to %d from the "
                                     "staleness p99 floor", gens)
                        self.comm.broadcast_generations = gens
                self._totals["emitted"] += 1
                emitted = True
                to_send = sorted(self._parked | {sender - 1})
                self._parked.clear()
                record = {
                    "round": current,
                    metricslib.ASYNC_ARRIVALS: arrivals,
                    metricslib.ASYNC_STALE_FOLDS: self._window["stale"],
                    metricslib.ASYNC_DUP_UPLOADS: self._window["dup"],
                    metricslib.ASYNC_MEAN_STALENESS:
                        self._window["staleness_sum"] / arrivals,
                }
                self._window = {"stale": 0, "dup": 0, "staleness_sum": 0}
                ckpt_state = self._checkpoint_state()
            elif staleness > 0:
                # the worker trained an old version: hand it the current
                # model right away — no barrier to wait for
                to_send = [sender - 1]
            else:
                # trained the current version: re-dispatching it would
                # reproduce the same update bit-for-bit — park until the
                # next emission advances the version
                self._parked.add(sender - 1)
                to_send = []
            done = emitted and self.round_idx >= self.round_num
        # full-model disk I/O and downlink fan-outs run OUTSIDE the lock —
        # they must not block the receive path (same discipline as the sync
        # server's round close)
        if ckpt_state is not None:
            self._write_checkpoint(ckpt_state)
        if record is not None:
            # emission boundary = the async analogue of a round close: the
            # fleet liveness sweep runs here so the per-emission fleet
            # record (flushed by the runner's on_round_done wrapper) carries
            # a current timeline
            self._fleet_liveness_sweep()
            if self._async_stats is not None:
                self._async_stats.setdefault("rounds", []).append(record)
            if self.on_round_done:
                self.on_round_done(record["round"], self.global_flat)
        if done:
            self._fanout_model(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                               [w + 1 for w in range(self.worker_num)],
                               finished=True)
            self.finish()
            return
        if to_send:
            self._fanout_model(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                               [w + 1 for w in to_send],
                               cohort=self._round_cohort())

    def _round_timed_out(self, expected_round: int) -> None:  # pragma: no cover
        raise AssertionError("async server mode arms no round timer")

    def _downlink_failed(self, errors: dict[int, BaseException]) -> None:
        """A failed dispatch leg must not strand its worker: the sync
        server's round timeout re-covers a missed sync, but async mode has
        no timer, and a worker that never receives a model never uploads
        again. Re-park the failed ranks so the NEXT emission re-sends them
        the then-current version. (With ``buffer_goal == worker_num`` the
        next emission needs every worker, so a permanently unreachable rank
        still wedges the run — exactly like the sync server without a
        round_timeout; arm a retry_policy and a buffer_goal < worker_num
        for liveness under lossy transports.)"""
        for e in errors.values():
            if getattr(e, "unretryable", False):
                raise e
        with self._round_lock:
            self._parked.update(w - 1 for w in errors)
        logging.warning(
            "async downlink failed to ranks %s; re-parked for the next "
            "emission's dispatch: %s",
            sorted(errors),
            "; ".join(f"{d}: {type(e).__name__}: {e}"
                      for d, e in sorted(errors.items())),
        )

    def _fleet_liveness_sweep(self, now: float | None = None) -> None:
        """Classify every worker's heartbeat age into the FLEET VIEW's
        health timeline. Async mode has no round barrier, so nothing ever
        marks a worker SLOW/OFFLINE protocol-wise (liveness is
        heartbeats-only, docs/ROBUSTNESS.md) — but the operator still needs
        the timeline, so each emission classifies by heartbeat age:

        - age > ``heartbeat_timeout``        -> SLOW
        - age > 3 x ``heartbeat_timeout``    -> OFFLINE
        - fresh again after OFFLINE          -> READMITTED, then ONLINE

        READ-ONLY by the fleet contract: states land on the fleet view
        only; the status tracker, the live set, and the dispatch discipline
        are never touched, so a swept run stays bit-identical to an
        unswept one. A rank that never made contact ages from server start
        (a worker dark from minute zero must not read as healthy).
        ``now`` is injectable for deterministic tests."""
        from fedml_tpu_torch.comm.status import ClientStatus

        if self.fleet is None or self.heartbeat_timeout is None:
            return
        t = time.monotonic() if now is None else now
        for w in range(self.worker_num):
            rank = w + 1
            seen = self.status.last_seen(rank)
            age = t - (self._fleet_t0 if seen is None else seen)
            prev = self.fleet.state(rank)
            if age > 3.0 * self.heartbeat_timeout:
                if prev not in (ClientStatus.SLOW, ClientStatus.OFFLINE):
                    # aging is monotonic: a rank seen only after it crossed
                    # the OFFLINE threshold still passed through the SLOW
                    # band — keep the degradation path on the timeline
                    self.fleet.record_state(rank, ClientStatus.SLOW)
                self.fleet.record_state(rank, ClientStatus.OFFLINE)
            elif age > self.heartbeat_timeout:
                if prev != ClientStatus.OFFLINE:
                    self.fleet.record_state(rank, ClientStatus.SLOW)
            else:
                self._fleet_transition(rank, ClientStatus.ONLINE)

    def _fleet_transition(self, rank: int, status: str) -> None:
        """Fleet-view state recorder (also the tracker's ``on_transition``
        hook in async mode): a worker the fleet wrote OFF that makes
        contact again gets the distinct READMITTED event before ONLINE —
        same operator convention as the sync server's readmission branch,
        but triggered by contact, since async mode never excludes."""
        from fedml_tpu_torch.comm.status import ClientStatus

        if (status == ClientStatus.ONLINE and self.fleet.state(rank)
                == ClientStatus.OFFLINE):
            self.fleet.record_state(rank, registry.STATE_READMITTED)
            self.fleet.counter(rank, "readmissions")
        self.fleet.record_state(rank, status)

    def async_totals(self) -> dict:
        # under the round lock (fedlint guarded-by): the runner reads the
        # totals after the protocol finishes, but a late in-flight handler
        # may still be folding — never serve a torn read
        with self._round_lock:
            return {
                metricslib.ASYNC_MODELS_EMITTED: self._totals["emitted"],
                metricslib.ASYNC_STALE_FOLDS: self._totals["stale"],
                metricslib.ASYNC_DUP_UPLOADS: self._totals["dup"],
            }

    def restore_from_checkpoint(self, checkpointer=None,
                                round_idx: int | None = None) -> int:
        version = super().restore_from_checkpoint(checkpointer, round_idx)
        with self._round_lock:
            # in-flight dispatches died with the crashed process: the resume
            # init re-broadcasts the restored version to EVERY worker, so
            # nobody is parked
            self._parked.clear()
        return version


class AsyncCompressedFedAvgServerManager(AsyncFedAvgServerManager,
                                         CompressedFedAvgServerManager):
    """Barrier-free server over the encoded-update uplink: EncodedUpdate
    planes fold on arrival (staleness-weighted), bytes-on-wire accounting
    unchanged."""

    def _make_async_aggregator(self):
        agg = AsyncCompressedFedAggregator(self.worker_num, self.codec)
        agg.get_global = lambda: self.global_flat
        return agg


class AsyncRobustFedAvgServerManager(_RobustServerMixin,
                                     AsyncFedAvgServerManager):
    """Barrier-free server with the streaming clip+DP defense folded into
    the arrival path (mean rule only; Robust/* records flush per emitted
    version)."""

    def __init__(self, *args, robust_config=None, robust_stats=None,
                 **kwargs):
        self._hoist_robust(robust_config)
        super().__init__(*args, **kwargs)
        self._init_robust(robust_stats)

    def _make_async_aggregator(self):
        return AsyncRobustFedAggregator(
            self.worker_num, self.robust_config,
            model_desc=self.model_desc,
        )
