"""Metrics and logging, the port of ``logging_config`` and ``MetricsLogger``
from ``fedml_tpu/obs/metrics.py``: python logging with a per-process format
(fedml_api/utils/logger.py:7), and one metric sink with the reference's
wandb key names (Train/Acc, Train/Loss, Test/Acc, Test/Loss by round),
writing JSONL locally and forwarding to wandb when asked and available,
the robust defenses' metric keys and the bytes-on-wire keys of update
compression (``Comm/*``), and the wire path's ``CommBytesAccountant``, the
per-round byte ledger of the message-passing server, and ``RoundTimer``,
the reference's comm/compute tick-tock spans."""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any

from fedml_tpu_torch.obs import trace

# Robust-aggregation defense keys (algorithms/robust.py): per-round mean
# pre-clip update norm, fraction of the cohort whose delta got clipped, and
# how many client updates the combine rule discarded (Krum and the median
# keep one, trimmed mean drops 2k), each over the real (weight > 0) clients
ROBUST_UPDATE_NORM = "Robust/UpdateNorm"
ROBUST_CLIP_FRACTION = "Robust/ClipFraction"
ROBUST_FILTERED = "Robust/FilteredClients"

# Canonical bytes-on-wire metric keys (compress subsystem): actual bytes
# that crossed (or would cross) the transport vs the dense-f32 equivalent,
# per round. Emitted by the sim engine's compressed aggregator
# (compress/aggregate.py) so compression ratio shows up in the same metrics
# stream as Train/Acc.
COMM_UPLINK_BYTES = "Comm/UplinkBytes"
COMM_UPLINK_DENSE_BYTES = "Comm/UplinkDenseBytes"
COMM_DOWNLINK_BYTES = "Comm/DownlinkBytes"
COMM_DOWNLINK_DENSE_BYTES = "Comm/DownlinkDenseBytes"
COMM_RATIO = "Comm/CompressionRatio"
COMM_DOWNLINK_RATIO = "Comm/DownlinkCompressionRatio"
# downlink delta coding (the wire path's, ROADMAP §A11): how many receivers
# were served a dense keyframe this round
COMM_DOWNLINK_KEYFRAMES = "Comm/DownlinkKeyframes"

# ratio keys are derived, not additive — totals must never sum them
_RATIO_KEYS = (COMM_RATIO, COMM_DOWNLINK_RATIO)

# retry/backoff send plane (comm/retry.py): how many send attempts were
# re-tried after a transient failure over the whole run, in comm_stats
# totals when a RetryPolicy is armed
COMM_RETRY_COUNT = "Comm/RetryCount"
# uploads from an already-closed round that the synchronous server
# discarded, in comm_stats totals
COMM_STALE_UPLOADS = "Comm/StaleUploads"
# sharded fold plane (algorithms/fold_plane.py): uploads submitted to the
# chunk workers and not yet folded (a gauge), and the wall time a quiesce
# point spent draining the queues (a histogram)
FOLD_QUEUE_DEPTH = "Fold/QueueDepth"
FOLD_STALL_MS = "Fold/StallMs"
# tree mode (async_agg/tree.py): the bytes each edge tier's partials put on
# the wire toward its parent, and their raw-f64 equivalent, summed over
# the edges into tier_stats/comm_stats totals
COMM_TIER_UPLINK_BYTES = "Comm/TierUplinkBytes"
COMM_TIER_UPLINK_DENSE_BYTES = "Comm/TierUplinkDenseBytes"
# the buffered-async server (async_agg/server.py), per emission window:
# uploads folded, how many of them trained an older version, replayed
# (sender, version) legs absorbed, the mean version lag; ModelsEmitted
# rides the run totals
ASYNC_ARRIVALS = "Async/Arrivals"
ASYNC_STALE_FOLDS = "Async/StaleFolds"
ASYNC_DUP_UPLOADS = "Async/DuplicateUploads"
ASYNC_MEAN_STALENESS = "Async/MeanStaleness"
ASYNC_MODELS_EMITTED = "Async/ModelsEmitted"
# the multi-tenant job plane (tenancy/): the fair scheduler's per-job bytes,
# send legs and deficit-round-robin turns, and each job's rounds closed and
# captured error (0 or 1)
JOB_SEND_BYTES = "Job/SendBytes"
JOB_SEND_LEGS = "Job/SendLegs"
JOB_SCHED_TURNS = "Job/SchedulerTurns"
JOB_ROUNDS = "Job/Rounds"
JOB_ERRORS = "Job/Errors"


class CommBytesAccountant:
    """Per-round uplink/downlink byte ledger for the message-passing path.

    The sim engine computes these inside the round program (shapes are
    static); the wire path counts real payload sizes here instead — one
    ``record_*`` call per message, ``round_record`` to flush a round's
    totals into the metrics stream under the canonical keys."""

    def __init__(self):
        import threading

        # record_* runs on the server's receive thread; round_record can run
        # on the straggler-timeout timer thread (fedavg_distributed
        # _round_timed_out -> _complete_round) — counters need the lock or
        # an interleaved read-add-store loses straggler bytes
        self._lock = threading.Lock()
        self.rounds: list[dict] = []  # guarded-by: _lock
        self._up = 0  # guarded-by: _lock
        self._up_dense = 0  # guarded-by: _lock
        self._down = 0  # guarded-by: _lock
        self._down_dense = 0  # guarded-by: _lock
        self._keyframes = 0  # guarded-by: _lock

    def record_uplink(self, actual: int, dense: int) -> None:
        with self._lock:
            self._up += int(actual)
            self._up_dense += int(dense)

    def record_downlink(self, actual: int, dense: int) -> None:
        with self._lock:
            self._down += int(actual)
            self._down_dense += int(dense)

    def record_keyframes(self, count: int = 1) -> None:
        """Receivers served a dense keyframe instead of a delta chain
        (downlink delta plane only — the key is emitted only when the
        counter moved, so pre-downlink records are unchanged)."""
        with self._lock:
            self._keyframes += int(count)

    def round_record(self, round_idx: int) -> dict:
        with self._lock:
            rec = {
                "round": round_idx,
                COMM_UPLINK_BYTES: self._up,
                COMM_UPLINK_DENSE_BYTES: self._up_dense,
                COMM_DOWNLINK_BYTES: self._down,
                COMM_DOWNLINK_DENSE_BYTES: self._down_dense,
            }
            if self._up:
                rec[COMM_RATIO] = self._up_dense / self._up
            if self._down:
                rec[COMM_DOWNLINK_RATIO] = self._down_dense / self._down
            if self._keyframes:
                rec[COMM_DOWNLINK_KEYFRAMES] = self._keyframes
            self.rounds.append(rec)
            self._up = self._up_dense = self._down = self._down_dense = 0
            self._keyframes = 0
            return rec

    def totals(self) -> dict:
        out: dict = {}
        # include traffic recorded since the last round flush (e.g. the
        # final stop broadcast, which lands after the last round_record)
        with self._lock:
            pending = {
                COMM_UPLINK_BYTES: self._up,
                COMM_UPLINK_DENSE_BYTES: self._up_dense,
                COMM_DOWNLINK_BYTES: self._down,
                COMM_DOWNLINK_DENSE_BYTES: self._down_dense,
            }
            if self._keyframes:
                pending[COMM_DOWNLINK_KEYFRAMES] = self._keyframes
            rounds = list(self.rounds)
        for rec in rounds + [pending]:
            for k, v in rec.items():
                if k.startswith("Comm/") and k not in _RATIO_KEYS:
                    out[k] = out.get(k, 0) + v
        if out.get(COMM_UPLINK_BYTES):
            out[COMM_RATIO] = (
                out[COMM_UPLINK_DENSE_BYTES] / out[COMM_UPLINK_BYTES]
            )
        if out.get(COMM_DOWNLINK_BYTES):
            out[COMM_DOWNLINK_RATIO] = (
                out[COMM_DOWNLINK_DENSE_BYTES] / out[COMM_DOWNLINK_BYTES]
            )
        return out


def logging_config(process_id: int = 0, level=logging.INFO) -> None:
    """Per-process log format (fedml_api/utils/logger.py:7-32)."""
    logging.basicConfig(
        level=level,
        format=f"%(asctime)s [{process_id}] %(filename)s[%(lineno)d] %(levelname)s: %(message)s",
        force=True,
    )


class MetricsLogger:
    """wandb-key-compatible metric sink (Train/Acc, Test/Acc, ... by round).

    Usable as a context manager — the JSONL handle is closed even when the
    run body raises. ``close()`` is idempotent; ``log()`` after close raises
    instead of writing to a closed handle."""

    def __init__(self, run_dir: str | Path | None = None, use_wandb: bool = False,
                 wandb_kwargs: dict | None = None):
        self.run_dir = Path(run_dir) if run_dir else None
        self._fh = None
        self._closed = False
        if self.run_dir:
            self.run_dir.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.run_dir / "metrics.jsonl", "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(**(wandb_kwargs or {}))
            except Exception as e:  # wandb optional, never fatal
                logging.warning("wandb unavailable: %s", e)
        self.history: list[dict[str, Any]] = []

    def log(self, metrics: dict[str, Any], round_idx: int | None = None) -> None:
        if self._closed:
            raise RuntimeError(
                "MetricsLogger.log() after close(): the JSONL sink is gone; "
                "records logged here would be silently lost"
            )
        rec = dict(metrics)
        if round_idx is not None:
            rec["round"] = round_idx
        rec["_ts"] = time.time()
        self.history.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._wandb:
            self._wandb.log({k: v for k, v in rec.items() if not k.startswith("_")})

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._wandb:
            self._wandb.finish()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RoundTimer:
    """Comm/compute tick-tock instrumentation (reference fedml_core/
    distributed/communication/utils.py:6-18 log_communication_tick/tock,
    log_round_start/end): wall-clock spans keyed by tag.

    Every ``tock`` also lands the span in the process tracer's stream
    (obs/trace.py) when one is installed, so tick/tock call sites show up on
    the same Perfetto timeline as the engine and wire spans."""

    def __init__(self, tracer=None):
        # explicit tracer wins; by default the process tracer is resolved at
        # tock time (so a timer built before trace.install() still exports)
        self._tracer = tracer
        self._open: dict[str, float] = {}
        self.spans: list[tuple[str, float]] = []

    def tick(self, tag: str) -> None:
        self._open[tag] = time.perf_counter()

    def tock(self, tag: str) -> float:
        if tag not in self._open:
            raise ValueError(
                f"RoundTimer.tock({tag!r}) without a matching tick; "
                f"currently open tags: {sorted(self._open) or 'none'}"
            )
        t0 = self._open.pop(tag)
        t1 = time.perf_counter()
        dt = t1 - t0
        self.spans.append((tag, dt))
        tracer = self._tracer if self._tracer is not None else trace.get()
        if tracer is not None:
            tracer.add_span(tag, t0, t1)
        logging.debug("--- %s cost: %.4fs", tag, dt)
        return dt

    def summary(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for tag, dt in self.spans:
            out[tag] = out.get(tag, 0.0) + dt
        return out
