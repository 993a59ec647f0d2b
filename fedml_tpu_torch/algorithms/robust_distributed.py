"""Streaming Byzantine-robust + DP aggregation for the message-passing wire
path, the port of ``fedml_tpu/algorithms/robust_distributed.py``.

The sim engine's ``robust_aggregator`` (algorithms/robust.py) defends over a
stacked [C, ...] cohort. This module folds the same defense pipeline into the
wire server's accumulate-on-arrival tally, host numpy over the ``pack_pytree``
f32 wire layout, as the JAX server does:

- **clip**: each upload's delta against the last broadcast global model is
  norm-clipped at arrival (``robust.clip_scale``, the factor the sim uses;
  BN statistics excluded via ``robust.flat_norm_mask``), and the clipped
  update folds straight into the running f64 accumulator. Non-finite
  uploads (a bit-corrupted wire payload decodes to inf/NaN) are rejected
  outright: their weight never enters the divisor.
- **combine**: the ``mean`` rule stays pure streaming. Median, trimmed mean
  and Krum need a stack, so they get a bounded-memory arm: a seeded
  Algorithm-R reservoir of K clipped uploads (``reservoir_k``; 0 keeps every
  upload, the exact rule), with the JAX package's ``RandomState`` seeds, so
  both packages keep the same uploads. At round close the reservoir stack
  runs through the port's rule functions (``coordinate_median``,
  ``trimmed_mean``, ``krum_select``). Krum selects by the Krum rule, where
  the JAX ``krum_select`` always returns client 0 (ROADMAP §C, "Krum").
- **noise**: seeded weak-DP gaussian noise on the aggregate at round close,
  drawn from the port's :class:`~fedml_tpu_torch.core.rng.RoundNoise` on the
  host, ``(dp_seed, round)``: the same per-round schedule in both arms, other
  numbers than JAX's ``fold_in(key(dp_seed), round)`` (ROADMAP §C).

``Buffered*`` variants retain every upload and replay the identical defended
fold in arrival order at round close: the bit-exactness oracle for the
streaming arm. ``RobustCompressedDistAggregator`` composes with the
encoded-update uplink: the decoded fold is lifted to the model domain and
clipped exactly like a dense upload. :func:`run_attack_simulation` drives
the backdoor attack/defense A-B over the loopback wire.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg_distributed import (
    TRAIN_LOCK,
    BufferedFedAvgDistAggregator,
    CompressedFedAvgServerManager,
    FedAvgDistAggregator,
    FedAvgServerManager,
)
from fedml_tpu_torch.algorithms.fold_plane import FoldTask
from fedml_tpu_torch.algorithms.robust import (
    RobustConfig,
    add_weak_dp_noise,
    clip_scale,
    coordinate_median,
    flat_delta_norm,
    flat_norm_mask,
    krum_select,
    trimmed_mean,
)
from fedml_tpu_torch.core.rng import RoundNoise
from fedml_tpu_torch.obs import metrics as metricslib
from fedml_tpu_torch.obs import trace


@dataclasses.dataclass(frozen=True)
class RobustDistConfig:
    """Wire-path defense pipeline knobs (the distributed counterpart of
    robust.RobustConfig, plus the streaming-specific reservoir bound and
    noise seed)."""

    rule: str = "mean"  # mean | median | trimmed_mean | krum
    norm_bound: float = 0.0  # >0 enables per-upload clipping
    dp_stddev: float = 0.0  # >0 enables seeded weak-DP noise at close
    dp_seed: int = 0  # seeds the noise schedule AND the reservoir rng
    reservoir_k: int = 0  # non-mean rules: keep K uploads (0 = all = exact)
    trim_ratio: float = 0.1
    num_byzantine: int = 1

    def __post_init__(self):
        if self.rule not in RobustConfig.RULES:
            raise ValueError(
                f"unknown robust rule {self.rule!r} (expected one of "
                f"{RobustConfig.RULES})"
            )
        if self.reservoir_k < 0:
            raise ValueError(f"reservoir_k must be >= 0, got {self.reservoir_k}")

    @property
    def enabled(self) -> bool:
        return self.norm_bound > 0 or self.dp_stddev > 0 or self.rule != "mean"


def _reservoir_rng(config: RobustDistConfig, round_idx: int) -> np.random.RandomState:
    """Per-round seeded reservoir sampler: draws depend only on (seed,
    round, arrival order), so the buffered oracle's arrival-order replay
    reproduces the streaming arm's reservoir exactly."""
    return np.random.RandomState(
        (config.dp_seed * 1_000_003 + round_idx * 7919 + 0x0B57) % (2**31)
    )


def _clip_factor(norm: float, norm_bound: float) -> float:
    """``robust.clip_scale`` of one f32 norm, as a Python float."""
    return float(clip_scale(torch.tensor(norm, dtype=torch.float32), norm_bound))


class _RobustFoldTask(FoldTask):
    """The mean-rule defended fold through the sharded plane: the whole
    decision phase (delta against the submit-time global, full-vector
    finiteness, the BN-masked clip norm and scale) runs once in prepare, off
    the receive thread, with the exact serial expressions of
    ``_defended_fold``; the chunk folds then apply the (possibly clipped)
    vector with the base dense arithmetic. The order-sensitive scalars
    (``norm_sum`` is a float sum) are applied at drain in arrival order."""

    __slots__ = ("payload", "weight", "base", "config", "norm_mask",
                 "norm", "rejected", "clipped")

    def __init__(self, payload, weight: float, base: np.ndarray,
                 config: RobustDistConfig, norm_mask, acc_elems: int):
        super().__init__(acc_elems)
        self.payload = payload
        self.weight = float(weight)
        self.base = base  # f32 view of the global, captured at submit
        self.config = config
        self.norm_mask = norm_mask
        self.norm = 0.0
        self.rejected = False
        self.clipped = False

    def _dense_f32(self) -> np.ndarray | None:
        return np.ascontiguousarray(self.payload).view(np.float32)

    def _prepare(self):
        x = self._dense_f32()
        if x is None:  # undecodable encoded upload: rejected in finalize
            self.rejected = True
            return None
        cfg = self.config
        with trace.span("robust/fold", rule=cfg.rule):
            base = self.base
            delta = x - base
            with trace.span("robust/clip"):
                full_norm = float(np.linalg.norm(delta))
                if not np.isfinite(full_norm):
                    self.rejected = True
                    return None
                self.norm = (full_norm if self.norm_mask is None
                             else flat_delta_norm(delta, self.norm_mask))
                if cfg.norm_bound > 0:
                    scale = _clip_factor(self.norm, cfg.norm_bound)
                    if scale < 1.0:
                        self.clipped = True
                        x = base + delta * np.float32(scale)
            return x

    def fold_slice(self, acc, lo, hi, prep):
        acc[lo:hi] += np.multiply(prep[lo:hi], self.weight, dtype=np.float64)

    def finalize(self, agg) -> bool:  # lock-held: _lock
        agg._stats["n"] += 1
        if self.rejected:
            agg._stats["rejected"] += 1
            return False
        agg._stats["norm_sum"] += self.norm
        if self.clipped:
            agg._stats["clipped"] += 1
        agg._wsum += self.weight
        return True


def _decode_dense(codec, enc) -> np.ndarray | None:
    """An encoded upload decoded to one flat f32 vector in the wire order;
    None when it is undecodable (a corrupted upload is just another hostile
    one: rejected, never a crashed round)."""
    from fedml_tpu_torch.compress.aggregate import _flat_leaves

    try:
        with trace.span("compress/decode", scheme=enc.scheme):
            leaves = _flat_leaves(codec.decode(enc))
            return np.concatenate([l.astype(np.float32) for l in leaves])
    except Exception as e:  # noqa: BLE001 — any decode failure rejects the upload
        logging.warning("robust fold: undecodable encoded upload rejected (%s: %s)",
                        type(e).__name__, e)
        return None


class _RobustEncodedFoldTask(_RobustFoldTask):
    """Encoded-uplink variant: the decode (and the delta-domain lift onto
    the submit-time global) joins the prepare phase."""

    __slots__ = ("codec",)

    def __init__(self, enc, weight: float, base: np.ndarray,
                 config: RobustDistConfig, norm_mask, codec):
        super().__init__(enc, weight, base, config, norm_mask, base.nbytes // 4)
        self.codec = codec

    def _dense_f32(self) -> np.ndarray | None:
        dense = _decode_dense(self.codec, self.payload)
        if dense is None:
            return None
        x = self.base + dense if self.codec.delta_domain else dense
        return np.asarray(x, np.float32)


class RobustDistAggregator(FedAvgDistAggregator):
    """Streaming tally with the defense folded into the arrival path.

    Memory: O(model) for the accumulator plus O(reservoir_k x model) for
    non-mean rules, never O(workers x model). ``get_global`` (wired by the
    server manager) supplies the last broadcast flat model, the clip
    reference."""

    def __init__(self, worker_num: int, config: RobustDistConfig,
                 model_desc: str | None = None):
        super().__init__(worker_num)
        self.config = config
        self.get_global = None  # wired by the server manager (current flat)
        self._norm_mask = flat_norm_mask(model_desc) if model_desc else None
        self._round_counter = 0  # guarded-by: _lock
        self._reservoir: list[np.ndarray] = []  # guarded-by: _lock
        self._res_seen = 0  # guarded-by: _lock
        self._res_rng = _reservoir_rng(config, 0)  # guarded-by: _lock
        self._stats = {"norm_sum": 0.0, "n": 0, "clipped": 0, "rejected": 0}  # guarded-by: _lock
        self._last_record: dict | None = None  # guarded-by: _lock

    # -- defended arrival fold ----------------------------------------------

    def attach_fold_plane(self, plane) -> None:
        """The plane composes with the ``mean`` rule only; reservoir rules
        mutate seeded cross-client sampler state at every arrival, so they
        keep the serial path."""
        if self.config.rule == "mean":
            super().attach_fold_plane(plane)

    def _fold_task(self, payload, weight: float):
        # the clip reference is captured here, under the tally lock: the
        # same global the serial fold would have read at this arrival
        base = np.ascontiguousarray(self.get_global()).view(np.float32)
        return _RobustFoldTask(payload, weight, base, self.config, self._norm_mask,
                               np.asarray(payload).nbytes // 4)

    def _fold(self, payload, sample_num: float) -> None:
        x = np.ascontiguousarray(payload).view(np.float32)
        self._defended_fold(x, sample_num)

    def _defended_fold(self, x: np.ndarray, sample_num: float) -> None:  # lock-held: _lock
        """Clip ``x`` (a flat f32 model vector) against the last broadcast
        global and fold it into the f64 accumulator (mean rule) or the
        reservoir (order-statistic rules). Caller holds the tally lock."""
        cfg = self.config
        with trace.span("robust/fold", rule=cfg.rule):
            self._stats["n"] += 1
            base = np.ascontiguousarray(self.get_global()).view(np.float32)
            delta = x - base
            with trace.span("robust/clip"):
                # finiteness on the FULL delta norm (BN statistics included:
                # a corrupted coordinate anywhere would poison the
                # accumulator); the clip norm then excludes BN statistics
                full_norm = float(np.linalg.norm(delta))
                if not np.isfinite(full_norm):
                    self._stats["rejected"] += 1
                    return
                norm = (full_norm if self._norm_mask is None
                        else flat_delta_norm(delta, self._norm_mask))
                self._stats["norm_sum"] += norm
                if cfg.norm_bound > 0:
                    scale = _clip_factor(norm, cfg.norm_bound)
                    if scale < 1.0:
                        self._stats["clipped"] += 1
                        x = base + delta * np.float32(scale)
            if cfg.rule == "mean":
                super()._fold(x, sample_num)
            else:
                self._reservoir_add(x)

    def _reservoir_add(self, x: np.ndarray) -> None:  # lock-held: _lock
        """Algorithm-R reservoir over the round's (clipped) uploads: every
        upload has equal probability K/seen of being in the close-time
        stack. ``reservoir_k == 0`` keeps everything (the exact rule)."""
        k = self.config.reservoir_k
        self._res_seen += 1
        if k == 0 or len(self._reservoir) < k:
            self._reservoir.append(np.array(x, np.float32))  # own the bytes
        else:
            j = int(self._res_rng.randint(self._res_seen))
            if j < k:
                self._reservoir[j] = np.array(x, np.float32)

    # -- round close ---------------------------------------------------------

    def _finish(self) -> np.ndarray:
        cfg = self.config
        self._fold_epoch += 1
        with trace.span("robust/close", rule=cfg.rule):
            all_rejected = (self._acc is None if cfg.rule == "mean"
                            else not self._reservoir)
            if all_rejected:
                # every upload this round was rejected as non-finite: keep
                # the previous global (no noise either)
                logging.warning("robust round close: every upload rejected (non-finite); "
                                "keeping the previous global model")
                out = np.array(np.ascontiguousarray(self.get_global()).view(np.float32))
                rule_filtered = 0
                self._reservoir = []
                self._res_seen = 0
            elif cfg.rule == "mean":
                out = (self._acc / self._wsum).astype(np.float32)
                rule_filtered = 0
            else:
                stack = np.stack(self._reservoir)  # [K, D] f32
                out, rule_filtered = self._combine_reservoir(stack)
                self._reservoir = []
                self._res_seen = 0
            self._acc = None
            self._wsum = 0.0
            if cfg.dp_stddev > 0 and not all_rejected:
                noise = RoundNoise(cfg.dp_seed, self._round_counter, "cpu")
                out = add_weak_dp_noise({"w": torch.from_numpy(out)}, cfg.dp_stddev,
                                        noise)["w"].numpy()
            self._round_counter += 1
            self._res_rng = _reservoir_rng(cfg, self._round_counter)
            s, self._stats = self._stats, {"norm_sum": 0.0, "n": 0, "clipped": 0,
                                           "rejected": 0}
            # clip statistics average over the uploads that actually folded
            folded = max(s["n"] - s["rejected"], 1)
            self._last_record = {
                metricslib.ROBUST_UPDATE_NORM: s["norm_sum"] / folded,
                metricslib.ROBUST_CLIP_FRACTION: s["clipped"] / folded,
                metricslib.ROBUST_FILTERED: s["rejected"] + rule_filtered,
            }
            return out.astype(np.float32).view(np.uint8)

    def _combine_reservoir(self, stack: np.ndarray) -> tuple[np.ndarray, int]:  # lock-held: _lock
        """Run the port's rule functions over the reservoir stack. Returns
        (aggregate, number of updates the rule discarded).

        An elastic-timeout round can close with fewer survivors than the
        rule supports (trimmed_mean with ``C - 2k <= 0``, krum with
        ``num_byzantine > C - 3``): the close then degrades to the
        coordinate median for that round, with a warning, as in JAX."""
        cfg, k = self.config, len(stack)
        rule = cfg.rule
        if rule == "trimmed_mean" and k - 2 * int(cfg.trim_ratio * k) <= 0:
            logging.warning("robust close: %d survivors cannot support trimmed_mean"
                            "(trim_ratio=%s); using the coordinate median this round",
                            k, cfg.trim_ratio)
            rule = "median"
        if rule == "krum" and cfg.num_byzantine > k - 3:
            logging.warning("robust close: %d survivors cannot support krum"
                            "(num_byzantine=%d); using the coordinate median this round",
                            k, cfg.num_byzantine)
            rule = "median"
        t = {"w": torch.from_numpy(stack)}
        if rule == "median":
            return coordinate_median(t)["w"].numpy(), k - 1
        if rule == "trimmed_mean":
            return (trimmed_mean(t, cfg.trim_ratio)["w"].numpy(),
                    2 * int(cfg.trim_ratio * k))
        # krum: score distances over non-BN coordinates, return the winner
        kstack = stack if self._norm_mask is None else stack[:, self._norm_mask]
        idx = int(krum_select({"w": torch.from_numpy(np.ascontiguousarray(kstack))},
                              cfg.num_byzantine))
        return stack[idx], k - 1

    # -- crash-recovery snapshot ---------------------------------------------

    def snapshot_state(self) -> dict:
        """Base tally snapshot plus the defense's round schedule: the noise
        round counter (a restarted server must not replay round k's noise
        for round k+1) and the reservoir (empty at round close, when the
        server checkpoints; carried anyway)."""
        out = super().snapshot_state()
        with self._lock:
            out["robust_round"] = int(self._round_counter)
            out["res_seen"] = int(self._res_seen)
            if self._reservoir:
                out["reservoir"] = np.stack(self._reservoir)
        return out

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        with self._lock:
            self._round_counter = int(state.get("robust_round", 0))
            self._res_seen = int(state.get("res_seen", 0))
            res = state.get("reservoir")
            self._reservoir = ([np.array(r, np.float32) for r in res]
                               if res is not None else [])
            # round-close rng state is "fresh for the current round
            # counter", the state _finish() leaves behind
            self._res_rng = _reservoir_rng(self.config, self._round_counter)

    def pop_round_stats(self) -> dict | None:
        """The closed round's Robust/* record (None when no round closed
        since the last pop)."""
        with self._lock:
            rec, self._last_record = self._last_record, None
            return rec


class BufferedRobustDistAggregator(BufferedFedAvgDistAggregator, RobustDistAggregator):
    """Bit-exactness oracle: retains every upload and replays the SAME
    defended fold in arrival order at round close (same clip reference,
    same reservoir draws, same noise), so streaming == buffered
    byte-for-byte under any schedule, dropped stragglers included."""

    def __init__(self, worker_num: int, config: RobustDistConfig,
                 model_desc: str | None = None):
        RobustDistAggregator.__init__(self, worker_num, config, model_desc)
        self.model_dict = {}


class RobustCompressedDistAggregator(RobustDistAggregator):
    """Robust streaming tally for encoded uploads: decode the client's
    EncodedUpdate to ONE transient dense vector, lift delta-domain codecs
    onto the current global, then clip-and-fold exactly like a dense
    upload."""

    def __init__(self, worker_num: int, config: RobustDistConfig, codec,
                 model_desc: str | None = None):
        super().__init__(worker_num, config, model_desc)
        self.codec = codec

    def _fold_task(self, payload, weight: float):
        base = np.ascontiguousarray(self.get_global()).view(np.float32)
        return _RobustEncodedFoldTask(payload, weight, base, self.config,
                                      self._norm_mask, self.codec)

    def _fold(self, payload, sample_num: float) -> None:
        dense = _decode_dense(self.codec, payload)
        if dense is None:
            self._stats["n"] += 1
            self._stats["rejected"] += 1
            return
        if self.codec.delta_domain:
            base = np.ascontiguousarray(self.get_global()).view(np.float32)
            dense = base + dense
        self._defended_fold(np.asarray(dense, np.float32), sample_num)


class BufferedRobustCompressedDistAggregator(BufferedFedAvgDistAggregator,
                                             RobustCompressedDistAggregator):
    """Arrival-order replay oracle for the robust compressed tally."""

    def __init__(self, worker_num: int, config: RobustDistConfig, codec,
                 model_desc: str | None = None):
        RobustCompressedDistAggregator.__init__(self, worker_num, config, codec, model_desc)
        self.model_dict = {}


class _RobustServerMixin:
    """Shared server-manager wiring: swap in the robust tally and flush its
    Robust/* record per closed round (mirrors comm_stats)."""

    def _hoist_robust(self, robust_config: RobustDistConfig | None) -> None:
        """Validate and stash the defense config, before super().__init__:
        the base's single ``_make_aggregator()`` call reads it."""
        if robust_config is None:
            raise ValueError(f"{type(self).__name__} needs a robust_config")
        self.robust_config = robust_config

    def _init_robust(self, robust_stats: dict | None) -> None:
        self._robust_stats = robust_stats
        self.aggregator.get_global = lambda: self.global_flat
        # flush the closed round's Robust/* record BEFORE the caller's round
        # callback fires: a callback merging per-round metrics by round
        # index finds round r already recorded
        inner_cb = self.on_round_done

        def _flush_then(round_idx: int, flat) -> None:
            rec = self.aggregator.pop_round_stats()
            if rec is not None:
                rec = {"round": round_idx, **rec}
                logging.info("robust defense: %s", rec)
                if self._robust_stats is not None:
                    self._robust_stats.setdefault("rounds", []).append(rec)
            if inner_cb is not None:
                inner_cb(round_idx, flat)

        self.on_round_done = _flush_then


class RobustFedAvgServerManager(_RobustServerMixin, FedAvgServerManager):
    """FedAvg server with the streaming robust tally (dense uplink)."""

    def __init__(self, *args, robust_config: RobustDistConfig | None = None,
                 robust_stats: dict | None = None, **kwargs):
        self._hoist_robust(robust_config)
        super().__init__(*args, **kwargs)
        self._init_robust(robust_stats)

    def _make_aggregator(self):
        return (
            BufferedRobustDistAggregator if self.buffered_aggregation
            else RobustDistAggregator
        )(self.worker_num, self.robust_config, model_desc=self.model_desc)


class RobustCompressedFedAvgServerManager(_RobustServerMixin, CompressedFedAvgServerManager):
    """FedAvg server composing the encoded-update uplink with the robust
    tally: decode, clip, fold; bytes-on-wire accounting unchanged."""

    def __init__(self, *args, robust_config: RobustDistConfig | None = None,
                 robust_stats: dict | None = None, **kwargs):
        self._hoist_robust(robust_config)
        super().__init__(*args, **kwargs)
        self._init_robust(robust_stats)

    def _make_aggregator(self):
        return (
            BufferedRobustCompressedDistAggregator if self.buffered_aggregation
            else RobustCompressedDistAggregator
        )(self.worker_num, self.robust_config, self.codec, model_desc=self.model_desc)


# ---------------------------------------------------------------------------
# Loopback attack simulation: poison -> distributed rounds -> ASR
# ---------------------------------------------------------------------------


def eval_accuracy(trainer, variables, arrays: dict, batch_size: int = 64) -> float:
    """Pooled accuracy of ``variables`` (a port state dict) on ``arrays``
    ({"x","y"}), on the trainer's device: the clean accuracy and, on a
    triggered test set (data/poison.py ``backdoor_test_arrays``), the attack
    success rate. It runs under the wire clients' ``TRAIN_LOCK`` (the
    trainer's module is their working copy)."""
    from fedml_tpu_torch.core.trainer import make_local_eval
    from fedml_tpu_torch.sim.cohort import batch_array

    device = next(trainer.module.parameters()).device
    batches = {k: torch.from_numpy(v).to(device)
               for k, v in batch_array(arrays, batch_size).items()}
    with TRAIN_LOCK:
        m = make_local_eval(trainer)({k: v.to(device) for k, v in variables.items()}, batches)
    return float(m["test_correct"]) / max(float(m["test_total"]), 1.0)


def run_attack_simulation(
    trainer,
    train_data,
    test_arrays: dict,
    worker_num: int,
    round_num: int,
    batch_size: int,
    defense: RobustDistConfig,
    compromised_frac: float = 0.5,
    sample_frac: float = 1.0,
    target_label: int = 0,
    trigger=None,
    poison_seed: int = 0,
    fault_specs=None,
    buffered_aggregation: bool = False,
    round_timeout: float | None = None,
    seed: int = 0,
) -> dict:
    """End-to-end loopback attack/defense A-B: poison a client fraction
    (data/poison.py), run the real message-passing FedAvg protocol with the
    defense ON and OFF (optionally through the fault-injection wrapper,
    comm/faults.py), and report the backdoor attack success rate plus clean
    accuracy for both arms. The reference's main_fedavg_robust attack loop,
    driven over the wire path; the clients train on the trainer's device."""
    from fedml_tpu_torch.algorithms.fedavg_distributed import run_distributed_fedavg_loopback
    from fedml_tpu_torch.data.poison import Trigger, backdoor_test_arrays, poison_clients

    trigger = trigger or Trigger()
    poisoned, bad, counts = poison_clients(
        train_data, compromised_frac=compromised_frac, sample_frac=sample_frac,
        target_label=target_label, trigger=trigger, seed=poison_seed,
    )
    backdoor = backdoor_test_arrays(test_arrays, target_label=target_label, trigger=trigger)

    def arm(robust_config):
        stats: dict = {}
        final = run_distributed_fedavg_loopback(
            trainer, poisoned, worker_num=worker_num, round_num=round_num,
            batch_size=batch_size, seed=seed,
            robust_config=robust_config,
            robust_stats=stats if robust_config else None,
            fault_specs=fault_specs,
            round_timeout=round_timeout,
            server_kwargs={"buffered_aggregation": buffered_aggregation},
        )
        return {
            "asr": eval_accuracy(trainer, final, backdoor),
            "clean_acc": eval_accuracy(trainer, final, test_arrays),
            "robust_rounds": stats.get("rounds", []),
        }

    on, off = arm(defense), arm(None)
    result = {
        "compromised_clients": [int(c) for c in bad],
        "poisoned_counts": counts,
        "asr_defended": on["asr"],
        "asr_undefended": off["asr"],
        "clean_acc_defended": on["clean_acc"],
        "clean_acc_undefended": off["clean_acc"],
        "robust_rounds": on["robust_rounds"],
    }
    logging.info(
        "attack simulation: ASR %.3f defended vs %.3f undefended "
        "(clean acc %.3f vs %.3f)",
        result["asr_defended"], result["asr_undefended"],
        result["clean_acc_defended"], result["clean_acc_undefended"],
    )
    return result
