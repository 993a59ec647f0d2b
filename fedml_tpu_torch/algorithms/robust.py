"""Byzantine-robust aggregation, the port of ``fedml_tpu/algorithms/robust.py``.

Reference: fedml_core/robustness/robust_aggregation.py: norm-difference
clipping of client deltas (:38-49), weak-DP gaussian noise (:51-55),
coordinate-wise median (:57-89), BN statistics excluded from the vectorised
statistics (:4-9, 28-29); wired into FedAvg by
fedml_api/distributed/fedavg_robust/FedAvgRobustAggregator.py:176-206 (clip,
combine, noise). Trimmed mean and Krum are the standard extensions.

Every defense is a function of the stacked ``[C, ...]`` cohort state dict
(``Aggregator.stacked``) that stays on the device: no statistic is read on
the host, so a CUDA graph of the round captures it (Krum indexes the stack
with its device index). Where the port departs from the JAX package:

- Krum selects by the Krum rule (Blanchard et al., NeurIPS 2017). The JAX
  ``krum_select`` excludes a client's distance to itself by adding
  ``eye(C) * inf``, which is NaN off the diagonal (``0 * inf``), so every
  score is NaN and it always returns client 0;
- the weak-DP noise is a pure function of ``(seed, round)``
  (:class:`~fedml_tpu_torch.core.rng.RoundNoise`), not of JAX's threaded
  keys, so the two packages draw different noise.

Clients that a population drops mid-round keep weight 0 but stay in the
stack that median, trimmed mean and Krum read, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from fedml_tpu_torch.algorithms.base import Aggregator
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.obs import metrics as metricslib

StateDict = dict[str, torch.Tensor]


def clip_scale(norms: torch.Tensor, norm_bound: float) -> torch.Tensor:
    """The norm-difference clip factor (robust_aggregation.py:38-49):
    ``min(1, bound / max(norm, 1e-12))``."""
    return torch.clamp(norm_bound / torch.clamp(norms, min=1e-12), max=1.0)


def delta_norms(global_variables: StateDict, stacked: StateDict
                ) -> tuple[StateDict, torch.Tensor]:
    """Per-client deltas ``[C, ...]`` (every leaf) and their L2 norms ``[C]``
    over the parameters (the model state, BN statistics, excluded)."""
    deltas = {k: s - global_variables[k].unsqueeze(0) for k, s in stacked.items()}
    sq = None
    for k, d in deltas.items():
        if treelib.is_model_state(k):
            continue
        term = torch.sum(d.reshape(d.shape[0], -1) ** 2, dim=1)
        sq = term if sq is None else sq + term
    return deltas, torch.sqrt(sq)


# --- flat-vector (wire payload) defense helpers ------------------------------
# The message-passing server folds pack_pytree byte vectors of the JAX layout
# (all-f32 leaves, validated at server init); these apply the same defense
# statistics to that layout (algorithms/robust_distributed.py).


def _is_norm_stat(path: str) -> bool:
    """BatchNorm statistics filter over a JAX-layout leaf path (the whole
    ``batch_stats`` collection, as ``treelib.is_model_state`` excludes the
    port's model state)."""
    return "batch_stats" in path


def flat_norm_mask(model_desc: str) -> np.ndarray | None:
    """Elementwise bool mask over the ``pack_pytree`` f32 wire layout:
    False on BatchNorm-statistics leaves, which the robust statistics
    exclude. None when nothing is excluded (callers skip the masked
    gather)."""
    desc = json.loads(model_desc)
    if not any(_is_norm_stat(d["path"]) for d in desc):
        return None
    return np.concatenate([
        np.full(int(np.prod(d["shape"])) if d["shape"] else 1, not _is_norm_stat(d["path"]))
        for d in desc
    ])


def flat_delta_norm(delta: np.ndarray, mask: np.ndarray | None) -> float:
    """L2 norm of a flat f32 delta vector over the non-excluded coordinates
    (f32 accumulation, numpy's, as in the JAX package)."""
    v = delta if mask is None else delta[mask]
    return float(np.linalg.norm(v))


def clip_deltas(global_variables: StateDict, stacked: StateDict,
                norm_bound: float) -> StateDict:
    """Norm-difference clipping (robust_aggregation.py:38-49): each client's
    delta scaled so its L2 norm (over the parameters) is at most
    ``norm_bound``."""
    deltas, norms = delta_norms(global_variables, stacked)
    return _apply_scale(global_variables, deltas, clip_scale(norms, norm_bound))


def _apply_scale(global_variables: StateDict, deltas: StateDict,
                 scale: torch.Tensor) -> StateDict:
    return {k: global_variables[k].unsqueeze(0)
            + d * scale.reshape((-1,) + (1,) * (d.dim() - 1))
            for k, d in deltas.items()}


def add_weak_dp_noise(tree: StateDict, stddev: float, rng) -> StateDict:
    """Weak differential privacy (robust_aggregation.py:51-55): gaussian
    noise of ``stddev`` on every floating leaf, leaf k's the k-th draw of
    ``rng`` (a :class:`~fedml_tpu_torch.core.rng.RoundNoise`)."""
    return {k: v + rng.normal(v.shape, v.dtype) * stddev if v.is_floating_point() else v
            for k, v in tree.items()}


def coordinate_median(stacked: StateDict) -> StateDict:
    """Coordinate-wise median over the client axis (robust_aggregation.py:
    57-89): ``jnp.median``'s midpoint, the mean of the two middle values of
    the sorted column when C is even (``torch.median`` would return the
    lower one)."""
    out = {}
    for k, s in stacked.items():
        srt = torch.sort(s, dim=0).values
        c = s.shape[0]
        out[k] = ((srt[(c - 1) // 2] + srt[c // 2]) * 0.5).to(s.dtype)
    return out


def trimmed_ratio_k(c: int, trim_ratio: float) -> int:
    """Per-side trim count ``k = int(trim_ratio * C)``, validated: a config
    where ``C - 2k <= 0`` would trim away every client."""
    k = int(trim_ratio * c)
    if c - 2 * k <= 0:
        raise ValueError(
            f"trimmed_mean: trim_ratio={trim_ratio} with C={c} clients trims "
            f"k={k} per side, leaving C - 2k = {c - 2 * k} <= 0 updates — "
            "nothing to average; lower trim_ratio (or grow the cohort)")
    return k


def trimmed_mean(stacked: StateDict, trim_ratio: float = 0.1) -> StateDict:
    """Coordinate-wise trimmed mean: the k highest and k lowest values of
    each coordinate dropped."""
    c = next(iter(stacked.values())).shape[0]
    k = trimmed_ratio_k(c, trim_ratio)
    return {name: torch.mean(torch.sort(s, dim=0).values[k:c - k], dim=0).to(s.dtype)
            for name, s in stacked.items()}


def krum_scores(stacked: StateDict, num_byzantine: int = 1) -> torch.Tensor:
    """Each client's Krum score: the sum of its squared distances (over the
    parameters) to its ``C - f - 2`` closest other clients."""
    rows = [s.reshape(s.shape[0], -1) for k, s in stacked.items()
            if not treelib.is_model_state(k)]
    mat = torch.cat(rows, dim=1) if len(rows) > 1 else rows[0]
    c = mat.shape[0]
    closest = c - num_byzantine - 2
    if closest < 1:
        raise ValueError(
            f"krum_select: num_byzantine={num_byzantine} with C={c} clients "
            f"leaves C - f - 2 = {closest} < 1 neighbors to score — Krum "
            f"needs num_byzantine <= C - 3 (here <= {c - 3})")
    # one row of distances at a time: [C, D] live instead of [C, C, D]
    d2 = torch.stack([torch.sum((mat - mat[i]) ** 2, dim=1) for i in range(c)])
    self_pairs = torch.eye(c, dtype=torch.bool, device=d2.device)
    d2 = d2.masked_fill(self_pairs, float("inf"))
    return torch.sum(torch.sort(d2, dim=1).values[:, :closest], dim=1)


def krum_select(stacked: StateDict, num_byzantine: int = 1) -> torch.Tensor:
    """Krum: the index (a device tensor) of the client whose summed distance
    to its closest C - f - 2 neighbors is smallest."""
    return torch.argmin(krum_scores(stacked, num_byzantine))


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Defense pipeline flags (FedAvgRobustAggregator defense_type args)."""

    norm_bound: float = 0.0  # >0 enables clipping
    stddev: float = 0.0  # >0 enables weak-DP noise
    rule: str = "mean"  # mean | median | trimmed_mean | krum
    trim_ratio: float = 0.1
    num_byzantine: int = 1

    RULES = ("mean", "median", "trimmed_mean", "krum")

    def __post_init__(self):
        if self.rule not in self.RULES:
            raise ValueError(
                f"unknown robust rule {self.rule!r} (expected one of "
                f"{self.RULES}) — a silent mean fallback would run no "
                "defense at all")

    @property
    def enabled(self) -> bool:
        """True when any defense stage is active (a disabled config is
        exactly plain FedAvg)."""
        return self.norm_bound > 0 or self.stddev > 0 or self.rule != "mean"


def robust_aggregator(config: RobustConfig) -> Aggregator:
    """Clip -> combine (mean/median/trimmed mean/Krum) -> noise, the
    reference pipeline (FedAvgRobustAggregator.py:176-206). The round's
    metrics gain the ``Robust/*`` keys (``obs/metrics.py``): the mean
    pre-clip delta norm, the clipped fraction and the count of updates the
    rule discarded, each over the real (weight > 0) clients."""

    def init_state(global_variables):
        return ()

    def aggregate(global_variables, stacked, weights, state, rng=None, extras=None):
        c = next(iter(stacked.values())).shape[0]
        real = (weights > 0).float()
        n_real = torch.clamp(torch.sum(real), min=1.0)
        deltas, norms = delta_norms(global_variables, stacked)
        if config.rule in ("median", "krum"):
            filtered = n_real - 1.0
        elif config.rule == "trimmed_mean":
            filtered = torch.full((), float(2 * trimmed_ratio_k(c, config.trim_ratio)),
                                  device=weights.device)
        else:
            filtered = torch.zeros((), device=weights.device)
        metrics = {metricslib.ROBUST_UPDATE_NORM: torch.sum(norms * real) / n_real,
                   metricslib.ROBUST_FILTERED: filtered}
        if config.norm_bound > 0:
            scale = clip_scale(norms, config.norm_bound)
            metrics[metricslib.ROBUST_CLIP_FRACTION] = (
                torch.sum((scale < 1.0).float() * real) / n_real)
            stacked = _apply_scale(global_variables, deltas, scale)
        if config.rule == "median":
            out = coordinate_median(stacked)
        elif config.rule == "trimmed_mean":
            out = trimmed_mean(stacked, config.trim_ratio)
        elif config.rule == "krum":
            idx = krum_select(stacked, config.num_byzantine).reshape(1)
            out = {k: s.index_select(0, idx)[0] for k, s in stacked.items()}
        else:
            out = treelib.stacked_weighted_mean(stacked, weights)
        if config.stddev > 0:
            if rng is None:
                raise ValueError("robust_aggregator: DP noise (stddev > 0) needs the round's "
                                 "RoundNoise as rng")
            out = add_weak_dp_noise(out, config.stddev, rng)
        return out, state, metrics

    return Aggregator(init_state, aggregate, name=f"robust-{config.rule}", stacked=True)


def add_cli_flags(parser):
    """Register the canonical robust-defense flags on a repro entry point
    (one help text everywhere). They map onto the SimConfig robust fields
    through :func:`sim_config_fields`."""
    parser.add_argument("--robust_rule", type=str, default="mean",
                        choices=list(RobustConfig.RULES),
                        help="robust combine rule over the cohort stack; 'mean' is plain "
                             "FedAvg")
    parser.add_argument("--norm_bound", type=float, default=0.0,
                        help="clip each client delta's L2 norm to this bound (0 = no "
                             "clipping)")
    parser.add_argument("--dp_stddev", type=float, default=0.0,
                        help="seeded weak-DP gaussian noise stddev on the aggregate "
                             "(0 = no noise)")
    return parser


def sim_config_fields(args) -> dict:
    """The SimConfig kwargs for :func:`add_cli_flags`'s values."""
    return {"robust_rule": args.robust_rule, "norm_bound": args.norm_bound,
            "dp_stddev": args.dp_stddev}
