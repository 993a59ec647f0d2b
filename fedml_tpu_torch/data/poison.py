"""Backdoor / edge-case poisoning for the robust-FL testbed, a numpy copy of
``fedml_tpu/data/poison.py`` over the port's ``FederatedArrays``.

Reference: fedml_api/data_preprocessing/edge_case_examples/ (713+581 LoC of
poisoned-loader plumbing: southwest-airlines CIFAR backdoor images, howto
edge cases) feeding fedavg_robust's attack/defense pipeline
(main_fedavg_robust.py:75-82, FedAvgRobustAggregator.py:176-206).

Design: poisoning is a pure array transform over FederatedArrays — a
pixel trigger stamped on a fraction of compromised clients' samples with
labels flipped to the attacker's target. Attack success rate (ASR) is
measured on a triggered copy of the test set. Works for any [N, H, W, C]
image dataset; for flat features the trigger is a fixed offset pattern on the
first k dims.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fedml_tpu_torch.sim.cohort import FederatedArrays


@dataclasses.dataclass(frozen=True)
class Trigger:
    """A backdoor trigger: set a patch of pixels/features to ``value``."""

    size: int = 3
    value: float = 1.0
    corner: str = "br"  # tl | tr | bl | br for images

    def apply(self, x: np.ndarray) -> np.ndarray:
        x = x.copy()
        if x.ndim >= 3:  # [N, H, W, (C)]
            s = self.size
            sl = {
                "tl": (slice(0, s), slice(0, s)),
                "tr": (slice(0, s), slice(-s, None)),
                "bl": (slice(-s, None), slice(0, s)),
                "br": (slice(-s, None), slice(-s, None)),
            }[self.corner]
            x[:, sl[0], sl[1]] = self.value
        else:  # flat features
            x[:, : self.size] = self.value
        return x


def poison_clients(
    fed: FederatedArrays,
    compromised_frac: float = 0.2,
    sample_frac: float = 0.5,
    target_label: int = 0,
    trigger: Trigger = Trigger(),
    seed: int = 0,
) -> tuple[FederatedArrays, np.ndarray, dict[int, int]]:
    """Returns (poisoned copy, compromised client ids, per-client poisoned
    sample counts keyed by client id).

    A ``compromised_frac`` of clients stamp the trigger on ``sample_frac`` of
    their samples and flip those labels to ``target_label`` — the reference's
    poisoned-loader behavior as one vectorized transform. The rounded
    per-client draw is clamped to the partition size: tiny client shards
    (``round(sample_frac * n) > n`` near 1.0, or the ``max(1, ...)`` floor on
    an 0-or-1-sample shard) used to crash ``rng.choice(replace=False)``."""
    rng = np.random.RandomState(seed)
    n_clients = fed.num_clients
    n_bad = max(1, int(round(compromised_frac * n_clients)))
    bad = np.sort(rng.choice(n_clients, n_bad, replace=False))

    arrays = {k: v.copy() for k, v in fed.arrays.items()}
    counts: dict[int, int] = {}
    for c in bad:
        idxs = fed.partition[int(c)]
        n_chosen = min(len(idxs), max(1, int(round(sample_frac * len(idxs)))))
        counts[int(c)] = n_chosen
        if n_chosen == 0:  # empty client shard: nothing to poison
            continue
        chosen = rng.choice(idxs, n_chosen, replace=False)
        arrays["x"][chosen] = trigger.apply(arrays["x"][chosen])
        arrays["y"][chosen] = target_label
    return FederatedArrays(arrays, fed.partition), bad, counts


def backdoor_test_arrays(
    test_arrays: dict[str, np.ndarray],
    target_label: int = 0,
    trigger: Trigger = Trigger(),
) -> dict[str, np.ndarray]:
    """Triggered copy of the test set for attack-success-rate eval
    (reference FedAvgRobustTrainer.test(..., poison mode)). Samples already
    bearing the target label are excluded so ASR measures actual flips."""
    keep = np.asarray(test_arrays["y"]) != target_label
    out = {k: v[keep].copy() for k, v in test_arrays.items()}
    out["x"] = trigger.apply(out["x"])
    out["y"] = np.full(len(out["y"]), target_label, dtype=np.asarray(test_arrays["y"]).dtype)
    return out
