"""FedProx, the port of ``fedml_tpu/algorithms/fedprox.py``: the proximal
local objective (the client loss gains ``mu / 2 * ||w - w_global||^2``,
:attr:`ClientTrainer.prox_mu <fedml_tpu_torch.core.trainer.ClientTrainer>`),
the named algorithm wrapper, and the straggler protocol's per-client epoch
counts, copied from the reference so the same seed draws the same
stragglers."""

from __future__ import annotations

import dataclasses

import numpy as np

from fedml_tpu_torch.algorithms.base import Aggregator, fedavg_aggregator
from fedml_tpu_torch.core.trainer import ClientTrainer


def fedprox_trainer(trainer: ClientTrainer, mu: float) -> ClientTrainer:
    """Attach the proximal term to any ClientTrainer."""
    return dataclasses.replace(trainer, prox_mu=mu)


def fedprox_aggregator() -> Aggregator:
    """Server side is plain weighted averaging (FedProx paper)."""
    inner = fedavg_aggregator()
    return Aggregator(inner.init_state, inner.aggregate, name="fedprox")


def straggler_epochs(
    round_idx: int, cohort_size: int, epochs: int, straggler_frac: float, seed: int = 0
) -> np.ndarray:
    """Per-client local-epoch counts with a straggler fraction doing strictly
    fewer epochs (uniform 1..E-1), the FedProx heterogeneity protocol."""
    rng = np.random.RandomState(seed * 77_003 + round_idx)
    out = np.full(cohort_size, epochs, dtype=np.int32)
    stragglers = rng.rand(cohort_size) < straggler_frac
    out[stragglers] = rng.randint(1, max(epochs, 2), size=int(stragglers.sum()))
    return out
