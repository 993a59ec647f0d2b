"""RNG discipline, the port of ``fedml_tpu/core/rng.py``.

Client sampling is the reference's seeded numpy draw, copied verbatim so the
port samples bitwise the same cohorts. JAX's threaded keys become explicit
seeded ``torch.Generator``s; the two never give the same numbers, so parity
tests feed both packages the same numpy-made inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, device: str | torch.device = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (the port's
    ``root_key``)."""
    return torch.Generator(device=device).manual_seed(int(seed))


def sample_clients(round_idx: int, client_num_in_total: int,
                   client_num_per_round: int,
                   eligible: np.ndarray | None = None) -> np.ndarray:
    """Reproduce the reference's client-sampling sequence exactly.

    Reference (FedAVGAggregator.client_sampling, FedAVGAggregator.py:90-98):
    ``np.random.seed(round_idx); np.random.choice(range(N), k, replace=False)``.
    Kept host-side numpy on purpose so runs can be compared 1:1 against the
    reference's sampled cohorts.

    ``eligible`` restricts the draw to an availability-filtered client-id
    subset (the population model's cohort seam,
    fedml_tpu.population.model.Population.round_view). ``eligible=None``
    is bit-identical to the original full-population draw — and so is
    ``eligible=arange(N)``: numpy's ``choice(a, k, replace=False)`` indexes
    ``a`` through the same seeded permutation it returns for the int form,
    so a fully-available population reproduces the reference cohorts
    exactly (tools/population_smoke.py pins this).
    """
    if eligible is not None:
        eligible = np.asarray(eligible)
        if client_num_per_round >= len(eligible):
            # everyone available participates — the full-participation
            # shortcut, applied to the eligible subset
            return eligible.copy()
        rng = np.random.RandomState(round_idx)
        return rng.choice(eligible, client_num_per_round, replace=False)
    if client_num_in_total == client_num_per_round:
        return np.arange(client_num_in_total)
    rng = np.random.RandomState(round_idx)
    return rng.choice(client_num_in_total, client_num_per_round, replace=False)


class RoundNoise:
    """The server side's random draws for one round: gaussians (weak-DP
    noise, ``algorithms/robust.py``) and uniforms (the stochastic rounding of
    the quantizing codecs, ``compress/codec.py``). The k-th call of
    :meth:`normal` or :meth:`uniform` (one counter for both) draws on
    ``device`` from a generator seeded from ``(seed, round_idx, k, tag)`` by
    numpy's SeedSequence, the tag the kind's own, so a round's draws are a
    pure function of the run's seed and the round, whatever ran before it.
    JAX's threaded keys (``fold_in(key(seed), round)``) give other numbers.
    A draw reseeds the generator, which a CUDA graph cannot capture: a round
    replayed from a graph reads the same draws from buffers filled before
    the replay (``sim/graphs.py`` :class:`StaticNoise`)."""

    TAG = 0xD9
    UNIFORM_TAG = 0x75

    def __init__(self, seed: int, round_idx: int, device: str | torch.device = "cpu"):
        self.seed, self.round_idx = int(seed), int(round_idx)
        self.device = torch.device(device)
        self._generator: torch.Generator | None = None  # made at the first draw
        self._k = 0

    def _reseed(self, tag: int) -> torch.Generator:
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
        mixed = np.random.SeedSequence(
            [self.seed, self.round_idx, self._k, tag]).generate_state(1, np.uint64)[0]
        self._k += 1
        return self._generator.manual_seed(int(mixed))

    def normal(self, shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The next draw: standard normals of ``shape`` and ``dtype``."""
        return torch.randn(tuple(shape), generator=self._reseed(self.TAG), device=self.device,
                           dtype=dtype)

    def uniform(self, shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The next draw: uniforms on [0, 1) of ``shape`` and ``dtype``."""
        return torch.rand(tuple(shape), generator=self._reseed(self.UNIFORM_TAG),
                          device=self.device, dtype=dtype)
