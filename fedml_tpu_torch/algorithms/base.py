"""Server-side aggregator protocol, the port of ``fedml_tpu/algorithms/base.py``.

An aggregator is a pair of functions over state dicts. The JAX package hands
every rule the stack of client models with a leading client axis; the port
hands a rule the client models as an iterable in cohort order by default (the
scan mode trains each client as the rule draws it, so one client's model
lives at a time), and the stacked ``[C, ...]`` state dict to a rule that asks
for it (``Aggregator.stacked``): the cross-client rules (median, trimmed
mean, Krum, clipping, FedNova's normalised sum) read every client at once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from fedml_tpu_torch.core import tree as treelib


class EmptyRoundError(RuntimeError):
    """A round closed (or staged) with NOTHING to aggregate: the cohort is
    empty, or every member carries zero weight. Raised with the round named
    instead of surfacing as a downstream NaN."""


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """``init_state(global_variables) -> state`` and
    ``aggregate(global, locals, weights, state, rng=None, extras=None) ->
    (new_global, new_state, metrics)``.

    ``locals`` is an iterable of client state dicts in cohort order, consumed
    once, or, when ``stacked`` is True, one state dict whose leaves carry a
    leading ``[C]`` client axis; ``weights`` is a [C] tensor of per-client
    sample counts (the reference's weighting scheme). The engine passes, on
    every path, ``rng``: the round's
    :class:`~fedml_tpu_torch.core.rng.RoundNoise` (its gaussian and uniform
    draws), and ``extras``: ``tau`` [C], each client's true local SGD step count
    (heterogeneous under the straggler protocol, FedNova's), and
    ``max_tau``, the static bound on those counts. Every leaf of ``state``
    is a tensor, so a CUDA graph of the round carries it on the device.
    ``per_client``, ``num_clients`` and ``needs_prev_stack`` are the JAX
    fields of the per-client mode (a model kept per client,
    ``algorithms/decentralized.py``), which the engine honours: with
    ``per_client`` it keeps the ``[N, ...]`` stack of every client's model
    across rounds, trains each client from its own row, and passes the rule
    the previous stack in the place of the global model (the whole stack
    whether or not ``needs_prev_stack`` asks for it: the port does not
    shard the stack); ``num_clients`` must equal the client count."""

    init_state: Callable[[Any], Any]
    aggregate: Callable[..., tuple[Any, Any, dict]]
    name: str = "aggregator"
    per_client: bool = False
    num_clients: int | None = None
    needs_prev_stack: bool = False
    stacked: bool = False


def fedavg_aggregator() -> Aggregator:
    """Sample-count-weighted averaging (FedAVGAggregator.py:59-88)."""

    def init_state(global_variables):
        return ()

    def aggregate(global_variables, local_variables, weights, state, rng=None, extras=None):
        return treelib.weighted_mean(local_variables, weights), state, {}

    return Aggregator(init_state, aggregate, name="fedavg")
