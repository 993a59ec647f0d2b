"""Server-side aggregator protocol, the port of ``fedml_tpu/algorithms/base.py``.

An aggregator is a pair of functions over state dicts. Where the JAX package
hands the rule a stack of client models with a leading client axis, the port
hands it the client models as an iterable in cohort order: the engine trains
each client as the rule draws it, so one client's model lives at a time.
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
    ``aggregate(global, locals, weights, state) -> (new_global, new_state,
    metrics)``.

    ``locals`` is an iterable of client state dicts in cohort order, consumed
    once; ``weights`` is a [C] tensor of per-client sample counts (the
    reference's weighting scheme)."""

    init_state: Callable[[Any], Any]
    aggregate: Callable[..., tuple[Any, Any, dict]]
    name: str = "aggregator"


def fedavg_aggregator() -> Aggregator:
    """Sample-count-weighted averaging (FedAVGAggregator.py:59-88)."""

    def init_state(global_variables):
        return ()

    def aggregate(global_variables, local_variables, weights, state):
        return treelib.weighted_mean(local_variables, weights), state, {}

    return Aggregator(init_state, aggregate, name="fedavg")
