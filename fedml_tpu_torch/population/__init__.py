"""The heterogeneous population simulator, the port of
``fedml_tpu/population/`` (pure numpy copies, bitwise the reference's):

- :mod:`fedml_tpu_torch.population.model`: the seeded generative model
  (speed, availability, dropout and jitter distributions, round views, the
  step-budget mapping);
- :mod:`fedml_tpu_torch.population.trace`: bit-exact JSONL trace save and
  replay, in the JAX package's format;
- :mod:`fedml_tpu_torch.population.wire`: the message-passing adapter
  mapping the population onto per-rank upload delays and drops through
  ``comm/faults.py``;
- :mod:`fedml_tpu_torch.population.prng`: the subsystem's single seeded-rng
  funnel.

CLI surface (:func:`add_cli_flags` / :func:`sim_config_fields`): one flag
set shared by the entry points.
"""

from __future__ import annotations

from fedml_tpu_torch.population.model import (
    Dist,
    Population,
    PopulationSpec,
    RoundView,
    parse_dist,
    parse_population_spec,
    step_budgets,
)
from fedml_tpu_torch.population.trace import (
    TracePopulation,
    capture_trace,
    load_trace,
    save_trace,
)
from fedml_tpu_torch.population.wire import (
    PopulationWireAdapter,
    population_fault_specs,
)

__all__ = [
    "Dist", "Population", "PopulationSpec", "RoundView",
    "parse_dist", "parse_population_spec", "step_budgets",
    "TracePopulation", "capture_trace", "load_trace", "save_trace",
    "PopulationWireAdapter", "population_fault_specs",
    "add_cli_flags", "sim_config_fields",
]


def add_cli_flags(parser):
    """Register the population flags on an entry point (the JAX package's
    names, dests and defaults). They map one for one onto the
    ``SimConfig`` population fields through :func:`sim_config_fields`."""
    parser.add_argument(
        "--population", type=str, default=None,
        help="heterogeneous population spec: ';'-separated key=value with "
             "keys speed=<dist> | avail=<p> | avail_block=<rounds> | "
             "dropout=<p> | drop_frac=<dist> | jitter=<dist>, dist grammar "
             "const:v | uniform:lo,hi | lognormal:mu,sigma | zipf:a, e.g. "
             "'speed=lognormal:0,0.5;avail=0.8;dropout=0.05'. Drives cohort "
             "eligibility, per-client step budgets and mid-round dropout on "
             "the sim backend, per-rank upload delays/drops on the "
             "message-passing backends (jitter is wire-only). Default "
             "off; results with the flag unset are unchanged",
    )
    parser.add_argument(
        "--population_trace", type=str, default=None,
        help="replay a saved population trace (JSONL from "
             "population.save_trace, of either package) instead of drawing "
             "from --population: cohorts, step budgets and dropouts "
             "reproduce bit-exactly; sim backend only",
    )
    parser.add_argument(
        "--population_seed", type=int, default=None,
        help="seed for the population's draws (default: the run seed); "
             "separate so the same federated run can be replayed under a "
             "different population realization",
    )
    return parser


def sim_config_fields(args) -> dict:
    """The ``SimConfig`` kwargs for :func:`add_cli_flags`'s values."""
    return {
        "population": getattr(args, "population", None),
        "population_trace": getattr(args, "population_trace", None),
        "population_seed": getattr(args, "population_seed", None),
    }
