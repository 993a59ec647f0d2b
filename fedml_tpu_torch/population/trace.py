"""Population trace save and replay, a copy of
``fedml_tpu/population/trace.py``: the JSONL format is the same in both
packages, so a trace saved by one loads in the other.

A trace is the realized population schedule of a run: per round, the
sampled cohort (with its empty-slot padding), each member's speed
multiplier, the mid-round dropout schedule and the upload jitter, written
as JSONL. Replaying a trace through :class:`TracePopulation` reproduces
cohorts, step budgets and dropouts **bit-exactly**: floats ride JSON's
shortest round-trip repr (exact for float64), ints are ints, and the
loader refuses silently wrong replays (schema, shape and round mismatches
all raise).

    pop = Population("speed=lognormal:0,0.5;avail=0.8;dropout=0.05", N, seed)
    save_trace("run.jsonl", pop, rounds=50, cohort_size=64)
    replay = load_trace("run.jsonl")   # .round_view() == the original's
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from fedml_tpu_torch.population.model import Population, RoundView

TRACE_SCHEMA = 1
# the JAX package's header kind, kept so a trace saved by either package
# loads in the other
_KIND = "fedml_tpu_population_trace"


def _view_record(view: RoundView) -> dict:
    return {
        "round": view.round_idx,
        "cohort": [int(c) for c in view.cohort],
        "speed": [float(s) for s in view.speed],
        "dropped": [int(d) for d in view.dropped],
        "drop_frac": [float(f) for f in view.drop_frac],
        "jitter_s": [float(j) for j in view.jitter_s],
        "eligible_count": view.eligible_count,
    }


def _record_view(rec: dict, cohort_size: int) -> RoundView:
    fields = ("cohort", "speed", "dropped", "drop_frac", "jitter_s")
    for f in fields:
        if f not in rec:
            raise ValueError(
                f"population trace round record missing {f!r} "
                f"(round={rec.get('round')})"
            )
        if len(rec[f]) != cohort_size:
            raise ValueError(
                f"population trace round {rec.get('round')}: {f!r} has "
                f"{len(rec[f])} entries, header says cohort_size="
                f"{cohort_size}"
            )
    return RoundView(
        round_idx=int(rec["round"]),
        cohort=np.asarray(rec["cohort"], np.int32),
        speed=np.asarray(rec["speed"], np.float64),
        dropped=np.asarray(rec["dropped"], bool),
        drop_frac=np.asarray(rec["drop_frac"], np.float64),
        jitter_s=np.asarray(rec["jitter_s"], np.float64),
        eligible_count=int(rec["eligible_count"]),
    )


class TracePopulation:
    """Replay of a saved trace: the same ``round_view`` interface as
    :class:`fedml_tpu_torch.population.model.Population`, serving the recorded
    views verbatim. Requests outside the recorded rounds (or with a
    different cohort size) fail loudly — a trace cannot be extrapolated."""

    def __init__(self, num_clients: int, cohort_size: int,
                 views: dict[int, RoundView], source: str = "<memory>",
                 spec: str | None = None, seed: int | None = None):
        self.num_clients = int(num_clients)
        self.cohort_size = int(cohort_size)
        self._views = dict(views)
        self.source = source
        self.spec_string = spec
        self.seed = seed

    @property
    def rounds(self) -> list[int]:
        return sorted(self._views)

    @property
    def jitter_active(self) -> bool:
        """True when any recorded round carries a nonzero upload jitter —
        the wire-only knob the sim engine rejects on the generative spec
        path, held to the same contract on replay."""
        return any(
            (view.jitter_s > 0.0).any() for view in self._views.values()
        )

    def round_view(self, round_idx: int, cohort_size: int) -> RoundView:
        if int(cohort_size) != self.cohort_size:
            raise ValueError(
                f"population trace {self.source} was captured with "
                f"cohort_size={self.cohort_size}; this run asks for "
                f"{cohort_size} — a trace replays one cohort geometry only"
            )
        view = self._views.get(int(round_idx))
        if view is None:
            raise ValueError(
                f"population trace {self.source} records rounds "
                f"[{self.rounds[0]}..{self.rounds[-1]}] but round "
                f"{round_idx} was requested — a trace cannot be "
                "extrapolated; capture more rounds or use the generative "
                "spec"
            )
        return view

    def describe(self) -> dict:
        return {
            "kind": "trace",
            "source": self.source,
            "num_clients": self.num_clients,
            "cohort_size": self.cohort_size,
            "rounds": len(self._views),
            "spec": self.spec_string,
        }


def capture_trace(population: Population, rounds: int,
                  cohort_size: int) -> TracePopulation:
    """Materialize ``rounds`` round views from a generative population into
    an in-memory replayable trace (what ``save_trace`` writes)."""
    views = {
        r: population.round_view(r, cohort_size) for r in range(int(rounds))
    }
    return TracePopulation(
        population.num_clients, cohort_size, views,
        spec=population.spec.to_string(), seed=population.seed,
    )


def save_trace(path: str | Path, population: Population, rounds: int,
               cohort_size: int) -> Path:
    """Capture and write a JSONL trace: one header line, one line per
    round. Returns the path written."""
    trace = capture_trace(population, rounds, cohort_size)
    path = Path(path)
    header = {
        "kind": _KIND,
        "schema": TRACE_SCHEMA,
        "num_clients": trace.num_clients,
        "cohort_size": trace.cohort_size,
        "rounds": len(trace.rounds),
        "spec": trace.spec_string,
        "seed": trace.seed,
    }
    with open(path, "w") as f:
        f.write(json.dumps(header) + "\n")
        for r in trace.rounds:
            f.write(json.dumps(_view_record(trace.round_view(
                r, trace.cohort_size))) + "\n")
    return path


def load_trace(path: str | Path) -> TracePopulation:
    """Load a JSONL trace written by :func:`save_trace`."""
    path = Path(path)
    lines = [ln for ln in path.read_text().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"population trace {path}: empty file")
    header = json.loads(lines[0])
    if header.get("kind") != _KIND:
        raise ValueError(
            f"population trace {path}: not a population trace (header kind "
            f"{header.get('kind')!r})"
        )
    if header.get("schema") != TRACE_SCHEMA:
        raise ValueError(
            f"population trace {path}: schema {header.get('schema')!r} "
            f"(this build reads schema {TRACE_SCHEMA})"
        )
    cohort_size = int(header["cohort_size"])
    views: dict[int, RoundView] = {}
    for ln in lines[1:]:
        rec = json.loads(ln)
        view = _record_view(rec, cohort_size)
        if view.round_idx in views:
            raise ValueError(
                f"population trace {path}: duplicate round "
                f"{view.round_idx}"
            )
        views[view.round_idx] = view
    if len(views) != int(header.get("rounds", len(views))):
        raise ValueError(
            f"population trace {path}: header promises "
            f"{header.get('rounds')} rounds, file carries {len(views)} "
            "(truncated write?)"
        )
    return TracePopulation(
        int(header["num_clients"]), cohort_size, views, source=str(path),
        spec=header.get("spec"), seed=header.get("seed"),
    )
