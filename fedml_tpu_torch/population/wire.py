"""Population adapter for the message-passing wire path, a copy of
``fedml_tpu/population/wire.py``.

On the sim backend the population drives cohorts and step budgets inside
the engine; on the wire the physical fleet is the RANK set, so the adapter
maps the same configured distributions onto per-rank upload behaviour and
schedules it through the existing seeded fault machinery
(:mod:`fedml_tpu_torch.comm.faults`):

- per-rank upload delay = ``jitter_draw / min(speed, 1)`` seconds — a slow
  device's upload lands late (the async server's staleness distribution
  and the sync server's SLOW/stale-upload paths are stressed by a
  *population-shaped* arrival process instead of a hand-written spec),
- per-rank upload drop probability = the spec's ``dropout`` — a mid-round
  dropout on the wire IS a lost upload (the elastic-timeout /
  EmptyRoundError / heartbeat-readmission surface).

The adapter also carries per-rank profiles (speed, predicted step
fraction) that fleet-telemetry-armed clients piggyback as
predicted-vs-actual step gauges, so ``tools/fleet_report.py`` renders the
churn (docs/OBSERVABILITY.md "Fleet telemetry").

An identity spec (full speed, no dropout, zero jitter) produces NO active
fault specs — the wrapped transports are never constructed and a
population-armed run is bit-identical to a plain one
(tools/population_smoke.py holds the contract).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fedml_tpu_torch.population import prng
from fedml_tpu_torch.population.model import PopulationSpec, parse_population_spec


@dataclasses.dataclass(frozen=True)
class PopulationWireAdapter:
    """Resolved wire-side population: seeded per-rank fault specs (only
    ranks with an ACTIVE spec appear — wrap_make_comm leaves the rest
    unwrapped) plus per-rank profiles for telemetry."""

    spec: PopulationSpec
    seed: int
    worker_num: int
    fault_specs: dict  # {rank: comm.faults.FaultSpec}, active ranks only
    profiles: dict     # {rank: {"speed", "delay_s", "drop",
                       #         "predicted_frac"}}

    @property
    def active(self) -> bool:
        return bool(self.fault_specs)

    @property
    def max_delay_s(self) -> float:
        return max(
            (s.delay for s in self.fault_specs.values()), default=0.0
        )

    @property
    def drops_uploads(self) -> bool:
        return any(s.drop > 0 for s in self.fault_specs.values())

    def spec_for(self, rank: int):
        """Active fault spec for one rank (None = identity, leave the
        transport unwrapped). Tree mode indexes by GLOBAL leaf number
        (``leaf_base + cell_rank``), so one churn trace spans every cell of
        the hierarchy with the same per-client draws the flat wire path
        would see."""
        return self.fault_specs.get(int(rank))

    def describe(self) -> dict:
        return {
            "kind": "wire",
            "spec": self.spec.to_string(),
            "worker_num": self.worker_num,
            "seed": self.seed,
            "faulted_ranks": sorted(self.fault_specs),
            "max_delay_s": round(self.max_delay_s, 4),
        }


def population_fault_specs(spec: PopulationSpec | str, worker_num: int,
                           seed: int = 0) -> PopulationWireAdapter:
    """Build the wire adapter: per-rank (1..worker_num) profiles drawn from
    the population distributions on the dedicated wire stream, mapped onto
    :class:`fedml_tpu_torch.comm.faults.FaultSpec` upload delays/drops."""
    from fedml_tpu_torch.comm.faults import FaultSpec

    spec = parse_population_spec(spec)
    if worker_num < 1:
        raise ValueError(f"population wire adapter needs worker_num >= 1, "
                         f"got {worker_num}")
    speeds = np.maximum(
        spec.speed.draw(prng.spawn(seed, prng.STREAM_WIRE, 0), worker_num),
        1e-6,
    )
    jitter = np.maximum(
        spec.jitter.draw(prng.spawn(seed, prng.STREAM_WIRE, 1), worker_num),
        0.0,
    )
    fault_specs: dict[int, FaultSpec] = {}
    profiles: dict[int, dict] = {}
    for i in range(worker_num):
        rank = i + 1
        delay = float(jitter[i] / min(float(speeds[i]), 1.0))
        fs = FaultSpec(drop=spec.dropout, delay=delay,
                       delay_prob=1.0 if delay > 0 else 0.0)
        if fs.active:
            fault_specs[rank] = fs
        profiles[rank] = {
            "speed": float(speeds[i]),
            "delay_s": delay,
            "drop": float(spec.dropout),
            "predicted_frac": min(1.0, float(speeds[i])),
        }
    return PopulationWireAdapter(
        spec=spec, seed=int(seed), worker_num=int(worker_num),
        fault_specs=fault_specs, profiles=profiles,
    )
