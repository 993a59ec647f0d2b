"""Co-scheduling N simulation jobs on one card, the port of
``fedml_tpu/tenancy/sim_plane.py`` (the sim-engine half of the multi-tenant
plane; the message-passing half is tenancy/runner.py).

Each job brings its own :class:`~fedml_tpu_torch.sim.engine.FedSim`: its
own model, aggregator and round programs. The co-scheduler interleaves
their rounds on the shared device: round r of job A dispatches, then round
r of job B, and so on, so no job waits for a neighbor's full run. Because
``stage_round`` is pure in (config, round_idx) and ``run_staged_round``
touches only its own job's variables and server state, interleaving cannot
change any job's trajectory: per-round metrics and final variables are
bitwise the job's solo run (``tests/test_torch_tenancy.py`` holds this on
the CPU, ``chip_smoke.py``'s ``[async]`` phase on the card).

Isolation matches the runner's contract: a job whose dispatch raises is
recorded as failed in ITS result and drops out of the rotation; the other
jobs keep advancing.

Each job's dispatches run with the job's thread binding (obs/jobscope.py),
so job-scoped tracers capture the engine spans of their job only. Where
the JAX co-scheduler threads the job's root key into ``stage_round``, the
port's engine seeds each round's draws from its config alone.
"""

from __future__ import annotations

from typing import Callable

from fedml_tpu_torch.obs import jobscope
from fedml_tpu_torch.tenancy.job import JobResult


class _SimJob:
    """One engine's loop state in the rotation."""

    def __init__(self, name: str, engine):
        self.name = name
        self.engine = engine
        self.result = JobResult(name=name)
        self.variables = None
        self.server_state = None
        self.done = False

    def start(self) -> None:
        with jobscope.bound(self.name):
            self.variables = self.engine.init_round_variables()
            self.server_state = self.engine.aggregator.init_state(self.variables)

    def step(self, round_idx: int, callback: Callable[[str, dict], None] | None) -> None:
        cfg = self.engine.config
        if round_idx >= cfg.comm_round:
            self.done = True
            return
        with jobscope.bound(self.name):
            staged = self.engine.stage_round(round_idx)
            self.variables, self.server_state, metrics = self.engine.run_staged_round(
                staged, self.variables, self.server_state)
            rec = {"round": round_idx}
            rec.update({k: float(v) for k, v in metrics.items()})
            freq = max(cfg.frequency_of_the_test, 1)
            if (round_idx + 1) % freq == 0 or round_idx == cfg.comm_round - 1:
                rec.update(self.engine.eval_record(self.variables))
        self.result.rounds.append(rec)
        if callback is not None:
            callback(self.name, rec)
        if round_idx == cfg.comm_round - 1:
            self.done = True


def run_multi_job_sim(
    engines: dict[str, object],
    callback: Callable[[str, dict], None] | None = None,
) -> dict[str, JobResult]:
    """Interleave every engine's rounds on the shared device; returns
    ``{job name: JobResult}`` with ``final`` = the job's final variables and
    ``rounds`` = its per-round metric records (the serial loop's record
    shape without ``round_time``: round index, train metrics, eval block on
    test rounds)."""
    if not engines:
        raise ValueError("run_multi_job_sim needs at least one engine")
    jobs = [_SimJob(name, eng) for name, eng in engines.items()]
    for job in jobs:
        try:
            job.start()
        except BaseException as e:  # noqa: BLE001 — captured per-job
            job.result.error = e
            job.done = True
    round_idx = 0
    while any(not j.done for j in jobs):
        for job in jobs:
            if job.done:
                continue
            try:
                job.step(round_idx, callback)
            except BaseException as e:  # noqa: BLE001 — captured per-job
                job.result.error = e
                job.done = True
        round_idx += 1
    for job in jobs:
        if job.result.error is None:
            job.result.final = job.variables
    return {job.name: job.result for job in jobs}
