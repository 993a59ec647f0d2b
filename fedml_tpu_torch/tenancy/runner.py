"""The port of ``fedml_tpu/tenancy/runner.py``.

Multi-tenant job runner: N federations over one wire, pool, and process.

``run_multi_job`` is the message-passing co-scheduler (the sim-engine
counterpart lives in tenancy/sim_plane.py): it builds ONE shared loopback
fabric sized for every job's workers, ONE shared rank-0 endpoint pumped by a
:class:`~fedml_tpu_torch.tenancy.comm.JobRouter`, ONE
:class:`~fedml_tpu_torch.comm.send_pool.SendWorkerPool` fed through the fair
:class:`~fedml_tpu_torch.tenancy.scheduler.FairFanoutScheduler` — then runs each
job's UNCHANGED ``run_distributed_fedavg`` composition on its own thread
with job-scoped comm facades. Every protocol feature (codecs, defenses,
async server, checkpointing, heartbeats) rides along for free, and each
job's per-round trajectory is the same computation its solo run performs.

Isolation contract (tests/test_torch_tenancy.py): a job that raises — a crashed
server loop, an ``EmptyRoundError`` mid-run, a poisoned round hook — has
its exception captured into ITS :class:`JobResult` while the neighbors keep
advancing; the shared plane is torn down only after every job finished.

Per-job observability: each job's threads run bound to the job
(obs/jobscope.py), so a ``fleet=True`` spec gets a job-scoped metric
registry and its telemetry dict references only its own counters. With
``out_dir=`` the runner writes ``<out_dir>/<job>/fleet.jsonl`` + ``fleet.json``
(the exact single-job layout main_fedavg writes, so tools/fleet_report.py
renders any job unchanged) and a top-level ``jobs.json`` with every job's
``Job/*`` totals.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Iterable

from fedml_tpu_torch.algorithms.fedavg_distributed import run_distributed_fedavg
from fedml_tpu_torch.comm.loopback import LoopbackCommManager, LoopbackFabric
from fedml_tpu_torch.comm.send_pool import SendWorkerPool
from fedml_tpu_torch.obs import jobscope
from fedml_tpu_torch.obs import metrics as metricslib
from fedml_tpu_torch.obs import registry
from fedml_tpu_torch.tenancy.comm import JobClientComm, JobRouter, JobServerComm
from fedml_tpu_torch.tenancy.job import JobResult, JobSpec
from fedml_tpu_torch.tenancy.scheduler import FairFanoutScheduler


def plan_rank_bases(jobs: list[JobSpec]) -> dict[str, int]:
    """Global rank layout on the shared fabric: rank 0 is the shared server
    endpoint; job i's workers occupy ``base+1 .. base+worker_num`` where
    ``base`` is the cumulative worker count of the jobs before it."""
    bases: dict[str, int] = {}
    base = 0
    for job in jobs:
        bases[job.name] = base
        base += job.worker_num
    return bases


def _validate(jobs: list[JobSpec]) -> None:
    if not jobs:
        raise ValueError("run_multi_job needs at least one JobSpec")
    seen: set[str] = set()
    for job in jobs:
        if job.name in seen:
            raise ValueError(
                f"duplicate job name {job.name!r}: every job needs a unique "
                "id on the shared wire (note job_id=None claims the "
                "implicit 'default' name)")
        seen.add(job.name)


def run_multi_job(
    jobs: Iterable[JobSpec],
    send_workers: int = 4,
    quantum_bytes: int = 256 * 1024,
    fabric: LoopbackFabric | None = None,
    out_dir: str | None = None,
    join_timeout: float | None = None,
    trace_dir: str | None = None,
) -> dict[str, JobResult]:
    """Run every job concurrently over one shared wire; returns
    ``{job name: JobResult}``. ``fabric`` defaults to a fresh
    ``LoopbackFabric`` sized ``1 + sum(worker_num)``; pass an ordered
    variant (tenancy/comm.py ``MultiJobOrderedUplinkFabric``) to pin each
    job's fold order for bit-identity assertions. ``join_timeout`` bounds
    the wait on each job thread — a job still running after it gets a
    ``TimeoutError`` result instead of wedging the caller. ``trace_dir``
    (one causal-trace lane per job) raises, naming ROADMAP §A11.5."""
    if trace_dir is not None:
        from fedml_tpu_torch.algorithms.fedavg_distributed import _unported

        raise _unported("trace_dir= (one causal-trace lane per job)", "§A11.5")
    jobs = list(jobs)
    _validate(jobs)
    world = 1 + sum(j.worker_num for j in jobs)
    if fabric is None:
        fabric = LoopbackFabric(world)
    elif fabric.world_size < world:
        raise ValueError(
            f"shared fabric has world_size={fabric.world_size} but these "
            f"{len(jobs)} jobs need {world} ranks (1 server + "
            f"{world - 1} workers)")
    bases = plan_rank_bases(jobs)
    endpoint = LoopbackCommManager(fabric, 0)
    pool = SendWorkerPool(send_workers, name="tenancy-send")
    scheduler = FairFanoutScheduler(pool, quantum_bytes=quantum_bytes)
    router = JobRouter(endpoint).start()
    results = {job.name: JobResult(name=job.name) for job in jobs}

    def make_comm_for(job: JobSpec, inbox):
        base = bases[job.name]

        def make_comm(rank: int):
            if rank == 0:
                return JobServerComm(endpoint, scheduler, inbox,
                                     job_id=job.job_id, rank_base=base)
            return JobClientComm(
                LoopbackCommManager(fabric, base + rank), job_id=job.job_id)

        return make_comm

    def run_job(job: JobSpec) -> None:
        result = results[job.name]
        fleet_stats: dict | None = {} if job.fleet else None
        if job.fleet:
            # job-scoped registry: this job's counters (and its clients'
            # piggybacked telemetry) land in ITS snapshot, not a neighbor's;
            # the process merge view stays available via merged_snapshot()
            registry.install_job(job.name)
        make_comm = make_comm_for(job, router.register(job.job_id))

        def on_round(r, unpacked):
            result.rounds.append(r)
            if job.on_round is not None:
                job.on_round(r, unpacked)

        run_kwargs = dict(job.run_kwargs)
        try:
            with jobscope.bound(job.name):
                result.final = run_distributed_fedavg(
                    job.trainer, job.train_data, job.worker_num,
                    job.round_num, job.batch_size, make_comm,
                    seed=job.seed, on_round_done=on_round,
                    fleet_stats=fleet_stats, **run_kwargs,
                )
        except BaseException as e:  # noqa: BLE001 — captured per-job by contract
            result.error = e
        finally:
            if job.fleet:
                registry.uninstall_job(job.name)
        result.fleet_stats = fleet_stats

    try:
        threads = [
            threading.Thread(target=run_job, args=(job,),
                             name=f"tenancy-job-{job.name}", daemon=True)
            for job in jobs
        ]
        for t in threads:
            t.start()
        for job, t in zip(jobs, threads):
            t.join(join_timeout)
            if t.is_alive():
                results[job.name].error = TimeoutError(
                    f"job {job.name!r} still running after {join_timeout}s")
    finally:
        sched_stats = scheduler.stats()
        for job in jobs:
            res = results[job.name]
            res.totals = {
                metricslib.JOB_ROUNDS: len(res.rounds),
                metricslib.JOB_ERRORS: 0 if res.error is None else 1,
                **sched_stats.get(job.name, {}),
            }
            router.unregister(job.job_id)
        router.close()
        scheduler.close()
        pool.close()
    if out_dir is not None:
        _write_outputs(out_dir, jobs, results)
    return results


def _write_outputs(out_dir: str, jobs: list[JobSpec],
                   results: dict[str, JobResult]) -> None:
    """Per-job fleet telemetry in the single-job layout (fleet.jsonl of
    per-round snapshots + fleet.json of totals — what main_fedavg's
    --fleet_stats writes, so tools/fleet_report.py renders any job's dir
    unchanged), plus a top-level jobs.json of every job's Job/* totals."""
    from fedml_tpu_torch.obs.registry import FLEET_JSONL_NAME

    os.makedirs(out_dir, exist_ok=True)
    for job in jobs:
        res = results[job.name]
        if res.fleet_stats is None:
            continue
        job_dir = os.path.join(out_dir, job.name)
        os.makedirs(job_dir, exist_ok=True)
        with open(os.path.join(job_dir, FLEET_JSONL_NAME), "w") as f:
            for rec in res.fleet_stats.get("rounds", []):
                f.write(json.dumps(rec) + "\n")
        with open(os.path.join(job_dir, "fleet.json"), "w") as f:
            json.dump({"totals": res.fleet_stats.get("totals"),
                       "registry": res.fleet_stats.get("registry"),
                       "rounds_recorded":
                           len(res.fleet_stats.get("rounds", []))}, f)
    with open(os.path.join(out_dir, "jobs.json"), "w") as f:
        json.dump({
            name: {"totals": res.totals,
                   "error": repr(res.error) if res.error else None}
            for name, res in sorted(results.items())
        }, f, indent=2)
