"""The multi-tenant job plane, the port of ``fedml_tpu/tenancy/``.

Multi-tenant job plane: N concurrent federations sharing one wire, one
send pool, one card (docs/MULTITENANCY.md).

The single-job harness (``run_distributed_fedavg``) stays the unit of
composition: each job runs it UNCHANGED over job-scoped comm facades, while
this package owns everything shared —

- tenancy/comm.py: the ``job_id`` wire header, the :class:`JobRouter` demux
  on the shared rank-0 endpoint, the server/client facades, and the
  per-job ordered-uplink fabric for bit-identity tests;
- tenancy/scheduler.py: the deficit-round-robin
  :class:`FairFanoutScheduler` multiplexing every job's send legs onto one
  :class:`~fedml_tpu_torch.comm.send_pool.SendWorkerPool`;
- tenancy/job.py: :class:`JobSpec` / :class:`JobResult`;
- tenancy/runner.py: :func:`run_multi_job`, the message-passing
  co-scheduler;
- tenancy/sim_plane.py: :func:`run_multi_job_sim`, interleaved sim-engine
  rounds on one card.
"""

from fedml_tpu_torch.tenancy.comm import (
    DEFAULT_JOB,
    JobClientComm,
    JobRouter,
    JobServerComm,
    MultiJobOrderedUplinkFabric,
    job_key,
)
from fedml_tpu_torch.tenancy.job import JobResult, JobSpec
from fedml_tpu_torch.tenancy.runner import plan_rank_bases, run_multi_job
from fedml_tpu_torch.tenancy.scheduler import FairFanoutScheduler
from fedml_tpu_torch.tenancy.sim_plane import run_multi_job_sim

__all__ = [
    "DEFAULT_JOB",
    "FairFanoutScheduler",
    "JobClientComm",
    "JobResult",
    "JobRouter",
    "JobServerComm",
    "JobSpec",
    "MultiJobOrderedUplinkFabric",
    "job_key",
    "plan_rank_bases",
    "run_multi_job",
    "run_multi_job_sim",
]
