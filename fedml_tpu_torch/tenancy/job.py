"""The port of ``fedml_tpu/tenancy/job.py``.

Job specs and results for the multi-tenant runner.

A :class:`JobSpec` is everything one federation needs to run through
``run_distributed_fedavg`` — its trainer, data, shape, and any harness
knobs — plus its identity on the shared wire (``job_id``). The runner
(tenancy/runner.py) turns each spec into one server + W client facades over
the shared plane and hands back a :class:`JobResult` per job: final
variables on success, the captured exception on failure (one job's crash is
a RESULT, never a neighbor's problem), and the job's totals under the
canonical ``Job/*`` keys.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from fedml_tpu_torch.tenancy.comm import job_key

# harness seams the runner composes itself; a spec smuggling one of these
# through run_kwargs would silently fight the runner's own wiring
_RESERVED_RUN_KWARGS = frozenset(
    {"make_comm", "on_round_done", "fleet_stats", "trainer", "train_data",
     "worker_num", "round_num", "batch_size", "seed"}
)


@dataclass
class JobSpec:
    """One federation in a multi-job run.

    ``job_id=None`` is the implicit default job: its messages carry NO job
    header and its wire behavior is byte-identical to a single-job run
    (the compatibility contract). Named jobs stamp
    ``job_id`` on every message. ``run_kwargs`` passes straight through to
    ``run_distributed_fedavg`` (codec, robust_config, server_mode, ...);
    ``fleet=True`` arms the fleet telemetry plane with a job-scoped metric
    registry so this job's counters never mix into a neighbor's.
    ``on_round(round_idx, unpacked_vars)`` runs on the job's server thread
    after each round closes — raising from it fails THIS job only."""

    trainer: Any
    train_data: Any
    worker_num: int
    round_num: int
    batch_size: int
    job_id: str | None = None
    seed: int = 0
    on_round: Callable[[int, Any], None] | None = None
    fleet: bool = False
    run_kwargs: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.worker_num < 1:
            raise ValueError(
                f"job {self.name!r}: worker_num must be >= 1, "
                f"got {self.worker_num}")
        bad = _RESERVED_RUN_KWARGS & set(self.run_kwargs)
        if bad:
            raise ValueError(
                f"job {self.name!r}: run_kwargs {sorted(bad)} collide with "
                "seams the multi-job runner wires itself — set them as "
                "JobSpec fields (or not at all)")

    @property
    def name(self) -> str:
        """Routing/observability key: the job id, or the default job's."""
        return job_key(self.job_id)


@dataclass
class JobResult:
    """One job's outcome. Exactly one of ``final`` / ``error`` is set (a
    job that crashed before its first round close has ``final=None`` and
    ``rounds=[]``). ``totals`` carries the canonical ``Job/*`` keys:
    rounds closed, error count, and the fair scheduler's per-job send
    accounting. ``fleet_stats`` is the job's telemetry dict (rounds /
    totals / registry snapshot) when the spec armed ``fleet=True``."""

    name: str
    final: Any = None
    error: BaseException | None = None
    rounds: list = field(default_factory=list)
    totals: dict[str, int] = field(default_factory=dict)
    fleet_stats: dict | None = None

    @property
    def ok(self) -> bool:
        return self.error is None
