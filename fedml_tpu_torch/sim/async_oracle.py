"""A copy of ``fedml_tpu/sim/async_oracle.py``.

Exactness arm for the barrier-free server: a pure-numpy replay of the
async fold/emit schedule.

The wire-path async tally (async_agg.AsyncFedAggregator) folds uploads the
moment they arrive; its arithmetic is three lines of numpy, so the oracle
just replays a recorded arrival schedule through the SAME three lines —
hand-checkable staleness weighting, same f64 multiply-add, same
divide-at-emit, same f32 cast. Tests feed both the real aggregator and
this replay the same schedule and assert bitwise equality; the 10^4-client
soak uses it to pin the O(model)-memory window result at scale.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from fedml_tpu_torch.async_agg.staleness import StalenessFn, make_staleness_fn


@dataclasses.dataclass(frozen=True)
class AsyncUpload:
    """One arrival: the flat f32 model vector, the client's sample count,
    and the global-model version the client trained from."""

    x: np.ndarray
    n: float
    version: int


def replay_async_schedule(
    uploads: Sequence[AsyncUpload],
    buffer_goal: int,
    staleness: str | StalenessFn = "const",
    start_version: int = 0,
) -> tuple[list[np.ndarray], list[dict]]:
    """Replay an arrival schedule through the async fold arithmetic.

    Returns (emitted models as f32 vectors, per-emission records with
    ``version`` / ``arrivals`` / ``stale_folds`` / ``fold_weights``). The
    server's emitted model ``k`` must equal ``models[k]`` bit-for-bit when
    the wire run saw the same arrival order — the contract
    tests/test_torch_async_agg.py holds against
    `fedml_tpu_torch.async_agg` and chip_smoke.py's ``[async]`` phase holds
    end-to-end on the card."""
    s = staleness if callable(staleness) else make_staleness_fn(staleness)
    if buffer_goal < 1:
        raise ValueError(f"buffer_goal must be >= 1, got {buffer_goal}")
    version = int(start_version)
    acc: np.ndarray | None = None
    wsum = 0.0
    arrivals = 0
    window: dict = {"stale_folds": 0, "fold_weights": []}
    models: list[np.ndarray] = []
    records: list[dict] = []
    for up in uploads:
        x = np.asarray(up.x, np.float32)
        d = version - int(up.version)
        if d < 0:
            raise ValueError(
                f"upload version {up.version} is ahead of the model "
                f"version {version}"
            )
        w = float(s(d)) * float(up.n)
        if acc is None:
            acc = np.zeros(x.size, np.float64)
        # the EXACT fold arithmetic of FedAvgDistAggregator._fold
        acc += np.multiply(x.reshape(-1), w, dtype=np.float64)
        wsum += w
        arrivals += 1
        window["fold_weights"].append(w)
        if d > 0:
            window["stale_folds"] += 1
        if arrivals >= buffer_goal:
            models.append((acc / wsum).astype(np.float32))
            records.append({"version": version, "arrivals": arrivals,
                            **window})
            acc, wsum, arrivals = None, 0.0, 0
            window = {"stale_folds": 0, "fold_weights": []}
            version += 1
    return models, records
