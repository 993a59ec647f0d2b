"""Streaming UCI datasets for decentralized online learning, a copy of
``fedml_tpu/data/uci.py`` (bitwise equal streams for the same arguments).

Reference: fedml_api/data_preprocessing/UCI/data_loader_for_susy_and_ro.py —
SUSY (5M-event particle physics, 18 features) and Room Occupancy (time-series
environmental sensors, 5 features), streamed sample-by-sample to
ClientDSGD/ClientPushsum gossip learners (standalone/decentralized, SURVEY
§2.3). Labels are ±1 for the online logistic-regression regret metric.

Loader contract: ``load_streaming(name, data_dir, n_nodes, T)`` returns
``(xs [T, n_nodes, D], ys [T, n_nodes])`` — the round-robin assignment of the
sample stream to nodes that the reference does with per-client iterators.
Real CSV files are used when present; otherwise a synthetic stream with the
same shape/semantics keeps everything runnable offline.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

FEATURE_DIMS = {"susy": 18, "room_occupancy": 5}


def _standardize(x: np.ndarray) -> np.ndarray:
    mu = x.mean(axis=0, keepdims=True)
    sd = x.std(axis=0, keepdims=True) + 1e-8
    return (x - mu) / sd


def _load_csv(path: Path, label_first: bool) -> tuple[np.ndarray, np.ndarray]:
    raw = np.genfromtxt(path, delimiter=",", skip_header=1 if not label_first else 0)
    raw = raw[~np.isnan(raw).any(axis=1)]
    if label_first:  # SUSY: label, 18 features
        y, x = raw[:, 0], raw[:, 1:]
    else:  # room occupancy: features..., label last
        x, y = raw[:, :-1], raw[:, -1]
    y = np.where(y > 0.5, 1.0, -1.0).astype(np.float32)
    return _standardize(x).astype(np.float32), y


def synthetic_stream(
    n_samples: int, dim: int, seed: int = 0, drift: float = 0.0
) -> tuple[np.ndarray, np.ndarray]:
    """Linearly-separable-ish stream; ``drift`` rotates the true hyperplane
    over time (the reason regret, not accuracy, is the metric)."""
    rng = np.random.RandomState(seed)
    w = rng.randn(dim)
    xs = rng.randn(n_samples, dim).astype(np.float32)
    ys = np.empty(n_samples, np.float32)
    for t in range(n_samples):
        if drift:
            angle = drift * t
            w = w + angle * rng.randn(dim) * 1e-3
        margin = xs[t] @ w + 0.3 * rng.randn()
        ys[t] = 1.0 if margin > 0 else -1.0
    return xs, ys


def load_streaming(
    name: str,
    data_dir: str | None = None,
    n_nodes: int = 8,
    T: int = 200,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (xs [T, n_nodes, D], ys [T, n_nodes]) for run_online_gossip."""
    name = name.lower()
    if name not in FEATURE_DIMS:
        raise ValueError(f"unknown streaming dataset {name!r} (susy|room_occupancy)")
    dim = FEATURE_DIMS[name]
    x = y = None
    if data_dir:
        d = Path(data_dir)
        candidates = list(d.glob("*.csv")) + list(d.glob("*.csv.gz")) if d.is_dir() else []
        if candidates:
            x, y = _load_csv(candidates[0], label_first=(name == "susy"))
            dim = x.shape[1]
    if x is None:
        logging.warning("%s: CSV absent; using synthetic stream", name)
        x, y = synthetic_stream(n_nodes * T, dim, seed=seed,
                                drift=0.01 if name == "room_occupancy" else 0.0)
    need = n_nodes * T
    if len(x) < need:
        reps = -(-need // len(x))
        x, y = np.tile(x, (reps, 1))[:need], np.tile(y, reps)[:need]
    xs = x[:need].reshape(T, n_nodes, -1)
    ys = y[:need].reshape(T, n_nodes)
    return xs, ys
