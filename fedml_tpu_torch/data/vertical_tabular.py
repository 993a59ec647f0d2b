"""Vertical-FL tabular datasets, a copy of ``fedml_tpu/data/vertical_tabular.py``
(pure numpy; ``tests/test_torch_split_vertical.py`` holds it bitwise to the
original): feature columns split across parties.

Reference: fedml_api/data_preprocessing/NUS_WIDE/nus_wide_dataset.py (the
guest party holds 634-dim low-level image features + binary labels, the host
holds 1000-dim tag features) and lending_club_loan/{lending_club_dataset.py,
feature_group.py} (loan table whose columns are grouped into per-party
feature blocks). Consumed by ``fedml_tpu_torch/algorithms/vertical.py``'s ``run_vfl``.

Loader contract: ``load_vertical(name, data_dir, n_parties)`` returns
``(train_splits, y_train, test_splits, y_test)`` where ``*_splits`` is a list
of [N, d_p] float arrays, one per party, and the guest (party 0) owns the
labels. Real files when present; synthetic correlated feature blocks
otherwise so VFL runs offline.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

# lending_club feature groups (reference feature_group.py: columns are grouped
# into semantic blocks handed to different parties)
LENDING_GROUPS = ("loan", "borrower", "credit", "history")


def synthetic_vertical(
    n_samples: int = 600,
    dims: tuple[int, ...] = (16, 24),
    seed: int = 0,
    test_frac: float = 0.25,
):
    """Binary task where no single party's block is sufficient: the label
    depends on a cross-party interaction term, the situation VFL exists for."""
    rng = np.random.RandomState(seed)
    splits = [rng.randn(n_samples, d).astype(np.float32) for d in dims]
    ws = [rng.randn(d) / np.sqrt(d) for d in dims]
    score = sum(x @ w for x, w in zip(splits, ws))
    score = score + 0.5 * splits[0][:, 0] * splits[-1][:, 0]  # cross-party term
    y = (score + 0.2 * rng.randn(n_samples) > 0).astype(np.float32)
    n_test = int(n_samples * test_frac)
    train_splits = [s[:-n_test] for s in splits]
    test_splits = [s[-n_test:] for s in splits]
    return train_splits, y[:-n_test], test_splits, y[-n_test:]


def _column_blocks(x: np.ndarray, n_parties: int) -> list[np.ndarray]:
    cols = np.array_split(np.arange(x.shape[1]), n_parties)
    return [np.ascontiguousarray(x[:, c]) for c in cols]


def _load_table(path: Path) -> tuple[np.ndarray, np.ndarray]:
    raw = np.genfromtxt(path, delimiter=",", skip_header=1)
    raw = raw[~np.isnan(raw).any(axis=1)]
    x, y = raw[:, :-1], raw[:, -1]
    mu, sd = x.mean(0, keepdims=True), x.std(0, keepdims=True) + 1e-8
    return ((x - mu) / sd).astype(np.float32), (y > 0.5).astype(np.float32)


def load_vertical(
    name: str,
    data_dir: str | None = None,
    n_parties: int = 2,
    seed: int = 0,
):
    """NUS-WIDE / lending_club loader with synthetic fallback.

    nus_wide: party 0 (guest) = 634-d low-level features, party 1 (host) =
    1000-d tags (reference nus_wide_dataset.py get_two_party_data split).
    lending_club: columns split into ``n_parties`` blocks (feature_group.py).
    """
    name = name.lower()
    if name not in ("nus_wide", "lending_club", "lending_club_loan"):
        raise ValueError(f"unknown vertical dataset {name!r}")
    if data_dir:
        d = Path(data_dir)
        files = sorted(d.glob("*.csv")) if d.is_dir() else []
        if files:
            x, y = _load_table(files[0])
            n_test = max(1, len(x) // 4)
            tr, te = _column_blocks(x[:-n_test], n_parties), _column_blocks(x[-n_test:], n_parties)
            return tr, y[:-n_test], te, y[-n_test:]
    logging.warning("%s: files absent; using synthetic vertical split", name)
    if name == "nus_wide":
        dims = (64, 100) if n_parties == 2 else tuple([32] * n_parties)
    else:
        dims = tuple([16] * n_parties)
    return synthetic_vertical(dims=dims, seed=seed)
