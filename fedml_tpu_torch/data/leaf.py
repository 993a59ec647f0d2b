"""LEAF-format dataset readers, a copy of ``fedml_tpu/data/leaf.py``
(bitwise-equal arrays for the same files and arguments).

Reference: fedml_api/data_preprocessing/MNIST/data_loader.py:9-49 reads LEAF
JSON files ``{"users": [...], "user_data": {uid: {"x": [...], "y": [...]}},
"num_samples": [...]}`` from train/test directories; shakespeare uses the same
envelope with raw text lines encoded by language_utils. Here the readers
produce :class:`FederatedArrays` (stacked arrays + client index partition) —
the device-side representation — plus the pooled test arrays.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from fedml_tpu_torch.sim.cohort import FederatedArrays

# --- shakespeare char table (reference: shakespeare/language_utils.py
# ALL_LETTERS, 80 printable chars; the model vocab is 90 = 80 + specials) ---
ALL_LETTERS = "\n !\"&'(),-.0123456789:;>?ABCDEFGHIJKLMNOPQRSTUVWXYZ[]abcdefghijklmnopqrstuvwxyz}"
CHAR_VOCAB = len(ALL_LETTERS) + 10  # pad to the reference's 90-vocab model


def word_to_indices(word: str) -> list[int]:
    """Char -> index (reference language_utils.word_to_indices)."""
    return [ALL_LETTERS.find(c) % len(ALL_LETTERS) for c in word]


def _read_leaf_dir(d: str | Path) -> dict:
    """Merge all .json files in a LEAF split directory."""
    users, user_data = [], {}
    for f in sorted(Path(d).glob("*.json")):
        with open(f) as fh:
            blob = json.load(fh)
        users.extend(blob["users"])
        user_data.update(blob["user_data"])
    return {"users": users, "user_data": user_data}


def load_leaf_classification(
    train_dir: str | Path, test_dir: str | Path, x_shape: tuple[int, ...] = (28, 28)
) -> tuple[FederatedArrays, dict[str, np.ndarray], FederatedArrays]:
    """LEAF MNIST/FEMNIST-style: per-user flat feature vectors + int labels.

    Returns (train FederatedArrays, pooled test arrays, per-client test
    FederatedArrays) — the ingredients of the reference 8-tuple
    (MNIST/data_loader.py:87 ``load_partition_data_mnist``).
    """
    tr = _read_leaf_dir(train_dir)
    te = _read_leaf_dir(test_dir)

    def _gather(blob):
        xs, ys, part, cursor = [], [], {}, 0
        for ci, uid in enumerate(blob["users"]):
            ux = np.asarray(blob["user_data"][uid]["x"], dtype=np.float32)
            uy = np.asarray(blob["user_data"][uid]["y"], dtype=np.int32)
            ux = ux.reshape((len(uy),) + x_shape)
            xs.append(ux)
            ys.append(uy)
            part[ci] = np.arange(cursor, cursor + len(uy))
            cursor += len(uy)
        return FederatedArrays({"x": np.concatenate(xs), "y": np.concatenate(ys)}, part)

    train = _gather(tr)
    test_fed = _gather(te)
    test_pooled = {"x": test_fed.arrays["x"], "y": test_fed.arrays["y"]}
    return train, test_pooled, test_fed


def load_leaf_shakespeare(
    train_dir: str | Path, test_dir: str | Path, seq_len: int = 80
) -> tuple[FederatedArrays, dict[str, np.ndarray], FederatedArrays]:
    """Shakespeare next-char: each sample is (input chars [T], target chars [T]).

    The reference encodes (x=80-char window, y=next char) pairs
    (shakespeare/data_loader.py); we use the same windows with shifted targets
    so the LM loss trains on every position.
    """
    tr = _read_leaf_dir(train_dir)
    te = _read_leaf_dir(test_dir)

    def _gather(blob):
        xs, ys, part, cursor = [], [], {}, 0
        for ci, uid in enumerate(blob["users"]):
            raw_x = blob["user_data"][uid]["x"]
            raw_y = blob["user_data"][uid]["y"]
            seqs, tgts = [], []
            for window, nxt in zip(raw_x, raw_y):
                idx = word_to_indices(window)[:seq_len]
                nxt_idx = word_to_indices(nxt)[0] if nxt else 0
                tgt = idx[1:] + [nxt_idx]
                if len(idx) < seq_len:
                    pad = seq_len - len(idx)
                    idx = idx + [0] * pad
                    tgt = tgt + [0] * pad
                seqs.append(idx)
                tgts.append(tgt)
            if not seqs:
                continue
            xs.append(np.asarray(seqs, dtype=np.int32))
            ys.append(np.asarray(tgts, dtype=np.int32))
            n = len(seqs)
            part[len(part)] = np.arange(cursor, cursor + n)
            cursor += n
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        mask = np.ones_like(y, dtype=np.float32)
        return FederatedArrays({"x": x, "y": y, "mask": mask}, part)

    train = _gather(tr)
    test_fed = _gather(te)
    pooled = {k: v for k, v in test_fed.arrays.items()}
    return train, pooled, test_fed


def synthetic_leaf_mnist(
    n_clients: int = 50, seed: int = 0
) -> tuple[FederatedArrays, dict[str, np.ndarray], FederatedArrays]:
    """Hermetic stand-in for LEAF MNIST (power-law sizes, digit classes) used
    when the real download is absent — same shapes/dtypes as the real loader."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(10, 28, 28).astype(np.float32)

    def _make(n_per):
        xs, ys, part, cursor = [], [], {}, 0
        for ci in range(n_clients):
            n = n_per[ci]
            y = rng.randint(0, 10, n).astype(np.int32)
            x = centers[y] + rng.normal(0, 0.35, (n, 28, 28)).astype(np.float32)
            xs.append(x.astype(np.float32))
            ys.append(y)
            part[ci] = np.arange(cursor, cursor + n)
            cursor += n
        return FederatedArrays({"x": np.concatenate(xs), "y": np.concatenate(ys)}, part)

    raw = rng.pareto(2.0, n_clients) + 1
    sizes = np.maximum((raw / raw.sum() * 60 * n_clients).astype(int), 8)
    train = _make(sizes)
    test_fed = _make(np.maximum(sizes // 5, 2))
    return train, dict(test_fed.arrays), test_fed
