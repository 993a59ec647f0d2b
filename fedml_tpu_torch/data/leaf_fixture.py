"""LEAF-format MNIST fixture generator for offline BASELINE reproduction, a
copy of ``fedml_tpu/data/leaf_fixture.py`` that writes bitwise-equal files
for the same arguments.

The reference's Linear-Models benchmark row (benchmark/README.md:12-14;
BASELINE.md "Linear models") runs LEAF MNIST: 1000 clients, power-law sample
counts, 2 digit classes per client (the FedProx partition), FedAvg with
LR + SGD(0.03), B=10, E=1 -> test acc > 75 within ~100 rounds.

Without network access the real LEAF download cannot be fetched. This
generator writes the SAME on-disk format (LEAF JSON train/test split
directories, users/num_samples/user_data schema) from the closest real data
available offline: 1797 genuine handwritten digits (8x8), upsampled to 28x28
and augmented (same-class blending, pixel shifts, noise) to populate the
power-law client shards. The result is real handwriting with MNIST's
shape/partition statistics — NOT byte-identical MNIST.

The digits are scikit-learn's ``load_digits`` set, vendored beside this
module as ``digits.csv.gz`` (origin and licences in ``digits.csv.gz.txt``)
and read with numpy exactly as ``sklearn.datasets.load_digits`` reads it, so
the port needs no scikit-learn.
"""

from __future__ import annotations

import gzip
import json
from pathlib import Path

import numpy as np

DIGITS_FILE = Path(__file__).resolve().parent / "digits.csv.gz"


def load_digits() -> tuple[np.ndarray, np.ndarray]:
    """``(images [1797, 8, 8] f64, target [1797] int)``, as
    ``sklearn.datasets.load_digits()``'s ``images`` and ``target``."""
    with gzip.open(DIGITS_FILE, "rt") as f:
        data = np.loadtxt(f, delimiter=",")
    return data[:, :-1].reshape(-1, 8, 8), data[:, -1].astype(int)


def _digit_pools(seed: int) -> dict[int, np.ndarray]:
    """Per-class pools of real handwritten digits upsampled to 28x28."""
    images, target = load_digits()
    imgs = images.astype(np.float32) / 16.0  # [N, 8, 8] in [0, 1]
    # 8x8 -> 28x28: nearest-neighbor x3 (24) then edge-pad to 28, which keeps
    # strokes crisp (bilinear over 3.5x smears the 8px strokes into mush)
    up = np.kron(imgs, np.ones((1, 3, 3), np.float32))  # [N, 24, 24]
    up = np.pad(up, ((0, 0), (2, 2), (2, 2)))
    return {c: up[target == c] for c in range(10)}


def _sample_client(pool_a, pool_b, n, rng):
    """n augmented samples from two class pools: blend two same-class
    originals, shift +-2 px, add noise — real stroke structure, fresh
    examples."""
    labels = rng.randint(0, 2, n)
    out_x = np.empty((n, 28, 28), np.float32)
    out_y = np.empty((n,), np.int32)
    for i in range(n):
        pool, y = (pool_a if labels[i] == 0 else pool_b)
        a, b = pool[rng.randint(len(pool))], pool[rng.randint(len(pool))]
        t = rng.rand() * 0.5
        img = (1 - t) * a + t * b
        dx, dy = rng.randint(-2, 3, 2)
        img = np.roll(np.roll(img, dx, axis=0), dy, axis=1)
        img = np.clip(img + rng.normal(0, 0.05, img.shape), 0.0, 1.0)
        out_x[i] = img
        out_y[i] = y
    return out_x, out_y


def write_leaf_mnist_fixture(
    out_dir: str | Path,
    n_clients: int = 1000,
    seed: int = 0,
    min_samples: int = 10,
    max_samples: int = 400,
) -> Path:
    """Write LEAF-format train/ test/ JSON dirs; returns out_dir.

    Power-law sizes (lognormal, the FedProx MNIST recipe), 2 classes per
    client, 90/10 train/test split per client. Idempotency, real-data
    preservation, and stale regeneration follow the shared
    :mod:`fedml_tpu_torch.data.fixture_util` contract.
    """
    from fedml_tpu_torch.data import fixture_util

    out = Path(out_dir)
    names = [f"{split}/all_data_niid_0_keep_0_{split}_9.json"
             for split in ("train", "test")]
    if (out / "train").is_dir() and any((out / "train").glob("*.json")) \
            and not fixture_util.is_fixture(out, "mnist"):
        return out  # real LEAF json — never touched
    if not fixture_util.prepare(
        out, "mnist",
        {"n_clients": n_clients, "seed": seed,
         "min_samples": min_samples, "max_samples": max_samples},
        names,
    ):
        return out
    rng = np.random.RandomState(seed)
    pools = _digit_pools(seed)

    sizes = np.clip(
        np.exp(rng.normal(np.log(20.0), 1.0, n_clients)).astype(int),
        min_samples, max_samples,
    )
    train_blob = {"users": [], "num_samples": [], "user_data": {}}
    test_blob = {"users": [], "num_samples": [], "user_data": {}}
    for ci in range(n_clients):
        uid = f"f_{ci:05d}"
        c1, c2 = rng.choice(10, 2, replace=False)
        x, y = _sample_client(
            (pools[c1], int(c1)), (pools[c2], int(c2)), int(sizes[ci]), rng
        )
        n_test = max(1, len(y) // 10)
        # round pixels to 3 decimals: 4x smaller json, visually identical
        xr = np.round(x.reshape(len(y), -1), 3)
        for blob, sl in ((train_blob, slice(n_test, None)),
                         (test_blob, slice(0, n_test))):
            blob["users"].append(uid)
            blob["num_samples"].append(int(len(y[sl])))
            blob["user_data"][uid] = {
                "x": xr[sl].tolist(), "y": y[sl].tolist(),
            }
    # tmp+rename with the probe (train json, names[0]) renamed LAST, per the
    # fixture_util contract: a crash at any point leaves no probe file, so
    # prepare() treats the marker as stale and regenerates cleanly
    staged: list[tuple[Path, Path]] = []
    for split, blob in (("test", test_blob), ("train", train_blob)):
        d = out / split
        d.mkdir(parents=True, exist_ok=True)
        final = d / f"all_data_niid_0_keep_0_{split}_9.json"
        tmp = final.with_name(final.name + ".tmp")
        with open(tmp, "w") as f:
            # json.dumps runs the C encoder (json.dump streams through the
            # pure-Python one): the same bytes, ~10x sooner
            f.write(json.dumps(blob))
        staged.append((tmp, final))
    for tmp, final in staged:  # test first, train (probe) last
        tmp.replace(final)
    return out
