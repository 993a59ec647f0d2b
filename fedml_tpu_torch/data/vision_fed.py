"""Federated large-scale vision datasets, a copy of
``fedml_tpu/data/vision_fed.py``: ImageNet (ILSVRC2012) and Google
Landmarks (gld23k / gld160k).

Reference: fedml_api/data_preprocessing/ImageNet/data_loader.py (class-grouped
client partition — 1000 clients = 1 class each, 100 clients = 10 classes each,
:235-243; normalize with ImageNet mean/std :47-48) and
fedml_api/data_preprocessing/Landmarks/data_loader.py (csv mapping files
``user_id,image_id,class`` define the natural per-photographer non-IID
partition, get_mapping_per_user :116-157; 0.5/0.5 normalize :95-96).

Images are decoded once on the host into a dense normalized ``[N, H, W, 3]``
array, which the engine keeps on the device and gathers cohorts from.
``image_size`` is a knob — the reference's 224 works for real runs; tests
and fallbacks use small sizes.

Both loaders gate on files being present and fall back to synthetic
fixtures with the same partition semantics, bitwise equal to the JAX
package's for the same arguments. Pillow is optional (``HAS_PIL``) and
imported at the first decode.
"""

from __future__ import annotations

import csv
import importlib.util
from pathlib import Path

import numpy as np

from fedml_tpu_torch.sim.cohort import FederatedArrays

# Pillow is optional; the synthetic fixtures work without it
HAS_PIL = importlib.util.find_spec("PIL") is not None

# in-memory decode guard: refuse to silently OOM the host on full-scale
# datasets; callers cap with image_size / limit_per_class instead
MAX_DECODE_BYTES = 16 << 30

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
LANDMARKS_MEAN = np.asarray([0.5, 0.5, 0.5], np.float32)
LANDMARKS_STD = np.asarray([0.5, 0.5, 0.5], np.float32)


def _decode_image(path: Path, image_size: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((image_size, image_size))
        return np.asarray(im, np.uint8)


def _normalize(x_u8: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return ((x_u8.astype(np.float32) / 255.0) - mean) / std


# ---------------------------------------------------------------------------
# ImageNet
# ---------------------------------------------------------------------------


def class_group_partition(y: np.ndarray, num_classes: int, client_number: int
                          ) -> dict[int, np.ndarray]:
    """The reference's ImageNet federation: clients own contiguous groups of
    classes (data_loader.py:235-243 — 1000 clients -> 1 class, 100 -> 10).
    Generalized to any client_number dividing num_classes."""
    if num_classes % client_number != 0:
        raise ValueError(
            f"client_number {client_number} must divide num_classes {num_classes}"
        )
    per = num_classes // client_number
    order = np.argsort(y, kind="stable")
    y_sorted = y[order]
    part = {}
    for ci in range(client_number):
        lo, hi = ci * per, (ci + 1) * per
        sel = order[(y_sorted >= lo) & (y_sorted < hi)]
        part[ci] = np.sort(sel)
    return part


def _scan_imagefolder(root: Path, image_size: int, class_to_id=None,
                      limit_per_class: int | None = None):
    """Decode an ImageFolder layout ``root/<class_dir>/<img>`` into dense
    arrays. Returns (x_u8, y, class_to_id)."""
    dirs = sorted(d for d in root.iterdir() if d.is_dir())
    if class_to_id is None:
        class_to_id = {d.name: i for i, d in enumerate(dirs)}
    files, ys = [], []
    for d in dirs:
        cid = class_to_id.get(d.name)
        if cid is None:
            continue
        imgs = sorted(
            f for f in d.iterdir()
            if f.suffix.lower() in (".jpeg", ".jpg", ".png")
        )[:limit_per_class]
        files.extend(imgs)
        ys.extend([cid] * len(imgs))
    est = len(files) * image_size * image_size * 3 * 4  # float32 output
    if est > MAX_DECODE_BYTES:
        raise ValueError(
            f"{root}: decoding {len(files)} images at {image_size}px needs "
            f"~{est >> 30} GiB in memory; pass a smaller image_size and/or "
            "limit_per_class (the in-memory engine is designed for "
            "device-resident subsets, not a full 1.28M-image stream)"
        )
    xs = [_decode_image(f, image_size) for f in files]
    return np.stack(xs), np.asarray(ys, np.int32), class_to_id


def load_imagenet(
    data_dir: str | Path,
    client_number: int = 100,
    image_size: int = 224,
    limit_per_class: int | None = None,
) -> tuple[FederatedArrays, dict[str, np.ndarray], int]:
    """ILSVRC2012 directory layout: ``train/<wnid>/*.JPEG`` +
    ``val/<wnid>/*.JPEG``. Any class count works (e.g. ImageNet subsets /
    tiny-imagenet trees) as long as client_number divides it. Full-resolution
    full-corpus decodes are refused (MAX_DECODE_BYTES) — cap with
    ``image_size`` / ``limit_per_class``."""
    root = Path(data_dir)
    train_x, train_y, c2i = _scan_imagefolder(
        root / "train", image_size, limit_per_class=limit_per_class
    )
    test_x, test_y, _ = _scan_imagefolder(
        root / "val", image_size, c2i, limit_per_class=limit_per_class
    )
    num_classes = len(c2i)
    part = class_group_partition(train_y, num_classes, client_number)
    train = FederatedArrays(
        {"x": _normalize(train_x, IMAGENET_MEAN, IMAGENET_STD), "y": train_y}, part
    )
    test = {"x": _normalize(test_x, IMAGENET_MEAN, IMAGENET_STD), "y": test_y}
    return train, test, num_classes


def synthetic_imagenet(
    client_number: int = 10,
    num_classes: int | None = None,
    per_class: int = 6,
    image_size: int = 16,
    seed: int = 0,
) -> tuple[FederatedArrays, dict[str, np.ndarray], int]:
    """Class-grouped fixture with the real loader's partition semantics.
    ``num_classes`` defaults to the smallest multiple of ``client_number``
    >= 20, so any client count divides evenly."""
    if num_classes is None:
        num_classes = client_number * max(1, -(-20 // client_number))
    rng = np.random.RandomState(seed)
    n = num_classes * per_class
    y = np.repeat(np.arange(num_classes), per_class).astype(np.int32)
    # class-dependent mean so the task is learnable
    x = rng.rand(n, image_size, image_size, 3).astype(np.float32) * 0.1
    x += (y[:, None, None, None] / num_classes).astype(np.float32)
    order = rng.permutation(n)
    x, y = x[order], y[order]
    part = class_group_partition(y, num_classes, client_number)
    n_test = num_classes * 2
    yt = np.repeat(np.arange(num_classes), 2).astype(np.int32)
    xt = rng.rand(n_test, image_size, image_size, 3).astype(np.float32) * 0.1
    xt += (yt[:, None, None, None] / num_classes).astype(np.float32)
    return FederatedArrays({"x": x, "y": y}, part), {"x": xt, "y": yt}, num_classes


# ---------------------------------------------------------------------------
# Google Landmarks (gld23k / gld160k)
# ---------------------------------------------------------------------------


def _read_mapping_csv(path: Path) -> list[dict]:
    with open(path) as f:
        rows = list(csv.DictReader(f))
    need = {"user_id", "image_id", "class"}
    if rows and not need.issubset(rows[0].keys()):
        raise ValueError(
            f"{path}: mapping csv must have user_id,image_id,class columns, "
            f"got {sorted(rows[0].keys())}"
        )
    return rows


def load_landmarks(
    data_dir: str | Path,
    fed_train_map_file: str | Path,
    fed_test_map_file: str | Path,
    image_size: int = 224,
    # (kept 224 to match the reference transform; callers may cap)
) -> tuple[FederatedArrays, dict[str, np.ndarray], int]:
    """gld23k/gld160k: mapping csvs assign images to photographers (user_id),
    the natural non-IID split (reference Landmarks/data_loader.py:199-256).
    Images live at ``data_dir/<image_id>.jpg`` (subdirectories in image_id
    are honored)."""
    root = Path(data_dir)
    train_rows = _read_mapping_csv(Path(fed_train_map_file))
    test_rows = _read_mapping_csv(Path(fed_test_map_file))

    def _decode_rows(rows):
        if not rows:
            return (
                np.zeros((0, image_size, image_size, 3), np.float32),
                np.zeros((0,), np.int32),
            )
        est = len(rows) * image_size * image_size * 3 * 4
        if est > MAX_DECODE_BYTES:
            raise ValueError(
                f"{root}: decoding {len(rows)} mapped images at {image_size}px "
                f"needs ~{est >> 30} GiB; pass a smaller image_size"
            )
        xs, ys = [], []
        for r in rows:
            img = root / f"{r['image_id']}.jpg"
            xs.append(_decode_image(img, image_size))
            ys.append(int(r["class"]))
        return (
            _normalize(np.stack(xs), LANDMARKS_MEAN, LANDMARKS_STD),
            np.asarray(ys, np.int32),
        )

    # group rows per user in order of first appearance -> contiguous ranges,
    # mirroring get_mapping_per_user's (start, stop) net_dataidx_map
    by_user: dict[int, list[int]] = {}
    for i, r in enumerate(train_rows):
        by_user.setdefault(int(r["user_id"]), []).append(i)
    order = np.concatenate([np.asarray(v) for v in by_user.values()])
    train_rows = [train_rows[i] for i in order]
    part, cursor = {}, 0
    for ci, (_uid, idxs) in enumerate(by_user.items()):
        part[ci] = np.arange(cursor, cursor + len(idxs))
        cursor += len(idxs)

    x, y = _decode_rows(train_rows)
    xt, yt = _decode_rows(test_rows)
    class_num = int(max(y.max(), yt.max() if len(yt) else 0)) + 1
    return FederatedArrays({"x": x, "y": y}, part), {"x": xt, "y": yt}, class_num


def synthetic_landmarks(
    n_clients: int = 12,
    num_classes: int = 8,
    image_size: int = 16,
    seed: int = 0,
) -> tuple[FederatedArrays, dict[str, np.ndarray], int]:
    """Power-law per-photographer sizes (the gld23k shape: few prolific
    users, many small ones)."""
    rng = np.random.RandomState(seed)
    sizes = np.maximum(2, (rng.pareto(1.5, n_clients) * 4).astype(int))
    xs, ys, part, cursor = [], [], {}, 0
    for ci, sz in enumerate(sizes):
        y = rng.randint(0, num_classes, sz).astype(np.int32)
        x = rng.rand(sz, image_size, image_size, 3).astype(np.float32) * 0.1
        x += (y[:, None, None, None] / num_classes).astype(np.float32)
        xs.append(x)
        ys.append(y)
        part[ci] = np.arange(cursor, cursor + sz)
        cursor += sz
    n_test = num_classes * 3
    yt = np.repeat(np.arange(num_classes), 3).astype(np.int32)
    xt = rng.rand(n_test, image_size, image_size, 3).astype(np.float32) * 0.1
    xt += (yt[:, None, None, None] / num_classes).astype(np.float32)
    return (
        FederatedArrays({"x": np.concatenate(xs), "y": np.concatenate(ys)}, part),
        {"x": xt, "y": yt},
        num_classes,
    )
