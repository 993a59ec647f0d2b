"""Non-IID client partitioners, a numpy copy of ``fedml_tpu/core/partition.py``:
the same labels and seed give bitwise the same partition.

Capability parity with the reference's partitioning stack:
- latent-Dirichlet partition with min-size retry loop
  (reference: fedml_core/non_iid_partition/noniid_partition.py:6-93)
- ``homo`` / ``hetero`` / ``hetero-fix`` methods of the CV loaders
  (reference: fedml_api/data_preprocessing/cifar10/data_loader.py:113-161)
- power-law client sizes used by LEAF MNIST (1000-client benchmark config)
- per-client class histograms (noniid_partition.py:94 ``record_data_stats``)

All functions are host-side numpy: partitioning happens once at startup, the
result is a list of index arrays that the data layer turns into stacked,
padded per-client device arrays.
"""

from __future__ import annotations

import logging

import numpy as np


def homo_partition(n_samples: int, n_clients: int, seed: int = 0) -> dict[int, np.ndarray]:
    """Uniform random split (reference partition_method='homo',
    cifar10/data_loader.py:113-117)."""
    rng = np.random.RandomState(seed)
    idxs = rng.permutation(n_samples)
    return {i: np.sort(part) for i, part in enumerate(np.array_split(idxs, n_clients))}


def dirichlet_partition(
    labels: np.ndarray,
    n_clients: int,
    alpha: float,
    min_size: int = 10,
    seed: int = 0,
    task: str = "classification",
) -> dict[int, np.ndarray]:
    """Latent-Dirichlet non-IID partition.

    For each class, sample proportions ~ Dir(alpha) over clients and split that
    class's samples accordingly; retry until every client has >= ``min_size``
    samples (reference noniid_partition.py:44-69 and
    cifar10/data_loader.py:118-149 — both implement this loop). ``alpha`` -> inf
    approaches a uniform split; small ``alpha`` concentrates classes on few
    clients.

    ``task='segmentation'`` treats ``labels`` as a list of per-sample label
    *sets* (multi-label; reference noniid_partition.py:29-43) and partitions by
    the first category of each sample.
    """
    rng = np.random.RandomState(seed)
    if task == "segmentation":
        flat = np.asarray([np.min(cats) for cats in labels])
    else:
        flat = np.asarray(labels).reshape(-1)
    n_samples = flat.shape[0]
    classes = np.unique(flat)

    size_min = -1
    tries = 0
    while size_min < min(min_size, max(1, n_samples // (n_clients * 2))):
        idx_batch: list[list[int]] = [[] for _ in range(n_clients)]
        for c in classes:
            idx_c = np.where(flat == c)[0]
            rng.shuffle(idx_c)
            proportions = rng.dirichlet(np.repeat(alpha, n_clients))
            # Balance heuristic from the reference (noniid_partition.py:76-93):
            # zero out proportions for clients already at average capacity.
            proportions = np.array(
                [p * (len(b) < n_samples / n_clients) for p, b in zip(proportions, idx_batch)]
            )
            s = proportions.sum()
            proportions = proportions / s if s > 0 else np.ones(n_clients) / n_clients
            cuts = (np.cumsum(proportions) * len(idx_c)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_c, cuts)):
                idx_batch[i].extend(part.tolist())
        size_min = min(len(b) for b in idx_batch)
        tries += 1
        if tries > 100:  # degenerate config (tiny dataset): accept best effort
            logging.warning("dirichlet_partition: min-size retry cap hit (min=%d)", size_min)
            break

    out = {}
    for i in range(n_clients):
        rng.shuffle(idx_batch[i])
        out[i] = np.sort(np.asarray(idx_batch[i], dtype=np.int64))
    return out


def powerlaw_partition(
    labels: np.ndarray, n_clients: int, alpha: float = 3.0, min_size: int = 2, seed: int = 0
) -> dict[int, np.ndarray]:
    """Power-law client sizes (LEAF MNIST-style: 1000 clients whose sample
    counts follow a power law; reference consumes this pre-partitioned from
    LEAF JSON — we generate it for in-memory datasets)."""
    rng = np.random.RandomState(seed)
    n_samples = len(labels)
    raw = rng.pareto(alpha, n_clients) + 1.0
    sizes = np.maximum((raw / raw.sum() * (n_samples - min_size * n_clients)).astype(int) + min_size, min_size)
    # fix rounding so sizes sum exactly
    diff = n_samples - sizes.sum()
    sizes[np.argmax(sizes)] += diff
    idxs = rng.permutation(n_samples)
    out, start = {}, 0
    for i in range(n_clients):
        out[i] = np.sort(idxs[start : start + sizes[i]])
        start += sizes[i]
    return out


def fixed_partition(distribution: dict[int, np.ndarray]) -> dict[int, np.ndarray]:
    """'hetero-fix': partition loaded from a saved distribution file
    (reference cifar10/data_loader.py:150-158)."""
    return {int(k): np.asarray(v, dtype=np.int64) for k, v in distribution.items()}


def read_net_dataidx_map(path) -> dict[int, np.ndarray]:
    """Read a saved client→sample-index map for ``hetero-fix``.

    Accepts both formats a reference user may have on disk:
    - the reference's printed-dict ``net_dataidx_map.txt``
      (cifar10/data_loader.py:31-43 ``read_net_dataidx_map``): ``N: [`` opens
      client N, subsequent comma-separated integer lines are its indices,
      ``]``/``{``/``}`` lines are structure;
    - plain JSON ``{"client": [indices...]}``.
    """
    import json
    from pathlib import Path

    text = Path(path).read_text()
    try:
        return fixed_partition(json.loads(text))
    except json.JSONDecodeError:
        pass  # not JSON — the reference's printed-dict layout
    mapping: dict[int, list[int]] = {}
    key = None
    for line in text.splitlines():
        line = line.strip()
        if not line or line[0] in "{}]":
            continue
        head, _, tail = line.partition(":")
        if tail.strip() == "[":
            key = int(head)
            mapping[key] = []
        else:
            if key is None:
                raise ValueError(f"malformed dataidx map line: {line!r}")
            mapping[key].extend(
                int(tok) for tok in line.replace("]", "").split(",") if tok.strip()
            )
    if not mapping:
        raise ValueError(f"no client index lists found in {path}")
    return fixed_partition(mapping)


def write_net_dataidx_map(path, net_dataidx_map: dict[int, np.ndarray]) -> None:
    """Write a partition in the reference's ``net_dataidx_map.txt`` layout so
    the file round-trips through both this reader and the reference's."""
    from pathlib import Path

    lines = ["{"]
    for client in sorted(net_dataidx_map):
        lines.append(f"{int(client)}: [")
        idxs = net_dataidx_map[client]
        if len(idxs):
            lines.append(", ".join(str(int(i)) for i in idxs))
        # zero-index clients get NO indices line: the reference reader
        # (cifar10/data_loader.py:38-42) int()s every token of every
        # non-structural line, so an empty line would crash it; both readers
        # parse "N: [" directly followed by "]" as an empty client
        lines.append("]")
    lines.append("}")
    Path(path).write_text("\n".join(lines) + "\n")


def partition(
    method: str,
    labels: np.ndarray,
    n_clients: int,
    alpha: float = 0.5,
    seed: int = 0,
    dataidx_map_path=None,
) -> dict[int, np.ndarray]:
    """Dispatch by reference partition_method name. ``hetero-fix`` loads the
    saved distribution at ``dataidx_map_path`` (reference hard-codes
    ``./data_preprocessing/non-iid-distribution/<DS>/net_dataidx_map.txt``;
    here the path is explicit)."""
    if method == "homo":
        return homo_partition(len(labels), n_clients, seed)
    if method in ("hetero", "dirichlet", "noniid"):
        return dirichlet_partition(labels, n_clients, alpha, seed=seed)
    if method in ("power-law", "power_law"):
        return powerlaw_partition(labels, n_clients, seed=seed)
    if method == "hetero-fix":
        if dataidx_map_path is None:
            raise ValueError(
                "partition_method='hetero-fix' needs dataidx_map_path "
                "(--dataidx_map_path, a saved net_dataidx_map.txt)"
            )
        mapping = read_net_dataidx_map(dataidx_map_path)
        if set(mapping) != set(range(n_clients)):
            raise ValueError(
                f"hetero-fix map at {dataidx_map_path} has clients "
                f"{sorted(mapping)} but client_num_in_total={n_clients} "
                f"needs exactly 0..{n_clients - 1}"
            )
        n = len(labels)
        for client, idxs in mapping.items():
            if len(idxs) and (idxs.min() < 0 or idxs.max() >= n):
                raise ValueError(
                    f"hetero-fix map at {dataidx_map_path}: client {client} "
                    f"indexes outside the {n}-sample dataset"
                )
        return mapping
    raise ValueError(f"unknown partition method: {method!r}")


def record_data_stats(labels: np.ndarray, net_dataidx_map: dict[int, np.ndarray], n_classes: int | None = None):
    """Per-client class histogram (reference noniid_partition.py:94-102)."""
    labels = np.asarray(labels).reshape(-1)
    if n_classes is None:
        n_classes = int(labels.max()) + 1
    stats = {}
    for client, idxs in net_dataidx_map.items():
        hist = np.bincount(labels[idxs], minlength=n_classes)
        stats[client] = {int(c): int(n) for c, n in enumerate(hist) if n > 0}
    logging.debug("client class histograms: %s", stats)
    return stats
