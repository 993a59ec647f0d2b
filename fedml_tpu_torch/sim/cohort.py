"""Host-side cohort staging, the numpy port of ``fedml_tpu/sim/cohort.py``.

For each round's cohort the sampled clients' sample indices are laid out as
one ``[C, S, B]`` index map (C clients x S steps x B batch, -1 = empty slot)
with the true per-client sample counts as aggregation weights. The functions
are copies of the reference's, so the same seed gives bitwise-equal maps and
batches; the engine gathers the batches on the device from the map.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FederatedArrays:
    """An in-memory federated dataset.

    ``arrays``: field name -> [N, ...] numpy array (must include "x" and "y";
    may include a per-token "mask" for sequence tasks).
    ``partition``: client id -> sorted sample indices into those arrays
    (the 8-tuple contract's train_data_local_dict, flattened to indices).
    """

    arrays: dict[str, np.ndarray]
    partition: dict[int, np.ndarray]

    @property
    def num_clients(self) -> int:
        return len(self.partition)

    @property
    def num_samples(self) -> int:
        return len(self.arrays["y"])

    def client_sizes(self) -> np.ndarray:
        return np.asarray([len(self.partition[i]) for i in range(self.num_clients)])

    def max_client_size(self) -> int:
        return int(self.client_sizes().max())

    def index_csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, dict | None]:
        """The vectorized form of ``partition``, in a ragged CSR layout:
        ``flat`` (every client's sample rows concatenated, int32),
        ``offsets`` (int64, client row i owns flat[offsets[i]:offsets[i]+
        sizes[i]]), ``sizes`` (int64), and a client-id -> row lookup (None
        when ids are the usual contiguous 0..N-1, so rows are indexed
        directly; cross-silo keys its single-client shards by global silo
        index, hence the general case). CSR rather than a dense padded
        matrix keeps the cache O(total samples) on skewed populations —
        one giant client must not multiply the whole population's footprint.
        Built once (the only remaining O(num_clients) Python loop) and
        cached — every round's staging reads it, so the partition is
        treated as immutable after the first call."""
        cached = self.__dict__.get("_index_csr")
        if cached is None:
            keys = sorted(self.partition)
            sizes = np.asarray(
                [len(self.partition[k]) for k in keys], np.int64
            )
            flat = (
                np.concatenate(
                    [np.asarray(self.partition[k], np.int32).ravel()
                     for k in keys]
                )
                if keys else np.zeros(0, np.int32)
            )
            offsets = np.zeros(len(keys), np.int64)
            if len(keys):
                np.cumsum(sizes[:-1], out=offsets[1:])
            lookup = (
                None if keys == list(range(len(keys)))
                else {k: row for row, k in enumerate(keys)}
            )
            cached = (flat, offsets, sizes, lookup)
            self.__dict__["_index_csr"] = cached
        return cached


def steps_per_epoch(max_client_size: int, batch_size: int) -> int:
    return max(1, -(-max_client_size // batch_size))


def cohort_index_map(
    data: FederatedArrays,
    client_ids: np.ndarray,
    batch_size: int,
    steps: int | None = None,
    rng: np.random.RandomState | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized cohort staging: the round's [C, S, B] int32 sample-index
    map (-1 = empty slot) and [C] float32 true sample counts, built with a
    fixed number of numpy ops per round instead of a per-client Python loop.

    This is the ONE definition of cohort selection: host batch stacks
    (:func:`stack_cohort` gathers rows through it) and the engine's
    on-device gather both stage via this map, so their shuffle/truncation/
    zero-fill semantics cannot drift.

    ``rng`` shuffles each client's sample order by drawing one
    [C, max cohort size] uniform block and argsorting each row (padding is
    sunk to the tail) — a uniform per-client permutation in one vectorized
    draw, sized by THIS cohort's largest member, not the population's. Clients with more samples than ``steps * batch_size``
    slots keep the first ``slots`` entries of their (shuffled) order — a
    without-replacement subsample over ALL their samples, exactly the old
    permute-then-truncate semantics; weights still report the true client
    size.
    """
    flat, offsets, sizes, lookup = data.index_csr()
    # negative client ids are EMPTY cohort slots (the population model's
    # availability padding, population/model.py RoundView): zero samples,
    # all-(-1) index rows, zero weight — the same shape-stable padding
    # convention the mesh pad already uses, so churned cohorts never change
    # compiled shapes
    ids = np.asarray(client_ids)
    empty = ids < 0
    if lookup is None:
        rows = np.where(empty, 0, ids).astype(np.intp)
    else:
        rows = np.asarray(
            [0 if e else lookup[int(c)] for c, e in zip(ids, empty)],
            dtype=np.intp,
        )
    sz = sizes[rows]
    if empty.any():
        sz = np.where(empty, 0, sz)
    if steps is None:
        steps = steps_per_epoch(int(sz.max()), batch_size)
    slots = steps * batch_size
    # unshuffled, truncation == keeping each row's first `slots` entries, so
    # the gather can stop there; a shuffle must permute the FULL row first
    width = int(sz.max()) if len(sz) else 0
    if rng is None:
        width = min(width, slots)
    width = max(width, 1)
    col = np.arange(width)
    valid = col[None, :] < sz[:, None]
    all_full = bool(valid.all())
    gather = offsets[rows][:, None] + col[None, :]
    guard = max(len(flat) - 1, 0)
    sel = (
        flat[np.minimum(gather, guard)]
        if len(flat) else np.full(gather.shape, -1, np.int32)
    )
    if not all_full:
        sel[~valid] = -1
    if rng is not None:
        # argsort of iid uniforms = a uniform permutation per row (tie
        # probability ~ C*L^2 * 2^-53, ignorable); +inf sinks the padding
        # to the row tail (every pad slot is the same -1, so pad order is
        # irrelevant and the default sort suffices)
        u = rng.random_sample(sel.shape)
        if not all_full:
            u[~valid] = np.inf
        sel = np.take_along_axis(sel, np.argsort(u, axis=1), axis=1)
    if width < slots:
        sel = np.pad(sel, ((0, 0), (0, slots - width)), constant_values=-1)
    elif width > slots:
        sel = sel[:, :slots]
    return (
        np.ascontiguousarray(sel).reshape(len(rows), steps, batch_size),
        sz.astype(np.float32),
    )


def gather_index_stack(
    arrays: dict[str, np.ndarray], idx: np.ndarray
) -> dict[str, np.ndarray]:
    """Gather dataset rows through an index map (-1 = empty slot) with the
    canonical zero-fill + example-mask semantics: empty slots are zero rows
    with mask 0, and sequence tasks' per-token mask is combined with example
    validity. ``idx`` may have any leading shape, e.g. [C, S, B] for the
    cohort stack (the host mirror of ``FedSim._gather_batches``)."""
    lead = idx.shape
    flat = idx.reshape(-1)
    valid = flat >= 0
    safe = np.where(valid, flat, 0)
    out: dict[str, np.ndarray] = {}
    for name, arr in arrays.items():
        gathered = arr[safe]
        gathered[~valid] = 0  # empty slots are zero-filled, exactly as before
        out[name] = gathered.reshape(lead + arr.shape[1:])
    example_mask = valid.astype(np.float32).reshape(lead)
    if "mask" in out:
        # sequence tasks: combine per-token mask with example validity
        tok = out["mask"].astype(np.float32)
        out["mask"] = tok * example_mask.reshape(
            example_mask.shape + (1,) * (tok.ndim - example_mask.ndim)
        )
    else:
        out["mask"] = example_mask
    return out


def stack_cohort(
    data: FederatedArrays,
    client_ids: np.ndarray,
    batch_size: int,
    steps: int | None = None,
    rng: np.random.RandomState | None = None,
) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Build the round's training stack.

    Returns ``(batch_stack, num_samples)`` where batch_stack leaves are
    [C, S, B, ...] and num_samples is [C] float32 true sample counts (the
    aggregation weights, FedAVGAggregator.py:59-88). ``steps`` pins S so every
    round has identical shapes; default = fit the largest cohort member.
    ``rng`` shuffles each client's sample order (torch DataLoader shuffle
    semantics). Selection runs through :func:`cohort_index_map`, so the host
    stack is the gathered image of the exact index map the on-device path
    ships — one vectorized gather instead of a per-client copy loop.
    """
    idx, sizes = cohort_index_map(data, client_ids, batch_size, steps=steps, rng=rng)
    return gather_index_stack(data.arrays, idx), sizes


def batch_array(arrays: dict[str, np.ndarray], batch_size: int) -> dict[str, np.ndarray]:
    """Batch a flat dataset into [S, B, ...] with padding mask — used for
    centralized training and global eval."""
    n = len(arrays["y"])
    steps = steps_per_epoch(n, batch_size)
    slots = steps * batch_size
    out = {}
    for name, arr in arrays.items():
        padded = np.zeros((slots,) + arr.shape[1:], dtype=arr.dtype)
        padded[:n] = arr
        out[name] = padded.reshape((steps, batch_size) + arr.shape[1:])
    mask = np.zeros((slots,), dtype=np.float32)
    mask[:n] = 1.0
    mask = mask.reshape(steps, batch_size)
    if "mask" in out:
        tok = out["mask"].astype(np.float32)
        out["mask"] = tok * mask.reshape(mask.shape + (1,) * (tok.ndim - 2))
    else:
        out["mask"] = mask
    return out
