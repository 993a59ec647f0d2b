"""TFF HDF5 federated dataset readers, the port of
``fedml_tpu/data/tff_h5.py`` (pure numpy and h5py: the same arrays for the
same files).

Reference: the four h5py client-keyed archives — FederatedEMNIST
(data_loader.py:22 ``examples/<client>/pixels|label``, 3400 clients),
fed_cifar100 (``examples/<client>/image|label``, 500 clients),
fed_shakespeare (``examples/<client>/snippets``, 715 clients),
stackoverflow_nwp/lr (342k clients, ``tokens/title/tags``). Each reader emits
:class:`FederatedArrays`; clients become contiguous index ranges.

h5py is imported when a reader runs, never at import: a machine without it
(the card's) imports every port module, and a reader there raises instead of
standing synthetic data in for the files (the registry reads them only when
they are present).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fedml_tpu_torch.sim.cohort import FederatedArrays


def _h5py():
    """The ``h5py`` module, or ``RuntimeError`` where it is not installed."""
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("h5py unavailable; use synthetic fixtures instead") from e
    return h5py


_EXAMPLE = "examples"


def _load_clientkeyed(
    path: str | Path, field_map: dict[str, str], limit_clients: int | None = None
) -> FederatedArrays:
    """Generic reader: ``examples/<client_id>/<field>`` -> FederatedArrays.

    ``field_map``: output name -> h5 dataset name, e.g. {"x": "pixels",
    "y": "label"}.
    """
    h5py = _h5py()
    arrays: dict[str, list[np.ndarray]] = {k: [] for k in field_map}
    part: dict[int, np.ndarray] = {}
    cursor = 0
    with h5py.File(path, "r") as f:
        client_ids = sorted(f[_EXAMPLE].keys())
        if limit_clients:
            client_ids = client_ids[:limit_clients]
        for ci, cid in enumerate(client_ids):
            grp = f[_EXAMPLE][cid]
            n = None
            for out_name, h5_name in field_map.items():
                a = np.asarray(grp[h5_name][()])
                arrays[out_name].append(a)
                n = len(a) if n is None else n
            part[ci] = np.arange(cursor, cursor + n)
            cursor += n
    merged = {k: np.concatenate(v) for k, v in arrays.items()}
    if "y" in merged and merged["y"].ndim > 1:
        merged["y"] = merged["y"].squeeze(-1)
    return FederatedArrays(merged, part)


def load_federated_emnist(data_dir: str | Path, limit_clients: int | None = None):
    """FederatedEMNIST: 3400 clients, 28x28 pixels, 62 classes
    (FederatedEMNIST/data_loader.py:46-49; note the reference benchmark's
    200-client LR row is a different config from the 3400-client CNN row)."""
    train = _load_clientkeyed(
        Path(data_dir) / "fed_emnist_train.h5", {"x": "pixels", "y": "label"}, limit_clients
    )
    test = _load_clientkeyed(
        Path(data_dir) / "fed_emnist_test.h5", {"x": "pixels", "y": "label"}, limit_clients
    )
    return train, dict(test.arrays), test


def load_fed_cifar100(data_dir: str | Path, limit_clients: int | None = None):
    """fed_cifar100: 500 train / 100 test clients, 24x24 crops in the TFF
    pipeline (fed_cifar100/data_loader.py:105)."""
    train = _load_clientkeyed(
        Path(data_dir) / "fed_cifar100_train.h5", {"x": "image", "y": "label"}, limit_clients
    )
    test = _load_clientkeyed(
        Path(data_dir) / "fed_cifar100_test.h5", {"x": "image", "y": "label"}, limit_clients
    )
    train.arrays["x"] = train.arrays["x"].astype(np.float32) / 255.0
    test.arrays["x"] = test.arrays["x"].astype(np.float32) / 255.0
    return train, dict(test.arrays), test


def load_fed_shakespeare(
    data_dir: str | Path, seq_len: int = 80, limit_clients: int | None = None
):
    """fed_shakespeare: snippets per client -> (x, y) shifted char windows
    (fed_shakespeare/data_loader.py:110 + utils preprocessing)."""
    from fedml_tpu_torch.data.leaf import word_to_indices

    h5py = _h5py()

    def _read(path):
        xs, ys, part, cursor = [], [], {}, 0
        with h5py.File(path, "r") as f:
            cids = sorted(f[_EXAMPLE].keys())
            if limit_clients:
                cids = cids[:limit_clients]
            for ci, cid in enumerate(cids):
                snippets = f[_EXAMPLE][cid]["snippets"][()]
                seqs, tgts = [], []
                for snip in snippets:
                    text = snip.decode("utf-8") if isinstance(snip, bytes) else str(snip)
                    idx = word_to_indices(text)
                    for s in range(0, max(len(idx) - 1, 1), seq_len):
                        window = idx[s : s + seq_len + 1]
                        if len(window) < 2:
                            continue
                        x = window[:-1]
                        y = window[1:]
                        pad = seq_len - len(x)
                        seqs.append(x + [0] * pad)
                        tgts.append(y + [0] * pad)
                if not seqs:
                    continue
                xs.append(np.asarray(seqs, np.int32))
                ys.append(np.asarray(tgts, np.int32))
                n = len(seqs)
                part[len(part)] = np.arange(cursor, cursor + n)
                cursor += n
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        mask = (y != 0).astype(np.float32)
        return FederatedArrays({"x": x, "y": y, "mask": mask}, part)

    train = _read(Path(data_dir) / "shakespeare_train.h5")
    test = _read(Path(data_dir) / "shakespeare_test.h5")
    return train, dict(test.arrays), test


def load_stackoverflow_nwp(
    data_dir: str | Path,
    vocab_size: int = 10000,
    seq_len: int = 20,
    limit_clients: int | None = 1000,
):
    """StackOverflow next-word: per-client token sequences, 10k vocab + pad(0)/
    bos/eos/oov specials (stackoverflow_nwp/data_loader.py + utils vocab dicts).
    ``limit_clients`` defaults small — the full 342k-client archive is huge."""
    h5py = _h5py()
    vocab_path = Path(data_dir) / "stackoverflow.word_count"
    word_id: dict[str, int] = {}
    if vocab_path.exists():
        with open(vocab_path) as fh:
            for line in fh:
                w = line.split()[0]
                if w not in word_id and len(word_id) < vocab_size:
                    word_id[w] = len(word_id)
    bos, eos, oov = vocab_size + 1, vocab_size + 2, vocab_size + 3

    def _tokenize(sentence: str):
        # known words occupy ids 1..vocab_size (0 = pad); OOV is already an
        # absolute special id — adding 1 to it would index past the
        # (vocab_size+4)-entry embedding and silently clamp
        toks = [word_id[w] + 1 if w in word_id else oov
                for w in sentence.split()]
        return [bos] + toks[: seq_len - 1] + [eos]

    def _read(path):
        xs, ys, part, cursor = [], [], {}, 0
        with h5py.File(path, "r") as f:
            cids = sorted(f[_EXAMPLE].keys())
            if limit_clients:
                cids = cids[:limit_clients]
            for cid in cids:
                toks = f[_EXAMPLE][cid]["tokens"][()]
                seqs, tgts = [], []
                for sent in toks:
                    text = sent.decode("utf-8") if isinstance(sent, bytes) else str(sent)
                    ids = _tokenize(text)
                    x = ids[:-1][:seq_len]
                    y = ids[1:][:seq_len]
                    pad = seq_len - len(x)
                    seqs.append(x + [0] * pad)
                    tgts.append(y + [0] * pad)
                if not seqs:
                    continue
                xs.append(np.asarray(seqs, np.int32))
                ys.append(np.asarray(tgts, np.int32))
                n = len(seqs)
                part[len(part)] = np.arange(cursor, cursor + n)
                cursor += n
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        mask = (y != 0).astype(np.float32)
        return FederatedArrays({"x": x, "y": y, "mask": mask}, part)

    train = _read(Path(data_dir) / "stackoverflow_train.h5")
    test = _read(Path(data_dir) / "stackoverflow_test.h5")
    return train, dict(test.arrays), test
