"""Real stackoverflow_lr pipeline: h5 client shards + vocab/tag dictionaries,
a copy of ``fedml_tpu/data/stackoverflow.py`` (the same arrays for the same
files; h5py imported when a split is read).

Reference: fedml_api/data_preprocessing/stackoverflow_lr/ — word/tag count
files define the 10k-word vocabulary and 500-tag label space
(utils.py:32-62), each example becomes a mean-of-one-hots bag of words over
the vocabulary (OOV column dropped, utils.py:119-125) and a multi-hot tag
vector (OOV tag dropped, utils.py:140-145); the h5 archives are client-keyed
(data_loader.py:25-75, ``examples/<client_id>/tokens|tags``).

Here the transform scatter-adds all of a client's tokens into its [n, vocab]
block with one np.add.at call per client (not one per sentence/token pair the
way the reference's per-example __getitem__ works).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from fedml_tpu_torch.sim.cohort import FederatedArrays

WORD_COUNT_FILE = "stackoverflow.word_count"
TAG_COUNT_FILE = "stackoverflow.tag_count"
TRAIN_FILE = "stackoverflow_train.h5"
TEST_FILE = "stackoverflow_test.h5"


def load_word_dict(data_dir: str | Path, vocab_size: int = 10000) -> dict[str, int]:
    """``stackoverflow.word_count``: one ``word count`` pair per line, already
    sorted by frequency (reference utils.py:32-36)."""
    out: dict[str, int] = {}
    with open(Path(data_dir) / WORD_COUNT_FILE) as f:
        for line in f:
            if len(out) >= vocab_size:
                break
            out[line.split()[0]] = len(out)
    return out


def load_tag_dict(data_dir: str | Path, tag_size: int = 500) -> dict[str, int]:
    """``stackoverflow.tag_count``: a JSON object whose key order is the
    frequency ranking (reference utils.py:39-42)."""
    with open(Path(data_dir) / TAG_COUNT_FILE) as f:
        tags = json.load(f)
    return {t: i for i, t in enumerate(list(tags.keys())[:tag_size])}


def sentences_to_bow(sentences: list[str], word_dict: dict[str, int]) -> np.ndarray:
    """Mean-of-one-hots over the vocabulary, OOV dropped — matches reference
    utils.preprocess_input (:119-125): each sentence's vector sums to
    (in-vocab tokens)/(all tokens). One scatter-add for the whole batch."""
    V = len(word_dict)
    rows, cols, wts = [], [], []
    for i, s in enumerate(sentences):
        toks = s.split(" ")
        w = 1.0 / len(toks)
        for t in toks:
            j = word_dict.get(t)
            if j is not None:
                rows.append(i)
                cols.append(j)
                wts.append(w)
    out = np.zeros((len(sentences), V), np.float32)
    if rows:
        np.add.at(out, (np.asarray(rows), np.asarray(cols)),
                  np.asarray(wts, np.float32))
    return out


def tags_to_multihot(tag_strs: list[str], tag_dict: dict[str, int]) -> np.ndarray:
    """Multi-hot over the tag space, OOV dropped (reference
    utils.preprocess_target :140-145; '|' separates tags)."""
    T = len(tag_dict)
    rows, cols = [], []
    for i, s in enumerate(tag_strs):
        for t in s.split("|"):
            j = tag_dict.get(t)
            if j is not None:
                rows.append(i)
                cols.append(j)
    out = np.zeros((len(tag_strs), T), np.float32)
    if rows:
        out[rows, cols] = 1.0
    return out


def _load_split(path: Path, word_dict, tag_dict,
                client_ids: list[str] | None = None,
                limit_clients: int | None = None):
    """``client_ids`` pins the client slot order (slot i = ids[i]); clients
    absent from this archive get an empty shard. Without it, all archive
    clients load in sorted order. Returns (FederatedArrays, ids used)."""
    import h5py

    V, T = len(word_dict), len(tag_dict)
    xs, ys, part, cursor = [], [], {}, 0
    with h5py.File(path, "r") as f:
        present = set(f["examples"].keys())
        if client_ids is None:
            client_ids = sorted(present)
            if limit_clients:
                client_ids = client_ids[:limit_clients]
        for ci, cid in enumerate(client_ids):
            if cid not in present:
                part[ci] = np.arange(0)
                continue
            grp = f["examples"][cid]
            sentences = [t.decode() if isinstance(t, bytes) else str(t)
                         for t in grp["tokens"][()]]
            tags = [t.decode() if isinstance(t, bytes) else str(t)
                    for t in grp["tags"][()]]
            xs.append(sentences_to_bow(sentences, word_dict))
            ys.append(tags_to_multihot(tags, tag_dict))
            part[ci] = np.arange(cursor, cursor + len(sentences))
            cursor += len(sentences)
    if not xs:
        xs, ys = [np.zeros((0, V), np.float32)], [np.zeros((0, T), np.float32)]
    fa = FederatedArrays({"x": np.concatenate(xs), "y": np.concatenate(ys)}, part)
    return fa, client_ids


def load_stackoverflow_lr(
    data_dir: str | Path,
    vocab_size: int = 10000,
    tag_size: int = 500,
    limit_clients: int | None = None,
):
    """Returns (train FederatedArrays, pooled test arrays, federated test,
    output_dim). ``limit_clients`` caps the 342k-client corpus for tractable
    simulations (the reference loads all clients into a pickle cache)."""
    d = Path(data_dir)
    word_dict = load_word_dict(d, vocab_size)
    tag_dict = load_tag_dict(d, tag_size)
    train, ids = _load_split(d / TRAIN_FILE, word_dict, tag_dict,
                             limit_clients=limit_clients)
    # pin test slots to the SAME client ids as train: per-client federated
    # eval must score client i's model on client i's own held-out questions
    # (the real test archive's client set is a subset of train's)
    test_fed, _ = _load_split(d / TEST_FILE, word_dict, tag_dict, client_ids=ids)
    logging.info(
        "stackoverflow_lr: %d train clients / %d samples, vocab %d, tags %d",
        train.num_clients, train.num_samples, len(word_dict), len(tag_dict),
    )
    return train, dict(test_fed.arrays), test_fed, len(tag_dict)


def has_real_files(data_dir: str | Path) -> bool:
    d = Path(data_dir)
    try:
        import h5py  # noqa: F401
    except Exception:  # pragma: no cover
        return False
    return all(
        (d / f).exists()
        for f in (TRAIN_FILE, TEST_FILE, WORD_COUNT_FILE, TAG_COUNT_FILE)
    )
