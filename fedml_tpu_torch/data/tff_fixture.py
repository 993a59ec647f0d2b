"""TFF-format h5 fixtures for offline BASELINE reproduction, a copy of
``fedml_tpu/data/tff_fixture.py`` that writes files holding bitwise-equal
datasets for the same arguments (h5py imported by each writer).

The reference's shallow-NN benchmark row (benchmark/README.md:51-58;
BASELINE.md) runs FederatedEMNIST: 3400 natural writer-clients, CNN
(2 conv + 2 FC, CNN_DropOut), 10 clients/round, B=20, SGD lr=0.1 → test acc
84.9 beyond ~1500 rounds.

Without network access the real fed_emnist h5 archives
(FederatedEMNIST/data_loader.py:22 ``examples/<client>/pixels|label``) cannot
be fetched. This generator writes the SAME on-disk schema from the real
handwriting available offline: scikit-learn's 1797 genuine digits (vendored,
``data/leaf_fixture.py``). Each client is a simulated *writer* with a
persistent style (fixed stroke shift, contrast, and noise level — the
natural-heterogeneity axis real FEMNIST has), drawing samples across all 10
digit classes. It is NOT the 62-class EMNIST. The fed_cifar100 and
StackOverflow next-word writers follow.

The fixtures exercise the real ingestion path end to end:
registry "femnist" -> tff_h5.load_federated_emnist -> FederatedArrays.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fedml_tpu_torch.data.leaf_fixture import _digit_pools


def _writer_samples(pools, n, rng):
    """n samples from one simulated writer: same-class pair blending plus a
    persistent per-writer style (shift/contrast/noise drawn once)."""
    dx, dy = rng.randint(-2, 3, 2)
    contrast = 0.7 + 0.6 * rng.rand()
    noise = 0.02 + 0.06 * rng.rand()
    ys = rng.randint(0, 10, n).astype(np.int32)
    xs = np.empty((n, 28, 28), np.float32)
    for c in range(10):
        idx = np.where(ys == c)[0]
        if not len(idx):
            continue
        pool = pools[c]
        a = pool[rng.randint(len(pool), size=len(idx))]
        b = pool[rng.randint(len(pool), size=len(idx))]
        t = rng.rand(len(idx), 1, 1).astype(np.float32) * 0.5
        xs[idx] = (1 - t) * a + t * b
    xs = np.roll(np.roll(xs, dx, axis=1), dy, axis=2)
    xs = np.clip(contrast * xs + rng.normal(0, noise, xs.shape), 0.0, 1.0)
    return xs.astype(np.float32), ys


def write_femnist_h5_fixture(
    out_dir: str | Path,
    n_clients: int = 3400,
    seed: int = 0,
    min_samples: int = 10,
    max_samples: int = 200,
) -> Path:
    """Write fed_emnist_train.h5 / fed_emnist_test.h5; returns out_dir.

    Lognormal per-writer sample counts, 90/10 train/test split per writer.
    Idempotency, real-data preservation, and stale-config regeneration are
    the shared :mod:`fedml_tpu_torch.data.fixture_util` contract. Pixels stored
    float32 in [0, 1] like the real TFF archive.
    """
    import h5py

    from fedml_tpu_torch.data import fixture_util

    out = Path(out_dir)
    if not fixture_util.prepare(
        out, "femnist", {"n_clients": n_clients, "seed": seed},
        ["fed_emnist_train.h5", "fed_emnist_test.h5"],
    ):
        return out
    rng = np.random.RandomState(seed)
    pools = _digit_pools(seed)
    sizes = np.clip(
        np.exp(rng.normal(np.log(30.0), 0.8, n_clients)).astype(int),
        min_samples, max_samples,
    )
    tmp_train = out / "fed_emnist_train.h5.tmp"
    tmp_test = out / "fed_emnist_test.h5.tmp"
    with h5py.File(tmp_train, "w") as ftr, h5py.File(tmp_test, "w") as fte:
        gtr = ftr.create_group("examples")
        gte = fte.create_group("examples")
        for ci in range(n_clients):
            x, y = _writer_samples(pools, int(sizes[ci]), rng)
            n_test = max(1, len(y) // 10)
            cid = f"f{ci:05d}"
            for grp, sl in ((gtr, slice(n_test, None)), (gte, slice(0, n_test))):
                g = grp.create_group(cid)
                g.create_dataset("pixels", data=x[sl], compression="gzip")
                g.create_dataset("label", data=y[sl].astype(np.int64))
    # probe file (train) LAST: a crash between renames must leave a state
    # prepare() regenerates (probe missing), never a pinned half-fixture
    tmp_test.rename(out / "fed_emnist_test.h5")
    tmp_train.rename(out / "fed_emnist_train.h5")
    return out


def write_fed_cifar100_h5_fixture(
    out_dir: str | Path,
    n_train_clients: int = 500,
    n_test_clients: int = 100,
    samples_per_client: int = 100,
    seed: int = 0,
) -> Path:
    """Write fed_cifar100_{train,test}.h5 in the real TFF schema
    (``examples/<client>/image|label``, fed_cifar100/data_loader.py:105).

    Offline stand-in for GLD-downloaded archives: 100 class-blob RGB classes,
    per-client class skew drawn from a Dirichlet (the real archive's Pachinko
    allocation is also a per-client class-mixture; this keeps the non-IID
    shape without the LDA tree). NOT real CIFAR-100 — REPRO.md says so.
    Idempotency/real-data preservation follow the shared
    :mod:`fedml_tpu_torch.data.fixture_util` contract.
    """
    import h5py

    from fedml_tpu_torch.data import fixture_util

    out = Path(out_dir)
    if not fixture_util.prepare(
        out, "fed_cifar100",
        {"n_train_clients": n_train_clients, "n_test_clients": n_test_clients,
         "samples_per_client": samples_per_client, "seed": seed},
        ["fed_cifar100_train.h5", "fed_cifar100_test.h5"],
    ):
        return out
    rng = np.random.RandomState(seed)
    centers = rng.rand(100, 32, 32, 3).astype(np.float32)

    def client_samples(n):
        # per-client class mixture: a few dominant classes (non-IID)
        probs = rng.dirichlet(np.full(100, 0.1))
        ys = rng.choice(100, size=n, p=probs).astype(np.int64)
        xs = np.clip(centers[ys] + rng.normal(0, 0.25, (n, 32, 32, 3)), 0, 1)
        return (xs * 255).astype(np.uint8), ys

    tmp_train = out / "fed_cifar100_train.h5.tmp"
    tmp_test = out / "fed_cifar100_test.h5.tmp"
    with h5py.File(tmp_train, "w") as ftr, h5py.File(tmp_test, "w") as fte:
        gtr = ftr.create_group("examples")
        gte = fte.create_group("examples")
        for ci in range(n_train_clients):
            x, y = client_samples(samples_per_client)
            g = gtr.create_group(f"c{ci:05d}")
            g.create_dataset("image", data=x, compression="gzip")
            g.create_dataset("label", data=y)
        for ci in range(n_test_clients):
            x, y = client_samples(samples_per_client)
            g = gte.create_group(f"c{ci:05d}")
            g.create_dataset("image", data=x, compression="gzip")
            g.create_dataset("label", data=y)
    # probe file (train) LAST — see write_femnist_h5_fixture
    tmp_test.rename(out / "fed_cifar100_test.h5")
    tmp_train.rename(out / "fed_cifar100_train.h5")
    return out


# -- StackOverflow next-word-prediction fixture ------------------------------


def stackoverflow_markov_source(active_words: int = 500, seed: int = 0,
                                alpha: float = 0.002, clusters: int = 20):
    """The fixture's generating process: a CLUSTER-structured word-level
    Markov chain — each of the ``active_words`` states belongs to one of
    ``clusters`` word classes, and the next-word distribution depends only
    on the class of the current word (``clusters`` sparse
    Dirichlet(``alpha``) rows, shared across class members). Returns
    (transition matrix [A, A], stationary distribution [A]) — the analytic
    handle repro ceilings are computed from.

    The cluster structure is what makes the fixture LEARNABLE the way
    natural language is: an LSTM needs only the class identity of the
    current word plus ``clusters`` output distributions (a low-rank
    factorization), not a table of ``active_words`` unrelated rows — a
    structureless table at the same Bayes accuracy is pure memorization
    and no sequence model approaches its ceiling in bounded rounds.
    ``alpha`` controls how predictable transitions are; ``active_words``
    controls SAMPLE EFFICIENCY — how often each embedding row is visited.
    Round-4 ran A=2000/50 clusters: the task was learnable (Adam captures
    ~70% of the signal in 200 centralized steps) but the ROW'S plain-SGD
    lr=10^-0.5 recipe never left the eos floor in 1500 rounds — each of
    2000 embeddings was simply visited too rarely for un-adaptive SGD.
    A=500/20 keeps the same structure with 4x the visit rate; the recipe
    optimizer then captures >60% of the learnable signal within a few
    hundred effective steps — the profile real language gets from its Zipf
    head."""
    rng = np.random.RandomState(seed)
    class_rows = rng.dirichlet(
        np.ones(active_words) * alpha, size=clusters
    ).astype(np.float64)
    assign = rng.randint(0, clusters, active_words)
    trans = class_rows[assign]
    pi = np.full(active_words, 1.0 / active_words)
    for _ in range(200):  # power iteration to the stationary distribution
        nxt = pi @ trans
        if np.abs(nxt - pi).max() < 1e-12:
            pi = nxt
            break
        pi = nxt
    return trans, pi / pi.sum()


def stackoverflow_bayes_ceiling(active_words: int = 500, seed: int = 0,
                                sentence_len: int = 10,
                                alpha: float = 0.002,
                                clusters: int = 20) -> float:
    """Exact Bayes-optimal next-token accuracy of the fixture under the
    loader's tokenization: per sentence the model predicts bos->w1
    (optimum: argmax pi), sentence_len-1 interior transitions (optimum:
    argmax_j T[i, j]), and w_last->eos (deterministic — sentence length is
    fixed). No predictor can beat the average of those three terms. The
    matching NO-LEARNING floor is ``1 / (sentence_len + 1)`` — a model
    that only ever predicts eos gets exactly that — so results should be
    read as (acc - floor) / (ceiling - floor), the fraction of learnable
    signal captured."""
    trans, pi = stackoverflow_markov_source(active_words, seed, alpha, clusters)
    first = float(pi.max())
    interior = float(np.sum(pi * trans.max(axis=1)))
    return (first + (sentence_len - 1) * interior + 1.0) / (sentence_len + 1)


def write_stackoverflow_nwp_fixture(
    out_dir: str | Path,
    n_clients: int = 342_477,
    seed: int = 0,
    vocab_size: int = 10_000,
    active_words: int = 500,
    sentence_len: int = 10,
    min_sent: int = 2,
    max_sent: int = 64,
    test_clients: int = 10_000,
    alpha: float = 0.002,
    clusters: int = 20,
) -> Path:
    """Write stackoverflow_{train,test}.h5 + stackoverflow.word_count in the
    real TFF schema (``examples/<client>/tokens`` string sentences;
    stackoverflow_nwp/data_loader.py:96 + vocab dicts) at the row's full
    342,477-client population scale.

    Sentences are fixed-length word sequences from
    :func:`stackoverflow_markov_source` — a known generating process, so the
    row's attainable accuracy is the analytic
    :func:`stackoverflow_bayes_ceiling`. Only ``active_words`` of the 10k
    vocab ever occur (a Zipf-like head); per-client sentence counts are
    lognormal in [min_sent, max_sent] — population heterogeneity without
    per-client distribution shift. The first ``test_clients`` clients get a
    held-out test shard. Idempotency and real-data preservation follow the
    shared fixture_util contract.
    """
    import h5py

    from fedml_tpu_torch.data import fixture_util

    out = Path(out_dir)
    config = {
        "n_clients": n_clients, "seed": seed, "vocab_size": vocab_size,
        "active_words": active_words, "sentence_len": sentence_len,
        "min_sent": min_sent, "max_sent": max_sent,
        "test_clients": test_clients, "alpha": alpha,
        "clusters": clusters,
    }
    files = ["stackoverflow_train.h5", "stackoverflow_test.h5",
             "stackoverflow.word_count"]
    if not fixture_util.prepare(out, "stackoverflow_nwp", config, files):
        return out
    rng = np.random.RandomState(seed)
    trans, pi = stackoverflow_markov_source(active_words, seed, alpha, clusters)
    cum = np.cumsum(trans, axis=1).astype(np.float32)
    words = np.asarray([f"w{k}" for k in range(vocab_size)], dtype=object)

    sizes = np.clip(
        np.exp(rng.normal(np.log(6.0), 0.8, n_clients)).astype(int),
        min_sent, max_sent,
    )
    n_test_sent = 2  # held-out sentences per test-shard client

    def sample_sentences(n):
        """[n, sentence_len] Markov word-id sequences, vectorized."""
        toks = np.empty((n, sentence_len), np.int32)
        toks[:, 0] = rng.choice(active_words, size=n, p=pi)
        u = rng.rand(n, sentence_len - 1).astype(np.float32)
        for t in range(1, sentence_len):
            rows = cum[toks[:, t - 1]]
            # clamp BEFORE the next step's row indexing: float32 cumsum can
            # top out fractionally below u, yielding index == active_words
            toks[:, t] = np.minimum(
                (rows < u[:, t - 1 : t]).sum(axis=1), active_words - 1
            )
        return toks

    tmp_train = out / "stackoverflow_train.h5.tmp"
    tmp_test = out / "stackoverflow_test.h5.tmp"
    tmp_vocab = out / "stackoverflow.word_count.tmp"
    # vocab file: one "word count" line per word, most-frequent first — the
    # loader assigns ids by line order, so active words get ids 0..A-1
    with open(tmp_vocab, "w") as fh:
        for k in range(vocab_size):
            fh.write(f"w{k} {max(vocab_size - k, 1)}\n")
    chunk = 4096
    dt = h5py.string_dtype()
    with h5py.File(tmp_train, "w") as ftr, h5py.File(tmp_test, "w") as fte:
        gtr = ftr.create_group("examples")
        gte = fte.create_group("examples")
        for lo in range(0, n_clients, chunk):
            csizes = sizes[lo : lo + chunk]
            in_test = lo < test_clients
            extra = n_test_sent if in_test else 0
            total = int(csizes.sum()) + extra * len(csizes)
            toks = sample_sentences(total)
            sents = np.asarray(
                [" ".join(words[row]) for row in toks], dtype=object
            )
            cursor = 0
            for ci, sz in enumerate(csizes):
                cid = f"{lo + ci:08d}"
                take = int(sz) + (extra if (lo + ci) < test_clients else 0)
                mine = sents[cursor : cursor + take]
                cursor += take
                if (lo + ci) < test_clients:
                    gte.create_group(cid).create_dataset(
                        "tokens", data=list(mine[:n_test_sent]), dtype=dt
                    )
                    mine = mine[n_test_sent:]
                gtr.create_group(cid).create_dataset(
                    "tokens", data=list(mine), dtype=dt
                )
    # probe file (train) LAST — see write_femnist_h5_fixture
    tmp_vocab.rename(out / "stackoverflow.word_count")
    tmp_test.rename(out / "stackoverflow_test.h5")
    tmp_train.rename(out / "stackoverflow_train.h5")
    return out
