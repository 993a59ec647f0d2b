"""Dataset registry, the port of ``fedml_tpu/data/registry.py``: the
reference's 8-tuple loader contract (:meth:`FedDataset.as_legacy_tuple`) and
the dataset-name dispatch of :func:`load_partition_data`.

Ported: ``cifar10``, ``cifar100`` and ``cinic10`` (``data/cv.py``),
``mnist`` (LEAF JSON when present, the ``synthetic_leaf_mnist`` fixture
otherwise), ``shakespeare`` (LEAF JSON), the TFF h5 sets ``femnist``,
``fed_cifar100``, ``fed_shakespeare``, ``stackoverflow_nwp``
(``data/tff_h5.py``) and ``stackoverflow_lr`` (``data/stackoverflow.py``),
each on its synthetic fallback without its files, and
``synthetic[_alpha_beta]``. An h5 branch whose files are present reads them
with h5py, imported then; without h5py (the card's machine) it raises,
never falling through to synthetic data. ImageNet
(``imagenet``/``ILSVRC2012``) and the landmarks sets (``gld23k``,
``gld160k``, ``landmarks``) read image trees with Pillow when both are
there (``data/vision_fed.py``), else use their synthetic fixtures. The
synthetic fixtures are copies of the JAX package's, bitwise equal for the
same arguments.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import numpy as np

from fedml_tpu_torch.sim.cohort import FederatedArrays


@dataclasses.dataclass
class FedDataset:
    train: FederatedArrays
    test_arrays: dict[str, np.ndarray]
    class_num: int
    test_fed: FederatedArrays | None = None
    name: str = ""

    def as_legacy_tuple(self, batch_size: int):
        """The reference 8-tuple (SURVEY §2.5)."""
        train_num = self.train.num_samples
        test_num = len(self.test_arrays["y"])
        train_global = _batches(self.train.arrays, batch_size)
        test_global = _batches(self.test_arrays, batch_size)
        local_num = {i: len(self.train.partition[i]) for i in range(self.train.num_clients)}
        train_local = {
            i: _batches(_take(self.train.arrays, self.train.partition[i]), batch_size)
            for i in range(self.train.num_clients)
        }
        if self.test_fed is not None:
            test_local = {
                i: _batches(_take(self.test_fed.arrays, self.test_fed.partition[i]), batch_size)
                for i in range(self.test_fed.num_clients)
            }
        else:
            test_local = {i: test_global for i in range(self.train.num_clients)}
        return (
            train_num,
            test_num,
            train_global,
            test_global,
            local_num,
            train_local,
            test_local,
            self.class_num,
        )


def _take(arrays, idxs):
    return {k: v[idxs] for k, v in arrays.items()}


def _batches(arrays, batch_size):
    n = len(arrays["y"])
    out = []
    for s in range(0, n, batch_size):
        out.append((arrays["x"][s : s + batch_size], arrays["y"][s : s + batch_size]))
    return out


# every name of the JAX registry's dispatch ("synthetic" matches by prefix)
KNOWN_DATASETS = (
    "cifar10", "cifar100", "cinic10", "mnist", "shakespeare",
    "fed_shakespeare", "femnist", "fed_cifar100", "stackoverflow_nwp",
    "stackoverflow_lr", "ILSVRC2012", "ILSVRC2012_hdf5", "imagenet",
    "gld23k", "gld160k", "landmarks", "synthetic",
)

def _h5_needs_reader(dataset: str, files: list[Path]) -> None:
    """Raise when the real files of an h5-backed branch are present but
    h5py is not: synthetic data must not stand in for them."""
    present = [str(f) for f in files if f.exists()]
    if present:
        from fedml_tpu_torch.data.tff_h5 import _h5py

        try:
            _h5py()
        except RuntimeError as e:
            raise RuntimeError(f"{dataset}: real files {present} are present but "
                               "h5py, their reader, is not installed") from e


def load_partition_data(
    dataset: str,
    data_dir: str | None = None,
    partition_method: str = "hetero",
    partition_alpha: float = 0.5,
    client_num_in_total: int = 10,
    seed: int = 0,
    image_size: int | None = None,
    limit_per_class: int | None = None,
    dataidx_map_path: str | None = None,
) -> FedDataset:
    """Dataset-name dispatch matching the reference experiment scripts'
    ``load_data`` (main_fedavg.py:133-351). Falls back to hermetic synthetic
    fixtures when real files are absent. ``image_size`` / ``limit_per_class``
    cap the in-memory decode for the large vision datasets (and
    ``limit_per_class`` CINIC-10's)."""
    data_dir = data_dir or f"./data/{dataset}"

    if dataset in ("cifar10", "cifar100", "cinic10"):
        from fedml_tpu_torch.data.cv import load_cifar

        train, test, class_num = load_cifar(
            dataset, data_dir, partition_method, partition_alpha, client_num_in_total,
            seed, dataidx_map_path=dataidx_map_path, limit_per_class=limit_per_class,
        )
        return FedDataset(train, test, class_num, name=dataset)

    if dataset == "mnist":
        from fedml_tpu_torch.data import leaf

        tdir, edir = Path(data_dir) / "train", Path(data_dir) / "test"
        if tdir.is_dir() and any(tdir.glob("*.json")):
            train, test, test_fed = leaf.load_leaf_classification(tdir, edir)
        else:
            logging.warning("mnist: LEAF files absent; using synthetic fixture")
            train, test, test_fed = leaf.synthetic_leaf_mnist(n_clients=client_num_in_total,
                                                              seed=seed)
        return FedDataset(train, test, 10, test_fed, name=dataset)

    if dataset in ("shakespeare", "fed_shakespeare"):
        from fedml_tpu_torch.data import leaf, tff_h5

        if dataset == "fed_shakespeare" and (Path(data_dir) / "shakespeare_train.h5").exists():
            train, test, test_fed = tff_h5.load_fed_shakespeare(data_dir)
        elif (Path(data_dir) / "train").is_dir():
            train, test, test_fed = leaf.load_leaf_shakespeare(
                Path(data_dir) / "train", Path(data_dir) / "test"
            )
        else:
            logging.warning("%s: files absent; using synthetic char-LM fixture", dataset)
            train, test, test_fed = synthetic_char_lm(n_clients=client_num_in_total, seed=seed)
        return FedDataset(train, test, 90, test_fed, name=dataset)

    if dataset == "femnist":
        from fedml_tpu_torch.data import tff_h5

        if (Path(data_dir) / "fed_emnist_train.h5").exists():
            train, test, test_fed = tff_h5.load_federated_emnist(data_dir)
        else:
            from fedml_tpu_torch.data import leaf

            logging.warning("femnist: h5 absent; using synthetic fixture")
            train, test, test_fed = leaf.synthetic_leaf_mnist(n_clients=client_num_in_total,
                                                              seed=seed)
        return FedDataset(train, test, 62, test_fed, name=dataset)

    if dataset == "fed_cifar100":
        from fedml_tpu_torch.data import tff_h5

        if (Path(data_dir) / "fed_cifar100_train.h5").exists():
            train, test, test_fed = tff_h5.load_fed_cifar100(data_dir)
            return FedDataset(train, test, 100, test_fed, name=dataset)
        from fedml_tpu_torch.data.cv import load_cifar

        logging.warning("fed_cifar100: h5 absent; using synthetic cifar-like fixture")
        train, test, class_num = load_cifar(
            "cifar100", data_dir, partition_method, partition_alpha, client_num_in_total, seed
        )
        return FedDataset(train, test, class_num, name=dataset)

    if dataset == "stackoverflow_nwp":
        from fedml_tpu_torch.data import tff_h5

        if (Path(data_dir) / "stackoverflow_train.h5").exists():
            train, test, test_fed = tff_h5.load_stackoverflow_nwp(data_dir)
        else:
            logging.warning("stackoverflow_nwp: h5 absent; using synthetic fixture")
            train, test, test_fed = synthetic_char_lm(
                n_clients=client_num_in_total, vocab=10004, seq_len=20, seed=seed
            )
        return FedDataset(train, test, 10004, test_fed, name=dataset)

    if dataset == "stackoverflow_lr":
        from fedml_tpu_torch.data import stackoverflow

        if stackoverflow.has_real_files(data_dir):
            train, test, test_fed, output_dim = stackoverflow.load_stackoverflow_lr(
                data_dir, limit_clients=client_num_in_total or None
            )
            return FedDataset(train, test, output_dim, test_fed, name=dataset)
        # has_real_files is False without h5py: refuse rather than fall back
        _h5_needs_reader(dataset, [Path(data_dir) / stackoverflow.TRAIN_FILE,
                                   Path(data_dir) / stackoverflow.TEST_FILE])
        logging.warning("stackoverflow_lr: h5/vocab files absent; using synthetic fixture")
        train, test, test_fed = synthetic_tag_prediction(n_clients=client_num_in_total,
                                                         seed=seed)
        return FedDataset(train, test, 500, test_fed, name=dataset)

    if dataset in ("ILSVRC2012", "ILSVRC2012_hdf5", "imagenet"):
        from fedml_tpu_torch.data import vision_fed

        if (vision_fed.HAS_PIL and (Path(data_dir) / "train").is_dir()
                and (Path(data_dir) / "val").is_dir()):
            train, test, class_num = vision_fed.load_imagenet(
                data_dir, client_number=client_num_in_total,
                image_size=image_size or 224, limit_per_class=limit_per_class,
            )
        else:
            logging.warning("imagenet: %s/train absent (or Pillow missing); "
                            "using synthetic fixture", data_dir)
            train, test, class_num = vision_fed.synthetic_imagenet(
                client_number=client_num_in_total, seed=seed
            )
        return FedDataset(train, test, class_num, name=dataset)

    if dataset in ("gld23k", "gld160k", "landmarks"):
        from fedml_tpu_torch.data import vision_fed

        size = "gld160k" if dataset == "gld160k" else "gld23k"
        train_csv = Path(data_dir) / "data_user_dict" / f"{size}_user_dict_train.csv"
        test_csv = Path(data_dir) / "data_user_dict" / f"{size}_user_dict_test.csv"
        if vision_fed.HAS_PIL and train_csv.exists() and test_csv.exists():
            train, test, class_num = vision_fed.load_landmarks(
                Path(data_dir) / "images", train_csv, test_csv,
                image_size=image_size or 224,
            )
        else:
            logging.warning("%s: mapping csvs absent (or Pillow missing); "
                            "using synthetic fixture", dataset)
            train, test, class_num = vision_fed.synthetic_landmarks(
                n_clients=client_num_in_total, seed=seed
            )
        return FedDataset(train, test, class_num, name=dataset)

    if dataset.startswith("synthetic"):
        from fedml_tpu_torch.data.synthetic import synthetic_classification

        # "synthetic_0.5_0.5" -> alpha=0.5, beta=0.5 (LEAF family)
        parts = dataset.split("_")
        alpha = float(parts[1]) if len(parts) > 1 else 0.0
        beta = float(parts[2]) if len(parts) > 2 else 0.0
        train, test = synthetic_classification(
            n_clients=client_num_in_total, alpha=alpha, beta=beta, seed=seed
        )
        return FedDataset(train, test, 10, name=dataset)

    raise ValueError(f"unknown dataset {dataset!r}")


def _markov_step(rng, trans, state):
    """Each chain's next state, the draws of ``[rng.choice(len(p), p=p) for
    p in trans[state]]`` (one uniform a chain, in order, against the row's
    normalised cumulative sum) made at once."""
    cdf = np.cumsum(trans[state], axis=1)
    cdf /= cdf[:, -1:]
    u = rng.random_sample(len(state))
    return np.sum(cdf <= u[:, None], axis=1)


def synthetic_char_lm(
    n_clients: int = 10, vocab: int = 90, seq_len: int = 20, samples: int = 30, seed: int = 0
):
    """Markov-chain char-LM fixture with per-token masks."""
    rng = np.random.RandomState(seed)
    trans = rng.dirichlet(np.ones(vocab) * 0.05, size=vocab)

    def _make(n_per_client):
        xs, ys, part, cursor = [], [], {}, 0
        for ci in range(n_clients):
            seqs = np.zeros((n_per_client, seq_len + 1), np.int32)
            state = rng.randint(1, vocab, n_per_client)
            seqs[:, 0] = state
            for t in range(1, seq_len + 1):
                state = _markov_step(rng, trans, state)
                seqs[:, t] = state
            xs.append(seqs[:, :-1])
            ys.append(seqs[:, 1:])
            part[ci] = np.arange(cursor, cursor + n_per_client)
            cursor += n_per_client
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        return FederatedArrays(
            {"x": x, "y": y, "mask": np.ones_like(y, np.float32)}, part
        )

    train = _make(samples)
    test_fed = _make(max(samples // 5, 2))
    return train, dict(test_fed.arrays), test_fed


def synthetic_tag_prediction(
    n_clients: int = 10, dim: int = 1000, tags: int = 500, samples: int = 40, seed: int = 0
):
    """stackoverflow_lr-style fixture: bag-of-words x, multi-hot tag y."""
    rng = np.random.RandomState(seed)
    proj = (rng.rand(dim, tags) < 0.01).astype(np.float32)

    def _make(n_per):
        xs, ys, part, cursor = [], [], {}, 0
        for ci in range(n_clients):
            x = (rng.rand(n_per, dim) < 0.02).astype(np.float32)
            y = (x @ proj > 0.5).astype(np.float32)
            xs.append(x)
            ys.append(y)
            part[ci] = np.arange(cursor, cursor + n_per)
            cursor += n_per
        return FederatedArrays({"x": np.concatenate(xs), "y": np.concatenate(ys)}, part)

    train = _make(samples)
    test_fed = _make(max(samples // 5, 2))
    return train, dict(test_fed.arrays), test_fed
