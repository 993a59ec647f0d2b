"""The port's numpy data modules (fedml_tpu_torch.data: synthetic, leaf,
leaf_fixture, registry; algorithms.fedprox.straggler_epochs) against the
JAX package's. They are copies, so every array, partition and file is held
bitwise equal for the same arguments and seed — the LEAF fixture's digits
come from the port's vendored ``digits.csv.gz`` (read with numpy), the JAX
writer's from scikit-learn."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fedml_tpu.algorithms.fedprox import straggler_epochs as jax_straggler_epochs
from fedml_tpu.data import leaf as jleaf
from fedml_tpu.data import registry as jregistry
from fedml_tpu.data import synthetic as jsynthetic
from fedml_tpu.data.leaf_fixture import write_leaf_mnist_fixture as jax_write_fixture
from fedml_tpu_torch.algorithms.fedprox import straggler_epochs
from fedml_tpu_torch.data import leaf, registry, synthetic
from fedml_tpu_torch.data.leaf_fixture import write_leaf_mnist_fixture


def _same_fed(a, b):
    assert sorted(a.arrays) == sorted(b.arrays)
    for k in a.arrays:
        assert a.arrays[k].dtype == b.arrays[k].dtype, k
        np.testing.assert_array_equal(a.arrays[k], b.arrays[k], err_msg=k)
    assert sorted(a.partition) == sorted(b.partition)
    for c in a.partition:
        np.testing.assert_array_equal(a.partition[c], b.partition[c])


def _same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kwargs", [
    dict(n_clients=5, seed=1),
    dict(n_clients=4, alpha=0.5, beta=0.5, seed=2),
    dict(n_clients=6, size_dist="lognormal", seed=3),
])
def test_synthetic_classification_bitwise(kwargs):
    (a, ta), (b, tb) = (synthetic.synthetic_classification(**kwargs),
                        jsynthetic.synthetic_classification(**kwargs))
    _same_fed(a, b)
    _same_arrays(ta, tb)


@pytest.mark.parametrize("method", ["homo", "hetero"])
def test_gaussian_blobs_bitwise(method):
    kw = dict(n_clients=6, samples_per_client=20, partition_method=method, seed=4)
    (a, ta), (b, tb) = synthetic.gaussian_blobs(**kw), jsynthetic.gaussian_blobs(**kw)
    _same_fed(a, b)
    _same_arrays(ta, tb)


def test_synthetic_leaf_mnist_bitwise():
    for got, want in zip(leaf.synthetic_leaf_mnist(n_clients=7, seed=5),
                         jleaf.synthetic_leaf_mnist(n_clients=7, seed=5)):
        if isinstance(got, dict):
            _same_arrays(got, want)
        else:
            _same_fed(got, want)


def test_leaf_fixture_files_bitwise_and_reader(tmp_path):
    port = write_leaf_mnist_fixture(tmp_path / "port", n_clients=12, seed=3)
    ref = jax_write_fixture(tmp_path / "jax", n_clients=12, seed=3)
    names = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(port) for p in port.rglob("*") if p.is_file())
    for name in names:
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    blob = json.loads(next((port / "train").glob("*.json")).read_text())
    assert set(blob) == {"users", "num_samples", "user_data"} and len(blob["users"]) == 12
    # idempotent: a second call keeps the files
    stamp = next((port / "train").glob("*.json")).stat().st_mtime_ns
    write_leaf_mnist_fixture(tmp_path / "port", n_clients=12, seed=3)
    assert next((port / "train").glob("*.json")).stat().st_mtime_ns == stamp
    got = leaf.load_leaf_classification(port / "train", port / "test")
    want = jleaf.load_leaf_classification(port / "train", port / "test")
    _same_fed(got[0], want[0])
    _same_arrays(got[1], want[1])
    _same_fed(got[2], want[2])


def test_leaf_shakespeare_reader_bitwise(tmp_path):
    for split, users in (("train", {"a": 3, "b": 2}), ("test", {"a": 1, "b": 1})):
        d = tmp_path / split
        d.mkdir()
        text = "To be, or not to be, that is the question: whether 'tis nobler"
        blob = {"users": list(users), "num_samples": list(users.values()), "user_data": {
            u: {"x": [text[i:i + 20] for i in range(n)], "y": [text[i + 20] for i in range(n)]}
            for u, n in users.items()}}
        (d / "all.json").write_text(json.dumps(blob))
    got = leaf.load_leaf_shakespeare(tmp_path / "train", tmp_path / "test", seq_len=24)
    want = jleaf.load_leaf_shakespeare(tmp_path / "train", tmp_path / "test", seq_len=24)
    _same_fed(got[0], want[0])
    _same_arrays(got[1], want[1])
    assert leaf.word_to_indices("Ab z") == jleaf.word_to_indices("Ab z")


PORTED = ["cifar10", "cifar100", "cinic10", "mnist", "femnist", "shakespeare",
          "fed_shakespeare", "fed_cifar100", "stackoverflow_nwp", "stackoverflow_lr",
          "synthetic", "synthetic_0.5_0.5"]


@pytest.mark.parametrize("dataset", PORTED)
def test_load_partition_data_bitwise(tmp_path, dataset):
    kw = dict(data_dir=str(tmp_path / "none"), partition_method="hetero",
              partition_alpha=0.5, client_num_in_total=4, seed=2)
    got = registry.load_partition_data(dataset, **kw)
    want = jregistry.load_partition_data(dataset, **kw)
    assert (got.class_num, got.name) == (want.class_num, want.name)
    _same_fed(got.train, want.train)
    _same_arrays(got.test_arrays, want.test_arrays)
    assert (got.test_fed is None) == (want.test_fed is None)
    if got.test_fed is not None:
        _same_fed(got.test_fed, want.test_fed)
    legacy, jlegacy = got.as_legacy_tuple(8), want.as_legacy_tuple(8)
    assert legacy[0] == jlegacy[0] and legacy[1] == jlegacy[1] and legacy[4] == jlegacy[4]
    assert legacy[7] == jlegacy[7]
    for (x, y), (jx, jy) in zip(legacy[5][0], jlegacy[5][0]):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_load_partition_data_leaf_mnist_files(tmp_path):
    write_leaf_mnist_fixture(tmp_path / "mnist", n_clients=5, seed=1)
    got = registry.load_partition_data("mnist", str(tmp_path / "mnist"))
    want = jregistry.load_partition_data("mnist", str(tmp_path / "mnist"))
    _same_fed(got.train, want.train)
    _same_fed(got.test_fed, want.test_fed)
    assert got.train.num_clients == 5


_H5_BRANCHES = (("femnist", "fed_emnist_train.h5"), ("fed_cifar100", "fed_cifar100_train.h5"),
                ("stackoverflow_nwp", "stackoverflow_train.h5"),
                ("stackoverflow_lr", "stackoverflow_train.h5"),
                ("fed_shakespeare", "shakespeare_train.h5"))


def test_known_datasets_and_unported_branches(tmp_path):
    """The JAX dispatch's names; each h5 branch reads its files when they
    are present (a file that is no h5 archive fails in h5py, the same
    error the JAX registry meets) and never stands synthetic data in for
    them, nor without h5py (a process where it cannot be imported:
    ``RuntimeError``); the synthetic fallbacks otherwise (here ImageNet's
    and the landmarks')."""
    assert registry.KNOWN_DATASETS == jregistry.KNOWN_DATASETS
    files = {}
    for dataset, name in _H5_BRANCHES:
        d = tmp_path / dataset
        d.mkdir()
        (d / name).write_bytes(b"not an h5 archive")
        if dataset == "stackoverflow_lr":
            (d / "stackoverflow_test.h5").write_bytes(b"not an h5 archive")
            (d / "stackoverflow.word_count").write_text("a 1\n")
            (d / "stackoverflow.tag_count").write_text('{"t": 1}')
        files[dataset] = str(d)
        for reg in (registry, jregistry):
            with pytest.raises(OSError):
                reg.load_partition_data(dataset, str(d))
    code = ("import sys\n"
            "class _Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] == 'h5py':\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, _Block())\n"
            "from fedml_tpu_torch.data import registry\n"
            f"for dataset, d in {sorted(files.items())!r}:\n"
            "    try:\n"
            "        registry.load_partition_data(dataset, d)\n"
            "    except RuntimeError as e:\n"
            "        assert 'h5py' in str(e), e\n"
            "    else:\n"
            "        raise SystemExit(dataset + ' fell back to synthetic data')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).parents[1],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    # ImageNet and the landmarks sets load the JAX registry's fallbacks
    for dataset in ("imagenet", "gld23k"):
        got = registry.load_partition_data(dataset, str(tmp_path / "none"))
        want = jregistry.load_partition_data(dataset, str(tmp_path / "none"))
        _same_fed(got.train, want.train)
        assert got.class_num == want.class_num
        for k in want.test_arrays:
            np.testing.assert_array_equal(got.test_arrays[k], want.test_arrays[k])
    with pytest.raises(ValueError, match="unknown dataset"):
        registry.load_partition_data("nope")


@pytest.mark.parametrize("round_idx,cohort,epochs,frac,seed", [
    (0, 10, 2, 0.5, 0), (3, 7, 5, 0.3, 1), (9, 16, 1, 0.9, 2), (4, 5, 3, 0.0, 0)])
def test_straggler_epochs_bitwise(round_idx, cohort, epochs, frac, seed):
    got = straggler_epochs(round_idx, cohort, epochs, frac, seed)
    want = jax_straggler_epochs(round_idx, cohort, epochs, frac, seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
