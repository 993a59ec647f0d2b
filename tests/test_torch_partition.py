"""The port's numpy copies against the JAX package's: the partitioners
(``fedml_tpu_torch/core/partition.py``), the fixture marker
(``data/fixture_util.py``), the CIFAR-10 fixture writer
(``exp/repro_cross_silo.py``) and the CIFAR loader (``data/cv.py``).

Tolerance: none. They are copies, so every partition, file and array is held
bitwise (byte-for-byte) equal to the reference's for the same inputs."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import numpy as np
import pytest

from fedml_tpu.core import partition as jpart
from fedml_tpu.data import cv as jcv
from fedml_tpu.data import fixture_util as jfix
from fedml_tpu.exp import repro_cross_silo as jrepro
from fedml_tpu_torch.core import partition as tpart
from fedml_tpu_torch.data import cv as tcv
from fedml_tpu_torch.data import fixture_util as tfix
from fedml_tpu_torch.exp import repro_cross_silo as trepro

LABELS = np.random.RandomState(1).randint(0, 10, 3000)


def _same_partition(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("method,alpha", [("homo", 0.5), ("hetero", 0.5), ("hetero", 0.05),
                                          ("dirichlet", 100.0), ("power-law", 0.5)])
def test_partition_bitwise(method, alpha, seed):
    _same_partition(tpart.partition(method, LABELS, 10, alpha, seed),
                    jpart.partition(method, LABELS, 10, alpha, seed))


def test_partition_pieces_bitwise(tmp_path):
    _same_partition(tpart.homo_partition(1001, 7, seed=3), jpart.homo_partition(1001, 7, seed=3))
    _same_partition(tpart.powerlaw_partition(LABELS, 20, alpha=2.0, seed=4),
                    jpart.powerlaw_partition(LABELS, 20, alpha=2.0, seed=4))
    segs = [[3, 1], [2], [0, 5]] * 40
    _same_partition(tpart.dirichlet_partition(segs, 4, 0.5, seed=2, task="segmentation"),
                    jpart.dirichlet_partition(segs, 4, 0.5, seed=2, task="segmentation"))
    # hetero-fix: a map written by the port reads back the same in both
    parts = tpart.partition("hetero", LABELS, 5, 0.5, 0)
    path = tmp_path / "net_dataidx_map.txt"
    tpart.write_net_dataidx_map(path, parts)
    _same_partition(tpart.partition("hetero-fix", LABELS, 5, dataidx_map_path=path),
                    jpart.partition("hetero-fix", LABELS, 5, dataidx_map_path=path))
    _same_partition(tpart.read_net_dataidx_map(path), parts)
    assert tpart.record_data_stats(LABELS, parts) == jpart.record_data_stats(LABELS, parts)
    with pytest.raises(ValueError, match="needs dataidx_map_path"):
        tpart.partition("hetero-fix", LABELS, 5)
    with pytest.raises(ValueError, match="unknown partition method"):
        tpart.partition("nope", LABELS, 5)


def test_fixture_util_matches(tmp_path):
    """The same sequence of prepare() calls leaves the same files and
    returns the same decisions in both packages."""
    outs = []
    for mod, d in ((jfix, tmp_path / "j"), (tfix, tmp_path / "t")):
        d.mkdir()
        decisions = [mod.prepare(d, "cifar10", {"n": 1}, ["a"])]
        (d / "a").write_text("data")
        decisions += [mod.prepare(d, "cifar10", {"n": 1}, ["a"]),   # current: reuse
                      mod.prepare(d, "cifar10", {"n": 2}, ["a"]),   # stale: regenerate
                      mod.is_fixture(d, "cifar10"), mod.is_fixture(d, "cifar100")]
        (d / "real").mkdir()
        (d / "real" / "a").write_text("real")
        decisions.append(mod.prepare(d / "real", "cifar10", {"n": 1}, ["a"]))  # real: keep
        files = {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}
        outs.append((decisions, files))
    assert outs[0] == outs[1]
    assert tfix.marker_path(tmp_path, "x") == jfix.marker_path(tmp_path, "x")


def _tiny_fixture(write, d):
    return write(d, n_train=500, n_test=100, seed=3, signal=0.5)


def test_cifar10_fixture_files_byte_equal(tmp_path):
    j = _tiny_fixture(jrepro.write_cifar10_fixture, tmp_path / "j")
    t = _tiny_fixture(trepro.write_cifar10_fixture, tmp_path / "t")
    names = sorted(p.name for p in j.iterdir())
    assert names == sorted(p.name for p in t.iterdir()) == [
        "data_batch_1", "data_batch_2", "data_batch_3", "data_batch_4", "data_batch_5",
        "test_batch"]
    for name in names:
        assert (t / name).read_bytes() == (j / name).read_bytes(), name
    assert (tfix.marker_path(tmp_path / "t", "cifar10").read_bytes()
            == jfix.marker_path(tmp_path / "j", "cifar10").read_bytes())
    # a second call with the same config reuses the files
    assert _tiny_fixture(trepro.write_cifar10_fixture, tmp_path / "t") == t


@pytest.mark.parametrize("method", ["hetero", "homo"])
def test_load_cifar_bitwise(tmp_path, method):
    _tiny_fixture(jrepro.write_cifar10_fixture, tmp_path)
    j_train, j_test, j_nc = jcv.load_cifar("cifar10", tmp_path, method, 0.5, 5, 2,
                                           allow_synthetic=False)
    t_train, t_test, t_nc = tcv.load_cifar("cifar10", tmp_path, method, 0.5, 5, 2,
                                           allow_synthetic=False)
    assert t_nc == j_nc == 10
    assert t_train.arrays["x"].shape == (500, 32, 32, 3)
    assert t_train.arrays["x"].dtype == np.float32
    for k in ("x", "y"):
        np.testing.assert_array_equal(t_train.arrays[k], j_train.arrays[k])
        assert t_train.arrays[k].dtype == j_train.arrays[k].dtype
        np.testing.assert_array_equal(t_test[k], j_test[k])
    _same_partition(t_train.partition, j_train.partition)
    with pytest.raises(FileNotFoundError):
        tcv.load_cifar("cifar10", tmp_path / "missing", allow_synthetic=False)
