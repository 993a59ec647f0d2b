"""FedNAS's local search and entry point (``fedml_tpu_torch/algorithms/fednas.py``
``local_search``, ``fedml_tpu_torch/exp/main_fednas.py``) against the JAX
package, from the JAX variables converted and the same numpy-made batches
as ``tests/test_torch_fednas.py`` (whose helpers and fixtures these are; the
file was split from it for the tier-1 suite's time). Each JAX reference is
computed once, in a module-scoped fixture.

Tolerances, fixed before the first run:
- ``local_search`` of 2 steps x 2 epochs: atol 1e-4 on weights, α, BN
  statistics and losses;
- ``main_fednas --device cpu`` (synthetic_cv, 2 clients, 1 round) against
  the JAX CLI from the same initial variables: ``Train/Loss`` atol 1e-4 and
  the same ``genotype_normal``."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse
import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.exp import main_fednas as jmain
from fedml_tpu.models import darts as jdarts
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fednas
from fedml_tpu_torch.exp import main_fednas
from tests.test_torch_fednas import (_jax_trainer, _max_err, _np, _port_trainer,  # noqa: F401
                                     _torch_batch, batches, init)


@pytest.fixture(scope="module")
def local_search_ref(init, batches):
    tr = _jax_trainer(epochs=2)
    b = jax.tree.map(jnp.asarray, batches)
    out, m = jax.jit(tr.local_search)(init, b, b, jax.random.key(1))
    return _np(out), float(m["train_loss"])


def test_local_search_matches_jax(local_search_ref, init, batches):
    want, want_loss = local_search_ref
    tr = _port_trainer(epochs=2)
    b = _torch_batch(batches)
    got, m = tr.local_search(convert.from_flax(init), b, b)
    assert _max_err(got, want) <= 1e-4
    assert abs(float(m["train_loss"]) - want_loss) <= 1e-4


@pytest.fixture(scope="module")
def jax_cli():
    """The JAX CLI at its defaults (synthetic_cv, 2 clients) for 1 round, and
    its initial variables (the CLI's init, recomputed)."""
    out = jmain.main(["--client_number", "2", "--comm_round", "1"])
    net = jdarts.DARTSNetwork(num_classes=4, channels=4, layers=2, steps=2)
    v = _np(net.init({"params": jax.random.key(0)}, jnp.zeros((8, 8, 8, 3)), train=False))
    return out, convert.from_flax(v)


def test_main_fednas_matches_jax_cli(jax_cli, monkeypatch):
    want, init_sd = jax_cli
    monkeypatch.setattr(fednas.FedNASTrainer, "init",
                        lambda self, generator: {k: v.clone() for k, v in init_sd.items()})
    got = main_fednas.main(["--client_number", "2", "--comm_round", "1", "--device", "cpu"])
    assert set(got) == set(want) | {"round_time"}
    assert got["round"] == want["round"] == 0
    assert abs(got["Train/Loss"] - want["Train/Loss"]) <= 1e-4
    assert got["genotype_normal"] == want["genotype_normal"]
    assert got["round_time"] > 0


def test_main_fednas_gdas_runs():
    """gdas through the CLI: a finite loss and a decoded genotype (its noise
    streams differ from JAX's, so it is not held to the JAX CLI)."""
    out = main_fednas.main(["--client_number", "2", "--comm_round", "1", "--device", "cpu",
                            "--search_mode", "gdas", "--tau", "2.0"])
    assert np.isfinite(out["Train/Loss"])
    assert len(ast.literal_eval(out["genotype_normal"])) == 4


def test_main_fednas_cifar10_data_matches_jax_registry(tmp_path):
    """Any dataset but synthetic_cv comes from the registry with hetero
    alpha 0.5: the CIFAR-10 fallback (2,000 images) partitions as in the JAX
    package."""
    from fedml_tpu.data import load_partition_data

    args = main_fednas.add_args(argparse.ArgumentParser()).parse_args(
        ["--dataset", "cifar10", "--data_dir", str(tmp_path), "--client_number", "4"])
    train, classes = main_fednas._load(args)
    want = load_partition_data("cifar10", str(tmp_path), "hetero", 0.5, 4, 0)
    assert classes == want.class_num == 10 and train.num_samples == 2000
    for c in range(4):
        np.testing.assert_array_equal(train.partition[c], want.train.partition[c])
    np.testing.assert_array_equal(train.arrays["x"], want.train.arrays["x"])


def test_main_fednas_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="cuda"):
        main_fednas.main(["--client_number", "2", "--comm_round", "1"])
