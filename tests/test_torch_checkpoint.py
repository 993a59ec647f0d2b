"""Parameter files and round checkpoints in the port
(``fedml_tpu_torch/obs/checkpoint.py``) against the JAX package's.

Every comparison here is bitwise:

- a params file the JAX package's ``save_params`` wrote loads into the port
  (LogisticRegression, CNNDropOut, a depth-8 ResNet with BatchNorm, a small
  TransformerLM) as ``convert.from_flax`` of the same variables, and the
  port's file loads into the JAX package with ``load_params(like=...)`` as
  those variables: the file is the JAX layout;
- a file that holds part of a model grafts over the model, the rest keeping
  its values; an unknown name or a shape that differs raises;
- a run of 3 rounds, checkpointed, then resumed to 6, equals 6 straight
  rounds: the history (the JSON round trip of its floats is exact) and the
  final variables (an eval every 3 rounds, so the first run's last round,
  which is always evaluated, is an eval round of the straight run too), with FedAdam's server state (a tensor step count and two
  moment dicts) and with CNNDropOut's dropout;
- a round checkpoint keeps the last 3 rounds, and a server state of nested
  dicts and tuples round-trips with its dtypes.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.cnn import CNNDropOut as JaxCNN
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.models.resnet import CifarResNet as JaxResNet
from fedml_tpu.models.transformer import TransformerLM as JaxLM
from fedml_tpu.obs import checkpoint as jckpt
from fedml_tpu_torch import convert
from fedml_tpu_torch.exp import main_fedavg as port_cli
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.obs import checkpoint


def _models():
    """name -> (JAX module, an input, the port's module)."""
    return {
        "lr": (JaxLR(num_classes=10), jnp.zeros((2, 20)),
               lambda: create_model("lr", 10, "mnist", device="cpu", input_shape=(20,))),
        "cnn": (JaxCNN(num_classes=62), jnp.zeros((2, 28, 28)),
                lambda: create_model("cnn", 62, "femnist", device="cpu")),
        "resnet8": (JaxResNet(depth=8, num_classes=10), jnp.zeros((2, 8, 8, 3)),
                    lambda: CifarResNet(depth=8, num_classes=10, device="cpu")),
        "lm": (JaxLM(vocab_size=32, embed_dim=16, num_layers=2, num_heads=2, max_len=8,
                     attn_impl="xla"), jnp.zeros((2, 8), jnp.int32),
               lambda: TransformerLM(vocab_size=32, embed_dim=16, num_layers=2, num_heads=2,
                                     max_len=8, attn_impl="xla", device="cpu")),
    }


def _jax_variables(name):
    module, x, _ = _models()[name]
    return jax.tree.map(np.asarray, dict(module.init(jax.random.key(3), x)))


def _assert_same(a: dict, b: dict):
    assert list(a) == list(b) or set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", ["lr", "cnn", "resnet8", "lm"])
def test_jax_file_loads_into_the_port_and_back(tmp_path, name):
    variables = _jax_variables(name)
    jpath = jckpt.save_params(tmp_path / "jax", variables)
    want = convert.from_flax(variables)
    _assert_same(checkpoint.load_params(jpath), want)
    like = _models()[name][2]().state_dict()
    assert set(like) == set(want)
    _assert_same(checkpoint.load_params(jpath, like=like), want)
    # the reverse: the port's file read by the JAX package into its model
    tpath = checkpoint.save_params(tmp_path / "port", want)
    assert tpath.suffix == ".npz"
    back = jckpt.load_params(tpath, like=variables)
    for (path, leaf), (_, ref) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                      jax.tree_util.tree_flatten_with_path(variables)[0]):
        np.testing.assert_array_equal(np.asarray(leaf), ref, err_msg=str(path))
        assert np.asarray(leaf).dtype == ref.dtype
    with np.load(tpath) as mine, np.load(jpath) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)


def test_partial_files_graft_and_errors(tmp_path):
    variables = _jax_variables("resnet8")
    like = CifarResNet(depth=8, num_classes=10, device="cpu").state_dict()
    # a backbone-only file: the JAX tree without the head, params only
    backbone = {"params": {k: v for k, v in variables["params"].items() if k != "Dense_0"}}
    path = jckpt.save_params(tmp_path / "backbone", backbone)
    got = checkpoint.load_params(path, like=like)
    full = convert.from_flax(variables)
    for k in like:
        if k.startswith("head.") or k.endswith(("running_mean", "running_var")):
            assert torch.equal(got[k], like[k]), k  # kept: the file has no such leaf
        else:
            assert torch.equal(got[k], full[k]), k
    # the port writes the same partial file (params only, no batch_stats)
    part = {k: v for k, v in full.items()
            if not k.startswith("head.") and not k.endswith(("running_mean", "running_var"))}
    mine = checkpoint.save_params(tmp_path / "mine", part)
    with np.load(mine) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])
    # a head alone: the model says it is a ResNet's head (flax Dense_0)
    head = jckpt.save_params(tmp_path / "head", {"params": {"Dense_0": variables["params"]["Dense_0"]}})
    assert torch.equal(checkpoint.load_params(head, like=like)["head.weight"], full["head.weight"])
    bad = jckpt.save_params(tmp_path / "bad", {"params": {"Dense_0": {
        "kernel": np.zeros((3, 10), np.float32), "bias": np.zeros(10, np.float32)}}})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_params(bad, like=like)
    unknown = jckpt.save_params(tmp_path / "unknown", {"params": {"Extra_0": {
        "kernel": np.zeros((3, 10), np.float32)}}})
    with pytest.raises(ValueError, match="not present in the model"):
        checkpoint.load_params(unknown, like=like)


def _run(argv):
    args = port_cli.parse_with_config(port_cli.add_args(argparse.ArgumentParser()), argv)
    return port_cli.run(args)


RESUME = {
    "fedadam_lr": ["--algorithm", "fedopt", "--server_optimizer", "adam"],
    "cnn_dropout": ["--model", "cnn", "--dataset", "femnist", "--batch_size", "20",
                    "--lr", "0.1", "--client_num_per_round", "3"],
}


@pytest.mark.parametrize("name", sorted(RESUME))
def test_resume_equals_straight_run_bitwise(tmp_path, name):
    base = ["--client_num_in_total", "6", "--client_num_per_round", "4",
            "--frequency_of_the_test", "3", "--checkpoint_every", "3",
            "--data_dir", str(tmp_path / "none"), "--device", "cpu"] + RESUME[name]
    straight = _run(base + ["--comm_round", "6", "--checkpoint_dir", str(tmp_path / "a"),
                            "--save_params_to", str(tmp_path / "a.npz")])
    first = _run(base + ["--comm_round", "3", "--checkpoint_dir", str(tmp_path / "b")])
    assert len(first) == 3
    resumed = _run(base + ["--comm_round", "6", "--checkpoint_dir", str(tmp_path / "b"),
                           "--resume", "1", "--save_params_to", str(tmp_path / "b.npz")])
    assert len(straight) == 6 and resumed == straight
    _assert_same(checkpoint.load_params(tmp_path / "a.npz"),
                 checkpoint.load_params(tmp_path / "b.npz"))
    if name == "fedadam_lr":
        ck = checkpoint.RoundCheckpointer(tmp_path / "b")
        like = checkpoint.load_params(tmp_path / "b.npz")
        from fedml_tpu_torch.algorithms.fedopt import server_optimizer

        state0 = server_optimizer("adam").init(like)
        _, state, rnd, hist = ck.restore(like, like_server_state=state0)
        assert rnd == 5 and hist == straight and int(state["count"]) == 6
        assert state["count"].dtype == torch.int32


class _Named(NamedTuple):
    count: torch.Tensor
    mu: dict


def test_round_checkpointer_keeps_three_and_round_trips_structures(tmp_path):
    ck = checkpoint.RoundCheckpointer(tmp_path)
    variables = {"b.w": torch.randn(3, 2), "a.w": torch.randn(4)}
    state = (_Named(torch.tensor(7, dtype=torch.int32),
                    {"z": torch.randn(2), "y": torch.randn(3, dtype=torch.float64)}),
             {"trace": {"b.w": torch.randn(3, 2)}})
    for r in range(5):
        ck.save(r, variables, state, [{"round": r}])
    assert sorted(p.name for p in tmp_path.glob("round_*")) == [
        "round_000002", "round_000003", "round_000004"]
    assert ck.latest_round() == 4
    like_vars = {k: torch.zeros_like(v) for k, v in variables.items()}
    like_state = (_Named(torch.tensor(0, dtype=torch.int32),
                         {"z": torch.zeros(2), "y": torch.zeros(3, dtype=torch.float64)}),
                  {"trace": {"b.w": torch.zeros(3, 2)}})
    v, s, rnd, hist = ck.restore(like_vars, like_server_state=like_state)
    assert rnd == 4 and hist == [{"round": 4}]
    _assert_same(v, variables)
    assert isinstance(s[0], _Named) and list(v) == list(like_vars)
    assert torch.equal(s[0].count, state[0].count) and s[0].count.dtype == torch.int32
    _assert_same(s[0].mu, state[0].mu)
    _assert_same(s[1]["trace"], state[1]["trace"])
    # a stateless rule saves no server state and gets its template back
    ck.save(5, variables, ())
    assert ck.restore(like_vars, like_server_state=())[1] == ()
    # the server half: nested dict of arrays and JSON values
    ck.save_server(3, {"model": np.arange(4.0), "meta": {"n": 2, "ids": [1, 2]}})
    back = ck.restore_server()
    np.testing.assert_array_equal(back["model"], np.arange(4.0))
    assert back["meta"] == {"n": 2, "ids": [1, 2]}


def test_jax_orbax_round_is_refused_naming_the_layout(tmp_path):
    """A round the JAX RoundCheckpointer wrote through orbax
    (``round_k/state/``) is refused by the port's restore with a message
    that names the layout and the params files that do cross."""
    jck = jckpt.RoundCheckpointer(tmp_path)
    assert jck._ckptr is not None, "orbax is installed here"
    jm = JaxLR(num_classes=3)
    variables = jax.tree.map(np.asarray, dict(jm.init(jax.random.key(0), jnp.zeros((1, 4)))))
    path = jck.save(0, variables, history=[{"round": 0}])
    assert (path / "state").is_dir() and not (path / "state.npz").exists()
    port = create_model("lr", 3, input_shape=(4,), device="cpu")
    like = {k: torch.zeros_like(v) for k, v in port.state_dict().items()}
    with pytest.raises(ValueError, match=r"orbax.*round_k/state/.*save_params/load_params"):
        checkpoint.RoundCheckpointer(tmp_path).restore(like)
