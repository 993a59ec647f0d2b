"""The port's SplitNN (``algorithms/splitnn.py``, ``exp/main_splitnn.py``)
and vertical FL (``data/vertical_tabular.py``, ``algorithms/vertical.py``,
``exp/main_vfl.py``) against the JAX package's, from the same variables
converted by ``convert.py``.

Tolerances:

- SplitNN, the JAX CLI's run (3 clients of the synthetic set, 2 epochs of
  the relay) against the port's from the JAX run's initial variables: every
  turn's loss, one ``train_step`` on a partly padded batch (loss, both
  halves) and the final halves atol 1e-5 (f32 products summed in other
  orders); ``Test/Acc`` and ``splitnn_eval`` exactly equal (argmax over
  the same logits within 1e-5 of each other, no near ties on this set);
- the ``vertical_tabular`` copy: bitwise (pure numpy);
- VFL, ``run_vfl`` from the JAX run's initial variables: every step's loss,
  one ``train_step`` and every party's model atol 1e-5, the predictions
  atol 1e-6; ``main_vfl``'s metrics: the loss atol 1e-5, ``Test/Acc``
  exactly;
- the §A11 refusals: ``NotImplementedError`` naming the item.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import splitnn as jsplit
from fedml_tpu.algorithms import vertical as jvert
from fedml_tpu.data import vertical_tabular as jtab
from fedml_tpu.exp import main_splitnn as jmain_split
from fedml_tpu.exp import main_vfl as jmain_vfl
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import splitnn, vertical
from fedml_tpu_torch.data import vertical_tabular as tab
from fedml_tpu_torch.exp import main_splitnn, main_vfl

ATOL = 1e-5
SPLIT_ARGV = ["--client_number", "3", "--epochs", "2"]


def _close(want, got_sd, atol=ATOL, msg=""):
    back = convert.to_flax(got_sd)
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(want))[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=atol, err_msg=f"{msg} {path}")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_split():
    """The JAX CLI's SplitNN run, with what its relay was given and gave."""
    seen = {}
    relay = jsplit.run_splitnn_relay

    def recording(split, client_batches, epochs, rng):
        sample_x = client_batches[0]["x"][0]
        seen["init"] = _np(split.init(rng, sample_x))
        seen["split"], seen["batches"] = split, _np(client_batches)
        seen["out"] = _np(relay(split, client_batches, epochs, rng))
        return seen["out"]

    with mock.patch.object(jsplit, "run_splitnn_relay", recording):
        seen["metrics"] = jmain_split.main(SPLIT_ARGV)
    return seen


def _port_split_args():
    return main_splitnn.add_args(argparse.ArgumentParser()).parse_args(
        SPLIT_ARGV + ["--device", "cpu"])


def test_splitnn_relay_and_cli_match_jax(jax_split):
    cvars0, svars0 = jax_split["init"]
    start = (convert.from_flax(cvars0), convert.from_flax(svars0))
    seen = {}
    relay = splitnn.run_splitnn_relay

    def recording(*args):
        seen["out"] = relay(*args)
        return seen["out"]

    with mock.patch.object(splitnn, "run_splitnn_relay", recording), \
            mock.patch.object(splitnn.SplitNN, "init", lambda self, generator: start):
        metrics = main_splitnn.run(_port_split_args())
    j_cvars, j_svars, j_losses = jax_split["out"]
    t_cvars, t_svars, t_losses = seen["out"]
    assert len(t_losses) == len(j_losses) == 6  # 3 clients x 2 epochs
    np.testing.assert_allclose(t_losses, j_losses, atol=ATOL)
    for c in range(3):
        _close(j_cvars[c], t_cvars[c], msg=f"client {c}")
    _close(j_svars, t_svars, msg="server")
    assert set(metrics) == set(jax_split["metrics"]) == {"Train/Loss", "Test/Acc"}
    np.testing.assert_allclose(metrics["Train/Loss"], jax_split["metrics"]["Train/Loss"],
                               atol=ATOL)
    assert metrics["Test/Acc"] == jax_split["metrics"]["Test/Acc"]


def test_splitnn_train_step_and_eval_match_jax(jax_split):
    split = jax_split["split"]
    cvars0, svars0 = jax_split["init"]
    batch = {k: v[-1] for k, v in jax_split["batches"][0].items()}  # its last, padded batch
    assert 0 < batch["mask"].sum() < len(batch["mask"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    c_opt, s_opt = split.client_opt.init(cvars0["params"]), split.server_opt.init(svars0["params"])
    j_c, j_s, _, _, j_loss = split.train_step(cvars0, svars0, c_opt, s_opt, jb, jax.random.key(0))
    args = _port_split_args()
    from fedml_tpu_torch.data.registry import load_partition_data

    ds = load_partition_data(args.dataset, args.data_dir, args.partition_method,
                             args.partition_alpha, args.client_number, args.seed)
    port, client_batches = main_splitnn.build(args, ds, torch.device("cpu"))
    tc, ts = convert.from_flax(cvars0), convert.from_flax(svars0)
    out_c, out_s, _, _, t_loss = port.train_step(tc, ts, {}, {},
                                                 {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(t_loss), float(j_loss), atol=ATOL)
    _close(_np(j_c), out_c)
    _close(_np(j_s), out_s)
    for k, v in client_batches[0].items():
        np.testing.assert_array_equal(v.numpy(), jax_split["batches"][0][k])
    test = {k: v[:3] for k, v in client_batches[1].items()}
    want = jsplit.splitnn_eval(split, cvars0, svars0, {k: jnp.asarray(v.numpy())
                                                      for k, v in test.items()})
    assert splitnn.splitnn_eval(port, tc, ts, test) == want


@pytest.mark.parametrize("backend", ["loopback", "shm"])
def test_splitnn_comm_backends_are_refused(backend):
    with pytest.raises(NotImplementedError, match="§A11"):
        main_splitnn.main(["--backend", backend, "--device", "cpu"])


def test_vertical_tabular_copy_is_bitwise(tmp_path):
    for kw in ({}, {"n_samples": 80, "dims": (3, 5, 2), "seed": 4, "test_frac": 0.5}):
        for a, b in zip(tab.synthetic_vertical(**kw), jtab.synthetic_vertical(**kw)):
            for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
    x = np.random.RandomState(2).randn(30, 7).astype(np.float32)
    for n in (2, 3):
        for a, b in zip(tab._column_blocks(x, n), jtab._column_blocks(x, n)):
            np.testing.assert_array_equal(a, b)
    table = np.random.RandomState(3).randn(40, 6)
    table[5, 2] = np.nan
    table[:, -1] = (table[:, -1] > 0).astype(float)
    np.savetxt(tmp_path / "loan.csv", table, delimiter=",", header="a,b,c,d,e,y", comments="")
    for a, b in zip(tab._load_table(tmp_path / "loan.csv"), jtab._load_table(tmp_path / "loan.csv")):
        np.testing.assert_array_equal(a, b)
    for name, data_dir, n in (("nus_wide", None, 2), ("nus_wide", None, 3),
                              ("lending_club", str(tmp_path), 3), ("lending_club_loan", None, 2)):
        for a, b in zip(tab.load_vertical(name, data_dir, n), jtab.load_vertical(name, data_dir, n)):
            for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
                np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="unknown vertical dataset"):
        tab.load_vertical("nope")


@pytest.fixture(scope="module")
def jax_vfl():
    """The JAX CLI's VFL run and its initial variables."""
    args = jmain_vfl.add_args(argparse.ArgumentParser()).parse_args(["--epochs", "2"])
    seen = {}
    run = jvert.run_vfl

    def recording(splits, y, **kw):
        parties = [jvert.PartyModel(hidden=kw["hidden"]) for _ in splits]
        seen["init"] = _np(jvert.VerticalFL(parties, None).init(jax.random.key(kw["seed"]),
                                                                 splits))
        seen["out"] = run(splits, y, **kw)
        return seen["out"]

    with mock.patch.object(jvert, "run_vfl", recording):
        seen["metrics"] = jmain_vfl.run(args)
    return seen


def test_vfl_run_and_cli_match_jax(jax_vfl):
    start = [convert.from_flax(v) for v in jax_vfl["init"]]
    seen = {}
    run = vertical.run_vfl

    def recording(*args, **kw):
        seen["out"] = run(*args, **kw)
        return seen["out"]

    args = main_vfl.add_args(argparse.ArgumentParser()).parse_args(
        ["--epochs", "2", "--device", "cpu"])
    with mock.patch.object(vertical, "run_vfl", recording), \
            mock.patch.object(vertical.VerticalFL, "init", lambda self, generator: start):
        metrics = main_vfl.run(args)
    j_vfl, j_vars, j_losses = jax_vfl["out"]
    t_vfl, t_vars, t_losses = seen["out"]
    assert len(t_losses) == len(j_losses) == 2 * (450 // 40)
    np.testing.assert_allclose(t_losses, j_losses, atol=ATOL)
    for p in range(2):
        _close(_np(j_vars[p]), t_vars[p], msg=f"party {p}")
    tr, y_tr, te, _ = main_vfl.load(args)
    want = np.asarray(j_vfl.predict(j_vars, [jnp.asarray(s) for s in te]))
    got = t_vfl.predict(t_vars, [torch.tensor(s) for s in te]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(metrics["Train/Loss"], jax_vfl["metrics"]["Train/Loss"], atol=ATOL)
    assert metrics["Test/Acc"] == jax_vfl["metrics"]["Test/Acc"]
    # one step on a partly masked batch
    jb = [jnp.asarray(s[:8]) for s in tr]
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32)
    j_opts = [j_vfl.optimizer.init(v["params"]) for v in jax_vfl["init"]]
    j_new, _, j_loss = j_vfl.train_step(jax_vfl["init"], j_opts, jb, jnp.asarray(y_tr[:8]),
                                        jnp.asarray(mask))
    t_new, _, t_loss = t_vfl.train_step(start, [{}, {}], [torch.tensor(s[:8]) for s in tr],
                                        torch.tensor(y_tr[:8]), torch.tensor(mask))
    np.testing.assert_allclose(float(t_loss), float(j_loss), atol=ATOL)
    for p in range(2):
        _close(_np(j_new[p]), t_new[p], msg=f"step party {p}")


def test_vfl_loopback_is_refused():
    with pytest.raises(NotImplementedError, match="§A11"):
        main_vfl.main(["--backend", "loopback", "--device", "cpu"])
