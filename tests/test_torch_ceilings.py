"""The port's fixture ceilings (fedml_tpu_torch/exp/repro_ceilings.py) and
``ceiling_lookup`` (exp/_report.py) against the JAX package's.

- ``centralized_ceiling`` on the synthetic LR row's data against the JAX
  function from the same initial variables (the JAX trainer's ``init``
  wrapped to capture them, the port's handed them): every epoch's test
  accuracy within 1e-6 (f32 LR, the same shuffle, batches and steps), the
  same best and the same early stop;
- ``run`` merges its rows into ``--store`` and writes the report section;
  ``ceiling_lookup`` reads a written store as the JAX one does;
- the two h5 rows raise, naming ROADMAP §A6b; the Bayes ceiling is a copy.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse
import json

import jax
import numpy as np
import pytest

from fedml_tpu.core import trainer as jax_trainer
from fedml_tpu.exp import _report as jreport
from fedml_tpu.exp import repro_ceilings as jceil
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch import convert
from fedml_tpu_torch.core import trainer as port_trainer
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.exp import _report as treport
from fedml_tpu_torch.exp import repro_ceilings as tceil
from fedml_tpu_torch.models.linear import LogisticRegression

ATOL = 1e-6


def _accs(monkeypatch, module, name):
    """Record the accuracy of every evaluation ``module.make_local_eval``
    makes."""
    accs, original = [], getattr(module, name)

    def make(trainer):
        fn = original(trainer)

        def recorded(*a):
            m = fn(*a)
            accs.append(m)
            return m
        return recorded

    monkeypatch.setattr(module, name, make)
    return accs


def test_centralized_ceiling_matches_jax(monkeypatch):
    train, test = synthetic_classification(n_clients=30, alpha=0.5, beta=0.5, seed=0)
    captured = []
    original_init = jax_trainer.ClientTrainer.init

    def capture(self, rng, sample):
        v = original_init(self, rng, sample)
        captured.append(convert.from_flax(jax.tree.map(np.asarray, dict(v))))
        return v

    monkeypatch.setattr(jax_trainer.ClientTrainer, "init", capture)
    jax_device_get, j_accs = jax.device_get, []

    def device_get(x):
        out = jax_device_get(x)
        if isinstance(out, dict) and "test_correct" in out:
            j_accs.append(float(out["test_correct"]) / float(out["test_total"]))
        return out

    monkeypatch.setattr(jax, "device_get", device_get)
    import optax
    want = jceil.centralized_ceiling(
        jax_trainer.ClientTrainer(module=JaxLR(num_classes=10), optimizer=optax.sgd(0.01)),
        train.arrays, test, 10, epochs=8, seed=3, patience=2)
    monkeypatch.setattr(jax, "device_get", jax_device_get)

    monkeypatch.setattr(port_trainer.ClientTrainer, "init",
                        lambda self, generator: {k: v.clone() for k, v in captured[0].items()})
    t_accs = _accs(monkeypatch, port_trainer, "make_local_eval")
    got = tceil.centralized_ceiling(
        port_trainer.ClientTrainer(module=LogisticRegression(10, 60, device="cpu"),
                                   optimizer=port_trainer.sgd(0.01)),
        train.arrays, test, 10, epochs=8, seed=3, patience=2, device="cpu")
    t_accs = [float(m["test_correct"]) / float(m["test_total"]) for m in t_accs]
    assert len(captured) == 1 and len(t_accs) == len(j_accs) == got[1] == want[1]
    np.testing.assert_allclose(t_accs, j_accs, atol=ATOL)
    assert got[0] == pytest.approx(want[0], abs=ATOL)
    with pytest.raises(ValueError, match="epochs >= 1"):
        tceil.centralized_ceiling(None, train.arrays, test, 10, epochs=0, device="cpu")


def test_run_writes_the_store_and_lookup_reads_it(tmp_path, monkeypatch):
    train, test = synthetic_classification(n_clients=6, seed=1)

    def tiny_row(args):
        tr = port_trainer.ClientTrainer(module=LogisticRegression(10, 60, device=args.device),
                                        optimizer=port_trainer.sgd(0.05))
        return [("tiny", "a small synthetic set", tr, train.arrays, test, 10, 2, "a note")]

    monkeypatch.setitem(tceil.BUILDERS, "synthetic", tiny_row)
    store, report = tmp_path / "ceilings.json", tmp_path / "report.md"
    kept = {"fixture": "an earlier row", "ceiling_acc": 0.5, "epochs": 3, "note": None}
    store.write_text(json.dumps({"kept": kept}))
    args = tceil.add_args(argparse.ArgumentParser()).parse_args(
        ["--rows", "synthetic", "--device", "cpu", "--store", str(store), "--out", str(report)])
    results = tceil.run(args)
    merged = json.loads(store.read_text())
    assert set(merged) == {"kept", "tiny"} and merged["tiny"] == results["tiny"]
    assert results["tiny"]["epochs"] == 2 and results["tiny"]["note"] == "a note"
    assert "| tiny | a small synthetic set |" in report.read_text()
    assert "| kept | an earlier row | 50.00 | 3 |" in report.read_text()
    # the lookup: next to the report first, then the cwd; None when absent
    for label in ("tiny", "kept", "absent"):
        assert treport.ceiling_lookup(label, report_path=report, store="ceilings.json") == \
            jreport.ceiling_lookup(label, report_path=report, store="ceilings.json")
    assert treport.ceiling_lookup("tiny", report_path=report, store="x/ceilings.json") == \
        merged["tiny"]
    monkeypatch.chdir(tmp_path)
    assert treport.ceiling_lookup("kept", store="ceilings.json") == kept
    assert treport.ceiling_lookup("kept", store="missing.json") is None
    (tmp_path / "bad.json").write_text("[1, 2")
    assert treport.ceiling_lookup("kept", store="bad.json") is None
    # the defaults write no file
    defaults = tceil.add_args(argparse.ArgumentParser()).parse_args([])
    assert defaults.store is None and defaults.out is None
    assert defaults.rows == ["mnist_lr", "synthetic", "shakespeare", "cross_silo"]


@pytest.mark.parametrize("row", ["femnist_cnn", "fed_cifar100"])
def test_h5_rows_raise(row):
    with pytest.raises(NotImplementedError, match="§A6b"):
        tceil.BUILDERS[row](argparse.Namespace(data_root="unused", device="cpu"))
    assert set(tceil.BUILDERS) == set(jceil.BUILDERS)


def test_markov_bayes_ceiling_is_a_copy():
    for vocab, seed in ((90, 0), (20, 3)):
        assert tceil.markov_bayes_ceiling(vocab, seed) == jceil.markov_bayes_ceiling(vocab, seed)
