"""The port's Shakespeare + RNN reproduction entry point
(``fedml_tpu_torch.exp.repro_shakespeare``) and its copy of
``markov_bayes_ceiling`` against the JAX package's.

Tolerances: the ceiling bitwise (the same numpy draws and eigen-solve);
the round records of ``main`` at atol 1e-4 from the same initial variables
(four rounds of SGD at lr 1.0 through two LSTM layers over 16 steps, f32,
products summed in other orders); result keys equal."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import json

import jax
import numpy as np
import pytest

import fedml_tpu.sim.engine as jax_engine
import fedml_tpu_torch.sim.engine as port_engine
from fedml_tpu.exp import repro_ceilings as jax_ceilings
from fedml_tpu.exp import repro_shakespeare as jax_repro
from fedml_tpu_torch import convert
from fedml_tpu_torch.exp import repro_ceilings, repro_shakespeare

ATOL = 1e-4
# the arguments of tests/test_repro_shakespeare.py's end-to-end run
SMALL = ["--client_num_in_total", "6", "--comm_round", "4", "--client_num_per_round", "3",
         "--seq_len", "16", "--samples_per_client", "8", "--frequency_of_the_test", "4"]


@pytest.mark.parametrize("seed", [0, 1])
def test_markov_bayes_ceiling_is_the_jax_one(seed):
    got = repro_ceilings.markov_bayes_ceiling(vocab=90, seed=seed)
    assert got == jax_ceilings.markov_bayes_ceiling(vocab=90, seed=seed)
    assert 1 / 90 < got < 1


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_repro_main_matches_jax(monkeypatch, tmp_path):
    captured = {}
    original = jax_engine.FedSim.init_round_variables

    def capture(self, overrides=None):
        v = original(self, overrides)
        captured["v"] = convert.from_flax(jax.tree.map(np.asarray, dict(v)))
        return v

    monkeypatch.setattr(jax_engine.FedSim, "init_round_variables", capture)
    common = SMALL + ["--data_dir", str(tmp_path / "none")]
    want = jax_repro.main(common + ["--metrics_out", str(tmp_path / "jax.jsonl"),
                                    "--out", str(tmp_path / "JAX.md")])
    monkeypatch.setattr(port_engine.FedSim, "init_variables",
                        lambda self: {k: t.clone() for k, t in captured["v"].items()})
    # no report and no metrics file unless asked: the run writes nothing
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    monkeypatch.chdir(run_dir)
    bare = repro_shakespeare.main(common + ["--device", "cpu"])
    assert list(run_dir.iterdir()) == []
    got = repro_shakespeare.main(common + ["--device", "cpu",
                                           "--metrics_out", str(tmp_path / "port.jsonl"),
                                           "--out", str(tmp_path / "PORT.md")])
    assert list(run_dir.iterdir()) == []
    assert "shakespeare_rnn_torch" in (tmp_path / "PORT.md").read_text()

    assert set(got) == set(want) == set(bare)
    assert "fixture_bayes_ceiling" in got and "pct_of_ceiling" in got
    for k in ("dataset", "clients", "samples", "rounds", "fixture_bayes_ceiling"):
        assert got[k] == want[k], k
    assert got["rounds"] == 4
    assert set(got["final"]) - {"round_time"} == set(want["final"]) - {"round_time", "_ts"}
    # the histories, unrounded (the result dict rounds to 4 digits)
    j_recs, t_recs = _records(tmp_path / "jax.jsonl"), _records(tmp_path / "port.jsonl")
    assert len(j_recs) == len(t_recs) == 4
    for j, t in zip(j_recs, t_recs):
        keys = set(j) - {"round_time", "_ts"}
        assert keys == set(t) - {"round_time"}
        for k in keys:
            np.testing.assert_allclose(t[k], j[k], atol=ATOL, err_msg=f"round {j['round']} {k}")
    best = max(r["Test/Acc"] for r in t_recs if "Test/Acc" in r)
    assert got["best_test_acc"] == round(best, 4)
    bayes = repro_ceilings.markov_bayes_ceiling(vocab=90, seed=0)
    assert got["pct_of_ceiling"] == round(100 * best / bayes, 1)


def test_repro_defaults_to_the_card(tmp_path):
    """``--device`` defaults to cuda: without a card the run raises before
    it builds anything, rather than falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card error")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_shakespeare.main(SMALL + ["--data_dir", str(tmp_path / "none")])
    assert list(tmp_path.iterdir()) == []
