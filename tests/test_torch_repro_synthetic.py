"""The port's Synthetic(α,β) + LR row (fedml_tpu_torch/exp/repro_synthetic.py)
against the JAX entry point, at 20 clients of the generator's ``uniform``
sizes (the flag's smoke-test shapes: the reference's lognormal sizes reach
10,000 samples a client), from the same initial variables
(the JAX engine's ``init_variables`` captured and handed to the port's):
every round record of the three runs, and the result dicts, within 1e-5
(LogisticRegression's f32 sums in other orders). Cases: the padded rounds,
and packed lanes under a heterogeneous population with norm clipping (the
JAX engine pads a cohort to its 8-device mesh with zero-weight copies, which
a mean ignores)."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse

import jax
import numpy as np
import pytest

from fedml_tpu.exp import repro_synthetic as jrepro
from fedml_tpu.sim import engine as jax_engine
from fedml_tpu_torch import convert
from fedml_tpu_torch.exp import repro_synthetic as trepro
from fedml_tpu_torch.sim import engine as port_engine

ATOL = 1e-5
BASE = ["--client_num_in_total", "20", "--client_num_per_round", "8", "--comm_round", "4",
        "--frequency_of_the_test", "2", "--lr", "0.05", "--size_dist", "uniform"]
CASES = {
    "padded": [],
    "packed_population": ["--pack_lanes", "2", "--norm_bound", "5.0",
                          "--population", "speed=lognormal:0,0.5;avail=0.9;dropout=0.05"],
}


def _runs(monkeypatch, tmp_path, argv):
    """(port, JAX): each run's result dict and the three runs' histories."""
    inits, hists = [], {"jax": [], "port": []}
    j_init, j_run = jax_engine.FedSim.init_variables, jax_engine.FedSim.run
    t_run = port_engine.FedSim.run

    def capture(self):
        v = j_init(self)
        inits.append(convert.from_flax(jax.tree.map(np.asarray, dict(v))))
        return v

    def recorder(run, key):
        def wrapped(self, *a, **kw):
            out = run(self, *a, **kw)
            hists[key].append(out[1])
            return out
        return wrapped

    monkeypatch.setattr(jax_engine.FedSim, "init_variables", capture)
    monkeypatch.setattr(jax_engine.FedSim, "run", recorder(j_run, "jax"))
    want = jrepro.run(jrepro.add_args(argparse.ArgumentParser()).parse_args(
        argv + ["--report", str(tmp_path / "jax.md")]))
    queue = list(inits)
    monkeypatch.setattr(port_engine.FedSim, "init_variables",
                        lambda self: {k: t.clone() for k, t in queue.pop(0).items()})
    monkeypatch.setattr(port_engine.FedSim, "run", recorder(t_run, "port"))
    got = trepro.run(trepro.add_args(argparse.ArgumentParser()).parse_args(
        argv + ["--device", "cpu", "--report", str(tmp_path / "port.md")]))
    assert not queue
    return (got, hists["port"]), (want, hists["jax"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_histories_match_jax(monkeypatch, tmp_path, case):
    (got, port_h), (want, jax_h) = _runs(monkeypatch, tmp_path, BASE + CASES[case])
    assert len(port_h) == len(jax_h) == 3
    for p_hist, j_hist in zip(port_h, jax_h):
        assert [r["round"] for r in p_hist] == [r["round"] for r in j_hist]
        for p, j in zip(p_hist, j_hist):
            keys = {k for k in j if k not in ("round_time", "_ts")}
            assert keys <= set(p)
            for k in keys:
                np.testing.assert_allclose(p[k], j[k], atol=ATOL, err_msg=k)
    assert set(got) == set(want)
    for name in want:
        assert got[name]["clients_sizes_minmax"] == want[name]["clients_sizes_minmax"]
        assert got[name]["first_round_over_60"] == want[name]["first_round_over_60"]
        np.testing.assert_allclose(got[name]["best_test_acc"], want[name]["best_test_acc"],
                                   atol=ATOL)
        np.testing.assert_allclose(got[name]["curve"], want[name]["curve"], atol=ATOL)
    report = (tmp_path / "port.md").read_text()
    assert "Synthetic(α,β)" in report and "| synthetic(0.5,0.5) |" in report


def test_flags_match_jax():
    flags = {a.dest for a in jrepro.add_args(argparse.ArgumentParser())._actions}
    port = {a.dest for a in trepro.add_args(argparse.ArgumentParser())._actions}
    assert port == flags | {"device"}
    defaults = vars(trepro.add_args(argparse.ArgumentParser()).parse_args([]))
    assert {k: v for k, v in defaults.items() if k != "device"} == vars(
        jrepro.add_args(argparse.ArgumentParser()).parse_args([]))
