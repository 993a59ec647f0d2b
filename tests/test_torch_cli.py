"""The port's unified CLI (fedml_tpu_torch.exp.main_fedavg) and the MNIST +
LR reproduction entry point (exp/repro_mnist_lr) against the JAX package's.

Tolerances: the final round record of ``main([... "--device", "cpu"])``
against JAX ``main([...])`` from the same initial variables (the JAX run's,
converted): the same keys apart from ``round_time`` and ``_ts``; values at
atol 1e-5 for LogisticRegression runs (FedAvg and FedProx), 1e-4 for the
CNN (three rounds of SGD through two convolutions and a 3136 x 512 Dense in
f32, sums in other orders).

The CNN run uses batch 40, two steps per client-epoch. On the CPU the JAX
package straight-lines a client's steps into one XLA program
(``fedml_tpu/core/scan.py``), and for CNNOriginalFedAvg a program of three
or more steps departs from the same steps run one jitted step at a time
(measured on one client's epoch: 3e-8 after two steps, 1.7e-4 after three,
3.1e-3 after six), while the port stays within 1e-7 of the step-at-a-time
arithmetic (``tests/test_torch_cnn.py::test_cnn_local_training_matches_jax_steps``
holds it over eight steps)."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse

import jax
import numpy as np
import pytest

import fedml_tpu.sim.engine as jax_engine
import fedml_tpu_torch.sim.engine as port_engine
from fedml_tpu.exp import main_fedavg as jax_cli
from fedml_tpu_torch import convert
from fedml_tpu_torch.exp import main_fedavg as port_cli
from fedml_tpu_torch.exp import repro_mnist_lr


def _table(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices) if a.choices else None)
            for a in parser._actions if a.dest != "help"}


def test_add_args_matches_jax_plus_device():
    ours = _table(port_cli.add_args(argparse.ArgumentParser()))
    theirs = _table(jax_cli.add_args(argparse.ArgumentParser()))
    assert ours.pop("device") == (("--device",), "cuda", str, None)
    assert ours == theirs


def _port_run_from_jax_init(monkeypatch, argv, tmp_path):
    """JAX main, then the port's main from the JAX run's initial variables."""
    captured = {}
    original = jax_engine.FedSim.init_round_variables

    def capture(self, overrides=None):
        v = original(self, overrides)
        captured["v"] = convert.from_flax(jax.tree.map(np.asarray, dict(v)))
        return v

    monkeypatch.setattr(jax_engine.FedSim, "init_round_variables", capture)
    argv = argv + ["--data_dir", str(tmp_path / "none")]
    want = jax_cli.main(argv)
    monkeypatch.setattr(port_engine.FedSim, "init_variables",
                        lambda self: {k: t.clone() for k, t in captured["v"].items()})
    got = port_cli.main(argv + ["--device", "cpu"])
    return got, want


RUNS = {
    "mnist_lr_defaults": ([], 1e-5),
    "synthetic_lr": (["--dataset", "synthetic_0.5_0.5", "--lr", "0.1"], 1e-5),
    "femnist_cnn_original": (["--dataset", "femnist", "--model", "cnn_original",
                              "--batch_size", "40", "--lr", "0.05"], 1e-4),
    "mnist_lr_eval_on_clients": (["--eval_on_clients", "1", "--frequency_of_the_test", "2"],
                                 1e-5),
    "mnist_lr_fedprox_stragglers": (["--algorithm", "fedprox", "--fedprox_mu", "0.1",
                                     "--straggler_frac", "0.5", "--epochs", "2"], 1e-5),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_main_final_record_matches_jax(monkeypatch, tmp_path, name):
    extra, atol = RUNS[name]
    argv = ["--client_num_in_total", "6", "--client_num_per_round", "4", "--comm_round", "3",
            "--frequency_of_the_test", "3"] + extra
    got, want = _port_run_from_jax_init(monkeypatch, argv, tmp_path)
    assert set(got) - {"round_time"} == set(want) - {"round_time", "_ts"}
    assert got["round"] == want["round"] == 2
    for k in set(want) - {"round", "round_time", "_ts"}:
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)
    if "eval_on_clients" in name:
        assert "Train/AccOnClients" in got


UNPORTED = [
    (["--downlink_compressor", "topk"], "§A11.4"),
    (["--downlink_retention", "2"], "§A11.4"),
    (["--backend", "grpc", "--downlink_compressor", "q8"], "§A11.4"),
    (["--mesh_shape", "2x4"], "§A12"),
    (["--shard_rules", "cnn_tp"], "§A12"),
    (["--downlink_keyframe_every", "4"], "§A11.4"),
    (["--backend", "mqtt_s3", "--downlink_retention", "2"], "§A11.4"),
    (["--backend", "loopback", "--server_mode", "tree", "--downlink_compressor", "q8"],
     "§A11.4"),
]


@pytest.mark.parametrize("argv,item", UNPORTED)
def test_unported_flags_raise_with_their_roadmap_item(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        port_cli.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("algorithm,item", [("fedgan", "§A13")])
def test_unported_algorithms_raise(tmp_path, algorithm, item):
    """Every ``--algorithm`` choice is ported now: the last one, fedgan
    (ROADMAP ``item``), runs instead of raising (its parity with the JAX
    package is ``tests/test_torch_fedgan.py``'s)."""
    final = port_cli.main(["--algorithm", algorithm, "--device", "cpu", "--client_num_in_total",
                           "4", "--client_num_per_round", "2", "--comm_round", "1",
                           "--data_dir", str(tmp_path)])
    assert np.isfinite(final["Train/Loss"]) and "Test/Acc" not in final


SERVER_RULES = {
    "fedopt_adam": ["--algorithm", "fedopt"],
    "fedopt_yogi": ["--algorithm", "fedopt", "--server_optimizer", "yogi",
                    "--server_lr", "0.05"],
    "fednova_stragglers": ["--algorithm", "fednova", "--straggler_frac", "0.5",
                           "--epochs", "2"],
    # 8 a round: the JAX engine pads a cohort to a multiple of its 8-device
    # CPU mesh with zero-weight copies of the global model, which the median
    # would read
    "robust_median_clip": ["--algorithm", "fedavg_robust", "--robust_rule", "median",
                           "--norm_bound", "0.5", "--client_num_in_total", "10",
                           "--client_num_per_round", "8"],
    "hierarchical": ["--algorithm", "hierarchical", "--group_num", "2",
                     "--group_comm_round", "2"],
}


@pytest.mark.parametrize("name", sorted(SERVER_RULES))
def test_server_rules_match_jax_cli(monkeypatch, tmp_path, name):
    """Two rounds of each server rule through both CLIs from the JAX run's
    initial variables (hierarchical: two global rounds): every record, atol
    1e-5 (LogisticRegression)."""
    captured = {}
    original = jax_engine.FedSim.init_variables

    def capture(self):
        v = original(self)
        captured["v"] = convert.from_flax(jax.tree.map(np.asarray, dict(v)))
        return v

    monkeypatch.setattr(jax_engine.FedSim, "init_variables", capture)
    argv = ["--client_num_in_total", "6", "--client_num_per_round", "4", "--comm_round", "2",
            "--frequency_of_the_test", "1", "--data_dir", str(tmp_path / "none")]
    argv += SERVER_RULES[name]
    args = jax_cli.add_args(argparse.ArgumentParser()).parse_args(argv)
    want = jax_cli.run(args)
    monkeypatch.setattr(port_engine.FedSim, "init_variables",
                        lambda self: {k: t.clone() for k, t in captured["v"].items()})
    got = port_cli.run(port_cli.add_args(argparse.ArgumentParser()).parse_args(
        argv + ["--device", "cpu"]))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        keys = set(w) - {"round_time", "_ts"}
        assert set(g) - {"round_time"} == keys
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("argv", [["--is_mobile", "1"], ["--server_mode", "async"],
                                  ["--fault_spec", "*:drop=1.0"], ["--buffer_goal", "2"],
                                  ["--tree_fan_ins", "2,2"], ["--send_retries", "2"],
                                  ["--fleet_stats", "fl"], ["--broadcast_generations", "3"],
                                  ["--backend", "shm", "--server_mode", "tree"]])
def test_jax_flag_combination_errors_kept(argv):
    with pytest.raises(NotImplementedError) as theirs:
        jax_cli.main(argv)
    with pytest.raises(NotImplementedError) as ours:
        port_cli.main(argv + ["--device", "cpu"])
    assert str(ours.value) == str(theirs.value)


def test_cli_yaml_config(tmp_path):
    """--cf loads flag values from YAML; explicit CLI flags override the
    file; unknown keys fail loudly; a whole run from a file."""
    cf = tmp_path / "exp.yaml"
    cf.write_text(
        "dataset: synthetic\nmodel: lr\nclient_num_in_total: 4\n"
        "client_num_per_round: 4\nbatch_size: 8\ncomm_round: 3\n"
        "epochs: 1\nfrequency_of_the_test: 3\nlr: 0.2\ndevice: cpu\n"
    )
    parser = port_cli.add_args(argparse.ArgumentParser())
    args = port_cli.parse_with_config(parser, ["--cf", str(cf)])
    assert args.dataset == "synthetic" and args.comm_round == 3 and args.lr == 0.2
    parser = port_cli.add_args(argparse.ArgumentParser())
    assert port_cli.parse_with_config(parser, ["--cf", str(cf), "--lr", "0.1"]).lr == 0.1
    bad = tmp_path / "bad.yaml"
    bad.write_text("no_such_flag: 1\n")
    with pytest.raises(ValueError, match="unknown keys"):
        port_cli.parse_with_config(port_cli.add_args(argparse.ArgumentParser()),
                                   ["--cf", str(bad)])
    final = port_cli.main(["--cf", str(cf)])
    assert final["round"] == 2
    assert final["Test/Acc"] > 0.5


def test_run_dir_metrics_jsonl(tmp_path):
    final = port_cli.main(["--dataset", "synthetic", "--client_num_in_total", "4",
                           "--comm_round", "2", "--frequency_of_the_test", "1",
                           "--run_dir", str(tmp_path / "run"), "--device", "cpu"])
    lines = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and final["round"] == 1


def test_repro_mnist_lr_converges_small(tmp_path):
    """1/10 scale (100 clients, 30 rounds), as tests/test_repro_mnist.py
    holds the JAX entry point."""
    result = repro_mnist_lr.main([
        "--client_num_in_total", "100", "--comm_round", "30",
        "--data_dir", str(tmp_path / "leaf"),
        "--metrics_out", str(tmp_path / "m.jsonl"),
        "--out", str(tmp_path / "R.md"), "--device", "cpu",
    ])
    assert result["best_test_acc"] > 0.6, result
    assert result["clients"] == 100 and result["dataset"] == "LEAF-format offline fixture"
    assert (tmp_path / "R.md").exists()
    assert len((tmp_path / "m.jsonl").read_text().strip().splitlines()) == 30
