"""The port's cross-silo entry point (fedml_tpu_torch/exp/repro_cross_silo.py)
run on a tiny fixture on the CPU, against the JAX entry point's contract.

The recipe's ResNet-56 in bf16 takes minutes on the CPU, so ``run()`` builds
a depth-8 ``CifarResNet`` here (same family, same bf16 compute); the card
runs the real ResNet-56 (``chip_smoke.py``). The checks are structural, so no
tolerance: the result dict has the JAX result's keys, one round completes
with finite metrics, nothing is written outside ``tmp_path``, and each
departure the module docstring states raises."""

import argparse
import ast
import json
import math
from pathlib import Path

import pytest
import torch

from fedml_tpu.exp import repro_cross_silo as jrepro
from fedml_tpu_torch.exp import repro_cross_silo as trepro
from fedml_tpu_torch.models import registry
from fedml_tpu_torch.models.resnet import CifarResNet

ROOT = Path(__file__).resolve().parent.parent


def _jax_result_keys():
    """The string keys of the ``result = {...}`` dict in the JAX ``run()``."""
    tree = ast.parse(Path(jrepro.__file__).read_text())
    run = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run")
    for node in ast.walk(run):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no result dict in the JAX run()")


def _args(tmp_path, *extra):
    return trepro.add_args(argparse.ArgumentParser()).parse_args([
        "--data_dir", str(tmp_path / "data"), "--fixture_train_n", "200",
        "--fixture_test_n", "40", "--epochs", "1", "--comm_round", "1",
        "--round_sleep", "0", "--device", "cpu", *extra])


@pytest.fixture
def small_model(monkeypatch):
    built = []

    def create_model(name, output_dim, dtype=None, device="cuda"):
        assert name == "resnet56" and dtype == torch.bfloat16
        built.append(CifarResNet(depth=8, num_classes=output_dim, dtype=dtype, device=device))
        return built[-1]

    monkeypatch.setattr(registry, "create_model", create_model)
    return built


def test_run_on_a_tiny_fixture(tmp_path, monkeypatch, small_model):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    watched = [ROOT / "REPRO.md", ROOT / "repro_cross_silo_metrics.jsonl"]
    before = {p: p.stat().st_mtime_ns for p in watched if p.exists()}
    metrics = tmp_path / "metrics.jsonl"
    result = trepro.run(_args(tmp_path, "--metrics_out", str(metrics),
                              "--out", str(tmp_path / "report.md")))
    assert set(result) == _jax_result_keys()
    assert result["dataset"] == "offline cifar10-format fixture"
    assert result["clients"] == 10 and result["batch_size"] == 64
    assert result["rounds"] == result["rounds_requested"] == 1
    assert result["partition"] == "hetero(alpha=0.5)"
    assert 0.0 <= result["final_test_acc"] <= 1.0
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert len(records) == 1 and records[0]["round"] == 0
    assert all(math.isfinite(v) for v in records[0].values())
    assert {"Train/Loss", "round_time", "Test/Acc", "Test/Loss"} <= set(records[0])
    assert small_model[0].blocks[0].conv_0.dtype == torch.bfloat16
    assert "Cross-silo flagship" in (tmp_path / "report.md").read_text()
    # nothing outside tmp_path
    assert list(cwd.iterdir()) == []
    assert {p: p.stat().st_mtime_ns for p in watched if p.exists()} == before
    # the defaults write no report and no metrics file
    args = trepro.add_args(argparse.ArgumentParser()).parse_args([])
    assert args.out is None and args.metrics_out is None and args.ceiling_epochs == 0
    assert args.device == "cuda"


def test_cohort_rule_and_flags_match_jax():
    for model in ("resnet56", "mobilenet"):
        for explicit in (None, "vmap", "scan"):
            assert (trepro.resolve_cohort_execution(model, explicit)
                    == jrepro.resolve_cohort_execution(model, explicit))
    # the JAX flag names are all kept; --device is the port's own
    flags = {a.dest for a in jrepro.add_args(argparse.ArgumentParser())._actions}
    port = {a.dest for a in trepro.add_args(argparse.ArgumentParser())._actions}
    assert port == flags | {"device"}


@pytest.mark.parametrize("extra,error,match", [
    (("--ceiling_epochs", "2"), NotImplementedError, "§A7b"),
    (("--dataset", "cifar100"), NotImplementedError, "§A7"),
    (("--dataset", "cinic10"), NotImplementedError, "§A7"),
    (("--model", "mobilenet"), NotImplementedError, "§A7"),
])
def test_departures_raise(tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        trepro.run(_args(tmp_path, *extra))
    assert not (tmp_path / "data").exists()


def test_no_card_raises_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card error")
    args = _args(tmp_path)
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trepro.run(args)
