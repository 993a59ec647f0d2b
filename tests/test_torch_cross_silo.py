"""The port's cross-silo entry point (fedml_tpu_torch/exp/repro_cross_silo.py)
run on tiny fixtures on the CPU, against the JAX entry point's contract.

The recipe's ResNet-56 and MobileNet in bf16 take minutes on the CPU, so
``run()`` builds a depth-8 ``CifarResNet`` and a MobileNet cut to two
depthwise-separable blocks here (same families, same bf16 compute); the
card runs the real models (``chip_smoke.py``). The checks are structural,
so no tolerance: the result dict has the JAX result's keys (with the
ceiling's keys when ``--ceiling_epochs`` > 0), each of the dataset x model
combos completes a round with finite metrics, nothing is written outside
``tmp_path``, and the CIFAR-100 and CINIC-10 fixture writers write files
byte-identical to the JAX package's."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse
import ast
import json
import math
from pathlib import Path

import pytest
import torch

from fedml_tpu.exp import repro_cross_silo as jrepro
from fedml_tpu_torch.exp import repro_cross_silo as trepro
from fedml_tpu_torch.models import mobilenet, registry
from fedml_tpu_torch.models.resnet import CifarResNet

ROOT = Path(__file__).resolve().parent.parent


def _jax_result_keys(ceiling=False):
    """The string keys of the ``result = {...}`` dict in the JAX ``run()``;
    with ``ceiling``, also the keys it sets as ``result["..."] = ...``
    when it measures the fixture's ceiling."""
    tree = ast.parse(Path(jrepro.__file__).read_text())
    run = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run")
    keys, extra = None, set()
    for node in ast.walk(run):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            keys = {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and getattr(t.value, "id", None) == "result":
                    extra.add(t.slice.value)
    assert keys is not None, "no result dict in the JAX run()"
    assert extra == {"fixture_ceiling", "ceiling_epochs", "pct_of_ceiling"}
    return keys | extra if ceiling else keys


def _args(tmp_path, *extra):
    return trepro.add_args(argparse.ArgumentParser()).parse_args([
        "--data_dir", str(tmp_path / "data"), "--fixture_train_n", "200",
        "--fixture_test_n", "40", "--epochs", "1", "--comm_round", "1",
        "--round_sleep", "0", "--device", "cpu", *extra])


@pytest.fixture
def small_model(monkeypatch):
    built = []
    monkeypatch.setattr(mobilenet, "_V1", [(64, 1), (128, 2)])

    def create_model(name, output_dim, dtype=None, device="cuda"):
        assert name in ("resnet56", "mobilenet") and dtype == torch.bfloat16
        built.append(CifarResNet(depth=8, num_classes=output_dim, dtype=dtype, device=device)
                      if name == "resnet56" else
                      mobilenet.MobileNet(num_classes=output_dim, dtype=dtype, device=device))
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
    result = trepro.run(_args(tmp_path, "--metrics_out", str(metrics), "--ceiling_epochs", "0",
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
    assert args.out is None and args.metrics_out is None
    assert args.ceiling_epochs == jrepro.add_args(argparse.ArgumentParser()).parse_args(
        []).ceiling_epochs == 6
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


@pytest.mark.parametrize("dataset,model,ceiling", [
    ("cifar10", "resnet56", 1),
    ("cifar100", "resnet56", 0),
    ("cinic10", "resnet56", 0),
    ("cifar100", "mobilenet", 1),
], ids=["ceiling_epochs", "cifar100", "cinic10", "mobilenet"])
def test_combo_runs_at_a_tiny_size(tmp_path, small_model, dataset, model, ceiling):
    """Each dataset x model combo and the fixture ceiling at a tiny size:
    the JAX runner's result keys, a completed round, finite metrics, the
    report section the JAX runner names, MobileNet in scan (the recipe's
    rule)."""
    result = trepro.run(_args(tmp_path, "--dataset", dataset, "--model", model,
                              "--ceiling_epochs", str(ceiling),
                              "--out", str(tmp_path / "report.md")))
    assert set(result) == _jax_result_keys(ceiling=ceiling > 0)
    assert result["dataset"] == f"offline {dataset}-format fixture"
    assert result["model"] == model and result["rounds"] == 1
    assert 0.0 <= result["final_test_acc"] <= 1.0
    if ceiling:
        assert result["ceiling_epochs"] == 1 and 0.0 <= result["fixture_ceiling"] <= 1.0
    assert isinstance(small_model[0], mobilenet.MobileNet) == (model == "mobilenet")
    report = (tmp_path / "report.md").read_text()
    assert f"({dataset} + {model}, hetero)" in report
    assert f"| {'scan' if model == 'mobilenet' else 'vmap'} |" in report
    assert ("fixture centralized ceiling" in report) == bool(ceiling)


def test_fixture_writers_match_jax_bytewise(tmp_path):
    """CIFAR-100 pickles and CINIC-10 PNG trees, each file byte for byte."""
    for name, kwargs in (("write_cifar100_fixture", dict(n_train=30, n_test=10, seed=3,
                                                         signal=0.5)),
                         ("write_cinic10_fixture", dict(n_train_per_class=3,
                                                        n_valid_per_class=2,
                                                        n_test_per_class=1, seed=3))):
        ports, jaxs = tmp_path / f"port_{name}", tmp_path / f"jax_{name}"
        getattr(trepro, name)(ports, **kwargs)
        getattr(jrepro, name)(jaxs, **kwargs)
        files = sorted(p.relative_to(jaxs) for p in jaxs.rglob("*") if p.is_file())
        assert files and files == sorted(p.relative_to(ports) for p in ports.rglob("*")
                                         if p.is_file())
        for f in files:
            assert (ports / f).read_bytes() == (jaxs / f).read_bytes(), f


def test_no_card_raises_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card error")
    args = _args(tmp_path)
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trepro.run(args)
