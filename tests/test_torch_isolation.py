"""The port stands alone: no module of fedml_tpu_torch/, and not
chip_smoke.py, imports JAX, flax, optax or the JAX package (the machine with
the card has no JAX). And chip_smoke.py fails, printing no result line,
where there is no card or no checkout of the repo around it."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "fedml_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _banned(module: str) -> bool:
    # fedml_tpu_torch starts with the string "fedml_tpu": match whole names
    return any(module == b or module.startswith(b + ".") for b in BANNED)


def test_port_imports_no_jax_nor_the_jax_package():
    files = sorted((ROOT / "fedml_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = {
        str(f.relative_to(ROOT)): mods
        for f in files
        if (mods := sorted({m for m in _imported_modules(f) if _banned(m)}))
    }
    assert offenders == {}


def test_banned_matches_whole_module_names():
    assert _banned("fedml_tpu") and _banned("fedml_tpu.ops.attention") and _banned("jax.numpy")
    assert not _banned("fedml_tpu_torch.ops.attention") and not _banned("jaxtyping")


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def _assert_failed_without_result(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout and '"kernels"' not in proc.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card exit")
    _assert_failed_without_result(_run_smoke(ROOT))


def test_chip_smoke_fails_alone_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _assert_failed_without_result(_run_smoke(tmp_path))
