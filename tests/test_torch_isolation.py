"""The port stands alone: no module of fedml_tpu_torch/, and not
chip_smoke.py, imports JAX, flax, optax, the JAX package or scikit-learn
(the machine with the card has none of them); the LEAF fixture's vendored
digits are read without scikit-learn; the port's modules import without
JAX and PyYAML. And chip_smoke.py fails, printing no result line, where
there is no card or no checkout of the repo around it."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "fedml_tpu", "sklearn")


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


# a process in which importing any of these fails
_BLOCKER = (
    "import sys\n"
    "class _Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in {blocked!r}:\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, _Block())\n"
)


def _run_blocked(code: str, blocked):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", _BLOCKER.format(blocked=set(blocked)) + code],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_every_port_module_imports_without_jax_sklearn_or_yaml():
    modules = sorted(".".join(f.relative_to(ROOT).with_suffix("").parts)
                     for f in (ROOT / "fedml_tpu_torch").rglob("*.py"))
    assert "fedml_tpu_torch.exp.main_fedavg" in modules
    assert "fedml_tpu_torch.data.leaf_fixture" in modules
    assert {"fedml_tpu_torch.models.segmentation", "fedml_tpu_torch.algorithms.fedseg",
            "fedml_tpu_torch.exp.main_fedseg", "fedml_tpu_torch.exp.main_dol",
            "fedml_tpu_torch.data.uci", "fedml_tpu_torch.data.vision_fed",
            "fedml_tpu_torch.schedule.scheduler",
            "fedml_tpu_torch.algorithms.turboaggregate",
            "fedml_tpu_torch.comm.message", "fedml_tpu_torch.comm.base",
            "fedml_tpu_torch.comm.send_pool", "fedml_tpu_torch.comm.retry",
            "fedml_tpu_torch.comm.loopback", "fedml_tpu_torch.comm.managers",
            "fedml_tpu_torch.comm.status", "fedml_tpu_torch.obs.registry",
            "fedml_tpu_torch.obs.sysstats", "fedml_tpu_torch.algorithms.fold_plane",
            "fedml_tpu_torch.algorithms.fedavg_distributed",
            "fedml_tpu_torch.algorithms.fedavg_mobile", "fedml_tpu_torch.algorithms.cross_silo",
            "fedml_tpu_torch.algorithms.turboaggregate_dist", "fedml_tpu_torch.models.export",
            "fedml_tpu_torch.exp.main_turboaggregate"} <= set(modules)
    code = "import importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in modules if not m.endswith("__main__"))
    proc = _run_blocked(code, BANNED + ("yaml",))
    assert proc.returncode == 0, proc.stderr


def test_vendored_digits_read_without_sklearn(tmp_path):
    code = ("from fedml_tpu_torch.data.leaf_fixture import load_digits, "
            "write_leaf_mnist_fixture\n"
            "images, target = load_digits()\n"
            "assert images.shape == (1797, 8, 8) and target.shape == (1797,)\n"
            f"write_leaf_mnist_fixture({str(tmp_path)!r}, n_clients=3, seed=0)\n")
    proc = _run_blocked(code, ("sklearn", "jax", "fedml_tpu"))
    assert proc.returncode == 0, proc.stderr
    assert any((tmp_path / "train").glob("*.json"))


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


def test_port_never_names_the_jax_shm_library():
    """The port builds its shm ring from its own copy into its own build
    directory: no file of it (nor chip_smoke.py) names the JAX package's
    source directory or library, and the library path lies in the port."""
    from fedml_tpu_torch.comm import shm

    files = [f for f in (ROOT / "fedml_tpu_torch").rglob("*")
             if f.is_file() and f.suffix in (".py", ".cpp", ".cu", ".h")]
    files.append(ROOT / "chip_smoke.py")
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if any(s in f.read_text() for s in ("fedml_tpu/ops/native", "libshmring.so"))]
    assert offenders == []
    port = (ROOT / "fedml_tpu_torch").resolve()
    assert shm.library_path().resolve().is_relative_to(port)
    assert shm._SRC.resolve().is_relative_to(port)
