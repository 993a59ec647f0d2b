"""MLOps packaging, the port of ``fedml_tpu/obs/package.py``: build
distributable client/server run packages.

Reference: build-mlops-package/build.sh — copies fedml_api/fedml_core/
fedml_experiments into ``mlops-core/fedml-{client,server}/package/fedml``
and zips each into ``dist-packages/{client,server}/package.zip`` for upload
to the MLOps platform.

Same artifact contract here, pythonic implementation: the whole
``fedml_tpu_torch`` package (its kernel sources, not the kernels built from
them under ``ops/_build``) plus a role entry script and a build manifest go
into each zip. ``verify_package`` round-trips a built zip (unzip + import-check
via compileall) so CI can prove the artifact is runnable without a
platform."""

from __future__ import annotations

import compileall
import json
import time
import zipfile
from pathlib import Path

EXCLUDE_DIRS = {"__pycache__", ".git", "tests", "_build"}

_CLIENT_ENTRY = '''\
"""MLOps client-package entry: run one federated client against the server
in the bundled config (reference mlops-core client runner role)."""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from fedml_tpu_torch.exp.main_fedavg import main

if __name__ == "__main__":
    cfg = json.loads((Path(__file__).parent / "fedml_config.json").read_text())
    main(cfg["client_args"] + sys.argv[1:])
'''

_SERVER_ENTRY = '''\
"""MLOps server-package entry: run the aggregation server for the bundled
config (reference mlops-core server runner role)."""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from fedml_tpu_torch.exp.main_fedavg import main

if __name__ == "__main__":
    cfg = json.loads((Path(__file__).parent / "fedml_config.json").read_text())
    main(cfg["server_args"] + sys.argv[1:])
'''


def _package_files(src_root: Path):
    for p in sorted((src_root / "fedml_tpu_torch").rglob("*")):
        if p.is_dir():
            continue
        rel = p.relative_to(src_root)
        if any(part in EXCLUDE_DIRS for part in rel.parts):
            continue
        if p.name.endswith((".pyc", ".so", ".so.tmp")):
            continue
        yield p


def build_mlops_package(
    src_root: str | Path,
    out_dir: str | Path,
    run_config: dict | None = None,
) -> dict[str, Path]:
    """Build ``dist-packages/{client,server}/package.zip``; returns the two
    zip paths. ``run_config`` may carry ``client_args`` / ``server_args``
    CLI argument lists baked into each package's fedml_config.json."""
    src_root = Path(src_root)
    out = Path(out_dir)
    run_config = run_config or {}
    manifest = {
        "framework": "fedml_tpu_torch",
        "built_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "entry": "run.py",
    }
    results: dict[str, Path] = {}
    for role, entry_src in (("client", _CLIENT_ENTRY), ("server", _SERVER_ENTRY)):
        zip_path = out / "dist-packages" / role / "package.zip"
        zip_path.parent.mkdir(parents=True, exist_ok=True)
        cfg = {
            "role": role,
            "client_args": run_config.get("client_args", []),
            "server_args": run_config.get("server_args", []),
        }
        with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
            for f in _package_files(src_root):
                z.write(f, Path("package") / f.relative_to(src_root))
            z.writestr("package/run.py", entry_src)
            z.writestr("package/fedml_config.json", json.dumps(cfg, indent=2))
            z.writestr("package/manifest.json", json.dumps({**manifest, "role": role}, indent=2))
        results[role] = zip_path
    return results


def verify_package(zip_path: str | Path, work_dir: str | Path) -> bool:
    """Unzip and byte-compile the package — proves the artifact is complete
    and syntactically runnable (CI-checkable without an MLOps platform)."""
    work = Path(work_dir)
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(work)
    pkg = work / "package"
    assert (pkg / "run.py").exists() and (pkg / "manifest.json").exists()
    return compileall.compile_dir(str(pkg / "fedml_tpu_torch"), quiet=2, force=True)
