"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with ``nvcc``
for ``sm_90a`` into a shared library under ``ops/_build/`` (listed in
``.gitignore``) at first use, keyed on a hash of the source and the flags, and
loaded with ``ctypes``. Nothing here falls back: a missing ``nvcc`` or a
failed compile raises.

Every library links ``libcuda`` (``-lcuda``): ``flash_fwd_sm90`` encodes its
TMA tensor maps with ``cuTensorMapEncodeTiled``, which only ``libcuda``
exports. The link uses the toolkit's stub (``<toolkit>/lib64/stubs``); at
run time the installed ``libcuda.so.1`` is loaded. No CUTLASS or other
header beyond the toolkit's is used.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-lcuda",)  # after the source, so the linker keeps it


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin (/usr/local/cuda/bin): "
        "the port's CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to; the name carries the hash of the
    source and the flags, so an edited source builds anew."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS + LINK_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library for this hash exists.
    The compiler's register/shared-memory report (``-Xptxas -v``) is kept
    beside the library as ``<library>.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    compiler = nvcc()
    stubs = Path(compiler).resolve().parent.parent / "lib64" / "stubs"
    link_dirs = ["-L", str(stubs)] if stubs.is_dir() else []
    cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"), *link_dirs,
           *LINK_FLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library."""
    return ctypes.CDLL(str(build(name)))
