"""Time one checkout's f32 flash-attention forward kernel at the main path's shape.

Run on a machine with an NVIDIA card::

    python3 fedml_tpu_torch/time_forward.py [--root DIR]

It imports ``fedml_tpu_torch`` from the checkout at ``DIR`` (default: the one
this file lies in), so an older checkout unpacked beside this one (for
example with ``git archive``) can be timed by the same code. It builds that
checkout's f32 kernel at first use, holds one launch to the checkout's plain
version, and times ``flash_fwd_cuda`` on contiguous f32 q, k, v at B=8, H=16,
T=1024, D=128, causal, with CUDA events (the mean of 20 launches after 3
warm-ups). It prints one JSON line with the card's name and power limit. To
compare two checkouts, run both in turns on one card (old, new, new, old),
e.g.::

    for r in old . . old; do python3 fedml_tpu_torch/time_forward.py --root $r; done
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPE = dict(b=8, h=16, t=1024, d=128)
REPS = 20


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    args = parser.parse_args()
    root = Path(args.root).resolve()
    here = Path(__file__).resolve().parent  # not on the path: its modules' names are generic
    sys.path = [str(root)] + [p for p in sys.path if Path(p or '.').resolve() != here]
    import torch

    from fedml_tpu_torch.ops import attention as attn

    if not Path(attn.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"fedml_tpu_torch was imported from {attn.__file__}, not {root}")
    if not torch.cuda.is_available():
        raise SystemExit("time_forward: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, t, d = SHAPE["b"], SHAPE["h"], SHAPE["t"], SHAPE["d"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(b, h, t, d, generator=gen, device="cuda") for _ in range(3))
    scale = d ** -0.5

    def launch():
        return attn.flash_fwd_cuda(q, k, v, True, scale)

    err = float((launch() - attn.flash_attention_plain(q, k, v, True, scale)).abs().max())
    for _ in range(3):
        launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPS):
        launch()
    end.record()
    torch.cuda.synchronize()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": str(root), "card": card, "dtype": "float32", **SHAPE,
                      "causal": True, "ms": start.elapsed_time(end) / REPS,
                      "max_abs_err_vs_plain": err}), flush=True)


if __name__ == "__main__":
    main()
