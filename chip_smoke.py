#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fedml_tpu_torch``) on one NVIDIA H100.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: require CUDA; print the card's name and power limit;
2. build both flash-attention forward kernels with nvcc, in parallel (timed):
   ``csrc/flash_fwd_sm90.cu`` (bf16, wgmma + TMA) and
   ``csrc/flash_fwd_f32_sm90.cu`` (f32, 3xTF32 mma.sync + cp.async); print
   each one's ``-Xptxas -v`` report and, where ``cuobjdump`` is found, the
   count of HGMMA and UTMALDG instructions in the bf16 kernel's SASS and of
   TF32 HMMA instructions (``HMMA.1688.F32.TF32``) in the f32 kernel's;
3. each kernel against its plain version (f32 inputs reach the f32 kernel,
   bf16 the bf16 one), causal and full, at the main path's shape and at
   ragged, Tq != Tk (D=128 too), D=8 and B*H > 65535 shapes, and each
   kernel on the main path's strided q/k/v views of one qkv projection,
   bitwise equal to the same call on contiguous copies;
4. the autograd function's gradients on the card (f32 kernel) against
   autograd through the plain version;
5. end-to-end check at a small size: a few FedAvg rounds of a small f32
   TransformerLM on the card (kernel) against the same rounds on the CPU
   (plain version), the cohort trained client by client
   (``cohort_execution="scan"``);
6. the main path: FedAvg rounds of the full-width TransformerLM (D=2048,
   H=16, T=1024, V=32000) with ``attn_impl="flash"`` in
   ``cohort_execution="scan"`` (as the JAX LM bench runs it), counting each
   kernel's launches: in bf16 compute (the bf16 kernel on every layer's
   forward, the f32 kernel never), then one round in f32 compute, the JAX
   package's default (the f32 kernel on every layer's forward, the bf16
   kernel never);
7. the kernels' times at the main path's shape beside their bounds, the
   plain version's and one PyTorch call's; and each forward on the main
   path's strided views against the same work on contiguous copies;
8. the vmapped cohort at a small size: phase 5's LM in
   ``cohort_execution="vmap"``, card against CPU, where the kernel is
   reached through the flash function's vmap rule (one launch per layer per
   step for the whole cohort; the count is asserted); and a depth-8 ResNet
   with BatchNorm, weight decay and augmentation, f32, 2 vmapped rounds on
   the card against the CPU and against scan on the card;
9. the cross-silo flagship at full width through
   ``fedml_tpu_torch.exp.repro_cross_silo.run``: CIFAR-10 (the 50k/10k
   offline fixture) + ResNet-56, hetero alpha=0.5, 10 clients x B=64, SGD
   lr 0.001 wd 0.001, bf16, augmentation, vmapped cohort, cut to E=1 and 2
   rounds; per round its seconds, images/s, FLOP/s from the shapes and peak
   memory; then one round of the same run in scan. It runs no kernel of the
   repo (the ResNet path has no TPU kernel: cuDNN convolutions).

It prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# f32 comparisons run with TF32 off (the default for matmuls; set explicitly)
F32_ATOL = 1e-4
# bf16: two bf16 ulps at unit scale (2 * 2^-7) plus one ulp relative to the
# value, since a flip of the final rounding at |x| >= 2 is one ulp of x
BF16_ATOL, BF16_RTOL = 2.0 ** -6, 2.0 ** -7
# end-to-end, card (kernel) vs CPU (plain version), f32: a few SGD steps
# through several layers of f32 arithmetic summed in different orders
E2E_ATOL = 1e-4
BF16_PEAK_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
# where the cross-silo run keeps its data and metrics (gitignored)
BUILD_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM
# H100 SXM dense peaks of the routes each input type has to products of its
# accuracy: bf16 on the tensor cores; f32 on the CUDA cores, or on the TF32
# tensor cores in three passes (3xTF32, what the f32 kernel does)
ROUTES = {"bfloat16": [("bf16 tensor cores", 989e12, 1)],
          "float32": [("f32 CUDA cores", 67e12, 1), ("3xTF32 tensor cores", 495e12, 3)]}
# each kernel of the path: its source, the dtype it serves and its launch counter;
# both replace the one TPU kernel, KERNEL_REPLACES
KERNELS = {
    "flash_fwd_sm90": dict(source="fedml_tpu_torch/ops/csrc/flash_fwd_sm90.cu",
                           dtype="bfloat16", counter="FLASH_FWD_BF16_LAUNCHES"),
    "flash_fwd_f32_sm90": dict(source="fedml_tpu_torch/ops/csrc/flash_fwd_f32_sm90.cu",
                               dtype="float32", counter="FLASH_FWD_F32_LAUNCHES"),
}
KERNEL_REPLACES = "fedml_tpu/ops/attention.py:59"

BENCH = dict(b=8, h=16, t=1024, d=128)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build():
    """Build every kernel of the path, one nvcc each, all at once."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from fedml_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        paths = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for name in KERNELS:
        _build.load(name)
    log(f"[build] {', '.join(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, path in paths.items():
        log_path = path.with_name(path.name + ".log")
        for line in log_path.read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "arning", "Performance")):
                log(f"[build] {name}: {line.strip()}")
    cuobjdump = shutil.which("cuobjdump") or shutil.which(
        str(Path(_build.nvcc()).resolve().parent / "cuobjdump"))
    if cuobjdump is None:
        log("[build] SASS not checked (no cuobjdump): flash_fwd_sm90's HGMMA and UTMALDG, "
            "flash_fwd_f32_sm90's TF32 HMMA")
        return

    def sass(name):
        return subprocess.run([cuobjdump, "-sass", str(paths[name])], capture_output=True,
                              text=True, timeout=120, check=True).stdout

    bf16_sass = sass("flash_fwd_sm90")
    hgmma, utmaldg = bf16_sass.count("HGMMA"), bf16_sass.count("UTMALDG")
    log(f"[build] flash_fwd_sm90 SASS: {hgmma} HGMMA, {utmaldg} UTMALDG instructions")
    if not hgmma or not utmaldg:
        fail("the bf16 kernel's SASS has no HGMMA or no UTMALDG: not a wgmma/TMA kernel")
    f32_sass = sass("flash_fwd_f32_sm90")
    hmma = f32_sass.count("HMMA.1688.F32.TF32")
    log(f"[build] flash_fwd_f32_sm90 SASS: {hmma} HMMA.1688.F32.TF32 instructions, "
        f"{f32_sass.count('HMMA')} HMMA in all")
    if not hmma:
        fail("the f32 kernel's SASS has no TF32 HMMA: its products are not on the tensor cores")


def _qkv(torch, b, h, tq, tk, d, dtype, gen):
    shape_q, shape_k = (b, h, tq, d), (b, h, tk, d)
    return tuple(
        torch.randn(s, generator=gen, device="cuda", dtype=torch.float32).to(dtype)
        for s in (shape_q, shape_k, shape_k)
    )


def _heads_of_qkv(torch, b, h, t, d, dtype, gen):
    """q, k, v as the main path makes them: strided [B, H, T, D] views of one
    [B, T, 3*H*D] projection output."""
    qkv = torch.randn(b, t, 3 * h * d, generator=gen, device="cuda").to(dtype)
    return [a.reshape(b, t, h, d).transpose(1, 2) for a in qkv.split(h * d, dim=-1)]


def _check(torch, name, out, ref, dtype, causal, tq, tk):
    """Worst error of out against its plain version; fails outside the
    tolerance, on non-finite values and on fully masked rows that are not 0."""
    if not torch.isfinite(out).all():
        fail(f"kernel {name} {dtype} causal={causal}: non-finite output")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    if dtype == torch.float32:
        ok = err <= F32_ATOL
    else:
        ok = bool((diff <= BF16_ATOL + BF16_RTOL * ref.float().abs()).all())
    if causal and tq > tk and not bool((out[:, :, : tq - tk] == 0).all()):
        fail(f"kernel {name} {dtype}: fully masked rows are not 0")
    b, h, _, d = out.shape
    log(f"[kernel] {name:9s} B={b} H={h} Tq={tq} Tk={tk} D={d} "
        f"{str(dtype)[6:]:8s} causal={causal!s:5s} max_abs_err={err:.3e} "
        f"{'ok' if ok else 'OUT OF TOLERANCE'}")
    if not ok:
        fail(f"kernel {name} {dtype} causal={causal} disagrees with its plain version")
    return err


def phase_kernel_vs_plain(torch):
    """Returns the worst error of each kernel against its plain version."""
    from fedml_tpu_torch.ops import attention as attn

    shapes = [
        ("bench", BENCH["b"], BENCH["h"], BENCH["t"], BENCH["t"], BENCH["d"]),
        ("ragged", 2, 4, 300, 300, 64),
        ("tq>tk", 2, 4, 200, 72, 32),
        ("tq<tk", 2, 4, 100, 260, 64),
        ("d8", 2, 2, 130, 130, 8),
        ("d128<", 2, 4, 333, 517, 128),
        ("d128>", 2, 4, 517, 333, 128),
        ("bh>65535", 1040, 64, 16, 16, 8),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {name: 0.0 for name in KERNELS}
    by_dtype = {getattr(torch, k["dtype"]): name for name, k in KERNELS.items()}
    for name, b, h, tq, tk, d in shapes:
        for dtype, kernel in by_dtype.items():
            q, k, v = _qkv(torch, b, h, tq, tk, d, dtype, gen)
            for causal in (True, False):
                out = attn.flash_fwd_cuda(q, k, v, causal, d ** -0.5)
                ref = attn.flash_attention_plain(q, k, v, causal, d ** -0.5)
                torch.cuda.synchronize()
                worst[kernel] = max(worst[kernel],
                                    _check(torch, name, out, ref, dtype, causal, tq, tk))
    # the main path's strided views reach each kernel without a copy
    b, h, t, d = BENCH["b"], BENCH["h"], BENCH["t"], BENCH["d"]
    for dtype, kernel in by_dtype.items():
        q, k, v = _heads_of_qkv(torch, b, h, t, d, dtype, gen)
        if not all(attn.tma_compatible(x) and not x.is_contiguous() for x in (q, k, v)):
            fail("the main path's q/k/v views are contiguous or not TMA-compatible")
        for causal in (True, False):
            out = attn.flash_fwd_cuda(q, k, v, causal, d ** -0.5)
            copies = attn.flash_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                         causal, d ** -0.5)
            ref = attn.flash_attention_plain(q, k, v, causal, d ** -0.5)
            torch.cuda.synchronize()
            worst[kernel] = max(worst[kernel], _check(
                torch, "views", out, ref, dtype, causal, t, t))
            if not torch.equal(out, copies):
                fail(f"{kernel} on strided views (causal={causal}) differs from the same "
                     "call on contiguous copies")
        log(f"[kernel] views: {kernel}'s output on the strided qkv views is bitwise equal "
            "to contiguous copies")
    return worst


def phase_gradient(torch):
    from fedml_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(1)
    for tq, tk in ((96, 96), (80, 48)):
        q, k, v = _qkv(torch, 2, 4, tq, tk, 64, torch.float32, gen)
        cot = torch.randn(2, 4, tq, 64, generator=gen, device="cuda")
        grads = []
        for fn in (attn.flash_attention, attn.flash_attention_plain):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = fn(*leaves, True, None, 32, 32)
            (out * cot).sum().backward()
            grads.append([out.detach()] + [t.grad for t in leaves])
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(*grads)]
        log(f"[grad] Tq={tq} Tk={tk} f32 causal: out/dq/dk/dv max_abs_err "
            + " ".join(f"{e:.3e}" for e in errs))
        if max(errs) > F32_ATOL:
            fail(f"gradient check Tq={tq} Tk={tk}: {errs} > {F32_ATOL}")


def _time_ms(torch, fn, n=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _bound(q, causal, dtype_name):
    """Least time for the function on these inputs: q, k, v read once and o
    written once over the memory rate, against the products of the visible
    (query, key) pairs on the fastest route the card has for products of the
    inputs' accuracy (for f32: the CUDA cores, or three TF32 passes on the
    tensor cores)."""
    b, h, t, d = q.shape
    nbytes = 4 * q.numel() * q.element_size()
    pairs = int(np.arange(1, t + 1).sum()) if causal else t * t  # visible pairs per head
    flops = 4 * b * h * d * pairs                                 # QK^T and PV, 2 per MAC
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms, route = min((passes * flops / rate * 1e3, name)
                        for name, rate, passes in ROUTES[dtype_name])
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_route="memory" if bytes_ms >= ops_ms else route,
                bytes=nbytes, flops=flops)


def phase_kernel_times(torch):
    """Times at the main path's shape (causal) of each kernel, its plain
    version and one library call computing the same function, beside the
    bound; and the bf16 forward on the main path's strided views against the
    same work on contiguous copies, in turns."""
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import attention as attn

    b, h, t, d = BENCH["b"], BENCH["h"], BENCH["t"], BENCH["d"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    scale = d ** -0.5
    times = {}
    for name, spec in KERNELS.items():
        q, k, v = _qkv(torch, b, h, t, t, d, getattr(torch, spec["dtype"]), gen)
        kernel_ms = _time_ms(torch, lambda: attn.flash_fwd_cuda(q, k, v, True, scale))
        plain_ms = _time_ms(torch, lambda: attn.flash_attention_plain(q, k, v, True, scale), n=5)
        library_ms = _time_ms(
            torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale))
        bound = _bound(q, True, spec["dtype"])
        log(f"[time] {name} {spec['dtype']} causal B={b} H={h} T={t} D={d}: kernel "
            f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({bound['bound_route']}; "
            f"bytes {bound['bytes']}, flops {bound['flops']}), "
            f"{bound['bound_ms'] / kernel_ms:.1%} of the bound")
        times[name] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                           bound_route=bound["bound_route"])
    for name, spec in KERNELS.items():
        q, k, v = _heads_of_qkv(torch, b, h, t, d, getattr(torch, spec["dtype"]), gen)

        def views():
            return attn._flash_fwd(q, k, v, True, scale, 128, 128)

        def copies():
            return attn.flash_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), True,
                                       scale)

        views_ms = [_time_ms(torch, views)]
        copies_ms = [_time_ms(torch, copies), _time_ms(torch, copies)]
        views_ms.append(_time_ms(torch, views))
        log(f"[time] {name} {spec['dtype']} forward on the main path's strided qkv views: "
            f"{views_ms[0]:.4f} / {views_ms[1]:.4f} ms; with three .contiguous() copies "
            f"first: {copies_ms[0]:.4f} / {copies_ms[1]:.4f} ms")
        times[name].update(views_ms=sum(views_ms) / 2, copies_ms=sum(copies_ms) / 2)
    return times


def _max_err(torch, runs):
    """Worst difference of two runs' variables and per-round metrics."""
    (v_a, h_a), (v_b, h_b) = runs
    err = max(float((v_a[k].cpu() - v_b[k].cpu()).abs().max()) for k in v_b)
    for rec_a, rec_b in zip(h_a, h_b):
        for key in ("Train/Loss", "Train/Acc", "Test/Acc", "Test/Loss"):
            err = max(err, abs(rec_a[key] - rec_b[key]))
    return err


def phase_small_end_to_end(torch, mode):
    """A few FedAvg rounds of a small f32 TransformerLM with the flash path
    in cohort mode ``mode``: on the card (the kernel) against the same
    rounds on the CPU (the plain version), from the same variables and data.
    Returns the f32 kernel's launches in the card run; in vmap they must be
    one per layer per step (the cohort folded into one launch) and per eval
    batch."""
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.ops import attention as attn
    from fedml_tpu_torch.sim.cohort import FederatedArrays, steps_per_epoch
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    v, t, n_clients, per, layers = 64, 96, 4, 12, 2
    rng = np.random.RandomState(0)
    x = rng.randint(0, v, (n_clients * per + 8, t)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    mask = np.ones_like(x, dtype=np.float32)
    mask[::3, 80:] = 0.0
    part = {c: np.arange(c * per, (c + 1) * per - c) for c in range(n_clients)}
    n = n_clients * per
    cfg = SimConfig(client_num_in_total=n_clients, client_num_per_round=2, batch_size=4,
                    comm_round=2, epochs=1, frequency_of_the_test=1, eval_batch_size=4, seed=0,
                    cohort_execution=mode)
    runs = {}
    for device in ("cuda", "cpu"):
        model = create_model("transformer", v, dtype=torch.float32, device=device, embed_dim=64,
                             num_layers=layers, num_heads=2, max_len=t, attn_impl="flash")
        sim = FedSim(ClientTrainer(module=model, task="nwp", optimizer=sgd(0.1, 0.9)),
                     FederatedArrays({"x": x[:n], "y": y[:n], "mask": mask[:n]}, part),
                     {"x": x[n:], "y": y[n:], "mask": mask[n:]}, cfg, device=device)
        if device == "cuda":
            init = {k: t_.cpu() for k, t_ in sim.init_variables().items()}
            attn.FLASH_FWD_F32_LAUNCHES = attn.FLASH_FWD_BF16_LAUNCHES = 0
        variables, history = sim.run(variables={k: t_.to(device) for k, t_ in init.items()})
        if device == "cuda":
            torch.cuda.synchronize()
            launches = (attn.FLASH_FWD_F32_LAUNCHES, attn.FLASH_FWD_BF16_LAUNCHES)
        runs[device] = (variables, history)
    err = _max_err(torch, (runs["cuda"], runs["cpu"]))
    h_gpu = runs["cuda"][1]
    steps = steps_per_epoch(max(len(p) for p in part.values()), cfg.batch_size)
    evals = steps_per_epoch(n, cfg.eval_batch_size) + steps_per_epoch(8, cfg.eval_batch_size)
    expected = layers * (cfg.comm_round * cfg.epochs * steps + cfg.comm_round * evals)
    log(f"[e2e {mode}] small TransformerLM, 2 FedAvg rounds, card vs CPU (f32, flash): "
        f"max_abs_err={err:.3e} (params, losses, eval); Test/Loss "
        f"{h_gpu[-1]['Test/Loss']:.5f}; f32 kernel launches {launches[0]}, bf16 {launches[1]}"
        + (f" (expected {expected} = L x (rounds x E x S steps + eval batches))"
           if mode == "vmap" else ""))
    if not err <= E2E_ATOL:
        fail(f"small {mode} run on the card disagrees with the CPU run: {err} > {E2E_ATOL}")
    if mode == "vmap" and launches != (expected, 0):
        fail(f"vmapped small LM launched the kernels {launches} times, expected ({expected}, 0)")
    return launches[0]


def phase_small_resnet(torch):
    """A depth-8 ResNet (BatchNorm, weight decay, momentum, augmentation),
    f32, 2 vmapped FedAvg rounds on the card against the CPU, and against
    scan on the card, from the same variables and data. Batch 16 and lr
    0.005 keep the two rounds well-conditioned: with batch 8 (a batch of one
    real image and seven zero rows normalised together) and lr 0.05, the
    f32 rounding differences of round 0 (~1e-6) grow past 1e-1 by round 1
    between vmap and scan on the CPU alone."""
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.models.resnet import CifarResNet
    from fedml_tpu_torch.ops.augment import ImageAugment
    from fedml_tpu_torch.sim.cohort import FederatedArrays
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    rng = np.random.RandomState(1)
    sizes = [40, 9, 25, 33, 17]
    n = sum(sizes)
    x = rng.randn(n + 32, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, n + 32).astype(np.int32)
    starts = np.cumsum([0] + sizes)
    part = {c: np.arange(starts[c], starts[c + 1]) for c in range(len(sizes))}
    runs = {}
    for device, mode in (("cuda", "vmap"), ("cpu", "vmap"), ("cuda", "scan")):
        trainer = ClientTrainer(module=CifarResNet(depth=8, num_classes=10, device=device),
                                optimizer=sgd(0.005, 0.9, 1e-3), epochs=2,
                                augment=ImageAugment())
        cfg = SimConfig(client_num_in_total=5, client_num_per_round=4, batch_size=16,
                        comm_round=2, epochs=2, frequency_of_the_test=1, eval_batch_size=32,
                        seed=0, cohort_execution=mode)
        sim = FedSim(trainer, FederatedArrays({"x": x[:n], "y": y[:n]}, part),
                     {"x": x[n:], "y": y[n:]}, cfg, device=device)
        if not runs:
            init = {k: t_.cpu() for k, t_ in sim.init_variables().items()}
        runs[(device, mode)] = sim.run(variables={k: t_.to(device) for k, t_ in init.items()})
    card_cpu = _max_err(torch, (runs[("cuda", "vmap")], runs[("cpu", "vmap")]))
    vmap_scan = _max_err(torch, (runs[("cuda", "vmap")], runs[("cuda", "scan")]))
    log(f"[resnet] depth-8 ResNet f32, 2 vmapped FedAvg rounds (5 ragged clients, BN, wd, "
        f"augmentation): card vs CPU max_abs_err={card_cpu:.3e}, vmap vs scan on the card "
        f"max_abs_err={vmap_scan:.3e} (params, BN statistics, losses, eval); Test/Acc "
        f"{runs[('cuda', 'vmap')][1][-1]['Test/Acc']:.4f}")
    if not card_cpu <= E2E_ATOL:
        fail(f"small ResNet on the card disagrees with the CPU run: {card_cpu} > {E2E_ATOL}")
    if not vmap_scan <= E2E_ATOL:
        fail(f"small ResNet vmap disagrees with scan on the card: {vmap_scan} > {E2E_ATOL}")


MAIN = dict(vocab=32000, embed_dim=2048, num_layers=8, num_heads=16, seq=1024,
            clients=2, batch=8, steps=4, rounds=2, held_out=16, dtype="bfloat16")
# the same LM in f32 compute, the JAX package's default; one round of 2 x 2
# steps keeps the script inside its time limit
MAIN_F32 = dict(MAIN, steps=2, rounds=1, dtype="float32")


def phase_main_path(torch, c):
    """The main path: FedAvg rounds of the full-width TransformerLM in
    ``c["dtype"]`` compute with the flash kernel, through the entry points a
    user calls. Synthetic tokens from numpy.random.RandomState(0), as the JAX
    package's LM bench makes them. Fails unless the kernel of that dtype ran
    on every layer's forward and the other never. Returns each kernel's
    launch count in this run."""
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.ops import attention as attn
    from fedml_tpu_torch.sim.cohort import FederatedArrays
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    rng = np.random.RandomState(0)
    n_per = c["steps"] * c["batch"]
    n = c["clients"] * n_per
    x = rng.randint(0, c["vocab"], (n + c["held_out"], c["seq"])).astype(np.int32)
    y = rng.randint(0, c["vocab"], (n + c["held_out"], c["seq"])).astype(np.int32)
    mask = np.ones((n + c["held_out"], c["seq"]), np.float32)
    part = {i: np.arange(i * n_per, (i + 1) * n_per) for i in range(c["clients"])}
    model = create_model("transformer", c["vocab"], dtype=getattr(torch, c["dtype"]),
                         embed_dim=c["embed_dim"], num_layers=c["num_layers"],
                         num_heads=c["num_heads"], max_len=c["seq"], attn_impl="flash")
    trainer = ClientTrainer(module=model, task="nwp", optimizer=sgd(0.01, momentum=0.9),
                            epochs=1)
    cfg = SimConfig(client_num_in_total=c["clients"], client_num_per_round=c["clients"],
                    batch_size=c["batch"], comm_round=c["rounds"], epochs=1,
                    frequency_of_the_test=c["rounds"], eval_batch_size=c["batch"], seed=0,
                    shuffle_each_round=False, train_eval_samples=c["held_out"],
                    cohort_execution="scan")
    sim = FedSim(trainer, FederatedArrays({"x": x[:n], "y": y[:n], "mask": mask[:n]}, part),
                 {"x": x[n:], "y": y[n:], "mask": mask[n:]}, cfg)
    variables = sim.init_variables()
    n_params = sum(t.numel() for t in variables.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for spec in KERNELS.values():
        setattr(attn, spec["counter"], 0)
    attn.FLASH_FWD_LAUNCHES = 0
    t0 = time.perf_counter()
    variables, history = sim.run(variables=variables)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(attn, spec["counter"]) for name, spec in KERNELS.items()}

    train_steps = c["rounds"] * c["clients"] * c["steps"]
    eval_batches = 2 * -(-c["held_out"] // c["batch"])  # pooled train eval + test eval
    expected = {name: (c["num_layers"] * (train_steps + eval_batches)
                       if spec["dtype"] == c["dtype"] else 0)
                for name, spec in KERNELS.items()}
    tokens_per_round = c["clients"] * c["steps"] * c["batch"] * c["seq"]
    tag = f"[main {c['dtype']}]"
    for rec in history:
        log(f"{tag} round {rec['round']}: Train/Loss {rec['Train/Loss']:.5f} "
            f"round_time {rec['round_time']:.3f} s "
            f"({tokens_per_round / rec['round_time']:.0f} tokens/s)"
            + (f" Test/Loss {rec['Test/Loss']:.5f} Test/Acc {rec['Test/Acc']:.6f}"
               if "Test/Loss" in rec else ""))
    log(f"{tag} TransformerLM V={c['vocab']} D={c['embed_dim']} L={c['num_layers']} "
        f"H={c['num_heads']} T={c['seq']} {c['dtype']} flash, {n_params} params; "
        f"{c['clients']} clients x {c['steps']} steps x batch {c['batch']}, {c['rounds']} "
        f"rounds in {wall:.3f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches} "
        f"(expected {expected})")
    values = [rec["Train/Loss"] for rec in history] + [
        history[-1][k] for k in ("Train/Acc", "Test/Acc", "Test/Loss")]
    if not all(np.isfinite(values)):
        fail(f"{c['dtype']} main path produced non-finite metrics: {history}")
    ln_v = float(np.log(c["vocab"]))
    if abs(history[0]["Train/Loss"] - ln_v) > 2.0:
        fail(f"first-round loss {history[0]['Train/Loss']} is far from ln(V) = {ln_v:.3f} "
             "for random labels")
    if not all(torch.isfinite(t).all() for t in variables.values()):
        fail(f"{c['dtype']} main path produced non-finite parameters")
    if launches != expected:
        fail(f"kernel launches on the {c['dtype']} main path {launches}: expected {expected}")
    return launches


# the cross-silo flagship (repro_cross_silo.py's recipe), cut to E=1 and 2
# rounds with one eval at the end; widths, depth, clients and batch as they are
CROSS_SILO = dict(n_train=50_000, n_test=10_000, clients=10, batch=64, epochs=1, rounds=2)


def _resnet_train_flops_per_image(torch, model, image=32):
    """Training FLOPs of one image through ``model``, from its layers'
    shapes: 2 per multiply-add of every conv and the head forward, three
    times that for forward + backward (input and weight gradients)."""
    from fedml_tpu_torch.models.resnet import Conv

    flops = []

    def hook(mod, args, out):
        flops.append(2 * out[0].numel() * mod.weight[0].numel())

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, Conv)]
    with torch.no_grad():
        model(torch.zeros(1, image, image, 3, device=next(model.parameters()).device))
    for h in handles:
        h.remove()
    return 3 * (sum(flops) + 2 * model.head.weight.numel())


def phase_cross_silo(torch):
    """The cross-silo flagship at full width through the entry point a user
    calls, in the vmapped cohort (2 rounds), then one round of the same run
    in scan. Fails on non-finite metrics or a first-round loss far from
    ln 10: within [ln 10 - 1, ln 10 + 3], since at flax's initialisation
    ResNet-56's logits have a standard deviation near 2 (the residual
    stream grows over 27 blocks), which puts the loss of the first steps
    near 3-4 in the JAX package and the port alike. Returns the vmap and
    scan round times."""
    from fedml_tpu_torch.core import partition
    from fedml_tpu_torch.data import cv
    from fedml_tpu_torch.exp import repro_cross_silo as repro
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.sim.cohort import steps_per_epoch

    c = CROSS_SILO
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    data_dir = BUILD_DIR / "cifar10"
    argv = ["--data_dir", str(data_dir), "--fixture_train_n", str(c["n_train"]),
            "--fixture_test_n", str(c["n_test"]), "--fixture_signal", "0.045",
            "--partition_method", "hetero", "--partition_alpha", "0.5",
            "--client_num_in_total", str(c["clients"]), "--batch_size", str(c["batch"]),
            "--lr", "0.001", "--wd", "0.001", "--epochs", str(c["epochs"]),
            "--round_sleep", "0", "--device", "cuda"]
    runs = {}
    for mode, rounds in (("vmap", c["rounds"]), ("scan", 1)):
        metrics = BUILD_DIR / f"cross_silo_{mode}.jsonl"
        args = repro.add_args(argparse.ArgumentParser()).parse_args(
            argv + ["--cohort_execution", mode, "--comm_round", str(rounds),
                    "--frequency_of_the_test", str(rounds), "--metrics_out", str(metrics)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = repro.run(args)
        wall = time.perf_counter() - t0
        records = [json.loads(line) for line in metrics.read_text().splitlines()]
        runs[mode] = (result, records, wall, torch.cuda.max_memory_allocated())
        if len(records) != rounds:
            fail(f"cross-silo {mode}: {len(records)} of {rounds} rounds completed")

    (_, y), _, _ = cv._load_cifar10_raw(data_dir)
    sizes = np.array([len(p) for p in partition.partition(
        "hetero", y, c["clients"], 0.5, 0).values()])
    steps = steps_per_epoch(int(sizes.max()), c["batch"])
    executed = int(sum(steps_per_epoch(int(n), c["batch"]) for n in sizes)) * c["epochs"]
    slots = c["clients"] * steps * c["epochs"]
    model = create_model("resnet56", 10, dtype=torch.bfloat16)
    per_image = _resnet_train_flops_per_image(torch, model)
    round_flops = slots * c["batch"] * per_image  # vmap computes padded slots too
    log(f"[cross-silo] CIFAR-10 fixture {c['n_train']}/{c['n_test']} + ResNet-56 bf16, hetero "
        f"alpha=0.5, {c['clients']} clients x B={c['batch']}, E={c['epochs']}: client sizes "
        f"{sizes.tolist()}; {steps} steps a client-epoch; executed client steps "
        f"{executed} of {slots} step slots ({1 - executed / slots:.1%} padded steps, "
        f"{1 - sizes.sum() / (slots * c['batch']):.1%} padded image slots); training FLOPs "
        f"{per_image / 1e9:.4f} GFLOP an image slot, {round_flops / 1e12:.3f} TFLOP a round")
    ln10 = float(np.log(10))
    for mode, (result, records, wall, peak) in runs.items():
        for rec in records:
            t = rec["round_time"]
            log(f"[cross-silo {mode}] round {rec['round']}: {t:.3f} s, Train/Loss "
                f"{rec['Train/Loss']:.5f}, {executed * c['batch'] / t:.1f} images/s "
                f"(executed steps x {c['batch']}), {round_flops / t / 1e12:.2f} TFLOP/s "
                f"({round_flops / t / BF16_PEAK_FLOPS:.2%} of the bf16 peak)"
                + (f"; Test/Acc {rec['Test/Acc']:.4f} Test/Loss {rec['Test/Loss']:.5f} "
                   f"Train/Acc {rec['Train/Acc']:.4f}" if "Test/Acc" in rec else ""))
        log(f"[cross-silo {mode}] run() in {wall:.2f} s (fixture, load, rounds, eval); peak "
            f"device memory {peak / 2**30:.2f} GiB; result {json.dumps(result)}")
        values = [v for rec in records for k, v in rec.items() if k != "round"]
        if not all(np.isfinite(values)):
            fail(f"cross-silo {mode} produced non-finite metrics: {records}")
        if not ln10 - 1.0 <= records[0]["Train/Loss"] <= ln10 + 3.0:
            fail(f"cross-silo {mode}: first-round loss {records[0]['Train/Loss']} is far from "
                 f"ln 10 = {ln10:.4f} (band [ln 10 - 1, ln 10 + 3])")
    vmap_t = runs["vmap"][1][-1]["round_time"]
    scan_t = runs["scan"][1][0]["round_time"]
    log(f"[cross-silo] round time vmap {vmap_t:.3f} s (round {runs['vmap'][1][-1]['round']}) "
        f"against scan {scan_t:.3f} s (round 0): vmap/scan {vmap_t / scan_t:.3f}; round-0 "
        f"Train/Loss vmap {runs['vmap'][1][0]['Train/Loss']:.5f}, scan "
        f"{runs['scan'][1][0]['Train/Loss']:.5f}")
    return vmap_t, scan_t


def main() -> None:
    import torch

    from fedml_tpu_torch.ops import attention  # noqa: F401  (fails outside the repo)

    phase_device(torch)
    phase_build()
    errors = phase_kernel_vs_plain(torch)
    phase_gradient(torch)
    phase_small_end_to_end(torch, "scan")
    launches = {}
    for config in (MAIN, MAIN_F32):
        run = phase_main_path(torch, config)
        launches.update({name: n for name, n in run.items()
                         if KERNELS[name]["dtype"] == config["dtype"]})
        torch.cuda.empty_cache()
    times = phase_kernel_times(torch)
    small_vmap_launches = phase_small_end_to_end(torch, "vmap")
    phase_small_resnet(torch)
    phase_cross_silo(torch)
    kernels = [{
        "name": name, "route": "cuda", "source": spec["source"], "replaces": KERNEL_REPLACES,
        "dtype": spec["dtype"], "launches": launches[name], "max_abs_err": errors[name],
        "launches_small_vmap_lm": small_vmap_launches if spec["dtype"] == "float32" else 0,
        **times[name],
    } for name, spec in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
