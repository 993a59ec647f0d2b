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
   (``cohort_execution="scan"``). On the card every path below that runs
   eval-aligned blocks of rounds (block dispatch, the default there) replays
   one CUDA graph of the round per round (``sim/graphs.py``), the flash
   kernel inside it; a launch inside a graph counts once per replay;
6. the main path: FedAvg rounds of the full-width TransformerLM (D=2048,
   H=16, T=1024, V=32000) with ``attn_impl="flash"`` in
   ``cohort_execution="scan"`` (as the JAX LM bench runs it), counting each
   kernel's launches: in bf16 compute (the bf16 kernel on every layer's
   forward, the f32 kernel never), then 2 rounds of 2 x 1 steps in f32
   compute, the JAX package's default (the f32 kernel on every layer's
   forward, the bf16 kernel never); each run one block, its round captured
   (timed) before the counters are set to 0; then the same rounds
   dispatched one at a time (``block_dispatch=False``) in the same process,
   both timed; then the bf16 LM's round with ``remat=True`` against
   without, from one init: bitwise, lower peak memory, 2L flash launches a
   train step against L; and a small LM with dropout and remat, a round
   twice from one seed bitwise, the keep share 0.9 +- 0.01, another seed's
   loss different (``[lm remat]``);
7. the kernels' times at the main path's shape beside their bounds, the
   plain version's and one PyTorch call's; and each forward on the main
   path's strided views against the same work on contiguous copies;
8. the vmapped cohort at a small size: phase 5's LM in
   ``cohort_execution="vmap"``, card against CPU, where the kernel is
   reached through the flash function's vmap rule (one launch per layer per
   step for the whole cohort; the count is asserted); and a depth-8 ResNet
   with BatchNorm, weight decay and augmentation, f32, 2 vmapped rounds on
   the card against the CPU and against scan on the card (an eval each
   round, each compared);
9. the cross-silo flagship at full width through
   ``fedml_tpu_torch.exp.repro_cross_silo.run``: CIFAR-10 (the 50k/10k
   offline fixture) + ResNet-56, hetero alpha=0.5, 10 clients x B=64, SGD
   lr 0.001 wd 0.001, bf16, augmentation, vmapped cohort, cut to E=1 and 1
   round; per round its seconds, images/s, FLOP/s from the shapes and peak
   memory. It runs no kernel of the repo (the ResNet path has no TPU
   kernel: cuDNN convolutions). Then the CIFAR zoo (no TPU kernel either):
   resnet18_gn, mobilenet, mobilenet_v3, vgg11 and efficientnet-b0 at full
   width, f32, card against CPU from the same variables, the eval and
   training forwards and one vmapped FedAvg round of 2 clients x 2 steps
   (``[zoo small]``); ``repro_cross_silo.run`` on a 25k/5k CIFAR-100
   fixture with MobileNet, 1 round in scan (the recipe's rule) with a
   1-epoch fixture ceiling, then the round in vmap, each with s/round,
   images/s and peak memory (``[cross_silo zoo]``); and ``main_fedavg
   --dataset fed_cifar100 --model resnet18_gn`` on the fallback at
   fed_cifar100's recipe (10 a round, B=20, SGD 0.1, bf16, vmapped), 2
   rounds as one block against per-round dispatch under deterministic
   cuDNN, rtol 1e-6 / atol 1e-7 (``[resnet18_gn]``); FedGKT (ResNet-8
   client, ResNet-56 server) on the CIFAR-10 fixture, 10 clients, 1 round,
   its steps after each phase's first replayed as CUDA graphs, the feature
   stack on the card; ``main_fedgkt``'s default card against CPU (1e-4) and
   replayed against eager steps (``[fedgkt]``);
10. BASELINE row 1 (LEAF-format MNIST fixture of 1000 clients, written and
    timed here; LogisticRegression, 10 a round, B=10, SGD 0.03, E=1, 20
    rounds, eval every 10) through ``exp/repro_mnist_lr.main``, then through
    the CLI ``exp/main_fedavg`` four times in turns (pipelined, serial,
    serial, pipelined; two blocks of 10 each; the first with every block
    dispatched under ``torch.cuda.set_sync_debug_mode("error")`` between
    eval rounds, the capture before them, the
    last with round 1 under ``torch.profiler``); all five histories bitwise
    equal, ``round_time`` aside; then FedProx (mu 0.1) with stragglers
    (frac 0.5, E=2), 5 rounds, with each round's executed client steps;
    ``--algorithm fedgan`` (3 rounds as one block against per round; 8
    clients card against CPU in float64, 1e-9: ``[fedgan]``); SplitNN's
    relay of all 1000 clients through ``main_splitnn`` (each turn card
    against CPU, 1e-5) and ``main_vfl`` (card against CPU, 1e-5: ``[split
    and vertical]``). The row's JSON is loaded once for its runs;
11. FEMNIST + CNNDropOut through the CLI (3400 clients, 10 a round, B=20,
    SGD 0.1, E=1, the registry's synthetic fallback), 3 rounds with the
    per-client eval of all 3400 clients at rounds 1 and 2: images/s of
    rounds 0-1, peak memory, and the last round under ``torch.profiler``;
    then 2 rounds as one block (a graph of 318 steps) against the same
    rounds dispatched one at a time, both under cuDNN's deterministic
    algorithms, rtol 1e-6 / atol 1e-7 (``[femnist blocks]``); then
    packed lanes (``[packed femnist]``: the same 3 rounds with
    ``--pack_lanes 2``, each pass one replay of the lane pass's CUDA graph:
    s/round beside the padded block's and per-round dispatch's, passes a
    round, lane occupancy, a round's parts and a pass under
    ``torch.profiler`` with one ``cudaGraphLaunch``; each round from the
    same variables, 10 lanes bitwise equal to the padded round and 2 lanes
    within rtol 1e-3 / atol 1e-4), the heterogeneous population
    (``[population]``: the churn spec, packed, its saved trace replayed
    bitwise, packed against padded as before) and LR's overflow passes
    (``[packed overflow]``: several replays a round bitwise equal to one,
    6 lanes bitwise equal to the padded round of 6 clients, 1 lane within
    1e-6);
12. card against CPU at a small size in f32: LR FedProx with stragglers
    (scan and vmap) free-running, the CNNs round by round from the same
    variables, CNNDropOut's eval forward and masks; the pipelined against
    the serial driver on the card, bitwise; the CLI's transformer
    (``attn_impl="xla"``: no flash launch) under ``--profile_dir``, whose
    Chrome trace must hold kernel events;
13. blocks against per-round dispatch on the card, f32, deterministic
    cuDNN, rtol 1e-6 / atol 1e-7 (``[blocks]``): LR FedProx with stragglers
    (scan, vmap), CNNDropOut (its masks), the small RNN, a ResNet-8 with
    augmentation (vmap, scan);
14. the recurrent family (no flash launch on any of its paths): both RNNs
    at a small width in f32, one vmapped cohort step on the card with every
    warning an error, then 4 vmapped FedAvg rounds card against CPU from the
    same variables, an eval every 2 (``[rnn small]``); BASELINE row 4's recipe through the
    CLI (``[shakespeare cli]``: blocks against per-round dispatch, round 1
    of each profiled with the host's CUDA calls, the capture timed);
    BASELINE row 4 through ``exp/repro_shakespeare.main`` at full width
    (715-client Markov fixture, 10 a round, B=4, SGD 1.0, E=1, seq 80; 6
    rounds, eval every 3), its pipelined loop against the serial one
    (bitwise; round 1 of the serial run under ``torch.profiler``), with the
    fixture's build time, s/round, best accuracy against the fixture's
    Bayes ceiling and peak memory (``[repro_shakespeare]``); StackOverflow
    NWP through the CLI at full width on the fallback of 100 clients (50 a
    round, B=16, SGD 10^-0.5, seq 20; 4 rounds, the last profiled), with the
    dataset on the device and with ``--stage_on_device 0``, bitwise, bytes
    staged a round (``[so_nwp]``); the tag task
    through the CLI on ``stackoverflow_lr``, 2 rounds card against CPU from
    the same variables (``[so_lr]``);
15. FedNAS (no flash launch on any of its paths): the DARTS network at a
    small width (4 channels, 3 cells, 2 steps, 8x8, B=4), f32, card against
    CPU from the same variables: its forward in evaluation and training,
    one first-order, one unrolled and one gdas search step, the gdas noise
    drawn from one CPU generator seed (``[fednas small]``);
    ``exp/main_fednas.run`` at the DARTS search width (16 channels, 8
    cells, 4 steps, B=64, SGD 0.025, Adam 3e-4 for α, first order) on the
    CIFAR-10 fallback of 2,000 images over 4 clients, 1 round, with
    s/round, search steps/s, images/s, peak memory and one search step
    under ``torch.profiler`` (``[fednas]``); and one unrolled search step
    at that width beside a first-order one, timed, with peak memory
    (``[fednas unrolled]``);
16. the server rules, checkpoints and tracing (no flash launch on any of
    their paths): FedOpt at row 4's recipe through the CLI (``--algorithm
    fedopt``, server Adam, its step count a device tensor in the round's
    graph), blocks against per-round dispatch, rtol 1e-6 / atol 1e-7,
    then the six server optimizers on a small LR card against CPU
    (``[fedopt]``, after ``[shakespeare cli]``); FedNova at row 1 with
    stragglers, E=2, 10 rounds, tau_eff by round, blocks against per round
    and card against CPU (``[fednova]``); hierarchical FedAvg at row 1, 2
    groups x 2 group rounds, 3 global rounds, card against CPU
    (``[hierarchical]``); ``--trace_dir`` at row 1, traced and untraced in
    turns, bitwise, with the span counts and the repro loop's spans
    (``[trace]``); the robust rules (median, trimmed mean, Krum, with
    clipping and DP noise) on FEMNIST + CNNDropOut at full width, 2 rounds
    as one block against per-round dispatch under deterministic cuDNN, each
    rule on the card's client stack against CPU copies (``[robust]``); and
    round checkpoints (FedAdam at row 1: 10 rounds straight against 5 and a
    resume to 10, bitwise) and a FEMNIST params file warm-starting a fresh
    run, its eval bitwise the saving run's (``[checkpoint]``);
17. update compression and gossip (no flash launch on either path):
    ``[compress]`` (after ``[robust]``) holds the six codecs' planes on the
    card bitwise to the CPU's on a ResNet-56-shaped delta, runs FEMNIST +
    CNNDropOut at its recipe with ``--compressor q4 --error_feedback 0``
    (2 rounds as one block against per-round dispatch, deterministic
    cuDNN, rtol 1e-6 / atol 1e-7) and the cross-silo flagship with top-k
    0.01 and error feedback (1 round: residual nonzero after it, uplink
    bytes 10 x one client's); ``[gossip]`` (after ``[trace]``) runs
    ``--algorithm decentralized`` at row 1 (all 1000 clients on a ring,
    3 rounds, one block against per-round dispatch, bitwise) and an
    8-client ring card against CPU within 1e-5. ``[fednas small]`` also
    runs each of its checks twice on the card under deterministic
    algorithms and prints the largest difference (ROADMAP §C, item 3);
18. federated segmentation, decentralized online learning and the
    ImageNet/Landmarks fallbacks (no flash launch on any of their paths;
    after ``[fedgkt]``): ``[fedseg]`` runs ``main_fedseg``'s defaults
    (``--model unet`` and ``--model deeplab``, 1 round) on the card and on
    the CPU from the same variables: the f32 logits and one batch's
    gradients from those variables within 1e-4, each
    client's confusion matrix bitwise but at pixels whose top two logits
    lie within 1e-4 (counted), and the round in float64 within 1e-9 (the
    card's f32 round printed against it);
    then UNet and DeepLabLite at full width (features 32/64/128, 21
    classes) on a seeded 128 x 128 fixture with 255 on a border band, 8
    clients of 16 images, 4 a round, B=8, Adam 3e-3, 2 rounds as one block
    against per-round dispatch under deterministic cuDNN, bitwise, with
    s/round, images/s, peak memory and ``evaluate_clients``'s global
    metrics; ``[vision_fed]`` runs ``main_fedavg --dataset imagenet --model
    resnet18_gn`` and ``--dataset gld23k --model mobilenet_v3`` on the
    synthetic fallbacks, 2 rounds; from the same variables card vs CPU in
    f32 the forwards at the zoo's card tolerance and every layer alone
    within 1e-5 of float64 or 10x the CPU's error, and round 1 in float64
    within 1e-9 (the f32 round printed); ``[dol]`` runs ``main_dol``'s
    defaults (DSGD, and Push-Sum on the time-varying graph) on the card
    against the CPU, regret
    within 1e-5 relative, the late half of the stream cheaper than the
    early half;
19. the message-passing wire path over the loopback fabric (no flash
    launch on any of its paths; after ``[split and vertical]``,
    ``[wire]``): ``run_distributed_fedavg_loopback`` on LR against the
    port's FedSim on the card (rtol 2e-4 / atol 2e-5) and against the same
    wire run on the CPU (1e-5); the cross-silo flagship over the wire
    (``main_fedavg --backend loopback``, CIFAR-10 + ResNet-56 bf16, 10
    silos all in the round, B=64, SGD 0.001 wd 0.001, hetero 0.5, E=1, 1
    round, cut in depth to a 10k/2k fixture, over an
    ``OrderedUplinkFabric`` under deterministic algorithms), holding the
    global bitwise the f64 weighted mean of the captured uploads, rank 1's
    upload bitwise a direct ``make_local_train`` in the JAX layout and a
    finite eval, with the round's seconds, its split from the tracer's
    spans, uplink bytes and peak memory; BASELINE row 1 over the wire, 2
    rounds, ``--is_mobile 1`` bitwise the native run and top-k + EF and q4
    streaming bitwise buffered, ``Comm/UplinkBytes`` the static figure;
    ``run_cross_silo`` card against CPU (1e-5); ``main_turboaggregate`` at
    its defaults against open FedAvg of the same round (atol 1e-3);
20. the real transports and the failure surface (no flash launch on any
    of their paths; after ``[wire]``, ``[transports]``): the port's shm
    ring built with g++ from its own copy of ``shm_ring.cpp`` into
    ``fedml_tpu_torch/ops/_build/``; the cross-silo flagship (ResNet-56
    bf16 at full width, B=64, E=1, 1 round, deterministic algorithms, 4
    silos a round on 1/40 shares of ``[wire]``'s fixture) over ``--backend
    shm``, ``mqtt_s3`` (the in-process broker, a directory store with
    offload) and ``grpc``, each holding the global bitwise the f64
    weighted mean of that run's uploads in arrival order, each rank's
    upload bitwise the same rank's over shm, a finite eval, with the
    round's seconds, ``comm/send``/``comm/recv`` seconds, uplink and
    downlink bytes and the store's blobs; the robust wire server over shm
    (median, ``--reservoir_k 0``, a clipping norm bound, rank 1's uploads
    duplicated, rank 2's corrupted): the streaming tally bitwise its
    buffered replay, the duplicate folded once, the corrupted upload
    rejected or clipped as the ``Robust/*`` record says; and LR over shm
    with a round timeout and heartbeats: a rank that drops every send
    excluded as OFFLINE, a rank whose syncs arrive late but which
    heartbeats marked SLOW with no miss, a heartbeating run bitwise a
    silent one;
21. the barrier-free server plane and the job plane (no flash launch on
    any of their paths; after ``[transports]``, ``[async]``): the flagship
    at ``[transports]``' depth over loopback under ``--server_mode async``
    (a full buffer, ``const``, 2 versions; a buffer of 2, ``poly:0.5``, 4
    versions), each emission bitwise ``replay_async_schedule`` over the
    arrivals and each version-0 upload bitwise ``[transports]``'; the
    1-tier tree, the root's global bitwise the f64 mean of the edge's
    arrivals; the ``(2, 2)`` ladder over 2 rounds (the sync tree, async
    edges at a buffer of 2 and the none-coded tier uplink bitwise alike
    per round) and the sync tree over shm bitwise its loopback run;
    ``--jobs`` with the flagship and row 1 on one wire, each job's global
    the f64 mean of its arrivals and each upload its solo run's; and
    ``run_multi_job_sim`` over two row-1 engines, each job's per-round
    globals bitwise its solo run.

Each phase prints its seconds (``[phase]``). It prints a
``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
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
        if set(rec_a) != set(rec_b):
            fail(f"two runs' records differ in keys: {rec_a} {rec_b}")
        for key in ("Train/Loss", "Train/Acc", "Test/Acc", "Test/Loss"):
            if key in rec_b:
                err = max(err, abs(rec_a[key] - rec_b[key]))
    return err


def _capture(sim, variables, tag):
    """Capture ``sim``'s round graph before a run (its warm-up round and the
    capture stay out of the run and of the launch counts taken over it);
    returns the seconds."""
    seconds = sim.capture_round_graph(variables=variables)
    log(f"{tag} round captured as a CUDA graph in {seconds:.3f} s (one warm-up round on "
        f"scratch copies, then the capture)")
    return seconds


def phase_small_end_to_end(torch, mode):
    """A few FedAvg rounds of a small f32 TransformerLM with the flash path
    in cohort mode ``mode``: on the card (the kernel) against the same
    rounds on the CPU (the plain version), from the same variables and data,
    with an eval every round, each held to the CPU's. Returns the f32
    kernel's launches in the card run; in vmap they must be
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
    # an eval every round, each held to the CPU's: each round is a block of
    # one, a replay of the round's graph on the card
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
            _capture(sim, {k: t_.to(device) for k, t_ in init.items()}, f"[e2e {mode}]")
            attn.FLASH_FWD_F32_LAUNCHES = attn.FLASH_FWD_BF16_LAUNCHES = 0
        variables, history = sim.run(variables={k: t_.to(device) for k, t_ in init.items()})
        if device == "cuda":
            torch.cuda.synchronize()
            launches = (attn.FLASH_FWD_F32_LAUNCHES, attn.FLASH_FWD_BF16_LAUNCHES)
        runs[device] = (variables, history)
    err = _max_err(torch, (runs["cuda"], runs["cpu"]))
    h_gpu = runs["cuda"][1]
    steps = steps_per_epoch(max(len(p) for p in part.values()), cfg.batch_size)
    evals = sum("Test/Loss" in rec for rec in h_gpu) * (
        steps_per_epoch(n, cfg.eval_batch_size) + steps_per_epoch(8, cfg.eval_batch_size))
    expected = layers * (cfg.comm_round * cfg.epochs * steps + evals)
    log(f"[e2e {mode}] small TransformerLM, 2 FedAvg rounds with an eval each, two blocks "
        f"of one (replays of the round's CUDA graph on the card), card vs CPU (f32, flash): "
        f"max_abs_err={err:.3e} (params, losses, both evals); Test/Loss "
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
    scan on the card, from the same variables and data, with an eval every
    round, each compared. Batch 16 and lr
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
    log(f"[resnet] depth-8 ResNet f32, 2 vmapped FedAvg rounds with an eval each (blocks of "
        f"one, graph replays on the card; 5 ragged clients, BN, wd, "
        f"augmentation): card vs CPU max_abs_err={card_cpu:.3e}, vmap vs scan on the card "
        f"max_abs_err={vmap_scan:.3e} (params, BN statistics, losses, eval); Test/Acc "
        f"{runs[('cuda', 'vmap')][1][-1]['Test/Acc']:.4f}")
    if not card_cpu <= E2E_ATOL:
        fail(f"small ResNet on the card disagrees with the CPU run: {card_cpu} > {E2E_ATOL}")
    if not vmap_scan <= E2E_ATOL:
        fail(f"small ResNet vmap disagrees with scan on the card: {vmap_scan} > {E2E_ATOL}")


MAIN = dict(vocab=32000, embed_dim=2048, num_layers=8, num_heads=16, seq=1024,
            clients=2, batch=8, steps=4, rounds=2, held_out=16, dtype="bfloat16")
# the same LM in f32 compute, the JAX package's default; 2 rounds of 2 clients
# x 1 step (one block: the round's graph replayed twice) keep the script
# inside its time limit
MAIN_F32 = dict(MAIN, steps=1, rounds=2, dtype="float32")


def phase_main_path(torch, c):
    """The main path: FedAvg rounds of the full-width TransformerLM in
    ``c["dtype"]`` compute with the flash kernel, through the entry points a
    user calls. Synthetic tokens from numpy.random.RandomState(0), as the JAX
    package's LM bench makes them. Fails unless the kernel of that dtype ran
    on every layer's forward and the other never. Returns each kernel's
    launch count in this run, counted per launch on the device. The rounds
    make one eval-aligned block (block dispatch, on by default on the card):
    the round is captured as a CUDA graph first (timed; its warm-up round
    stays out of the counts) and the run replays it once a round, the flash
    kernel inside it. The serial driver (``pipeline_depth=0``) synchronises
    at the block's end."""
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
                    cohort_execution="scan", pipeline_depth=0)
    sim = FedSim(trainer, FederatedArrays({"x": x[:n], "y": y[:n], "mask": mask[:n]}, part),
                 {"x": x[n:], "y": y[n:], "mask": mask[n:]}, cfg)
    variables = sim.init_variables()
    initial = {k: t.clone() for k, t in variables.items()}
    n_params = sum(t.numel() for t in variables.values())
    tag = f"[main {c['dtype']}]"
    if sim._dispatch_plan(0) != [(0, c["rounds"])]:
        fail(f"{tag} the rounds do not make one block: {sim._dispatch_plan(0)}")
    capture_s = _capture(sim, variables, tag)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
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
    for rec in history:
        log(f"{tag} round {rec['round']}: Train/Loss {rec['Train/Loss']:.5f} "
            f"round_time {rec['round_time']:.3f} s "
            f"({tokens_per_round / rec['round_time']:.0f} tokens/s)"
            + (f" Test/Loss {rec['Test/Loss']:.5f} Test/Acc {rec['Test/Acc']:.6f}"
               if "Test/Loss" in rec else ""))
    log(f"{tag} TransformerLM V={c['vocab']} D={c['embed_dim']} L={c['num_layers']} "
        f"H={c['num_heads']} T={c['seq']} {c['dtype']} flash, {n_params} params; "
        f"{c['clients']} clients x {c['steps']} steps x batch {c['batch']}, {c['rounds']} "
        f"rounds in {wall:.3f} s (one block, graph replays; capture {capture_s:.3f} s before "
        f"it); device memory held after the capture {held / 2**30:.2f} GiB, peak in the run "
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

    # the same rounds dispatched one at a time (eager rounds, every kernel
    # launched from the host, as before blocks), from the same variables and
    # in the same process: what the block costs or saves on this path
    eager = FedSim(trainer, FederatedArrays({"x": x[:n], "y": y[:n], "mask": mask[:n]}, part),
                   {"x": x[n:], "y": y[n:], "mask": mask[n:]},
                   dataclasses.replace(cfg, block_dispatch=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, eager_history = eager.run(variables=initial)
    torch.cuda.synchronize()
    eager_wall = time.perf_counter() - t0
    gap = max(abs(a[k] - b[k]) for a, b in zip(history, eager_history)
              for k in ("Train/Loss", "Test/Loss") if k in b)
    rounds = [", ".join(f"{rec['round_time']:.4f}" for rec in h) for h in (history, eager_history)]
    log(f"{tag} blocks against per-round dispatch in one process: "
        f"{wall / c['rounds']:.4f} s a round in one block (round_time {rounds[0]}) against "
        f"{eager_wall / c['rounds']:.4f} s a round eager (round_time {rounds[1]}); largest "
        f"loss difference {gap:.3e}")
    return launches


# the cross-silo flagship (repro_cross_silo.py's recipe), cut to E=1 and 2
# rounds with one eval at the end; widths, depth, clients and batch as they are
CROSS_SILO = dict(n_train=50_000, n_test=10_000, clients=10, batch=64, epochs=1, rounds=1)


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
    calls, in the vmapped cohort (2 rounds; the scan mode's round is
    MobileNet's, ``[cross_silo zoo]``). Fails on non-finite metrics or a
    first-round loss far from
    ln 10: within [ln 10 - 1, ln 10 + 3], since at flax's initialisation
    ResNet-56's logits have a standard deviation near 2 (the residual
    stream grows over 27 blocks), which puts the loss of the first steps
    near 3-4 in the JAX package and the port alike. Returns the rounds'
    times."""
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
            "--ceiling_epochs", "0", "--round_sleep", "0", "--device", "cuda"]
    runs = {}
    for mode, rounds in (("vmap", c["rounds"]),):
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
    return [rec["round_time"] for rec in runs["vmap"][1]]


# the CIFAR zoo of ROADMAP §A7 at full width: the names of the JAX registry,
# each with its federated recipe's step (cross-silo SGD 0.001 wd 0.001;
# resnet18_gn fed_cifar100's SGD 0.1); dropout and drop-connect at 0
ZOO = {"resnet18_gn": (0.1, 0.0, {}), "mobilenet": (1e-3, 1e-3, {}),
       "mobilenet_v3": (1e-3, 1e-3, {}), "vgg11": (1e-3, 1e-3, {"dropout_rate": 0.0}),
       "efficientnet-b0": (1e-3, 1e-3, {"dropout_rate": 0.0, "drop_connect_rate": 0.0})}
# repro_cross_silo's recipe on a CIFAR-100 fixture with MobileNet, cut to E=1
# and 1 round [100], with a 1-epoch fixture ceiling, on 25k/5k images
# [50k/10k] (~400 client steps a round in scan, for the script's time budget)
CROSS_SILO_ZOO = dict(CROSS_SILO, n_train=25_000, n_test=5_000, rounds=1, classes=100,
                      ceiling_epochs=1)
# repro_fed_cifar100.py's recipe (10 clients a round, B=20, SGD 0.1, bf16) on
# the registry's fed_cifar100 fallback, which reads a 50k/10k CIFAR-100
# fixture; 500 clients of 100 images (homo), 2 rounds
RESNET18_GN = dict(clients=500, per_round=10, batch=20, lr=0.1, rounds=2, n_train=50_000,
                   n_test=10_000)


def _out_and_state(out, stateful):
    return out if stateful else (out, {})


def _calibrated(model, init, stats):
    """``init`` with each BatchNorm's running statistics replaced by the
    batch statistics its training forward took (backed out of the momentum
    update ``new = m * old + (1 - m) * batch``), so that evaluation runs
    through statistics of the data's own scale."""
    out = dict(init)
    for k, new in stats.items():
        m = model.get_submodule(k.rsplit(".", 1)[0]).momentum
        batch = (new.cpu() - m * init[k]) / (1 - m)
        out[k] = batch.clamp_min(0.0) if k.endswith("running_var") else batch
    return out


def _zoo_round(torch, name, lr, wd, kwargs, init, data, device, dtype=None):
    """One vmapped FedAvg round of ``[zoo small]`` on ``device``:
    ``(variables, history)``."""
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.sim.cohort import FederatedArrays
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    xs, ys, part = data
    model = create_model(name, 10, "cifar10", device=device, **kwargs)
    if dtype is not None:  # the float64 reference of the CPU's rounding
        model = model.double()
        for mod in model.modules():
            if isinstance(getattr(mod, "dtype", None), torch.dtype):
                mod.dtype = dtype
        xs = xs.astype(np.float64)
    cfg = SimConfig(client_num_in_total=2, client_num_per_round=2, batch_size=4,
                    comm_round=1, epochs=1, frequency_of_the_test=1, eval_batch_size=8,
                    seed=0, cohort_execution="vmap")
    sim = FedSim(ClientTrainer(module=model, optimizer=sgd(lr, weight_decay=wd)),
                 FederatedArrays({"x": xs[:16], "y": ys[:16]}, part),
                 {"x": xs[16:], "y": ys[16:]}, cfg, device=device)
    return sim.run(variables={k: v.to(device, dtype or v.dtype) for k, v in init.items()})


def phase_zoo_small(torch):
    """The CIFAR zoo (``ZOO``: resnet18_gn, mobilenet, mobilenet_v3 large,
    vgg11, efficientnet-b0) at full width, f32 under deterministic cuDNN,
    card against CPU from the same variables (the port's seeded init, made
    on the CPU and copied), on 4 images of 32x32: the training forward
    (logits and new BN statistics), the eval forward through BN statistics
    calibrated to the batch (:func:`_calibrated`), each within 1e-4; then
    one vmapped FedAvg round of 2 clients x 2 steps (B=4) at the model's
    recipe with an eval, a replay of the round's CUDA graph on the card,
    within 1e-4 or, where f32 itself is further off, within twice the CPU
    run's distance from the same round in float64 (MobileNet V1's deep
    plain ReLU + BatchNorm stack: its early layers' f32 gradients are
    1e-3-ish off float64 at flax's initialisation). Returns the flash
    launches (none)."""
    from fedml_tpu_torch.models.registry import create_model

    rng = np.random.RandomState(0)
    x = rng.randn(4, 32, 32, 3).astype(np.float32)
    data = (rng.randn(24, 32, 32, 3).astype(np.float32), rng.randint(0, 10, 24).astype(np.int32),
            {0: np.arange(0, 8), 1: np.arange(8, 16)})
    _zero_flash_counters()
    torch.backends.cudnn.deterministic = True
    try:
        for name, (lr, wd, kwargs) in ZOO.items():
            t0 = time.perf_counter()
            models = {d: create_model(name, 10, "cifar10", device=d, **kwargs)
                      for d in ("cpu", "cuda")}
            init = {k: v.clone() for k, v in models["cpu"].state_dict().items()}
            stateful = next(models["cpu"].buffers(), None) is not None
            out = {}
            for d in ("cpu", "cuda"):
                m, xd = models[d], torch.tensor(x, device=d)
                m.load_state_dict(init)
                with torch.no_grad():
                    tr, stats = _out_and_state(m(xd, train=True), stateful)
                    if d == "cpu":
                        calibrated = _calibrated(m, init, stats)
                    m.load_state_dict(calibrated)
                    out[d] = [m(xd), tr, *stats.values()]
            errs = [float((a.cpu() - b).abs().max()) for a, b in zip(out["cuda"], out["cpu"])]
            runs = {d: _zoo_round(torch, name, lr, wd, kwargs, init, data, d)
                    for d in ("cuda", "cpu")}
            round_err = _max_err(torch, (runs["cuda"], runs["cpu"]))
            bound, f64_note = E2E_ATOL, ""
            if round_err > E2E_ATOL:
                f64 = _zoo_round(torch, name, lr, wd, kwargs, init, data, "cpu", torch.float64)
                cpu_f64 = _max_err(torch, (runs["cpu"], f64))
                bound = max(E2E_ATOL, 2 * cpu_f64)
                f64_note = f" (the CPU's f32 round is {cpu_f64:.3e} off float64: bound {bound:.3e})"
            rec = runs["cuda"][1][-1]
            log(f"[zoo small] {name} ({sum(v.numel() for v in init.values()) / 1e6:.2f}M "
                f"variables, f32, 4 x 32x32): card vs CPU training forward "
                f"max_abs_err={errs[1]:.3e}"
                + (f", new BN statistics {max(errs[2:]):.3e}" if len(errs) > 2 else "")
                + f", eval forward {errs[0]:.3e} (logits up to "
                f"{float(out['cpu'][0].abs().max()):.3f}); one vmapped FedAvg round of 2 clients "
                f"x 2 steps (SGD {lr}, wd {wd}, a graph replay on the card) {round_err:.3e}"
                f"{f64_note}; Train/Loss {rec['Train/Loss']:.5f}, Test/Loss "
                f"{rec['Test/Loss']:.5f}; {time.perf_counter() - t0:.2f} s")
            if not max(errs) <= E2E_ATOL or not round_err <= bound:
                fail(f"zoo small: {name} on the card disagrees with the CPU: eval/train "
                     f"{errs} > {E2E_ATOL} or round {round_err} > {bound}")
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    log(f"[zoo small] flash launches {_flash_launches()}")
    return _flash_launches()


def phase_cross_silo_zoo(torch):
    """``repro_cross_silo.run`` on a 25k/5k CIFAR-100 fixture (its
    write timed) with ``--model mobilenet`` at full width: 10 silos, B=64,
    hetero 0.5, bf16, augmentation, E=1, 1 round, in scan (the recipe's
    rule) with ``--ceiling_epochs 1``, then the same round in vmap (the
    mode the rule avoids), each with s/round, images/s and peak memory.
    Fails on non-finite metrics or a ceiling outside [0, 1]. Returns the
    flash launches (none)."""
    from fedml_tpu_torch.core import partition
    from fedml_tpu_torch.data import cv
    from fedml_tpu_torch.exp import repro_cross_silo as repro
    from fedml_tpu_torch.sim.cohort import steps_per_epoch

    c = CROSS_SILO_ZOO
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    data_dir = BUILD_DIR / "cifar100_zoo"
    t0 = time.perf_counter()
    repro.write_cifar100_fixture(data_dir, n_train=c["n_train"], n_test=c["n_test"],
                                 seed=0, signal=0.045)
    write_s = time.perf_counter() - t0
    argv = ["--dataset", "cifar100", "--model", "mobilenet", "--data_dir", str(data_dir),
            "--fixture_train_n", str(c["n_train"]), "--fixture_test_n", str(c["n_test"]),
            "--fixture_signal", "0.045", "--partition_method", "hetero",
            "--partition_alpha", "0.5", "--client_num_in_total", str(c["clients"]),
            "--batch_size", str(c["batch"]), "--lr", "0.001", "--wd", "0.001",
            "--epochs", str(c["epochs"]), "--comm_round", str(c["rounds"]),
            "--frequency_of_the_test", str(c["rounds"]), "--round_sleep", "0",
            "--device", "cuda"]
    (_, y), _, _ = cv._load_cifar100_raw(data_dir)
    sizes = np.array([len(p) for p in partition.partition(
        "hetero", y, c["clients"], 0.5, 0).values()])
    executed = int(sum(steps_per_epoch(int(n), c["batch"]) for n in sizes)) * c["epochs"]
    _zero_flash_counters()
    runs = {}
    for mode, extra in (("scan", ["--ceiling_epochs", str(c["ceiling_epochs"])]),
                        ("vmap", ["--cohort_execution", "vmap", "--ceiling_epochs", "0"])):
        metrics = BUILD_DIR / f"cross_silo_zoo_{mode}.jsonl"
        args = repro.add_args(argparse.ArgumentParser()).parse_args(
            argv + extra + ["--metrics_out", str(metrics)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = repro.run(args)
        wall = time.perf_counter() - t0
        records = [json.loads(line) for line in metrics.read_text().splitlines()]
        runs[mode] = (result, records, wall, torch.cuda.max_memory_allocated())
        if args.cohort_execution != mode or len(records) != c["rounds"]:
            fail(f"cross_silo zoo {mode}: ran in {args.cohort_execution}, "
                 f"{len(records)} of {c['rounds']} rounds")
        values = [v for rec in records for k, v in rec.items() if k != "round"]
        if not all(np.isfinite(values)):
            fail(f"cross_silo zoo {mode} produced non-finite metrics: {records}")
        torch.cuda.empty_cache()
    log(f"[cross_silo zoo] CIFAR-100 fixture {c['n_train']}/{c['n_test']} written in "
        f"{write_s:.2f} s; MobileNet bf16, hetero alpha=0.5, {c['clients']} clients x "
        f"B={c['batch']}, E={c['epochs']}: client sizes {sizes.tolist()}, {executed} executed "
        f"client steps a round")
    for mode, (result, records, wall, peak) in runs.items():
        t = records[-1]["round_time"]
        log(f"[cross_silo zoo {mode}] round {records[-1]['round']}: {t:.3f} s, "
            f"{executed * c['batch'] / t:.1f} images/s (executed steps x {c['batch']}), "
            f"Train/Loss {records[-1]['Train/Loss']:.5f}, Test/Acc "
            f"{records[-1]['Test/Acc']:.4f}; run() {wall:.2f} s; peak device memory "
            f"{peak / 2**30:.2f} GiB; result {json.dumps(result)}")
    ceiling = runs["scan"][0].get("fixture_ceiling")
    if ceiling is None or not 0.0 <= ceiling <= 1.0:
        fail(f"cross_silo zoo: bad fixture ceiling {ceiling}")
    scan_t, vmap_t = (runs[m][1][-1]["round_time"] for m in ("scan", "vmap"))
    log(f"[cross_silo zoo] MobileNet round time scan {scan_t:.3f} s against vmap "
        f"{vmap_t:.3f} s (vmap/scan {vmap_t / scan_t:.3f}); peak memory scan "
        f"{runs['scan'][3] / 2**30:.2f} GiB, vmap {runs['vmap'][3] / 2**30:.2f} GiB; fixture "
        f"ceiling after {runs['scan'][0]['ceiling_epochs']} centralized epoch(s) "
        f"{ceiling:.4f}; flash launches {_flash_launches()}")
    return _flash_launches()


def phase_resnet18_gn(torch):
    """``main_fedavg --dataset fed_cifar100 --model resnet18_gn`` on the
    registry's fallback (a 50k/10k CIFAR-100 fixture, 500 clients of 100
    images) at ``repro_fed_cifar100.py``'s recipe: 10 clients
    a round, B=20, SGD 0.1, bf16, vmapped; 2 rounds as one block (replays of
    the round's CUDA graph) against the same rounds dispatched one at a
    time, under deterministic cuDNN, rtol 1e-6 / atol 1e-7, with s/round in
    each mode and peak memory. Returns the flash launches (none)."""
    from fedml_tpu_torch.exp import repro_cross_silo as repro

    c = RESNET18_GN
    data_dir = BUILD_DIR / "cifar100"
    repro.write_cifar100_fixture(data_dir, n_train=c["n_train"], n_test=c["n_test"],
                                 seed=0, signal=0.045)
    argv = ["--dataset", "fed_cifar100", "--model", "resnet18_gn", "--data_dir", str(data_dir),
            "--partition_method", "homo", "--client_num_in_total", str(c["clients"]),
            "--client_num_per_round", str(c["per_round"]), "--batch_size", str(c["batch"]),
            "--lr", str(c["lr"]), "--model_dtype", "bfloat16", "--comm_round", str(c["rounds"]),
            "--frequency_of_the_test", str(c["rounds"])]
    _zero_flash_counters()
    runs, peaks = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, call in (("blocks", _cli), ("per round", _per_round_cli)):
            torch.cuda.reset_peak_memory_stats()
            runs[name] = call(torch, argv)
            peaks[name] = torch.cuda.max_memory_allocated()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    for name, (history, wall) in runs.items():
        times = ", ".join(f"{rec['round_time']:.4f}" for rec in history)
        log(f"[resnet18_gn] {name}: s/round {times}; Train/Loss "
            + ", ".join(f"{rec['Train/Loss']:.6f}" for rec in history)
            + f", Test/Acc {history[-1]['Test/Acc']:.4f}; run {wall:.2f} s; peak device "
            f"memory {peaks[name] / 2**30:.2f} GiB")
        values = [v for rec in history for k, v in rec.items() if k != "round"]
        if len(history) != c["rounds"] or not all(np.isfinite(values)):
            fail(f"resnet18_gn {name}: bad history {history}")
    (over, beyond), (diff, where) = _block_gap(torch, [({}, runs[k][0])
                                                      for k in ("blocks", "per round")])
    log(f"[resnet18_gn] deterministic cuDNN, one block of {c['rounds']} graph replays vs "
        f"per-round dispatch: largest difference {diff:.3e} ({where}), bitwise equal "
        f"{diff == 0.0}; flash launches {_flash_launches()}")
    if over > 0:
        fail(f"resnet18_gn: {beyond} differs beyond rtol {BLOCK_RTOL} / atol {BLOCK_ATOL} "
             f"(by {over:.3e} over)")
    return _flash_launches()


# the unified CLI's rows at full width (ROADMAP §A5, §A6): BASELINE row 1,
# LEAF MNIST + LogisticRegression (1000 clients, 10 a round, B=10, SGD 0.03,
# E=1), and the reference's FEMNIST recipe (3400 clients, 10 a round, B=20,
# SGD 0.1, E=1; fedml_tpu/exp/repro_femnist_cnn.py:3-6) with CNNDropOut on
# the registry's synthetic_leaf_mnist fallback (no h5 reader on the card)
MNIST = dict(clients=1000, per_round=10, batch=10, lr=0.03, epochs=1, rounds=20, freq=10)
# 3 rounds (5 before PR 13, cut for the script's time budget)
FEMNIST = dict(clients=3400, per_round=10, batch=20, lr=0.1, epochs=1, rounds=3)
FEDPROX = dict(mu=0.1, straggler_frac=0.5, epochs=2, rounds=5)


@contextlib.contextmanager
def _wrapped(cls, name, make):
    """Replace ``cls.name`` by ``make(original)`` for the block."""
    original = getattr(cls, name)
    setattr(cls, name, make(original))
    try:
        yield
    finally:
        setattr(cls, name, original)


def _timing(into, sync=None):
    """A ``_wrapped`` maker that appends each call's seconds to ``into``,
    between two calls of ``sync`` when given."""
    def make(original):
        def timed(*args, **kwargs):
            if sync is not None:
                sync()
            t0 = time.perf_counter()
            out = original(*args, **kwargs)
            if sync is not None:
                sync()
            into.append(time.perf_counter() - t0)
            return out
        return timed
    return make


def _cli(torch, argv, device="cuda"):
    """The port's CLI (``exp/main_fedavg``) on ``device`` (the card by
    default): (history, seconds)."""
    from fedml_tpu_torch.exp import main_fedavg as cli

    args = cli.parse_with_config(cli.add_args(argparse.ArgumentParser()),
                                 argv + ["--device", device])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = cli.run(args)
    torch.cuda.synchronize()
    return history, time.perf_counter() - t0


def _flash_launches():
    from fedml_tpu_torch.ops import attention as attn

    return {name: getattr(attn, spec["counter"]) for name, spec in KERNELS.items()}


def _zero_flash_counters():
    from fedml_tpu_torch.ops import attention as attn

    for spec in KERNELS.values():
        setattr(attn, spec["counter"], 0)


def _staging_recorder():
    """Wrap ``FedSim._host_cohort_indices`` (the host half of staging, run on
    the prefetch thread) to keep each round's index map and step budgets:
    what the run itself trained on."""
    from fedml_tpu_torch.sim.engine import FedSim

    staged = {}

    def make(original):
        def recorded(self, cohort, round_idx):
            out = original(self, cohort, round_idx)
            staged[round_idx] = (out[0], out[2], self._steps, self.trainer.epochs)
            return out
        return recorded

    return staged, _wrapped(FedSim, "_host_cohort_indices", make)


def _executed_steps(idx, budgets, steps, epochs):
    """Client steps with data inside each client's budget (what the masked
    step computes for real), and the same count without the budgets."""
    has_data = (idx >= 0).any(axis=2)  # [C, S]
    t = np.arange(epochs)[:, None] * steps + np.arange(steps)[None, :]  # [E, S]
    inside = t[None] < budgets[:, None, None]  # [C, E, S]
    return int((inside & has_data[:, None, :]).sum()), int(has_data.sum()) * epochs


def _strip_times(history):
    return [{k: v for k, v in rec.items() if k != "round_time"} for rec in history]


@contextlib.contextmanager
def _loaded_once(loads):
    """Keep each dataset ``data.registry.load_partition_data`` loads for the
    block, so runs of one row read its files once; ``loads`` gets each real
    load's seconds."""
    import inspect

    from fedml_tpu_torch.data import registry

    original, kept = registry.load_partition_data, {}
    signature = inspect.signature(original)

    def load_partition_data(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        key = repr(sorted(bound.arguments.items()))
        if key not in kept:
            t0 = time.perf_counter()
            kept[key] = original(*args, **kwargs)
            loads.append(time.perf_counter() - t0)
        return kept[key]

    registry.load_partition_data = load_partition_data
    try:
        yield
    finally:
        registry.load_partition_data = original


def _profiled(torch, got, fn, *args, host=False, **kwargs):
    """``fn(*args, **kwargs)`` under ``torch.profiler`` (device activity
    only, or with ``host`` the host's too), between two synchronisations;
    puts into ``got`` its device kernels and copies, their busy time, the
    call's wall time, the three kernels with the most device time and the
    count of each CUDA runtime call the host made (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ...); ``union_us`` is the time some kernel or copy
    ran (their intervals' union; ``busy_us`` sums their durations)."""
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        got["wall"] = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    got["kernels"] = len(device)
    got["busy_us"] = sum(e.time_range.elapsed_us() for e in device)
    union, end = 0.0, None
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in device):
        if end is None or start > end:
            union, end = union + stop - start, stop
        elif stop > end:
            union, end = union + stop - end, stop
    got["union_us"] = union
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    got["top"] = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    api: dict[str, int] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA and e.name.startswith("cuda"):
            api[e.name] = api.get(e.name, 0) + 1
    got["api"] = api
    return out


@contextlib.contextmanager
def _profile_round(torch, round_idx, got, host=False):
    """Run round ``round_idx`` under ``torch.profiler`` (``_profiled``),
    whether it is dispatched alone (``FedSim.run_staged_round``) or replayed
    in a block (``RoundGraph.replay_round``), and add to ``got`` the round's
    local steps and its dispatch."""
    from fedml_tpu_torch.sim.engine import FedSim
    from fedml_tpu_torch.sim.graphs import RoundGraph

    def eager(original):
        def run_staged_round(self, staged, *args, **kwargs):
            if staged.round_idx != round_idx:
                return original(self, staged, *args, **kwargs)
            got["steps"], got["dispatch"] = self._steps * self.trainer.epochs, "eager round"
            return _profiled(torch, got, original, self, staged, *args, host=host, **kwargs)
        return run_staged_round

    def replayed(original):
        def replay_round(self, sim, block, j):
            if block.round_idx + j != round_idx:
                return original(self, sim, block, j)
            got["steps"], got["dispatch"] = sim._steps * sim.trainer.epochs, "graph replay"
            return _profiled(torch, got, original, self, sim, block, j, host=host)
        return replay_round

    with _wrapped(FedSim, "run_staged_round", eager), \
            _wrapped(RoundGraph, "replay_round", replayed):
        yield


def _log_profile(name, round_idx, got):
    top = "; ".join(f"{k[:60]} {us / 1e3:.3f} ms ({us / max(got['busy_us'], 1e-9):.1%})"
                    for k, us in got.get("top", []))
    api = ", ".join(f"{k} {n}" for k, n in sorted(got["api"].items()) if n)
    log(f"[profile] {name}: round {round_idx} ({got['dispatch']}) under torch.profiler: "
        f"{got['kernels']} device kernels and copies over {got['steps']} local steps, "
        f"{got['kernels'] / got['steps']:.1f} a step; device busy {got['busy_us'] / 1e3:.3f} "
        f"ms of {got['wall'] * 1e3:.3f} ms wall ({1 - got['busy_us'] / 1e6 / got['wall']:.1%} "
        f"idle, profiler on); host CUDA calls: {api or 'none recorded'}; most device time: "
        f"{top}")


def phase_repro_mnist_lr(torch):
    """BASELINE row 1 through its own entry point,
    ``exp/repro_mnist_lr.main``, at full width on the card (1000 clients, 10
    a round, B=10, SGD 0.03, E=1), 20 rounds with an eval every 10. It
    writes the LEAF-format fixture (timed) that the CLI phases then read.
    Returns the flash kernels' launches, the fixture directory and the
    run's round records."""
    from fedml_tpu_torch.data import leaf_fixture
    from fedml_tpu_torch.exp import repro_mnist_lr

    c = MNIST
    data_dir, metrics = BUILD_DIR / "mnist", BUILD_DIR / "repro_mnist_lr.jsonl"
    written = []
    _zero_flash_counters()
    t0 = time.perf_counter()
    with _wrapped(leaf_fixture, "write_leaf_mnist_fixture", _timing(written)):
        result = repro_mnist_lr.main([
            "--data_dir", str(data_dir), "--client_num_in_total", str(c["clients"]),
            "--client_num_per_round", str(c["per_round"]), "--batch_size", str(c["batch"]),
            "--lr", str(c["lr"]), "--comm_round", str(c["rounds"]),
            "--frequency_of_the_test", str(c["freq"]), "--metrics_out", str(metrics),
            "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _flash_launches()
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    evals = [r for r in records if "Test/Acc" in r]
    if len(written) != 1 or result["clients"] != c["clients"]:
        fail(f"repro_mnist_lr: fixture writes {written}, result {result}")
    if len(records) != c["rounds"] or len(evals) != c["rounds"] // c["freq"] \
            or not all(np.isfinite([v for r in records for v in r.values()])):
        fail(f"repro_mnist_lr: bad records {records}")
    times = [r["round_time"] for r in records]
    log(f"[repro_mnist_lr] LEAF-format fixture, {c['clients']} clients, written in "
        f"{written[0]:.2f} s; {result['samples']} training samples")
    log(f"[repro_mnist_lr] exp/repro_mnist_lr.main, {c['rounds']} rounds x {c['per_round']} "
        f"clients x B={c['batch']}, SGD {c['lr']}, eval every {c['freq']}: {result['rounds_per_sec']} "
        f"rounds/s (its own figure: rounds over the run's wall time, evals included); mean "
        f"round time {np.mean(times) * 1e3:.3f} ms, steady state (rounds {c['freq']}-"
        f"{c['rounds'] - 1}) {np.mean(times[c['freq']:]) * 1e3:.3f} ms a round; best Test/Acc "
        f"{result['best_test_acc']}, final {result['final']}; main() {wall:.2f} s (fixture and "
        f"load included); flash launches {launches}")
    return launches, data_dir, records


def phase_mnist_lr(torch, data_dir, repro_records):
    """BASELINE row 1 through the port's CLI at full width, four times in
    turns: the default driver (pipelined, depth 1), ``--pipeline_depth 0``
    twice, the default again. The rounds run in two eval-aligned blocks of
    10, each replaying the round's CUDA graph. Every block's dispatch in the
    first run runs under ``torch.cuda.set_sync_debug_mode("error")``, lifted
    only from each sync point (the metrics drain's flush, at eval rounds) to
    the next dispatch, so a synchronisation between eval rounds fails the
    run; the capture (its warm-up round synchronises) comes before the first
    block, outside that window. All
    four histories, and ``repro_mnist_lr``'s records of the same row, must
    be bitwise equal, ``round_time`` aside. The last run profiles round 1
    (outside the steady-state rounds). Returns the flash kernels' launches
    in the first run."""
    from fedml_tpu_torch.sim.engine import FedSim
    from fedml_tpu_torch.sim.prefetch import MetricsDrain

    c = MNIST
    argv = ["--dataset", "mnist", "--model", "lr", "--data_dir", str(data_dir),
            "--client_num_in_total", str(c["clients"]),
            "--client_num_per_round", str(c["per_round"]), "--batch_size", str(c["batch"]),
            "--lr", str(c["lr"]), "--epochs", str(c["epochs"]), "--comm_round", str(c["rounds"]),
            "--frequency_of_the_test", str(c["freq"])]
    guarded = []

    def guard_dispatch(original):
        def run_block(self, start_round, n_rounds, *args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            guarded.append((start_round, n_rounds))
            return original(self, start_round, n_rounds, *args, **kwargs)
        return run_block

    def lift_at_sync(original):
        def flush(self):
            torch.cuda.set_sync_debug_mode(0)
            return original(self)
        return flush

    staged, recording = _staging_recorder()
    _zero_flash_counters()
    try:
        with _wrapped(FedSim, "run_block", guard_dispatch), \
                _wrapped(MetricsDrain, "flush", lift_at_sync), recording:
            pipelined, wall_p = _cli(torch, argv)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = _flash_launches()
    blocks = [(r, c["freq"]) for r in range(0, c["rounds"], c["freq"])]
    if guarded != blocks:
        fail(f"mnist: the sync guard saw blocks {guarded}, expected {blocks}")
    # then serial, serial, pipelined (unguarded, round 1 profiled): the two
    # drivers in turns
    runs = [("pipelined, guarded", pipelined, wall_p)]
    for name, extra in (("serial", ["--pipeline_depth", "0"]),
                        ("serial", ["--pipeline_depth", "0"])):
        runs.append((name,) + _cli(torch, argv + extra))
    profile = {}
    with _profile_round(torch, 1, profile):
        runs.append(("pipelined, round 1 profiled",) + _cli(torch, argv))
    for name, history, _ in runs[1:] + [("repro_mnist_lr", repro_records, None)]:
        if _strip_times(history) != _strip_times(pipelined):
            fail(f"mnist: the {name} history differs from the first pipelined run's")
    values = [v for rec in pipelined for v in rec.values()]
    if not all(np.isfinite(values)) or len(pipelined) != c["rounds"]:
        fail(f"mnist: bad history {pipelined}")
    idx, _, steps, _ = staged[0]
    log(f"[mnist] {c['rounds']} rounds x {c['per_round']} clients x B={c['batch']}, "
        f"{steps} steps a client-epoch (the population max), vmap, SGD {c['lr']}; the "
        f"pipelined run dispatched its blocks {guarded} (first round, rounds) under "
        f"sync_debug_mode('error'), the capture before them; "
        f"4 runs in turns (pipelined, serial, serial, pipelined) and repro_mnist_lr's run: "
        f"histories bitwise equal (round_time aside); flash launches {launches}")
    half = c["freq"]
    for name, history, wall in runs:
        times = [rec["round_time"] for rec in history]
        steady = sum(times[half:])
        log(f"[mnist {name}] mean round time {np.mean(times) * 1e3:.3f} ms over "
            f"{len(times)} rounds; steady state (rounds {half}-{len(times) - 1}) "
            f"{steady / (len(times) - half) * 1e3:.3f} ms a round, "
            f"{(len(times) - half) / steady:.2f} rounds/s; run {wall:.2f} s (evals included, "
            f"data loaded once for the row); rounds 0-{half - 1} "
            f"{np.mean(times[:half]) * 1e3:.3f} ms a round; Test/Acc "
            f"{history[half - 1]['Test/Acc']:.4f} (round {half - 1}), "
            f"{history[-1]['Test/Acc']:.4f} (round {len(times) - 1})")
    _log_profile("mnist_lr", 1, profile)
    if not pipelined[-1]["Test/Acc"] > 0.3:
        fail(f"mnist: Test/Acc {pipelined[-1]['Test/Acc']} after {c['rounds']} rounds")
    return launches


def phase_femnist_cnn(torch):
    """The FEMNIST recipe with CNNDropOut through the port's CLI at full
    width: 3 rounds with the per-client eval over all 3400 clients at each
    eval round (rounds 1 and 2), so rounds 0-1 make one timed window and the
    last round runs alone under ``torch.profiler``. Returns the flash
    kernels' launches."""
    from fedml_tpu_torch.sim.engine import FedSim

    c = FEMNIST
    timed_rounds = c["rounds"] - 1
    argv = ["--dataset", "femnist", "--model", "cnn", "--data_dir", str(BUILD_DIR / "femnist"),
            "--client_num_in_total", str(c["clients"]),
            "--client_num_per_round", str(c["per_round"]), "--batch_size", str(c["batch"]),
            "--lr", str(c["lr"]), "--epochs", str(c["epochs"]), "--comm_round", str(c["rounds"]),
            "--frequency_of_the_test", str(timed_rounds), "--eval_on_clients", "1"]
    eval_s = []
    staged, recording = _staging_recorder()
    profile = {}
    _zero_flash_counters()
    torch.cuda.reset_peak_memory_stats()
    with recording, \
            _wrapped(FedSim, "evaluate_per_client", _timing(eval_s, torch.cuda.synchronize)), \
            _profile_round(torch, timed_rounds, profile):
        history, wall = _cli(torch, argv)
    launches = _flash_launches()
    peak = torch.cuda.max_memory_allocated()
    values = [v for rec in history for v in rec.values()]
    if not all(np.isfinite(values)) or len(history) != c["rounds"]:
        fail(f"femnist: bad history {history}")
    if "Train/AccOnClients" not in history[-1]:
        fail("femnist: no per-client eval in the last round")
    if abs(history[0]["Train/Loss"] - np.log(62)) > 1.5:
        fail(f"femnist: first-round loss {history[0]['Train/Loss']} far from ln 62")
    idx, _, steps, _ = staged[0]
    window = sum(rec["round_time"] for rec in history[:timed_rounds])
    images = [int((staged[r][0] >= 0).sum()) for r in range(c["rounds"])]
    for rec, n in zip(history, images):
        note = ("under the profiler" if rec["round"] == timed_rounds
                else "the sync window's per-round mean")
        log(f"[femnist] round {rec['round']}: {rec['round_time']:.4f} s ({note}), {n} images, "
            f"{n / rec['round_time']:.1f} images/s, Train/Loss {rec['Train/Loss']:.5f}")
    log(f"[femnist] CNNDropOut f32, {c['clients']} clients (synthetic_leaf_mnist fallback), "
        f"{c['per_round']} x B={c['batch']}, {steps} steps a client-epoch (the population max), "
        f"vmap: rounds 0-{timed_rounds - 1} {sum(images[:timed_rounds]) / window:.1f} "
        f"images/s, {window / timed_rounds:.4f} s a round; per-client eval over "
        f"{c['clients']} clients {' and '.join(f'{t:.2f}' for t in eval_s)} s (rounds "
        f"{timed_rounds - 1} and {timed_rounds}); Train/AccOnClients "
        f"{history[-1]['Train/AccOnClients']:.4f} Test/Acc {history[-1]['Test/Acc']:.4f}; run "
        f"{wall:.2f} s; peak device memory {peak / 2**30:.2f} GiB; flash launches {launches}")
    _log_profile("femnist_cnn", timed_rounds, profile)
    return launches


def phase_femnist_blocks(torch):
    """FEMNIST + CNNDropOut through the CLI at ``[femnist]``'s recipe, cut
    to 2 rounds with the eval at the last and no per-client eval: one block
    of 2 replays of the round's CUDA graph (318 steps a client-epoch,
    ~62,600 kernels, the largest round graph of the script) against the
    same rounds dispatched one at a time (``block_dispatch=False``, set
    here), both under cuDNN's deterministic algorithms, held to rtol 1e-6 /
    atol 1e-7. (Before PR 13: 3 rounds, and two more per-round runs with the
    default algorithms, whose gap was printed; cut for the script's time
    budget.) Returns the flash launches and the runs (``[packed femnist]``
    reads them)."""
    import functools

    from fedml_tpu_torch.sim import engine
    from fedml_tpu_torch.sim.graphs import RoundGraph

    c = dict(FEMNIST, rounds=2)
    argv = ["--dataset", "femnist", "--model", "cnn", "--data_dir", str(BUILD_DIR / "femnist"),
            "--client_num_in_total", str(c["clients"]),
            "--client_num_per_round", str(c["per_round"]), "--batch_size", str(c["batch"]),
            "--lr", str(c["lr"]), "--epochs", str(c["epochs"]), "--comm_round", str(c["rounds"]),
            "--frequency_of_the_test", str(c["rounds"])]

    def per_round(original):
        return functools.partial(original, block_dispatch=False)

    def counted(original):
        def capture_round_graph(self, *args, **kwargs):
            seconds = original(self, *args, **kwargs)
            captures[-1] += bool(seconds)
            return seconds
        return capture_round_graph

    runs, captures, replay_s = {}, [], []
    _zero_flash_counters()
    for name, block, deterministic in (("blocks", True, True), ("per round", False, True)):
        captures.append(0)
        with contextlib.ExitStack() as stack:
            stack.enter_context(_wrapped(engine.FedSim, "capture_round_graph", counted))
            if not block:
                stack.enter_context(_wrapped(engine, "SimConfig", per_round))
            else:
                stack.enter_context(_wrapped(RoundGraph, "replay_round",
                                             _timing(replay_s, torch.cuda.synchronize)))
            torch.backends.cudnn.deterministic = deterministic
            try:
                runs[name] = _cli(torch, argv)
            finally:
                torch.backends.cudnn.deterministic = False
    if captures != [1, 0]:
        fail(f"femnist blocks: round graphs captured per run {captures}, expected [1, 0]")
    log(f"[femnist blocks] each replay of the block, synchronised: "
        + ", ".join(f"{t:.4f}" for t in replay_s) + " s")
    for name, (history, wall) in runs.items():
        losses = ", ".join(f"{rec['Train/Loss']:.6f}" for rec in history)
        log(f"[femnist blocks] {name}: run {wall:.2f} s, Train/Loss {losses}, Test/Acc "
            f"{history[-1]['Test/Acc']:.6f}")
    det = [({}, runs[k][0]) for k in ("blocks", "per round")]
    (over, beyond), (diff, where) = _block_gap(torch, det)
    log(f"[femnist blocks] deterministic cuDNN, one block of {c['rounds']} graph replays vs "
        f"per-round dispatch: largest difference {diff:.3e} ({where}), bitwise equal "
        f"{diff == 0.0}")
    if over > 0:
        fail(f"femnist blocks: {beyond} differs beyond rtol {BLOCK_RTOL} / atol {BLOCK_ATOL} "
             f"(by {over:.3e} over)")
    return _flash_launches(), runs


def phase_fedprox_stragglers(torch, data_dir):
    """MNIST + LR with FedProx (mu 0.1) and stragglers (half of each cohort
    on a uniform 1..E-1 epoch budget), E=2, 5 rounds, through the CLI. Prints
    each round's executed client steps against the count without budgets,
    from the index maps and budgets the run staged. Returns the flash
    kernels' launches."""
    c, p = MNIST, FEDPROX
    argv = ["--dataset", "mnist", "--model", "lr", "--data_dir", str(data_dir),
            "--client_num_in_total", str(c["clients"]),
            "--client_num_per_round", str(c["per_round"]), "--batch_size", str(c["batch"]),
            "--lr", str(c["lr"]), "--algorithm", "fedprox", "--fedprox_mu", str(p["mu"]),
            "--straggler_frac", str(p["straggler_frac"]), "--epochs", str(p["epochs"]),
            "--comm_round", str(p["rounds"]), "--frequency_of_the_test", str(p["rounds"])]
    staged, recording = _staging_recorder()
    _zero_flash_counters()
    with recording:
        history, wall = _cli(torch, argv)
    launches = _flash_launches()
    values = [v for rec in history for v in rec.values()]
    if not all(np.isfinite(values)) or len(history) != p["rounds"]:
        fail(f"fedprox: bad history {history}")
    cut = 0
    for rec in history:
        idx, budgets, steps, epochs = staged[rec["round"]]
        executed, full = _executed_steps(idx, budgets, steps, epochs)
        cut += full - executed
        log(f"[fedprox] round {rec['round']}: executed client steps {executed} of {full} "
            f"without budgets (epoch budgets {(budgets // steps).tolist()}), round time "
            f"{rec['round_time']:.4f} s, Train/Loss {rec['Train/Loss']:.5f}")
    log(f"[fedprox] mu {p['mu']}, straggler_frac {p['straggler_frac']}, E={p['epochs']}: "
        f"{cut} client steps cut by the budgets over {p['rounds']} rounds; Test/Acc "
        f"{history[-1]['Test/Acc']:.4f}; run {wall:.2f} s")
    if cut == 0:
        fail("fedprox: the straggler budgets cut no step")
    return launches


def _small_sim(torch, device, model, mode, prox=0.0, straggler=0.0, epochs=1, depth=None,
               rates=None, rounds=2, freq=2, block=None):
    """A small FedSim on the synthetic LEAF MNIST clients; by default its
    rounds make one eval-aligned block (on the card, replays of the round's
    CUDA graph)."""
    from fedml_tpu_torch.algorithms.fedprox import fedprox_trainer
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.data.leaf import synthetic_leaf_mnist
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    train, test, _ = synthetic_leaf_mnist(n_clients=8, seed=0)
    kwargs = {} if rates is None else {"dropout_rates": rates}
    module = create_model(model, 62 if model != "lr" else 10, "femnist", device=device,
                          **kwargs)
    trainer = fedprox_trainer(ClientTrainer(module=module, optimizer=sgd(0.05), epochs=epochs),
                              prox)
    cfg = SimConfig(client_num_in_total=8, client_num_per_round=4, batch_size=16,
                    comm_round=rounds, epochs=epochs, frequency_of_the_test=freq,
                    eval_batch_size=64, seed=0, cohort_execution=mode, straggler_frac=straggler,
                    pipeline_depth=depth, block_dispatch=block)
    return FedSim(trainer, train, test, cfg, device=device)


def phase_small_card_vs_cpu(torch):
    """The new paths at a small size in f32, the card against the CPU from
    the same variables: LR FedProx with stragglers (scan and vmap), 2 rounds
    free-running (one block on the card); cnn_original FedAvg and CNNDropOut at dropout rate 0
    (vmap), each of 2 rounds from the same variables, and CNNDropOut's eval
    forward at its rates; the pipelined against the serial driver on
    the card, bitwise; the dropout masks on the card (same seed, same masks;
    keep share); and the CLI's transformer, which launches no flash kernel
    (``attn_impl="xla"``). Returns that run's flash launches."""
    from fedml_tpu_torch.core.trainer import DropoutStream

    cases = [("LR FedProx stragglers scan", dict(model="lr", mode="scan", prox=0.1,
                                                 straggler=0.5, epochs=2)),
             ("LR FedProx stragglers vmap", dict(model="lr", mode="vmap", prox=0.1,
                                                 straggler=0.5, epochs=2)),
             ("cnn_original FedAvg vmap", dict(model="cnn_original", mode="vmap")),
             ("cnn rate 0 vmap", dict(model="cnn", mode="vmap", rates=(0.0, 0.0)))]
    for name, kw in cases:
        runs = {}
        for device in ("cuda", "cpu"):
            sim = _small_sim(torch, device, **kw)
            if device == "cuda":
                init = {k: t.cpu() for k, t in sim.init_variables().items()}
            runs[device] = sim.run(variables={k: t.to(device) for k, t in init.items()})
        (v_a, h_a), (v_b, h_b) = runs["cuda"], runs["cpu"]
        err = max(float((v_a[k].cpu() - v_b[k].cpu()).abs().max()) for k in v_b)
        for rec_a, rec_b in zip(h_a, h_b):
            err = max([err] + [abs(rec_a[k] - rec_b[k]) for k in rec_b
                               if k not in ("round", "round_time")])
        if kw["model"] == "lr":
            log(f"[small] {name}, 2 rounds, card vs CPU (f32): max_abs_err={err:.3e} "
                f"(variables, losses, eval); Test/Acc {h_a[-1]['Test/Acc']:.4f}")
            if not err <= E2E_ATOL:
                fail(f"small {name}: the card disagrees with the CPU: {err} > {E2E_ATOL}")
            continue
        # A max-pool CNN: a window whose two largest inputs lie within rounding
        # (or tie) routes its gradient to either input, so the card and the
        # CPU part at such a step (one window moved a gradient by 2.4e-3; python3
        # -m fedml_tpu_torch.cnn_numerics finds such windows step by step), and
        # parted runs meet more of them. So each round runs on both devices from
        # the CPU run's variables, its gap held to E2E_ATOL; the free-running
        # gap above is reported.
        sims = {d: _small_sim(torch, d, **kw) for d in ("cuda", "cpu")}
        v = dict(init)
        gaps = []
        for r in range(2):
            out = {d: sim.run_round(r, {k: t.to(d) for k, t in v.items()})
                   for d, sim in sims.items()}
            (va, _, ma), (vb, _, mb) = out["cuda"], out["cpu"]
            gap = max(float((va[k].cpu() - vb[k].cpu()).abs().max()) for k in vb)
            gap = max(gap, abs(float(ma["Train/Loss"]) - float(mb["Train/Loss"])))
            v = {k: t.cpu() for k, t in vb.items()}
            ev = {d: sim.evaluate({k: t.to(d) for k, t in v.items()}) for d, sim in sims.items()}
            gap = max([gap] + [abs(ev["cuda"][k] - ev["cpu"][k]) for k in ev["cpu"]])
            gaps.append(gap)
        log(f"[small] {name}, 2 rounds, card vs CPU (f32): each round from the same "
            f"variables max_abs_err {max(gaps):.3e} by round {[f'{g:.3e}' for g in gaps]} "
            f"(variables, round loss, eval of the same variables); free-running 2 rounds "
            f"{err:.3e}; Test/Acc {h_a[-1]['Test/Acc']:.4f}")
        if not max(gaps) <= E2E_ATOL:
            fail(f"small {name}: a round on the card disagrees with the CPU: {max(gaps)} > "
                 f"{E2E_ATOL}")
    # CNNDropOut's eval forward at its rates, card against CPU, same weights
    sim = _small_sim(torch, "cuda", "cnn", "vmap")
    variables = {k: t.cpu() for k, t in sim.init_variables().items()}
    x = torch.tensor(np.random.RandomState(2).rand(64, 28, 28).astype(np.float32))
    outs = []
    for device in ("cuda", "cpu"):
        model = _small_sim(torch, device, "cnn", "vmap").trainer.module
        model.load_state_dict(variables)
        with torch.no_grad():
            outs.append(model(x.to(device), train=False).cpu())
    err = float((outs[0] - outs[1]).abs().max())
    stream_a = DropoutStream(model.dropout_sites, 0, 3, 10, 20, torch.device("cuda"))
    stream_b = DropoutStream(model.dropout_sites, 0, 3, 10, 20, torch.device("cuda"))
    masks_a, masks_b = stream_a.masks(5), stream_b.masks(5)
    same = all(torch.equal(masks_a[k], masks_b[k]) for k in masks_a)
    keep = {k: float(m.float().mean()) for k, m in masks_a.items()}
    log(f"[small] CNNDropOut eval forward at rates (0.25, 0.5), card vs CPU: "
        f"max_abs_err={err:.3e}; masks on the card: same seed same masks {same}, keep share "
        f"{keep} (expected 0.75, 0.5)")
    if not err <= E2E_ATOL or not same or abs(keep["dropout_0"] - 0.75) > 0.01 \
            or abs(keep["dropout_1"] - 0.5) > 0.02:
        fail("CNNDropOut's eval forward or its masks on the card")
    # pipelined against serial on the card, bitwise, with dropout masks. cuDNN's
    # default convolution algorithms may sum in a run-dependent order, so two
    # serial runs can part in the last bit; the comparison runs deterministic
    # cuDNN, and the serial runs' own spread without it is reported.
    def two_rounds(depth):
        sim = _small_sim(torch, "cuda", "cnn", "vmap", depth=depth)
        return sim.run(variables={k: t.to("cuda") for k, t in variables.items()})

    def gap(a, b):
        return max(float((a[0][k] - b[0][k]).abs().max()) for k in a[0])

    spread = gap(two_rounds(0), two_rounds(0))
    torch.backends.cudnn.deterministic = True
    try:
        runs = [two_rounds(None), two_rounds(0)]
    finally:
        torch.backends.cudnn.deterministic = False
    same = (all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in runs[0][0])
            and _strip_times(runs[0][1]) == _strip_times(runs[1][1]))
    log(f"[small] CNNDropOut with dropout, 2 rounds on the card, deterministic cuDNN: "
        f"pipelined and serial variables and histories bitwise equal {same} (max variable "
        f"gap {gap(*runs):.3e}); two serial runs with cuDNN's default algorithms part by "
        f"{spread:.3e}")
    if not same:
        fail("the pipelined and serial drivers differ on the card")
    # the CLI's transformer builds attn_impl="xla": no flash launch; its one
    # round runs under --profile_dir, which must write a Chrome trace
    prof_dir = BUILD_DIR / "profile_cli_transformer"
    _zero_flash_counters()
    history, _ = _cli(torch, ["--dataset", "shakespeare", "--model", "transformer",
                              "--data_dir", str(BUILD_DIR / "shakespeare"),
                              "--client_num_in_total", "4", "--client_num_per_round", "2",
                              "--batch_size", "8", "--comm_round", "1",
                              "--profile_dir", str(prof_dir)])
    launches = _flash_launches()
    log(f"[small] CLI --model transformer --dataset shakespeare, 1 round: Train/Loss "
        f"{history[-1]['Train/Loss']:.5f}, flash launches {launches}")
    if any(launches.values()):
        fail(f"the CLI transformer launched the flash kernels: {launches}")
    traces = [p for p in prof_dir.glob("*.json") if p.stat().st_size > 0]
    if not traces:
        fail(f"--profile_dir wrote no trace under {prof_dir}")
    events = json.loads(traces[0].read_text()).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"[profile] --profile_dir on that run: {traces[0].name}, {traces[0].stat().st_size} "
        f"bytes, {kernels} kernel events (its one round and its eval)")
    if not kernels:
        fail("the --profile_dir trace holds no kernel event")
    return launches


# blocks against per-round dispatch on the card: the JAX package's tolerance
# for its block test (tests/test_device_staging.py:57)
BLOCK_RTOL, BLOCK_ATOL = 1e-6, 1e-7


def _block_gap(torch, runs, rtol=BLOCK_RTOL, atol=BLOCK_ATOL):
    """Two runs' variables and history values held to rtol/atol: ``(excess,
    name)`` of the value furthest beyond the tolerance (excess <= 0 when all
    agree) and ``(diff, name)`` of the largest absolute difference."""
    (v_a, h_a), (v_b, h_b) = runs
    if len(h_a) != len(h_b):
        fail(f"the runs have {len(h_a)} and {len(h_b)} records")
    seen = [(-atol, 0.0, "none")]  # (excess over the tolerance, |diff|, where)
    for k in v_b:
        a, b = v_a[k].double().cpu(), v_b[k].double().cpu()
        d = (a - b).abs()
        seen.append((float((d - atol - rtol * b.abs()).max()), float(d.max()),
                     f"variable {k}"))
    for rec_a, rec_b in zip(h_a, h_b):
        if set(rec_a) != set(rec_b):
            fail(f"blocks: the records differ in keys: {rec_a} {rec_b}")
        for k in rec_b:
            if k not in ("round", "round_time"):
                d = abs(rec_a[k] - rec_b[k])
                seen.append((d - atol - rtol * abs(rec_b[k]), d, f"round {rec_b['round']} {k}"))
    over = max(seen)
    largest = max(seen, key=lambda e: e[1])
    return (over[0], over[2]), (largest[1], largest[2])


def phase_blocks_small(torch):
    """Block dispatch against per-round dispatch on the card at a small size,
    f32, from the same variables: 4 rounds with an eval every 2, so two
    blocks of 2 replays of the round's CUDA graph, against the same rounds
    dispatched one at a time (``block_dispatch=False``): LR FedProx with
    stragglers (scan and vmap), CNNDropOut (its dropout masks drawn into the
    graph's buffers before each replay: the last round's are held against a
    fresh draw), the small RNN and a depth-8 ResNet with augmentation (vmap
    and scan). The histories and variables agree to rtol 1e-6 / atol 1e-7;
    the largest difference is printed with the variable or metric it is
    in. The runs use cuDNN's deterministic algorithms: its default ones may
    sum in a run-dependent order, and the BatchNorm ResNet carries such a
    last-bit difference past 1e-4 in 4 rounds (two per-round runs with the
    default algorithms are compared too, and their gap printed)."""
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.data.registry import synthetic_char_lm
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.models.resnet import CifarResNet
    from fedml_tpu_torch.ops.augment import ImageAugment
    from fedml_tpu_torch.sim.cohort import FederatedArrays
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    def rnn_sim(block):
        c = RNN_SMALL["original"]
        train, test, _ = synthetic_char_lm(n_clients=6, vocab=c["vocab_size"],
                                           seq_len=c["seq"], samples=10, seed=0)
        widths = {k: c[k] for k in ("vocab_size", "embedding_dim", "hidden_size")}
        trainer = ClientTrainer(module=create_model("rnn", 0, c["dataset"], device="cuda",
                                                    **widths), task="nwp", optimizer=sgd(0.5))
        cfg = SimConfig(client_num_in_total=6, client_num_per_round=4, batch_size=4,
                        comm_round=4, epochs=1, frequency_of_the_test=2, eval_batch_size=16,
                        seed=0, block_dispatch=block)
        return FedSim(trainer, train, test, cfg, device="cuda")

    rng = np.random.RandomState(1)
    sizes = [40, 9, 25, 33, 17]
    n = sum(sizes)
    images = rng.randn(n + 32, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, n + 32).astype(np.int32)
    starts = np.cumsum([0] + sizes)
    part = {c: np.arange(starts[c], starts[c + 1]) for c in range(len(sizes))}

    def resnet_sim(block, mode):
        trainer = ClientTrainer(module=CifarResNet(depth=8, num_classes=10, device="cuda"),
                                optimizer=sgd(0.005, 0.9, 1e-3), epochs=2,
                                augment=ImageAugment())
        cfg = SimConfig(client_num_in_total=5, client_num_per_round=4, batch_size=16,
                        comm_round=4, epochs=2, frequency_of_the_test=2, eval_batch_size=32,
                        seed=0, cohort_execution=mode, block_dispatch=block)
        return FedSim(trainer, FederatedArrays({"x": images[:n], "y": labels[:n]}, part),
                      {"x": images[n:], "y": labels[n:]}, cfg, device="cuda")

    _zero_flash_counters()
    small = dict(rounds=4, freq=2)
    cases = [
        ("LR FedProx stragglers scan", lambda b: _small_sim(
            torch, "cuda", "lr", "scan", prox=0.1, straggler=0.5, epochs=2, block=b, **small)),
        ("LR FedProx stragglers vmap", lambda b: _small_sim(
            torch, "cuda", "lr", "vmap", prox=0.1, straggler=0.5, epochs=2, block=b, **small)),
        ("CNNDropOut vmap", lambda b: _small_sim(torch, "cuda", "cnn", "vmap", block=b,
                                                 **small)),
        ("RNNOriginalFedAvg small vmap", rnn_sim),
        ("ResNet-8 augmentation vmap", lambda b: resnet_sim(b, "vmap")),
        ("ResNet-8 augmentation scan", lambda b: resnet_sim(b, "scan")),
    ]
    t0 = time.perf_counter()
    init = {k: t.clone() for k, t in resnet_sim(False, "vmap").init_variables().items()}
    spread = [resnet_sim(False, "vmap").run(variables={k: t.clone() for k, t in init.items()})
              for _ in range(2)]
    log(f"[blocks] two per-round runs of the ResNet-8 case with cuDNN's default algorithms: "
        f"largest difference {_block_gap(torch, spread)[1][0]:.3e}")
    for name, make in cases:
        runs, sims = [], []
        for block in (None, False):
            sim = make(block)
            if not runs:
                init = {k: t.clone() for k, t in sim.init_variables().items()}
            torch.backends.cudnn.deterministic = True
            try:
                runs.append(sim.run(variables={k: t.clone() for k, t in init.items()}))
            finally:
                torch.backends.cudnn.deterministic = False
            sims.append(sim)
        plan = sims[0]._dispatch_plan(0)
        if plan != [(0, 2), (2, 2)] or not sims[0]._graphs or sims[1]._graphs:
            fail(f"blocks {name}: plan {plan}, graphs {len(sims[0]._graphs)} and "
                 f"{len(sims[1]._graphs)}")
        (over, beyond), (diff, where) = _block_gap(torch, runs)
        note = ""
        if sims[0].trainer.dropout_sites:
            (graph,) = sims[0]._graphs.values()
            last = sims[0]._dropout(3, sims[0].config.client_num_per_round)
            same = all(torch.equal(graph.dropout.masks(t)[k], m)
                       for t in range(graph.dropout.steps)
                       for k, m in last.masks(t).items())
            note = f"; the graph's dropout masks of round 3 equal a fresh draw: {same}"
            if not same:
                fail(f"blocks {name}: the replayed round's dropout masks differ")
        log(f"[blocks] {name}: 4 rounds as 2 blocks of 2 graph replays vs per-round "
            f"dispatch, card: largest difference {diff:.3e} ({where}); bitwise equal "
            f"{diff == 0.0}{note}")
        if over > 0:
            fail(f"blocks {name}: {beyond} differs beyond rtol {BLOCK_RTOL} / atol "
                 f"{BLOCK_ATOL} (by {over:.3e} over)")
    log(f"[blocks] {len(cases)} cases in {time.perf_counter() - t0:.2f} s")
    return _flash_launches()


# packed lanes (SimConfig.pack_lanes) and the heterogeneous population: the
# JAX packed-lane test's power-law sizes (tests/test_packed_lanes.py:42) for
# the small LR overflow check; FEMNIST at [femnist]'s recipe, cut to 3
# rounds, for the packed pass graph and the population's churn. Packed
# against padded at the cohort's width (10 lanes for 10 clients) is held
# bitwise; with fewer lanes each conv runs as a grouped cuDNN conv of L
# groups where the padded round's has C, and cuDNN may pick another
# algorithm at another width (on the CPU the two agree bitwise,
# tests/test_torch_packed.py), so a round from the same variables is held
# to PACKED_CNN_RTOL / PACKED_CNN_ATOL: cuDNN's f32 weight gradient of a
# conv is up to 7.552e-4 off float64 (relative) on this card (PERF.md §6),
# so two algorithms may part by that share of a gradient, and a client's
# chain of up to 318 steps carries it into its model
PACKED_CNN_RTOL, PACKED_CNN_ATOL = 1e-3, 1e-4
POWERLAW = [97, 41, 24, 12, 9, 6]
POPULATION_SPEC = "speed=lognormal:0,0.5;avail=0.8;avail_block=4;dropout=0.05"
# LR packed into one lane against the padded round of six clients: the
# vmapped GEMMs and the loss's reductions run at width 1 against 6, and the
# card's kernels (cuBLAS, PyTorch's reductions) may sum in another order at
# another width: a few f32 ulps of the weights (~1e-7 at |w| ~ 1)
PACKED_LR_RTOL, PACKED_LR_ATOL = 1e-6, 1e-6


def _femnist_argv(rounds, *extra):
    c = FEMNIST
    return ["--dataset", "femnist", "--model", "cnn", "--data_dir", str(BUILD_DIR / "femnist"),
            "--client_num_in_total", str(c["clients"]),
            "--client_num_per_round", str(c["per_round"]), "--batch_size", str(c["batch"]),
            "--lr", str(c["lr"]), "--epochs", str(c["epochs"]), "--comm_round", str(rounds),
            "--frequency_of_the_test", str(rounds), *extra]


@contextlib.contextmanager
def _packed_recorder(torch):
    """Record what a packed run did: each round's plan stats
    (``PackedStaged.stats``), the pass graph replays a round and the
    captures' seconds."""
    from fedml_tpu_torch.sim.engine import FedSim
    from fedml_tpu_torch.sim.graphs import PassGraph

    rec = {"stats": {}, "replays": {}, "captures": [], "round": None}

    def run_packed(original):
        def wrapped(self, staged, *args, **kwargs):
            rec["stats"][staged.round_idx] = dict(staged.stats)
            rec["round"] = staged.round_idx
            rec["replays"][staged.round_idx] = 0
            return original(self, staged, *args, **kwargs)
        return wrapped

    def replay_pass(original):
        def wrapped(self, *args, **kwargs):
            rec["replays"][rec["round"]] += 1
            return original(self, *args, **kwargs)
        return wrapped

    def capture(original):
        def wrapped(self, *args, **kwargs):
            seconds = original(self, *args, **kwargs)
            if seconds:
                rec["captures"].append(seconds)
            return seconds
        return wrapped

    with _wrapped(FedSim, "_run_packed", run_packed), \
            _wrapped(PassGraph, "replay_pass", replay_pass), \
            _wrapped(FedSim, "capture_pass_graph", capture):
        yield rec


def _deterministic_cli(torch, argv):
    torch.backends.cudnn.deterministic = True
    try:
        return _cli(torch, argv)
    finally:
        torch.backends.cudnn.deterministic = False


def _pass_counts(name, rec, rounds):
    """Check one graph replay a pass in every round of a packed run and
    return the per-round pass counts."""
    passes = [rec["stats"][r]["n_passes"] for r in range(rounds)]
    replays = [rec["replays"][r] for r in range(rounds)]
    if replays != passes or len(rec["captures"]) != 1:
        fail(f"{name}: {replays} graph replays a round for {passes} passes, "
             f"{len(rec['captures'])} captures (expected one replay a pass, one capture)")
    return passes


def phase_packed_overflow(torch):
    """Packed lanes against padded rounds on the card at a small size: LR on
    the JAX packed-lane test's power-law clients (97 ... 6 samples), all 6
    a round, B=8, E=2, SGD 0.2, 4 rounds with an eval every 2, from the same
    variables. One lane and a capacity factor of 0.01 (a lane of the largest
    client's 26 steps), so every round overflows into several replays of
    the lane graph: bitwise equal to one lane sized to the round (capacity
    factor 10, one replay a round; the same width). Six lanes (the cohort's
    width) are bitwise equal to the padded round (per-round dispatch). The
    one lane against the padded round is held to ``PACKED_LR_RTOL`` /
    ``PACKED_LR_ATOL``, its gap printed. Returns the flash launches."""
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.models.linear import LogisticRegression
    from fedml_tpu_torch.sim.cohort import FederatedArrays
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    rng = np.random.RandomState(3)
    n = sum(POWERLAW)
    centers = rng.normal(0.0, 2.0, (4, 12))
    y = rng.randint(0, 4, n).astype(np.int32)
    x = (centers[y] + rng.normal(0.0, 0.6, (n, 12))).astype(np.float32)
    bounds = np.cumsum([0] + POWERLAW)
    train = FederatedArrays({"x": x, "y": y}, {i: np.arange(bounds[i], bounds[i + 1])
                                               for i in range(len(POWERLAW))})
    test = {"x": x[:16], "y": y[:16]}
    base = dict(client_num_in_total=len(POWERLAW), client_num_per_round=6, batch_size=8,
                comm_round=4, epochs=2, frequency_of_the_test=2, seed=0)

    def sim(**kw):
        trainer = ClientTrainer(module=LogisticRegression(4, 12, device="cuda"),
                                optimizer=sgd(0.2), epochs=2)
        return FedSim(trainer, train, test, SimConfig(**base, **kw), device="cuda")

    _zero_flash_counters()
    padded = sim(block_dispatch=False)
    init = {k: t.clone() for k, t in padded.init_variables().items()}
    runs, recs = {"padded": padded.run(variables={k: t.clone() for k, t in init.items()})}, {}
    for name, kw in (("overflow", dict(pack_lanes=1, pack_capacity_factor=0.01)),
                     ("one pass", dict(pack_lanes=1, pack_capacity_factor=10.0)),
                     ("six lanes", dict(pack_lanes=6))):
        with _packed_recorder(torch) as recs[name]:
            runs[name] = sim(**kw).run(variables={k: t.clone() for k, t in init.items()})
    passes = _pass_counts("packed overflow", recs["overflow"], base["comm_round"])
    if min(passes) < 2 or max(_pass_counts("packed one pass", recs["one pass"],
                                           base["comm_round"])) != 1:
        fail(f"packed overflow: passes a round {passes}; the capacity factor 0.01 should "
             "overflow every round, 10 never")
    checks = [("overflow", "one pass", 0.0, 0.0), ("padded", "six lanes", 0.0, 0.0),
              ("padded", "overflow", PACKED_LR_RTOL, PACKED_LR_ATOL)]
    for a, b, rtol, atol in checks:
        (over, beyond), (diff, where) = _block_gap(torch, [runs[a], runs[b]], rtol=rtol,
                                                   atol=atol)
        log(f"[packed overflow] LR, {b} against {a}: largest difference {diff:.3e} ({where}), "
            f"bitwise equal {diff == 0.0}" + (f"; passes a round {passes}, one graph replay "
                                              f"each" if b == "overflow" else ""))
        if over > 0:
            fail(f"packed overflow: {b} against {a}: {beyond} differs beyond rtol {rtol} / "
                 f"atol {atol} (by {over:.3e} over)")
    return _flash_launches()


def _one_round_gaps(torch, sims, rounds):
    """Each round ``r`` < ``rounds`` run by every FedSim of ``sims`` (name ->
    FedSim; the first is the reference) from the same variables, the
    reference's previous output (round 0: fresh variables), on the same
    staged inputs, under deterministic cuDNN: name -> a ``(diff, excess)``
    pair a round, the largest absolute difference of its variables and
    ``Train/Loss`` from the reference's, and the largest excess over
    ``PACKED_CNN_RTOL`` / ``PACKED_CNN_ATOL`` (> 0: beyond)."""
    names = list(sims)
    ref = sims[names[0]]
    v = ref.init_round_variables()
    gaps = {name: [] for name in names[1:]}
    torch.backends.cudnn.deterministic = True
    try:
        for r in range(rounds):
            out = {name: sim.run_staged_round(sim.stage_round(r),
                                              {k: t.clone() for k, t in v.items()})
                   for name, sim in sims.items()}
            v_ref, _, m_ref = out[names[0]]
            for name in names[1:]:
                v_o, _, m_o = out[name]
                pairs = [(v_o[k].double(), v_ref[k].double()) for k in v_ref]
                pairs.append((m_o["Train/Loss"].double(), m_ref["Train/Loss"].double()))
                diff = max(float((a - b).abs().max()) for a, b in pairs)
                excess = max(float(((a - b).abs() - PACKED_CNN_ATOL
                                    - PACKED_CNN_RTOL * b.abs()).max()) for a, b in pairs)
                gaps[name].append((diff, excess))
            v = v_ref
    finally:
        torch.backends.cudnn.deterministic = False
    return gaps


def _packed_round_parts(torch, sim, round_idx, variables):
    """One packed round of ``sim`` on the card (``run_staged_round``), timed
    by part with a synchronisation around each: the dropout masks' draws,
    the graph replays and the eager aggregation (seconds each); then its
    first pass again (``PassGraph.replay_pass``: the masks' draws, the
    input copies, the replay) under ``torch.profiler`` with the host's
    calls. Returns the parts, the plan's stats and the profile."""
    from fedml_tpu_torch.core.trainer import LaneDropout
    from fedml_tpu_torch.sim.engine import FedSim

    staged = sim.stage_round(round_idx)
    parts = {"dropout draws": [], "replays": [], "aggregation": []}
    sync = torch.cuda.synchronize
    with _wrapped(LaneDropout, "fill", _timing(parts["dropout draws"], sync)), \
            _wrapped(torch.cuda.CUDAGraph, "replay", _timing(parts["replays"], sync)), \
            _wrapped(FedSim, "_packed_aggregate", _timing(parts["aggregation"], sync)):
        sim.run_staged_round(staged, variables)
    graph = sim._pass_graphs[sim._pass_graph_key(staged)]
    profile = {"s_lane": staged.passes[0].slot.shape[1]}
    _profiled(torch, profile, graph.replay_pass, staged.passes[0],
              sim._dropout(round_idx, len(staged.cohort)), host=True)
    return {k: sum(v) for k, v in parts.items()}, staged.stats, profile


def phase_packed_femnist(torch, padded_runs):
    """FEMNIST + CNNDropOut through the CLI at ``[femnist blocks]``'s recipe
    (3 rounds, the eval at the last) with ``--pack_lanes 2``: each pass one
    replay of the lane pass's CUDA graph, under cuDNN's deterministic
    algorithms. Prints s/round packed (and each round's seconds), in the
    padded block and padded per round (``padded_runs``, the same recipe in
    ``[femnist blocks]``), the passes a round, lane occupancy (executed
    steps over lane slots), round 1's parts (synchronised) and its first
    pass under ``torch.profiler`` with the host's calls (kernels a lane
    step, device idle, one ``cudaGraphLaunch``), outside the timed run. Then
    each of rounds 0-2 from the same variables, against the padded round
    (per-round dispatch): packed with 10 lanes (the cohort's width) must be
    bitwise equal; packed with 2 lanes, whose convs run grouped over 2
    lanes where the padded round's run over 10 clients, is held to
    ``PACKED_CNN_RTOL`` / ``PACKED_CNN_ATOL``, its gap printed. Returns the
    flash launches."""
    from fedml_tpu_torch.sim.engine import FedSim

    rounds = 3
    round_s, made = [], []

    def keep(original):
        def run(self, *args, **kwargs):
            made.append(self)
            return original(self, *args, **kwargs)
        return run

    _zero_flash_counters()
    with _packed_recorder(torch) as rec, _wrapped(FedSim, "run", keep), \
            _wrapped(FedSim, "_run_packed", _timing(round_s, torch.cuda.synchronize)):
        history, wall = _deterministic_cli(torch, _femnist_argv(rounds, "--pack_lanes", "2"))
    launches = _flash_launches()
    passes = _pass_counts("packed femnist", rec, rounds)
    stats = [rec["stats"][r] for r in range(rounds)]
    executed = sum(st["total_steps"] for st in stats)
    slots = sum(st["capacity"] for st in stats)
    padded_slots = sum(st["padded_steps"] for st in stats)
    values = [v for r in history for v in r.values()]
    if not all(np.isfinite(values)) or len(history) != rounds:
        fail(f"packed femnist: bad history {history}")
    per_round = {"packed replays": history, "padded block": padded_runs["blocks"][0],
                 "padded per round": padded_runs["per round"][0]}
    seconds = {k: np.mean([r["round_time"] for r in h]) for k, h in per_round.items()}
    log(f"[packed femnist] CNNDropOut, {FEMNIST['clients']} clients, --pack_lanes 2, "
        f"deterministic cuDNN: s/round " + ", ".join(f"{k} {v:.4f}" for k, v in seconds.items())
        + f" (each packed round, synchronised: "
        + ", ".join(f"{t:.4f}" for t in round_s) + f" s); passes a round {passes}; lane "
        f"occupancy {executed / slots:.2%} ({executed} executed steps of {slots} lane slots; "
        f"the padded rounds ran {padded_slots} client steps, {executed / padded_slots:.2%} of "
        f"them with data); capture {rec['captures'][0]:.2f} s; run {wall:.2f} s; Train/Loss "
        + ", ".join(f"{r['Train/Loss']:.6f}" for r in history)
        + f", Test/Acc {history[-1]['Test/Acc']:.6f}; flash launches {launches}")
    (sim,) = made
    parts, st, profile = _packed_round_parts(torch, sim, 1, sim.init_round_variables())
    log(f"[packed femnist] round 1 by part, synchronised: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items()) + f" ({st['n_passes']} passes)")
    union, pass_wall = profile["union_us"] / 1e6, profile["wall"]
    log(f"[packed femnist] round 1, pass 1 again under torch.profiler: {profile['kernels']} "
        f"device kernels and copies over {profile['s_lane']} lane steps, "
        f"{profile['kernels'] / profile['s_lane']:.1f} a lane step; device busy "
        f"{union * 1e3:.3f} ms of {pass_wall * 1e3:.3f} ms ({1 - union / pass_wall:.1%} idle, "
        f"the masks' draws and input copies included; durations summed "
        f"{profile['busy_us'] / 1e3:.3f} ms); host CUDA calls: "
        + ", ".join(f"{k} {n}" for k, n in sorted(profile["api"].items()) if n))
    graph_launches = profile["api"].get("cudaGraphLaunch", 0)
    if graph_launches != 1:
        fail(f"packed femnist: a pass made {graph_launches} cudaGraphLaunch calls, expected 1")
    sims = {"padded": FedSim(sim.trainer, sim.train_data, None, dataclasses.replace(
        sim.config, pack_lanes=0, block_dispatch=False, pipeline_depth=0), device="cuda")}
    for lanes in (10, 2):
        sims[f"packed {lanes} lanes"] = FedSim(sim.trainer, sim.train_data, None,
                                               dataclasses.replace(sim.config, pack_lanes=lanes),
                                               device="cuda")
    t0 = time.perf_counter()
    gaps = _one_round_gaps(torch, sims, rounds)
    log(f"[packed femnist] rounds 0-{rounds - 1}, each from the same variables, against the "
        f"padded round ({time.perf_counter() - t0:.2f} s): largest difference a round, "
        + "; ".join(f"{k} " + ", ".join(f"{d:.3e}" for d, _ in v) for k, v in gaps.items()))
    _check_gaps("packed femnist", gaps)
    return launches


def _check_gaps(name, gaps):
    """Fail unless the cohort-wide lanes (``packed 10 lanes``) equal the
    padded rounds bitwise and the other lane widths stay within
    ``PACKED_CNN_RTOL`` / ``PACKED_CNN_ATOL``."""
    for lanes, per_round in gaps.items():
        if lanes == "packed 10 lanes" and any(d for d, _ in per_round):
            fail(f"{name}: 10 lanes (the cohort's width) differ from the padded round: "
                 f"{per_round}")
        worst = max(per_round, key=lambda g: g[1])
        if worst[1] > 0:
            fail(f"{name}: {lanes} differ from the padded round by {worst[0]:.3e}, beyond rtol "
                 f"{PACKED_CNN_RTOL} / atol {PACKED_CNN_ATOL} (by {worst[1]:.3e})")


def phase_population(torch):
    """FEMNIST through the CLI with the churn population
    (``POPULATION_SPEC``: lognormal speeds, 80% availability in blocks of 4
    rounds, 5% mid-round dropout), 3 rounds, packed (``--pack_lanes 2``:
    dropped clients re-packed into overflow passes), deterministic cuDNN;
    the population saved as a trace (``population.save_trace``) and
    replayed through ``--population_trace``, its history bitwise equal to
    the generative run's (``round_time`` aside); then rounds 0-2, each from
    the same variables, packed (10 lanes and 2) against the padded round
    (per-round dispatch) under the population, held as in
    ``[packed femnist]``. Returns the flash launches."""
    from fedml_tpu_torch import population as poplib
    from fedml_tpu_torch.sim.engine import FedSim

    rounds = 3
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    made = []

    def keep(original):
        def run(self, *args, **kwargs):
            made.append(self)
            return original(self, *args, **kwargs)
        return run

    _zero_flash_counters()
    with _packed_recorder(torch) as rec, _wrapped(FedSim, "run", keep):
        packed, packed_wall = _deterministic_cli(
            torch, _femnist_argv(rounds, "--pack_lanes", "2", "--population", POPULATION_SPEC))
    passes = _pass_counts("population", rec, rounds)
    pop = poplib.Population(POPULATION_SPEC, FEMNIST["clients"], 0)
    views = [pop.round_view(r, FEMNIST["per_round"]) for r in range(rounds)]
    trace = poplib.save_trace(BUILD_DIR / "population_trace.jsonl", pop, rounds,
                              FEMNIST["per_round"])
    with _packed_recorder(torch) as rec_trace:
        replayed, replay_wall = _deterministic_cli(
            torch, _femnist_argv(rounds, "--pack_lanes", "2", "--population_trace", str(trace)))
    _pass_counts("population trace", rec_trace, rounds)
    launches = _flash_launches()
    (sim,) = made
    padded = FedSim(sim.trainer, sim.train_data, None, dataclasses.replace(
        sim.config, pack_lanes=0, block_dispatch=False, pipeline_depth=0), device="cuda")
    wide = FedSim(sim.trainer, sim.train_data, None, dataclasses.replace(
        sim.config, pack_lanes=10), device="cuda")
    gaps = _one_round_gaps(torch, {"padded": padded, "packed 10 lanes": wide,
                                   "packed 2 lanes": sim}, rounds)
    same = _strip_times(replayed) == _strip_times(packed)
    values = [v for r in packed for v in r.values()]
    log(f"[population] FEMNIST, {POPULATION_SPEC!r}, --pack_lanes 2: dropped a round "
        f"{[int(v.dropped.sum()) for v in views]}, eligible "
        f"{[v.eligible_count for v in views]}, passes a round {passes}, one graph replay each; "
        f"s/round generative {np.mean([r['round_time'] for r in packed]):.4f}, replayed trace "
        f"{np.mean([r['round_time'] for r in replayed]):.4f} (runs {packed_wall:.2f} and "
        f"{replay_wall:.2f} s); the trace's replay bitwise equal to the generative run: {same}; "
        f"rounds 0-{rounds - 1} from the same variables, against the padded round: largest "
        f"difference a round " + "; ".join(f"{k} " + ", ".join(f"{d:.3e}" for d, _ in v)
                                           for k, v in gaps.items())
        + f"; Train/Loss " + ", ".join(f"{r['Train/Loss']:.6f}" for r in packed)
        + f"; flash launches {launches}")
    if not all(np.isfinite(values)) or len(packed) != rounds:
        fail(f"population: bad history {packed}")
    if not same:
        fail(f"population: the trace's replay {replayed} differs from the run {packed}")
    _check_gaps("population", gaps)
    return launches

# the recurrent family: small widths for the card-vs-CPU check; BASELINE row 4
# at its recipe (fedml_tpu/exp/repro_shakespeare.py:3-8), 1200 rounds cut to
# 20; the StackOverflow NWP recipe (fedml_tpu/exp/repro_stackoverflow_nwp.py:
# 3-6) on the registry's fallback, 342,477 clients cut to 100 and ~1500 rounds
# to 4: the fallback draws a 10004 x 10004 float64 transition matrix (~0.8 GB
# on the host) and one rng.choice per token, so its set-up grows with the
# population; the tag task on the stackoverflow_lr fallback, 2 rounds
RNN_SMALL = {"original": dict(dataset="shakespeare", vocab_size=90, embedding_dim=8,
                              hidden_size=32, seq=16),
             "stackoverflow": dict(dataset="stackoverflow_nwp", vocab_size=512,
                                   embedding_dim=16, hidden_size=48, seq=8)}
# 6 rounds with an eval every 3, cut from 10 and 5 for the script's time
# budget
SHAKESPEARE = dict(clients=715, per_round=10, batch=4, lr=1.0, seq=80, samples=16,
                   rounds=6, freq=3, profiled=1)
SO_NWP = dict(clients=100, per_round=50, batch=16, lr=10 ** -0.5, rounds=4, freq=3)
SO_LR = dict(clients=10, per_round=10, batch=10, lr=0.1, rounds=2)


def phase_rnn_small(torch):
    """Both RNNs at a small width, f32: one vmapped cohort step on the card
    with every warning an error (a per-client fallback of ``torch.func.vmap``
    warns), then 4 vmapped FedAvg rounds with an eval every 2 (two blocks of
    2 on the card) against the same rounds on the CPU from the same
    variables, each eval compared. Returns the flash launches of the
    card runs."""
    import warnings

    from fedml_tpu_torch.core.trainer import ClientTrainer, make_vmap_train, sgd
    from fedml_tpu_torch.data.registry import synthetic_char_lm
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    _zero_flash_counters()
    for name, c in RNN_SMALL.items():
        train, test, _ = synthetic_char_lm(n_clients=6, vocab=c["vocab_size"],
                                           seq_len=c["seq"], samples=10, seed=0)
        widths = {k: c[k] for k in ("vocab_size", "embedding_dim", "hidden_size")}
        cfg = SimConfig(client_num_in_total=6, client_num_per_round=4, batch_size=4,
                        comm_round=4, epochs=1, frequency_of_the_test=2, eval_batch_size=16,
                        seed=0, cohort_execution="vmap")
        runs = {}
        for device in ("cuda", "cpu"):
            trainer = ClientTrainer(module=create_model("rnn", 0, c["dataset"], device=device,
                                                        **widths),
                                    task="nwp", optimizer=sgd(0.5))
            sim = FedSim(trainer, train, test, cfg, device=device)
            if device == "cuda":
                init = {k: t.cpu() for k, t in sim.init_variables().items()}
                idx = torch.arange(16, device=sim.device).reshape(4, 1, 4)
                batches = FedSim._gather_batches(sim._dataset, idx)
                with warnings.catch_warnings():
                    warnings.simplefilter("error")
                    make_vmap_train(trainer)({k: t.to(sim.device) for k, t in init.items()},
                                             batches, torch.ones(4, dtype=torch.int64,
                                                                 device=sim.device))
                    torch.cuda.synchronize()
            runs[device] = sim.run(variables={k: t.to(device) for k, t in init.items()})
        err = _max_err(torch, (runs["cuda"], runs["cpu"]))
        log(f"[rnn small] {type(trainer.module).__name__} {widths} T={c['seq']} f32: one "
            f"vmapped cohort step on the card with warnings as errors: no warning; 4 vmapped "
            f"FedAvg rounds, an eval every 2 (two blocks of 2 on the card), card vs CPU from "
            f"the same variables: max_abs_err={err:.3e} "
            f"(variables, losses, both evals); Test/Acc {runs['cuda'][1][-1]['Test/Acc']:.4f}")
        if not err <= E2E_ATOL:
            fail(f"small {name} RNN on the card disagrees with the CPU run: {err} > {E2E_ATOL}")
    return _flash_launches()


def phase_repro_shakespeare(torch, smi):
    """BASELINE row 4 through its own entry point,
    ``exp/repro_shakespeare.main``, at full width on the card: the Markov
    char-LM fixture of 715 clients (16 windows of 80 characters each, built
    once and timed here), ``RNNOriginalFedAvg``, 10 a round, B=4, SGD 1.0,
    E=1, vmapped; 6 rounds with an eval every 3, dispatched one at a time
    by ``exp/_loop.run_rounds``: pipelined (the default), then serial
    (``pipeline_depth`` 0, round 1 under ``torch.profiler``). The two runs'
    records are bitwise equal, ``round_time`` aside. Report and metrics go to
    a temporary directory. Returns the flash kernels' launches."""
    import tempfile

    from fedml_tpu_torch.data import registry
    from fedml_tpu_torch.exp import repro_shakespeare
    from fedml_tpu_torch.sim.engine import FedSim

    c = SHAKESPEARE
    made, profile, kept = [], {}, {}

    def built_once(original):
        timed = _timing(made)(original)

        def synthetic_char_lm(*args, **kwargs):
            key = repr((args, sorted(kwargs.items())))
            if key not in kept:
                kept[key] = timed(*args, **kwargs)
            return kept[key]
        return synthetic_char_lm

    def serial(original):
        return property(lambda self: 0)

    def run(depth):
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.ExitStack() as stack:
            if depth == 0:
                stack.enter_context(_wrapped(FedSim, "pipeline_depth", serial))
                stack.enter_context(_profile_round(torch, c["profiled"], profile))
            t0 = time.perf_counter()
            result = repro_shakespeare.main([
                "--data_dir", str(Path(tmp) / "none"),
                "--client_num_in_total", str(c["clients"]),
                "--client_num_per_round", str(c["per_round"]), "--batch_size", str(c["batch"]),
                "--lr", str(c["lr"]), "--seq_len", str(c["seq"]),
                "--samples_per_client", str(c["samples"]), "--comm_round", str(c["rounds"]),
                "--frequency_of_the_test", str(c["freq"]),
                "--metrics_out", str(Path(tmp) / "metrics.jsonl"),
                "--out", str(Path(tmp) / "REPORT.md"), "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            records = [json.loads(line) for line in
                       (Path(tmp) / "metrics.jsonl").read_text().splitlines()]
            reported = "shakespeare_rnn_torch" in (Path(tmp) / "REPORT.md").read_text()
        return result, records, wall, reported

    _zero_flash_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _wrapped(registry, "synthetic_char_lm", built_once):
        result, records, wall, reported = run(None)
        launches = _flash_launches()
        _, serial_records, serial_wall, _ = run(0)
    peak = torch.cuda.max_memory_allocated()
    evals = [r for r in records if "Test/Acc" in r]
    if len(made) != 1 or result["clients"] != c["clients"] or not reported:
        fail(f"repro_shakespeare: fixture builds {made}, result {result}, report {reported}")
    if len(records) != c["rounds"] or len(evals) != c["rounds"] // c["freq"] \
            or not all(np.isfinite([v for r in records for v in r.values()])):
        fail(f"repro_shakespeare: bad records {records}")
    if abs(records[0]["Train/Loss"] - np.log(90)) > 1.0:
        fail(f"repro_shakespeare: first-round loss {records[0]['Train/Loss']} far from ln 90")
    if _strip_times(serial_records) != _strip_times(records):
        fail("repro_shakespeare: the serial loop's records differ from the pipelined loop's")
    steady = [r["round_time"] for r in serial_records if r["round"] > c["profiled"]]
    windows = [r["round_time"] for r in records if "Test/Acc" in r]
    log(f"[repro_shakespeare] {smi}: Markov char-LM fixture, {c['clients']} clients x "
        f"{c['samples']} windows of {c['seq']}, built in {made[0]:.2f} s; "
        f"{result['samples']} training windows")
    log(f"[repro_shakespeare] exp/repro_shakespeare.main, RNNOriginalFedAvg (2 x LSTM 256), "
        f"{c['rounds']} rounds (of the recipe's 1200) x {c['per_round']} clients x "
        f"B={c['batch']}, SGD {c['lr']}, E=1, vmap, eval every {c['freq']}, one round a "
        f"dispatch: pipelined loop {' and '.join(f'{t:.4f}' for t in windows)} s a round "
        f"(its two eval windows, round 0 in the first), {result['rounds_per_sec']} rounds/s "
        f"by its own count (evals included), main() {wall:.2f} s; serial loop, records "
        f"bitwise equal: steady rounds ({c['profiled'] + 1}-{c['rounds'] - 1}) "
        f"{np.mean(steady):.4f} s a round, round 0 {serial_records[0]['round_time']:.4f} s, "
        f"main() {serial_wall:.2f} s; best "
        f"Test/Acc {result['best_test_acc']}, the fixture's Bayes ceiling "
        f"{result['fixture_bayes_ceiling']} ({result['pct_of_ceiling']}% of it); final "
        f"{result['final']}; peak device memory {peak / 2**30:.2f} GiB; "
        f"flash launches {launches}")
    _log_profile("repro_shakespeare", c["profiled"], profile)
    return launches


def phase_shakespeare_cli(torch, smi):
    """BASELINE row 4 through the CLI, ``main_fedavg --dataset shakespeare
    --model rnn``, at row 4's recipe (``fedml_tpu/exp/repro_shakespeare.py:
    3-8``: 2 x LSTM 256, 10 clients a round, B=4, SGD 1.0, E=1) on the
    registry's Markov fixture, which the CLI builds without files (715
    clients of 30 windows of 20 characters, so 8 steps a round; the repro's
    are 16 windows of 80), 6 rounds with an eval every 3: two blocks of 3
    replays of the round's CUDA graph (the default on
    the card) against the same rounds dispatched one at a time
    (``block_dispatch=False``, set here: the CLI has no such flag, as in the
    JAX package), two runs (blocks, per round; four in turns before PR 13,
    cut for the script's time budget), each pipelined. Both profile round 1 with the host's activity:
    the host's ``cudaLaunchKernel`` and ``cudaGraphLaunch`` calls, the
    device kernels, the idle share; the block round must launch graphs and
    fewer than 1% of the eager round's kernels. Prints s/round (the second
    eval window's per-round mean), peak memory and the capture's seconds;
    the histories agree to rtol 1e-6 / atol 1e-7. Returns the flash
    launches."""
    import functools

    from fedml_tpu_torch.sim import engine

    c = SHAKESPEARE
    argv = ["--dataset", "shakespeare", "--model", "rnn",
            "--data_dir", str(BUILD_DIR / "shakespeare_cli"),
            "--client_num_in_total", str(c["clients"]),
            "--client_num_per_round", str(c["per_round"]), "--batch_size", str(c["batch"]),
            "--lr", str(c["lr"]), "--epochs", "1", "--comm_round", str(c["rounds"]),
            "--frequency_of_the_test", str(c["freq"])]
    captures = []

    def timed_capture(original):
        def capture_round_graph(self, *args, **kwargs):
            seconds = original(self, *args, **kwargs)
            if seconds:
                captures.append(seconds)
            return seconds
        return capture_round_graph

    def per_round(original):
        return functools.partial(original, block_dispatch=False)

    runs, profiles, loads = [], {}, []
    _zero_flash_counters()
    with _loaded_once(loads), _wrapped(engine.FedSim, "capture_round_graph", timed_capture):
        for i, name in enumerate(("blocks", "per round")):
            with contextlib.ExitStack() as stack:
                if name == "per round":
                    stack.enter_context(_wrapped(engine, "SimConfig", per_round))
                if i < 2:
                    profiles[name] = {}
                    stack.enter_context(_profile_round(torch, 1, profiles[name], host=True))
                torch.cuda.reset_peak_memory_stats()
                history, wall = _cli(torch, argv)
                runs.append((name, history, wall, torch.cuda.max_memory_allocated()))
    launches = _flash_launches()
    base = runs[1][1]
    if len(base) != c["rounds"] or not all(np.isfinite([v for r in base for v in r.values()])):
        fail(f"shakespeare cli: bad history {base}")
    for name, history, wall, peak in runs:
        (over, beyond), (diff, where) = _block_gap(torch, (({}, history), ({}, base)))
        steady = history[-1]["round_time"]
        log(f"[shakespeare cli {name}] {smi}: rounds {c['freq']}-{c['rounds'] - 1} "
            f"{steady:.5f} s a round ({1 / steady:.2f} rounds/s), rounds 0-{c['freq'] - 1} "
            f"{history[0]['round_time']:.5f} s a round; run {wall:.2f} s; peak device memory "
            f"{peak / 2**30:.3f} GiB; history against the first per-round run: largest "
            f"difference {diff:.3e} ({where}); Test/Acc {history[-1]['Test/Acc']:.4f}")
        if over > 0:
            fail(f"shakespeare cli: the {name} run's {beyond} differs beyond rtol "
                 f"{BLOCK_RTOL} / atol {BLOCK_ATOL}")
    for name, got in profiles.items():
        _log_profile(f"shakespeare cli {name}", 1, got)
    graph_launch = profiles["blocks"]["api"].get("cudaGraphLaunch", 0)
    kernels_block = profiles["blocks"]["api"].get("cudaLaunchKernel", 0)
    kernels_eager = profiles["per round"]["api"].get("cudaLaunchKernel", 0)
    log(f"[shakespeare cli] a block round: {graph_launch} cudaGraphLaunch, {kernels_block} "
        f"cudaLaunchKernel against the eager round's {kernels_eager} "
        f"({kernels_block / max(kernels_eager, 1):.3%}); captures {captures} s (one per "
        f"blocks run, before its first block); the row's data loaded once in "
        f"{loads[0]:.2f} s; flash launches {launches}")
    if not graph_launch or kernels_eager == 0 or kernels_block >= 0.01 * kernels_eager:
        fail("shakespeare cli: the block round did not replace the eager round's launches "
             "with graph launches")
    return launches


def _staged_bytes():
    """Wrap ``FedSim.stage_round`` and ``FedSim.stage_block`` to add up the
    bytes of the tensors each payload copies to the device: (totals by
    round count, context manager)."""
    from fedml_tpu_torch.sim.engine import FedSim

    totals = {"bytes": 0, "rounds": 0}

    def nbytes(payload):
        out = 0
        for value in vars(payload).values():
            for t in (value.values() if isinstance(value, dict) else [value]):
                if hasattr(t, "is_cuda") and t.is_cuda:
                    out += t.numel() * t.element_size()
        return out

    def counted(rounds_of):
        def make(original):
            def stage(self, *args):
                payload = original(self, *args)
                totals["bytes"] += nbytes(payload)
                totals["rounds"] += rounds_of(args)
                return payload
            return stage
        return make

    stack = contextlib.ExitStack()
    stack.enter_context(_wrapped(FedSim, "stage_round", counted(lambda a: 1)))
    stack.enter_context(_wrapped(FedSim, "stage_block", counted(lambda a: a[1])))
    return totals, stack


def phase_so_nwp(torch, smi):
    """The StackOverflow NWP recipe with ``RNNStackOverflow`` through the
    port's CLI at full width (vocab 10004, embed 96, LSTM 670, seq 20; 50
    clients a round, B=16, SGD 10^-0.5, E=1) on the registry's fallback of
    100 clients, 4 rounds with an eval at rounds 2 and 3 on the serial
    driver, twice: the default (the dataset on the device; rounds 0-2 one
    block of graph replays, round 3 alone, under ``torch.profiler``), then
    ``--stage_on_device 0`` (each round's batch stack built on the host and
    copied; rounds dispatched one at a time). The two histories are bitwise
    equal, ``round_time`` aside. Prints each run's s/round and the bytes its
    staging copied to the device a round. Returns the flash kernels'
    launches."""
    c = SO_NWP
    argv = ["--dataset", "stackoverflow_nwp", "--model", "rnn",
            "--data_dir", str(BUILD_DIR / "stackoverflow_nwp"),
            "--client_num_in_total", str(c["clients"]),
            "--client_num_per_round", str(c["per_round"]), "--batch_size", str(c["batch"]),
            "--lr", str(c["lr"]), "--epochs", "1", "--comm_round", str(c["rounds"]),
            "--frequency_of_the_test", str(c["freq"]), "--pipeline_depth", "0"]
    loads = []
    profile = {}
    runs = {}
    _zero_flash_counters()
    with _loaded_once(loads):
        for name, extra in (("on device", []), ("host-staged", ["--stage_on_device", "0"])):
            totals, counting = _staged_bytes()
            torch.cuda.reset_peak_memory_stats()
            with counting, (_profile_round(torch, c["rounds"] - 1, profile) if not extra
                            else contextlib.nullcontext()):
                history, wall = _cli(torch, argv + extra)
            runs[name] = (history, wall, totals["bytes"] / max(totals["rounds"], 1),
                          torch.cuda.max_memory_allocated())
            if not runs[name][0]:
                fail(f"so_nwp {name}: empty history")
    launches = _flash_launches()
    history = runs["on device"][0]
    values = [v for rec in history for v in rec.values()]
    if not all(np.isfinite(values)) or len(history) != c["rounds"]:
        fail(f"so_nwp: bad history {history}")
    if abs(history[0]["Train/Loss"] - np.log(10004)) > 1.5:
        fail(f"so_nwp: first-round loss {history[0]['Train/Loss']} far from ln 10004")
    same = _strip_times(runs["host-staged"][0]) == _strip_times(history)
    for name, (hist, wall, per_round_bytes, peak) in runs.items():
        for rec in hist:
            log(f"[so_nwp {name}] round {rec['round']}: {rec['round_time']:.4f} s"
                + (" (under the profiler)" if rec["round"] == c["rounds"] - 1
                   and name == "on device" else "")
                + f", Train/Loss {rec['Train/Loss']:.5f}"
                + (f", Test/Acc {rec['Test/Acc']:.4f}" if "Test/Acc" in rec else ""))
        log(f"[so_nwp {name}] {smi}: rounds 0-{c['rounds'] - 2} "
            f"{hist[0]['round_time']:.4f} s a round"
            + (" (one block: the window's mean)" if name == "on device" else
               f" (each its own: {', '.join(f'{r['round_time']:.4f}' for r in hist[:-1])})")
            + f"; {per_round_bytes / 2**20:.3f} MiB copied to the device a round by staging; "
            f"run {wall:.2f} s; peak device memory {peak / 2**30:.2f} GiB")
    log(f"[so_nwp] RNNStackOverflow (vocab 10004, embed 96, LSTM 670) through the CLI, "
        f"fallback fixture of {c['clients']} clients (30 windows of 20 each) built in "
        f"{loads[0]:.2f} s; {c['per_round']} clients a round x B={c['batch']}, SGD "
        f"{c['lr']:.4f}, E=1, vmap, serial driver; --stage_on_device 0 against the default: "
        f"histories bitwise equal {same}; flash launches {launches}")
    _log_profile("so_nwp", c["rounds"] - 1, profile)
    if not same:
        fail("so_nwp: the host-staged history differs from the on-device one")
    return launches


def phase_so_lr(torch):
    """The tag task: ``--model lr --dataset stackoverflow_lr`` through the
    CLI on the registry's fallback, 2 rounds on the card, then on the CPU
    from the card run's initial variables; variables and every record's
    values held to 1e-4. Returns the card run's flash launches."""
    from fedml_tpu_torch.exp import main_fedavg as cli
    from fedml_tpu_torch.sim.engine import FedSim

    c = SO_LR
    argv = ["--dataset", "stackoverflow_lr", "--model", "lr",
            "--data_dir", str(BUILD_DIR / "stackoverflow_lr"),
            "--client_num_in_total", str(c["clients"]),
            "--client_num_per_round", str(c["per_round"]), "--batch_size", str(c["batch"]),
            "--lr", str(c["lr"]), "--comm_round", str(c["rounds"]),
            "--frequency_of_the_test", "1"]
    inits, finals = [], []

    def recorded(original):
        def init_variables(self):  # the card run draws them, the CPU run takes them
            if inits:
                return {k: t.to(self.device) for k, t in inits[0].items()}
            inits.append({k: t.cpu() for k, t in original(self).items()})
            return {k: t.to(self.device) for k, t in inits[0].items()}
        return init_variables

    def keep_final(original):
        def run(self, *args, **kwargs):
            out = original(self, *args, **kwargs)
            finals.append({k: t.cpu() for k, t in out[0].items()})
            return out
        return run

    _zero_flash_counters()
    with _wrapped(FedSim, "init_variables", recorded), _wrapped(FedSim, "run", keep_final):
        card, wall = _cli(torch, argv)
        launches = _flash_launches()
        cpu = cli.run(cli.parse_with_config(cli.add_args(argparse.ArgumentParser()),
                                            argv + ["--device", "cpu"]))
    err = max(float((finals[0][k] - finals[1][k]).abs().max()) for k in finals[1])
    for a, b in zip(card, cpu):
        if set(a) != set(b):
            fail(f"so_lr: the card's and the CPU's records differ in keys: {a} {b}")
        err = max([err] + [abs(a[k] - b[k]) for k in a if k not in ("round", "round_time")])
    log(f"[so_lr] LogisticRegression (1000 -> 500 tags), tag task, {c['clients']} clients "
        f"(synthetic_tag_prediction fallback) x B={c['batch']}, SGD {c['lr']}, "
        f"{c['rounds']} rounds: card vs CPU from the same variables max_abs_err={err:.3e} "
        f"(variables, losses, eval); Test/Acc (tag precision) {card[-1]['Test/Acc']:.4f} "
        f"Test/Loss {card[-1]['Test/Loss']:.4f}; run {wall:.2f} s; flash launches {launches}")
    if len(card) != c["rounds"] or not all(np.isfinite([v for r in card for v in r.values()])):
        fail(f"so_lr: bad history {card}")
    if not err <= E2E_ATOL:
        fail(f"so_lr: the card disagrees with the CPU: {err} > {E2E_ATOL}")
    return launches


FEDNAS_SMALL = dict(num_classes=4, channels=4, layers=3, steps=2, hw=8, batch=4)
# the DARTS search network (Liu et al., ICLR 2019, sec. 3.1) on a CIFAR-10
# fixture of 800/200 images [50k/10k], cut from the registry's 2,000-image
# fallback for the script's time budget, first order; cut to 4 clients and
# 1 round
FEDNAS = dict(dataset="cifar10", channels=16, layers=8, steps=4, batch=64, lr=0.025,
              arch_lr=3e-4, clients=4, rounds=1, profiled_step=5, n_train=800, n_test=200)


def _fednas_err(torch, a, b):
    """Worst difference of two FedNAS outputs: variables dicts, tensors and
    numbers, nested in tuples and dicts alike."""
    if isinstance(a, dict):
        if set(a) != set(b):
            fail(f"fednas: outputs differ in keys: {sorted(set(a) ^ set(b))}")
        return max([0.0] + [_fednas_err(torch, a[k], b[k]) for k in a])
    if isinstance(a, (tuple, list)):
        return max([0.0] + [_fednas_err(torch, x, y) for x, y in zip(a, b)])
    if isinstance(a, torch.Tensor):
        return float((a.detach().cpu().double() - b.detach().cpu().double()).abs().max())
    return abs(float(a) - float(b))


def phase_fednas_small(torch):
    """FedNAS at a small width (4 channels, 3 cells, 2 steps, 8x8, B=4, S=2
    with one padding row), f32, card against CPU, each check from the same
    variables: the network forward in evaluation and in training (logits
    and new BN statistics); one first-order ``search_step``; one unrolled
    (second-order) ``search_step`` from a fresh momentum-SGD state; one gdas
    ``search_step`` whose Gumbel noise both devices draw from one CPU
    generator seed. Returns the flash launches of the card runs."""
    from fedml_tpu_torch.algorithms.fednas import FedNASTrainer
    from fedml_tpu_torch.core.trainer import adam, sgd
    from fedml_tpu_torch.models.darts import DARTSNetwork

    c = FEDNAS_SMALL
    widths = {k: c[k] for k in ("num_classes", "channels", "layers", "steps")}
    rng = np.random.RandomState(0)
    batches = {"x": rng.rand(2, c["batch"], c["hw"], c["hw"], 3).astype(np.float32),
               "y": rng.randint(0, c["num_classes"], (2, c["batch"])).astype(np.int64),
               "mask": np.ones((2, c["batch"]), np.float32)}
    batches["x"][1, -1] = 0.0
    batches["mask"][1, -1] = 0.0

    def on(device):
        return {k: torch.from_numpy(v).to(device) for k, v in batches.items()}

    def forward(device, init, mode):
        net = DARTSNetwork(search_mode=mode, device=device, **widths)
        net.load_state_dict({k: t.to(device) for k, t in init.items()})
        b = on(device)
        noise = net.gumbel_noise(torch.Generator().manual_seed(5))
        with torch.no_grad():
            return net(b["x"][0]), net(b["x"][0], train=True, noise=noise)

    def step(device, init, mode, unrolled):
        net = DARTSNetwork(search_mode=mode, device=device, **widths)
        tr = FedNASTrainer(net, sgd(0.05, momentum=0.9 if unrolled else 0.0), adam(3e-3),
                           unrolled=unrolled, unrolled_eta=0.05)
        variables = {k: t.to(device) for k, t in init.items()}
        params, arch, _ = tr.split(variables)
        b = on(device)
        out, opt, m = tr.search_step(
            variables, (tr.w_opt.init(params), tr.arch_opt.init(arch)),
            {k: v[0] for k, v in b.items()}, {k: v[1] for k, v in b.items()},
            torch.Generator().manual_seed(7))
        return out, opt, m

    checks = {"forward darts": lambda d, i: forward(d, i, "darts"),
              "forward gdas": lambda d, i: forward(d, i, "gdas"),
              "search_step first order": lambda d, i: step(d, i, "darts", False),
              "search_step unrolled": lambda d, i: step(d, i, "darts", True),
              "search_step gdas": lambda d, i: step(d, i, "gdas", False)}
    init = {k: t.cpu() for k, t in DARTSNetwork(device="cuda", **widths).state_dict().items()}
    _zero_flash_counters()
    errs = {}
    for name, check in checks.items():
        card = check("cuda", init)
        torch.cuda.synchronize()
        errs[name] = _fednas_err(torch, card, check("cpu", init))
    # ROADMAP §C, item 3: is FedNAS repeatable on the card? Each check twice on the
    # card from the same variables, under deterministic algorithms (cuBLAS's
    # check satisfied by its workspace setting; an op without a deterministic
    # form warns instead of raising) and deterministic cuDNN
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        repeat = {}
        for name, check in checks.items():
            first = check("cuda", init)
            second = check("cuda", init)
            torch.cuda.synchronize()
            repeat[name] = _fednas_err(torch, first, second)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    launches = _flash_launches()
    log(f"[fednas small] DARTSNetwork {widths} 8x8, B={c['batch']}, f32, card vs CPU from "
        f"the same variables, max_abs_err (variables, optimizer states, losses): "
        + "; ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f"; flash launches {launches}")
    log("[fednas small] two card runs of each check under deterministic algorithms and "
        "cuDNN, largest difference: " + "; ".join(f"{k} {v:.3e}" for k, v in repeat.items())
        + f"; bitwise equal: {max(repeat.values()) == 0.0}")
    for name, err in errs.items():
        if not err <= E2E_ATOL:
            fail(f"fednas small {name}: the card disagrees with the CPU: {err} > {E2E_ATOL}")
    return launches


def _profile_call(torch, call_idx, got):
    """A wrapper maker that runs call ``call_idx`` (0-based) of the wrapped
    function under ``torch.profiler`` (``_profiled``)."""
    calls = []

    def make(original):
        def profiled(*args, **kwargs):
            calls.append(None)
            if len(calls) - 1 != call_idx:
                return original(*args, **kwargs)
            return _profiled(torch, got, original, *args, **kwargs)
        return profiled
    return make


def phase_fednas(torch, smi):
    """The FedNAS path at the DARTS search width through its entry point,
    ``exp/main_fednas.run``: CIFAR-10 (a fixture of ``FEDNAS``' size in the
    real batch format, hetero alpha 0.5) over 4 clients, channels 16, 8 cells, 4
    steps, B=64, SGD 0.025 for the weights, Adam 3e-4 for α, first order, 1
    round; one search step of it under ``torch.profiler``. Then one
    unrolled (second-order) ``search_step`` at the same width, timed after a
    warm-up call beside a first-order one, with its peak memory. Returns the
    flash launches of the two parts."""
    from fedml_tpu_torch.algorithms import fednas
    from fedml_tpu_torch.core.trainer import adam, sgd
    from fedml_tpu_torch.exp import main_fednas
    from fedml_tpu_torch.models.darts import DARTSNetwork

    from fedml_tpu_torch.exp.repro_cross_silo import write_cifar10_fixture

    c = FEDNAS
    write_cifar10_fixture(BUILD_DIR / "fednas_cifar10", n_train=c["n_train"],
                          n_test=c["n_test"], seed=0)
    argv = ["--dataset", c["dataset"], "--data_dir", str(BUILD_DIR / "fednas_cifar10"),
            "--client_number", str(c["clients"]), "--comm_round", str(c["rounds"]),
            "--batch_size", str(c["batch"]), "--lr", str(c["lr"]), "--arch_lr",
            str(c["arch_lr"]), "--channels", str(c["channels"]), "--layers", str(c["layers"]),
            "--steps", str(c["steps"]), "--device", "cuda"]
    args = main_fednas.add_args(argparse.ArgumentParser()).parse_args(argv)
    losses, genotypes, round_ends, steps, profile = [], [], [], [], {}

    def record_losses(original):
        def local_search(self, *a, **k):
            out = original(self, *a, **k)
            losses.append(float(out[1]["train_loss"]))
            steps.append(int(a[1]["mask"].shape[0]) * self.epochs)
            return out
        return local_search

    def record_genotype(original):
        def global_genotype(variables):
            genotypes.append(original(variables))
            round_ends.append(time.perf_counter())
            return genotypes[-1]
        return global_genotype

    loads = []
    with _loaded_once(loads):
        train, _ = main_fednas._load(args)
        images = int(train.num_samples)
        sizes = [len(train.partition[i]) for i in range(c["clients"])]
        _zero_flash_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _wrapped(fednas.FedNASTrainer, "local_search", record_losses), \
                _wrapped(fednas, "global_genotype", record_genotype), \
                _wrapped(fednas.FedNASTrainer, "search_step",
                         _profile_call(torch, c["profiled_step"], profile)):
            t0 = time.perf_counter()
            last = main_fednas.run(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches_run = _flash_launches()
    per_round = np.diff([t0] + round_ends)
    steps_round = sum(steps[:c["clients"]])
    round_losses = [float(np.mean(losses[r * c["clients"]:(r + 1) * c["clients"]]))
                    for r in range(c["rounds"])]
    if len(losses) != c["clients"] * c["rounds"] or not np.all(np.isfinite(losses)) \
            or not np.isfinite(last["Train/Loss"]):
        fail(f"fednas: bad losses {losses} / {last}")
    for g in genotypes:
        if len(g.normal) != 2 * c["steps"] or len(g.reduce) != 2 * c["steps"]:
            fail(f"fednas: genotype does not decode to 2 x {c['steps']} genes: {g}")
    if str(genotypes[-1].normal) != last["genotype_normal"]:
        fail("fednas: the returned genotype is not the last round's")
    log(f"[fednas] {smi}: main_fednas --dataset cifar10 (a fixture of {images} images of 32x32x3, "
        f"hetero 0.5 over {c['clients']} clients: {sizes}) --channels {c['channels']} "
        f"--layers {c['layers']} --steps {c['steps']} --batch_size {c['batch']} --lr {c['lr']} "
        f"--arch_lr {c['arch_lr']}, first order, {c['rounds']} rounds; fixture loaded in "
        f"{loads[0]:.2f} s; {steps_round} search "
        f"steps a round; the last round {per_round[-1]:.3f} s (round 0 has one step under the "
        f"profiler): {steps_round / per_round[-1]:.3f} search steps/s, "
        f"{images / per_round[-1]:.1f} images/s (each image once in a training and once in a "
        f"validation batch); Train/Loss by round {round_losses}; genotype_normal {last['genotype_normal']}; run {wall:.2f} s; peak device memory "
        f"{peak / 2**30:.2f} GiB; flash launches {launches_run}")
    top = "; ".join(f"{k[:60]} {us / 1e3:.3f} ms ({us / max(profile['busy_us'], 1e-9):.1%})"
                    for k, us in profile["top"])
    log(f"[profile] fednas: search step {c['profiled_step']} of round 0 under torch.profiler: "
        f"{profile['kernels']} device kernels and copies; device busy "
        f"{profile['busy_us'] / 1e3:.3f} ms of {profile['wall'] * 1e3:.3f} ms wall "
        f"({1 - profile['busy_us'] / 1e6 / profile['wall']:.1%} idle, profiler on); most device "
        f"time: {top}")

    # (c) one unrolled search_step at full width, beside a first-order one
    rng = np.random.RandomState(0)
    b = {k: torch.from_numpy(v).to("cuda") for k, v in (
        ("x", rng.rand(2, c["batch"], 32, 32, 3).astype(np.float32)),
        ("y", rng.randint(0, 10, (2, c["batch"]))), ("mask", np.ones((2, c["batch"]), np.float32)))}
    _zero_flash_counters()
    times = {}
    for unrolled in (False, True):
        net = DARTSNetwork(num_classes=10, channels=c["channels"], layers=c["layers"],
                           steps=c["steps"], device="cuda")
        tr = fednas.FedNASTrainer(net, sgd(c["lr"]), adam(c["arch_lr"]), unrolled=unrolled,
                                  unrolled_eta=c["lr"])
        variables = tr.init(torch.Generator(device=net.alphas_normal.device).manual_seed(0))
        params, arch, _ = tr.split(variables)
        opt = (tr.w_opt.init(params), tr.arch_opt.init(arch))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(2):
            t1 = time.perf_counter()
            out, _, m = tr.search_step(variables, opt, {k: v[0] for k, v in b.items()},
                                       {k: v[1] for k, v in b.items()})
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t1)
        if not all(bool(torch.isfinite(v).all()) for v in out.values()) \
                or not np.isfinite(float(m["train_loss"])):
            fail(f"fednas unrolled={unrolled}: non-finite step output")
        times[unrolled] = (runs, torch.cuda.max_memory_allocated())
    launches_unrolled = _flash_launches()
    (fo, fo_peak), (so, so_peak) = times[False], times[True]
    log(f"[fednas unrolled] one search_step at the search width (B={c['batch']}, 32x32), "
        f"2 calls each (the first warms up): first order {fo[0]:.4f}, {fo[1]:.4f} s (peak "
        f"{fo_peak / 2**30:.2f} GiB); second order (unrolled, exact Hessian-vector term) "
        f"{so[0]:.4f}, {so[1]:.4f} s (peak {so_peak / 2**30:.2f} GiB); second call's ratio "
        f"{so[1] / fo[1]:.2f}; flash launches "
        f"{launches_unrolled}")
    return launches_run, launches_unrolled


# -- the server rules, checkpoints and tracing ---------------------------------


def _mnist_argv(data_dir, rounds, freq, *extra):
    """BASELINE row 1's recipe through the CLI (``MNIST``), ``rounds`` rounds
    with an eval every ``freq``."""
    c = MNIST
    return ["--dataset", "mnist", "--model", "lr", "--data_dir", str(data_dir),
            "--client_num_in_total", str(c["clients"]),
            "--client_num_per_round", str(c["per_round"]), "--batch_size", str(c["batch"]),
            "--lr", str(c["lr"]), "--epochs", str(c["epochs"]), "--comm_round", str(rounds),
            "--frequency_of_the_test", str(freq), *extra]


def _per_round_config(original):
    import functools

    return functools.partial(original, block_dispatch=False)


def _per_round_cli(torch, argv, device="cuda"):
    """A CLI run with every round dispatched alone (``block_dispatch=False``,
    set here: the CLI has no such flag, as in the JAX package)."""
    from fedml_tpu_torch.sim import engine

    with _wrapped(engine, "SimConfig", _per_round_config):
        return _cli(torch, argv, device)


def _history_gap(a, b):
    """The largest absolute difference of two histories' values (round time
    aside) and where."""
    if len(a) != len(b):
        fail(f"the runs have {len(a)} and {len(b)} records")
    gap = (0.0, "none")
    for ra, rb in zip(a, b):
        if set(ra) - {"round_time"} != set(rb) - {"round_time"}:
            fail(f"the records differ in keys: {ra} {rb}")
        for k in rb:
            if k not in ("round", "round_time"):
                gap = max(gap, (abs(ra[k] - rb[k]), f"round {rb['round']} {k}"))
    return gap


def _card_then_cpu(torch, argv):
    """A CLI run on the card, then the same run on the CPU from the card
    run's initial variables (a model drawn on the card from the seed is not
    the one the CPU's generator draws): the two histories."""
    from fedml_tpu_torch.sim.engine import FedSim

    init = {}

    def capture(original):
        def init_variables(self):
            v = original(self)
            init.setdefault("v", {k: t.detach().cpu().clone() for k, t in v.items()})
            return v
        return init_variables

    def replay(original):
        def init_variables(self):
            return {k: t.clone().to(self.device) for k, t in init["v"].items()}
        return init_variables

    with _wrapped(FedSim, "init_variables", capture):
        card = _cli(torch, argv)
    with _wrapped(FedSim, "init_variables", replay):
        cpu = _cli(torch, argv, "cpu")
    return card, cpu


def _small_rule_sim(torch, device, aggregator, rounds=5, epochs=1, straggler=0.0):
    """A small f32 LogisticRegression FedSim on the synthetic LEAF MNIST
    clients with the server rule ``aggregator``; its rounds make one
    eval-aligned block (on the card, replays of the round's CUDA graph)."""
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.data.leaf import synthetic_leaf_mnist
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    train, test, _ = synthetic_leaf_mnist(n_clients=8, seed=0)
    module = create_model("lr", 10, "femnist", device=device)
    cfg = SimConfig(client_num_in_total=8, client_num_per_round=4, batch_size=16,
                    comm_round=rounds, epochs=epochs, frequency_of_the_test=rounds,
                    eval_batch_size=64, seed=0, straggler_frac=straggler)
    return FedSim(ClientTrainer(module=module, optimizer=sgd(0.05), epochs=epochs), train, test,
                  cfg, aggregator=aggregator, device=device)


def phase_fedopt(torch, smi):
    """FedOpt at BASELINE row 4's recipe through the CLI (``[shakespeare
    cli]``'s argv: the Markov fixture, 715 clients, 10 a round, B=4, 2 x LSTM
    256, client SGD 1.0, 6 rounds, an eval every 3, cut from 20, 10 and 5 for
    the script's time budget) with ``--algorithm fedopt`` at the JAX
    defaults (adam, server lr 0.1, b1 0.9): two blocks of 3 replays of the
    round's CUDA graph, whose server step carries Adam's step count as a
    device tensor, against the same rounds dispatched one at
    a time, two runs (blocks, per round; four in turns before PR 13), held
    to rtol 1e-6 / atol 1e-7 (a count frozen in the graph would break the
    bias correction from a block's second round); s/round of each beside
    plain FedAvg's. Then each of the six server optimizers on a small f32
    LogisticRegression, 5 rounds on the card against the CPU, each round
    from the same variables and server state, within ``E2E_ATOL``; the
    free-running 5 rounds (one block on the card) are printed beside. Round
    by round, as the CNN checks run: rmsprop's update, ``g * rsqrt(nu +
    1e-8)``, multiplies a pseudo-gradient's rounding by up to ``lr /
    sqrt(1e-8)`` = 1000 where ``g`` is small (``g = old - avg``, a
    difference of nearly equal numbers), and free-running its card and CPU
    runs part by 1.725e-04 in 5 rounds (measured on the H100). Returns the
    flash launches."""
    from fedml_tpu_torch.algorithms.fedopt import fedopt_aggregator, server_optimizer

    c = dict(SHAKESPEARE, rounds=6, freq=3)
    argv = ["--dataset", "shakespeare", "--model", "rnn",
            "--data_dir", str(BUILD_DIR / "shakespeare_cli"),
            "--client_num_in_total", str(c["clients"]),
            "--client_num_per_round", str(c["per_round"]), "--batch_size", str(c["batch"]),
            "--lr", str(c["lr"]), "--epochs", "1", "--comm_round", str(c["rounds"]),
            "--frequency_of_the_test", str(c["freq"]), "--algorithm", "fedopt"]
    _zero_flash_counters()
    runs, loads = [], []
    with _loaded_once(loads):
        for name in ("blocks", "per round"):
            run = _per_round_cli(torch, argv) if name == "per round" else _cli(torch, argv)
            runs.append((name,) + run)
    launches = _flash_launches()
    base = runs[1][1]
    if not all(np.isfinite([v for r in base for v in r.values()])):
        fail(f"fedopt: bad history {base}")
    for name, history, wall in runs:
        (over, beyond), (diff, where) = _block_gap(torch, (({}, history), ({}, base)))
        log(f"[fedopt {name}] {smi}: rounds {c['freq']}-{c['rounds'] - 1} "
            f"{history[-1]['round_time']:.5f} s a round (plain FedAvg's at this recipe: "
            f"[shakespeare cli] above), rounds 0-{c['freq'] - 1} "
            f"{history[0]['round_time']:.5f} s a round; run {wall:.2f} s; against the first "
            f"per-round run: largest difference {diff:.3e} ({where}); Test/Acc "
            f"{history[-1]['Test/Acc']:.4f}")
        if over > 0:
            fail(f"fedopt: the {name} run's {beyond} differs beyond rtol {BLOCK_RTOL} / "
                 f"atol {BLOCK_ATOL}")
    from torch.utils import _pytree as pytree

    for name in ("sgd", "adam", "yogi", "adagrad", "rmsprop", "adamw"):
        sims, init = {}, None
        for device in ("cpu", "cuda"):
            sims[device] = _small_rule_sim(
                torch, device, fedopt_aggregator(server_optimizer(name, 0.1, 0.9)))
            if init is None:
                init = sims[device].init_round_variables()
        free = {d: sim.run(variables={k: v.to(d) for k, v in init.items()})
                for d, sim in sims.items()}
        free_err = _max_err(torch, (free["cuda"], free["cpu"]))
        # round by round from the CPU's variables and server state
        variables, state, step_err = init, sims["cpu"].aggregator.init_state(init), 0.0
        for r in range(5):
            out = {d: sims[d].run_round(r, {k: v.to(d) for k, v in variables.items()},
                                        pytree.tree_map(lambda t, d=d: t.to(d), state))
                   for d in ("cuda", "cpu")}
            gaps = [float((out["cuda"][0][k].cpu() - out["cpu"][0][k]).abs().max())
                    for k in variables]
            gaps += [float((a.cpu().float() - b.float()).abs().max()) for a, b in zip(
                pytree.tree_leaves(out["cuda"][1]), pytree.tree_leaves(out["cpu"][1]))]
            gaps.append(abs(float(out["cuda"][2]["Train/Loss"])
                            - float(out["cpu"][2]["Train/Loss"])))
            step_err = max(step_err, *gaps)
            variables, state = out["cpu"][0], out["cpu"][1]
        log(f"[fedopt small] server {name}: 5 rounds card vs CPU, each from the same "
            f"variables and server state: largest difference {step_err:.3e}; free-running "
            f"(one block on the card): {free_err:.3e}")
        if not step_err <= E2E_ATOL:
            fail(f"fedopt small: server {name} card vs CPU {step_err:.3e} > {E2E_ATOL}")
    return launches


def phase_fednova(torch, mnist_dir):
    """FedNova at BASELINE row 1 (the 1000-client MNIST LEAF fixture, LR)
    through the CLI with ``--algorithm fednova --straggler_frac 0.5 --epochs
    2``, 10 rounds: one block of 10 graph replays, the same rounds
    dispatched one at a time (rtol 1e-6 / atol 1e-7), and the CPU's run
    from the card run's initial variables (``E2E_ATOL``). Prints each round's ``tau_eff``, which must vary (the
    stragglers' tau differs). Returns the flash launches."""
    rounds = 10
    argv = _mnist_argv(mnist_dir, rounds, rounds, "--algorithm", "fednova",
                       "--straggler_frac", "0.5", "--epochs", "2")
    _zero_flash_counters()
    (blocks, wall_b), (cpu, wall_c) = _card_then_cpu(torch, argv)
    launches = _flash_launches()
    per_round, wall_p = _per_round_cli(torch, argv)
    taus = [rec["tau_eff"] for rec in blocks]
    log(f"[fednova] tau_eff by round: {', '.join(f'{t:.4f}' for t in taus)}")
    if len(set(taus)) < 2 or not all(np.isfinite(taus)):
        fail(f"fednova: tau_eff does not vary: {taus}")
    (over, beyond), (diff, where) = _block_gap(torch, (({}, blocks), ({}, per_round)))
    gap, gap_where = _history_gap(blocks, cpu)
    log(f"[fednova] {rounds} rounds, E=2, straggler_frac 0.5: one block {wall_b:.2f} s "
        f"({blocks[-1]['round_time']:.5f} s a round), per round {wall_p:.2f} s "
        f"({per_round[-1]['round_time']:.5f} s a round), CPU {wall_c:.2f} s; blocks vs per "
        f"round largest difference {diff:.3e} ({where}); card vs CPU {gap:.3e} ({gap_where}); "
        f"Test/Acc {blocks[-1]['Test/Acc']:.4f}")
    if over > 0:
        fail(f"fednova: blocks vs per round {beyond} beyond rtol {BLOCK_RTOL} / atol "
             f"{BLOCK_ATOL}")
    if not gap <= E2E_ATOL:
        fail(f"fednova: card vs CPU {gap:.3e} ({gap_where}) > {E2E_ATOL}")
    return launches


# 2 rounds, cut from 3 for the script's time budget
ROBUST = dict(norm_bound=1.0, stddev=1e-3, rules=("median", "trimmed_mean", "krum"), rounds=2)


def phase_robust(torch, femnist_runs):
    """``--algorithm fedavg_robust`` on FEMNIST + CNNDropOut through the CLI
    at ``[femnist]``'s width (3400 clients, 10 a round, B=20, the fallback),
    for each of median, trimmed mean and Krum, with clipping and DP noise:
    2 rounds as one block against per-round dispatch, both under cuDNN's
    deterministic algorithms, rtol 1e-6 / atol 1e-7 (the noise drawn into
    the graph's buffers before each replay); the rule applied to the card's
    own clipped client stack (the per-round run's last round) against the
    same rule on CPU copies: median and Krum bitwise (Krum's index too),
    trimmed mean within 1e-6. Prints the ``Robust/*`` metrics, s/round
    beside the plain FedAvg block's (``[femnist blocks]``) and peak memory.
    The median's per-round run saves its final model (``--save_params_to``,
    for ``[checkpoint]``). Returns the flash launches and the saved file."""
    from fedml_tpu_torch.algorithms import robust

    plain = femnist_runs["blocks"][0][-1]["round_time"]
    saved = BUILD_DIR / "robust_median.npz"
    _zero_flash_counters()
    records = {}
    for rule in ROBUST["rules"]:
        argv = _femnist_argv(ROBUST["rounds"], "--algorithm", "fedavg_robust",
                             "--robust_rule", rule,
                             "--norm_bound", str(ROBUST["norm_bound"]),
                             "--stddev", str(ROBUST["stddev"]))
        torch.cuda.reset_peak_memory_stats()
        blocks, wall_b = _deterministic_cli(torch, argv)
        peak = torch.cuda.max_memory_allocated()
        seen = {}

        def recorded(fn_name):
            def make(original):
                def wrapped(stacked, *args, **kwargs):
                    seen[fn_name] = ({k: v.detach().clone() for k, v in stacked.items()}, args)
                    return original(stacked, *args, **kwargs)
                return wrapped
            return make

        extra = ["--save_params_to", str(saved)] if rule == "median" else []
        with _wrapped(robust, "coordinate_median", recorded("coordinate_median")), \
                _wrapped(robust, "trimmed_mean", recorded("trimmed_mean")), \
                _wrapped(robust, "krum_select", recorded("krum_select")):
            per_round, wall_p = _deterministic_per_round(torch, argv + extra)
        records[rule] = per_round
        (over, beyond), (diff, where) = _block_gap(torch, (({}, blocks), ({}, per_round)))
        metrics = {k: [round(rec[k], 6) for rec in blocks] for k in blocks[0]
                   if k.startswith("Robust/")}
        fn_name = {"median": "coordinate_median", "trimmed_mean": "trimmed_mean",
                   "krum": "krum_select"}[rule]
        stack, args = seen[fn_name]
        on_card = getattr(robust, fn_name)(stack, *args)
        on_cpu = getattr(robust, fn_name)({k: v.cpu() for k, v in stack.items()}, *args)
        if rule == "krum":
            rule_gap = float(int(on_card) != int(on_cpu))
            chosen = f"Krum's client {int(on_card)} on the card, {int(on_cpu)} on the CPU"
        else:
            rule_gap = max(float((on_card[k].cpu() - on_cpu[k]).abs().max()) for k in on_cpu)
            chosen = f"largest difference {rule_gap:.3e}"
        log(f"[robust {rule}] clip {ROBUST['norm_bound']}, DP stddev {ROBUST['stddev']}: "
            f"{blocks[-1]['round_time']:.4f} s a round in one block of {ROBUST['rounds']} "
            f"(plain FedAvg's "
            f"block {plain:.4f} s), {per_round[-1]['round_time']:.4f} s a round per round "
            f"(runs {wall_b:.2f} s, {wall_p:.2f} s); peak device memory "
            f"{peak / 2**30:.3f} GiB; {metrics}; block vs per round largest difference "
            f"{diff:.3e} ({where}); the rule on the card's client stack vs CPU copies: "
            f"{chosen}; Test/Acc {blocks[-1]['Test/Acc']:.4f}")
        if over > 0:
            fail(f"robust {rule}: block vs per round {beyond} beyond rtol {BLOCK_RTOL} / atol "
                 f"{BLOCK_ATOL}")
        if rule == "trimmed_mean" and not rule_gap <= 1e-6:
            fail(f"robust trimmed_mean: card vs CPU {rule_gap:.3e} > 1e-6")
        if rule != "trimmed_mean" and rule_gap != 0.0:
            fail(f"robust {rule}: the card's rule and the CPU's differ ({chosen})")
        if rule == "krum":
            for k, v in stack.items():
                if not torch.equal(v[int(on_card)].cpu(), v.cpu()[int(on_cpu)]):
                    fail(f"robust krum: the selected client's {k} differs")
    return _flash_launches(), records["median"], saved


def _deterministic_per_round(torch, argv):
    torch.backends.cudnn.deterministic = True
    try:
        return _per_round_cli(torch, argv)
    finally:
        torch.backends.cudnn.deterministic = False


def phase_hierarchical(torch, mnist_dir):
    """Hierarchical FedAvg at BASELINE row 1 through the CLI (``--algorithm
    hierarchical --group_num 2 --group_comm_round 2``, 3 global rounds: each
    group round one eager dispatch over the group's half of the clients), card
    against CPU from the same initial variables within ``E2E_ATOL``. Returns the flash launches."""
    argv = _mnist_argv(mnist_dir, 3, 1, "--algorithm", "hierarchical", "--group_num", "2",
                       "--group_comm_round", "2")
    _zero_flash_counters()
    (card, wall), (cpu, wall_c) = _card_then_cpu(torch, argv)
    launches = _flash_launches()
    gap, where = _history_gap(card, cpu)
    log(f"[hierarchical] 3 global rounds x 2 groups of {MNIST['clients'] // 2} x 2 group "
        f"rounds: card "
        f"{wall:.2f} s ({wall / 3:.3f} s a global round, evals included), CPU {wall_c:.2f} s; "
        f"card vs CPU largest difference {gap:.3e} ({where}); Test/Acc by global round "
        f"{[round(r['Test/Acc'], 4) for r in card]}")
    if len(card) != 3 or not gap <= E2E_ATOL:
        fail(f"hierarchical: card vs CPU {gap:.3e} ({where}) > {E2E_ATOL}, {len(card)} records")
    return launches


def phase_checkpoint(torch, mnist_dir, femnist_record, saved):
    """Round checkpoints and parameter files on the card. BASELINE row 1 with
    FedAdam (``--algorithm fedopt``), one round a dispatch with a checkpoint
    every 5 rounds: 10 rounds straight against 5 rounds, then ``--resume
    1`` up to 10 (cut from 20 and 10 for the script's time budget); the histories and the final variables (``--save_params_to``)
    bitwise equal. Then ``[robust]``'s FEMNIST median run's saved model
    warm-starts a fresh run (``--init_from``, 0 rounds): the warm-started
    model's pooled eval is bitwise the saving run's final eval. Prints the
    file's size and the seconds to save and to load. Returns the flash
    launches."""
    import shutil

    from fedml_tpu_torch.obs import checkpoint
    from fedml_tpu_torch.sim.engine import FedSim

    root = BUILD_DIR / "checkpoint"
    shutil.rmtree(root, ignore_errors=True)
    base = _mnist_argv(mnist_dir, 10, 5, "--algorithm", "fedopt", "--checkpoint_every", "5")
    _zero_flash_counters()
    straight, wall_s = _cli(torch, base + ["--checkpoint_dir", str(root / "a"),
                                           "--save_params_to", str(root / "a.npz")])
    first, _ = _cli(torch, _mnist_argv(mnist_dir, 5, 5, "--algorithm", "fedopt",
                                       "--checkpoint_every", "5",
                                       "--checkpoint_dir", str(root / "b")))
    resumed, wall_r = _cli(torch, base + ["--checkpoint_dir", str(root / "b"), "--resume", "1",
                                          "--save_params_to", str(root / "b.npz")])
    launches = _flash_launches()
    a, b = checkpoint.load_params(root / "a.npz"), checkpoint.load_params(root / "b.npz")
    same_vars = set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    log(f"[checkpoint] FedAdam, row 1: 10 rounds straight ({wall_s:.2f} s, a checkpoint every "
        f"5) against 5 + resume to 10 ({wall_r:.2f} s for the last 5): histories equal "
        f"{resumed == straight}, final variables bitwise equal {same_vars}; kept "
        f"{sorted(p.name for p in (root / 'b').glob('round_*'))}")
    if len(first) != 5 or resumed != straight or not same_vars:
        fail("checkpoint: the resumed run differs from the straight run")
    times = {}

    def timing(name):
        def make(original):
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                out = original(*args, **kwargs)
                times[name] = time.perf_counter() - t0
                return out
            return timed
        return make

    sims = []

    def keep_sim(original):
        def init_round_variables(self, *args, **kwargs):
            out = original(self, *args, **kwargs)
            sims.append((self, {k: v.clone() for k, v in out.items()}))
            return out
        return init_round_variables

    with _wrapped(checkpoint, "load_params", timing("load")), \
            _wrapped(FedSim, "init_round_variables", keep_sim):
        _deterministic_cli(torch, _femnist_argv(0, "--init_from", str(saved)))
    sim, warm = sims[-1]
    torch.backends.cudnn.deterministic = True
    try:
        evals = sim.evaluate(warm)
    finally:
        torch.backends.cudnn.deterministic = False
    t_save = time.perf_counter()
    checkpoint.save_params(root / "resave.npz", warm)
    times["save"] = time.perf_counter() - t_save
    want = {k: femnist_record[k] for k in evals}
    log(f"[checkpoint] FEMNIST CNNDropOut params file {saved.stat().st_size / 2**20:.3f} MiB: "
        f"save {times['save']:.4f} s, load into the model {times['load']:.4f} s; the "
        f"warm-started model's eval {evals} against the saving run's final eval {want}: "
        f"bitwise equal {evals == want}")
    if evals != want:
        fail("checkpoint: the warm-started model's eval differs from the saved model's")
    return launches


def phase_trace(torch, mnist_dir):
    """``--trace_dir`` at BASELINE row 1 through the CLI (two blocks of 10,
    pipelined): traced and untraced runs in turns (untraced, traced, traced,
    untraced), histories bitwise equal (round time aside), s/round of each
    (the tracer's cost on the host-dispatch cell) and the span counts by
    name; then 5 rounds of the same FedSim through the repro loop
    (``exp/_loop.run_rounds``) under ``obs/trace.trace_to``. The engine's
    stage, dispatch and eval spans, the prefetch thread's and the loop's
    must each be present. Returns the flash launches."""
    import dataclasses
    import json as _json

    from fedml_tpu_torch.exp._loop import run_rounds
    from fedml_tpu_torch.obs import trace
    from fedml_tpu_torch.sim.engine import FedSim

    c = MNIST
    argv = _mnist_argv(mnist_dir, c["rounds"], c["freq"])
    sims = []

    def keep(original):
        def run(self, *args, **kwargs):
            sims.append(self)
            return original(self, *args, **kwargs)
        return run

    _zero_flash_counters()
    runs = []
    with _wrapped(FedSim, "run", keep):
        for i, traced in enumerate((False, True, True, False)):
            extra = ["--trace_dir", str(BUILD_DIR / f"trace_{i}")] if traced else []
            runs.append((traced,) + _cli(torch, argv + extra))
    base = _strip_times(runs[0][1])
    for traced, history, wall in runs:
        steady = np.mean([r["round_time"] for r in history[c["freq"]:]])
        log(f"[trace] {'traced' if traced else 'untraced'}: {steady * 1e3:.3f} ms a round "
            f"(rounds {c['freq']}-{c['rounds'] - 1}), run {wall:.2f} s")
        if _strip_times(history) != base:
            fail("trace: a traced run's history differs from the untraced one's")
    recs = [_json.loads(line) for line in
            (BUILD_DIR / "trace_1" / trace.JSONL_TRACE_NAME).read_text().splitlines()]
    cfg = dataclasses.replace(sims[-1].config, comm_round=5, frequency_of_the_test=5)
    with trace.trace_to(BUILD_DIR / "trace_loop") as tracer:
        run_rounds(sims[-1], cfg, None)
    launches = _flash_launches()
    counts: dict[str, int] = {}
    for r in recs + tracer.events():
        if r.get("ph") in ("X", "C", "i"):
            counts[r["name"]] = counts.get(r["name"], 0) + 1
    log(f"[trace] spans, counters and events by name (the traced CLI run, then 5 rounds of "
        f"the repro loop): {dict(sorted(counts.items()))}")
    need = ["engine/stage", "engine/dispatch", "engine/eval", "loop/round"]
    missing = [n for n in need if n not in counts]
    if missing or not any(n.startswith("prefetch/") for n in counts):
        fail(f"trace: missing spans {missing or 'prefetch/*'}")
    return launches


# depth cut to keep the script near its budget: FEMNIST 3 rounds -> 2, the
# flagship 2 -> 1 (its round 1 holds both checks)
COMPRESS = dict(specs=("none", "bf16", "topk", "q8", "q4", "topk+q4"), topk_frac=0.01,
                femnist_rounds=2, flagship_rounds=1)


class _SharedUniforms:
    """Uniforms for a quantizing codec (``.uniform(shape)``) from a numpy
    seed, put on ``device``: two of them with one seed serve the card and
    the CPU the same numbers."""

    def __init__(self, torch, device, seed=0):
        self.torch, self.device, self.rng = torch, device, np.random.RandomState(seed)

    def uniform(self, shape, dtype=None):
        u = self.rng.random_sample(tuple(shape)).astype(np.float32)
        return self.torch.from_numpy(u).to(self.device)


def _plane_gap(torch, a, b, where=""):
    """Where two encoded updates' planes differ (the card's moved to the
    CPU), bit for bit: a list of ``(plane/leaf, elements that differ)``."""
    from fedml_tpu_torch.compress.codec import EncodedUpdate

    if isinstance(a, EncodedUpdate):
        if a.scheme != b.scheme or a.meta != b.meta or sorted(a.planes) != sorted(b.planes):
            return [(where or "update", "scheme, meta or plane names")]
        return [g for name in a.planes for g in _plane_gap(torch, a.planes[name],
                                                           b.planes[name], f"{where}{name}/")]
    if isinstance(a, dict):
        return [g for k in a for g in _plane_gap(torch, a[k], b[k], f"{where}{k}")]
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return [(where, f"{a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")]
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(a.dtype)
    if bits is not None:
        a, b = a.view(bits), b.view(bits)
    n = int((a != b).sum())
    return [(where, n)] if n else []


def phase_compress(torch, femnist_runs, plain_flagship_s):
    """Update compression on the card (``--compressor``,
    ``compress/aggregate.py``). (1) Each codec of ``COMPRESS["specs"]``
    (top-k at 0.01) on a ResNet-56-shaped delta (its 0.86M-element state
    dict, normal draws x 0.01) on the card and on the CPU, the quantizers
    fed the same uniforms: every plane bitwise equal, else the differing
    planes are printed and the phase fails. (2) FEMNIST + CNNDropOut at
    ``[femnist]``'s recipe with ``--compressor q4 --error_feedback 0``:
    2 rounds as one block (the codec's uniforms drawn into the graph's
    buffers before each replay) against per-round dispatch, both under
    deterministic cuDNN, rtol 1e-6 / atol 1e-7; the compression ratio and
    s/round beside the plain block's (``COMPRESS`` sets the rounds of each
    part). (3) The cross-silo flagship
    (CIFAR-10 fixture of ``[cross-silo]``, ResNet-56 bf16, 10 silos all
    every round, B=64, E=1, SGD 0.001 wd 0.001, augmentation, per-round
    dispatch), built as ``repro_cross_silo`` builds it, with top-k 0.01 and
    error feedback: the residual stack nonzero after round 1, the
    uplink bytes 10 x one client's encoded bytes, the round metrics finite;
    the eval printed with the count of BatchNorm running variances below
    zero (error feedback over model state, as in the JAX wrapper, can make
    one negative and the eval NaN; a non-finite eval without one fails);
    s/round beside the plain flagship's rounds (``plain_flagship_s``).
    Returns the flash launches."""
    from fedml_tpu_torch.compress.codec import make_codec, tree_bytes
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.data.cv import load_cifar
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.obs import metrics as metricslib
    from fedml_tpu_torch.ops.augment import ImageAugment
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    _zero_flash_counters()
    # (1) the codecs, card against CPU
    rng = np.random.RandomState(0)
    shapes = {k: tuple(v.shape) for k, v in
              create_model("resnet56", 10, device="cpu").state_dict().items()}
    delta = {k: torch.from_numpy((rng.randn(*s) * 0.01).astype(np.float32))
             for k, s in shapes.items()}
    delta_card = {k: v.cuda() for k, v in delta.items()}
    n = sum(v.numel() for v in delta.values())
    for spec in COMPRESS["specs"]:
        codec = make_codec(spec, topk_frac=COMPRESS["topk_frac"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = codec.encode(delta_card, _SharedUniforms(torch, "cuda"))
        dec_card = codec.decode(card)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        cpu = codec.encode(delta, _SharedUniforms(torch, "cpu"))
        gaps = _plane_gap(torch, card, cpu)
        dec_gap = _plane_gap(torch, dec_card, codec.decode(cpu))
        log(f"[compress codecs] {spec}: {n} elements in {len(delta)} leaves, "
            f"{card.nbytes} bytes encoded of {tree_bytes(delta)} (ratio "
            f"{tree_bytes(delta) / card.nbytes:.3f}), card encode + decode {card_ms:.2f} ms "
            f"(first call); planes card vs CPU: "
            + ("bitwise equal" if not gaps else f"differ {gaps[:8]}")
            + ("; decoded bitwise equal" if not dec_gap else f"; decoded differ {dec_gap[:8]}"))
        if gaps or dec_gap:
            fail(f"compress codecs {spec}: the card's planes differ from the CPU's: "
                 f"{(gaps + dec_gap)[:8]}")
        if card.nbytes != cpu.nbytes:
            fail(f"compress codecs {spec}: {card.nbytes} bytes on the card, {cpu.nbytes} on "
                 "the CPU")
    del delta_card

    # (2) FEMNIST, q4 without error feedback, blocks against per round
    rounds = COMPRESS["femnist_rounds"]
    argv = _femnist_argv(rounds, "--compressor", "q4", "--error_feedback", "0")
    blocks, wall_b = _deterministic_cli(torch, argv)
    per_round, wall_p = _deterministic_per_round(torch, argv)
    (over, beyond), (diff, where) = _block_gap(torch, (({}, blocks), ({}, per_round)))
    plain = femnist_runs["blocks"][0][-1]["round_time"]
    plain_per_round = femnist_runs["per round"][0][-1]["round_time"]
    ratio = blocks[-1][metricslib.COMM_RATIO]
    log(f"[compress femnist] q4, no error feedback, {rounds} rounds: Comm/CompressionRatio "
        f"{ratio:.4f}, uplink {blocks[-1][metricslib.COMM_UPLINK_BYTES]:.0f} of "
        f"{blocks[-1][metricslib.COMM_UPLINK_DENSE_BYTES]:.0f} bytes a round; "
        f"{blocks[-1]['round_time']:.4f} s a round in one block (plain FedAvg's block "
        f"{plain:.4f} s), {per_round[-1]['round_time']:.4f} s a round per round (plain "
        f"{plain_per_round:.4f} s); runs {wall_b:.2f} s, {wall_p:.2f} s; Train/Loss "
        + ", ".join(f"{rec['Train/Loss']:.6f}" for rec in blocks)
        + f"; Test/Acc {blocks[-1]['Test/Acc']:.4f}; block vs per round largest difference "
        f"{diff:.3e} ({where})")
    if over > 0:
        fail(f"compress femnist: block vs per round {beyond} beyond rtol {BLOCK_RTOL} / atol "
             f"{BLOCK_ATOL}")
    if not ratio > 7.0:
        fail(f"compress femnist: q4's compression ratio {ratio} (expected near 8)")

    # (3) the cross-silo flagship with top-k and error feedback
    c = CROSS_SILO
    train, test, class_num = load_cifar("cifar10", BUILD_DIR / "cifar10", "hetero", 0.5,
                                        c["clients"], 0, allow_synthetic=False)
    model = create_model("resnet56", class_num, dtype=torch.bfloat16, device="cuda")
    trainer = ClientTrainer(module=model, optimizer=sgd(0.001, weight_decay=0.001),
                            epochs=c["epochs"], augment=ImageAugment())
    frac = COMPRESS["topk_frac"]
    cfg = SimConfig(client_num_in_total=c["clients"], client_num_per_round=c["clients"],
                    batch_size=c["batch"], comm_round=COMPRESS["flagship_rounds"],
                    epochs=c["epochs"], frequency_of_the_test=COMPRESS["flagship_rounds"],
                    seed=0, block_dispatch=False, cohort_execution="vmap",
                    compressor="topk", topk_frac=frac, error_feedback=True)
    sim = FedSim(trainer, train, test, cfg, device="cuda")
    variables = sim.init_round_variables()
    state = sim.aggregator.init_state(variables)
    one_client = make_codec("topk", topk_frac=frac).encode(variables, None).nbytes
    times, records = [], []
    for r in range(cfg.comm_round):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        variables, state, m = sim.run_round(r, variables, state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        records.append({k: float(v) for k, v in m.items()})
        if r == 0:
            nonzero = sum(int(torch.count_nonzero(v)) for v in state["residual"].values())
            if nonzero == 0:
                fail("compress flagship: the residual stack is zero after round 1")
    evaluated = sim.evaluate(variables)
    # error feedback over the BatchNorm running variances (the JAX wrapper
    # compresses every variable, model state too) can push one below zero,
    # and the eval's normalisation then reads NaN: count them
    negative = sum(int((v < 0).sum()) for k, v in variables.items()
                   if k.endswith("running_var"))
    uplink = records[-1][metricslib.COMM_UPLINK_BYTES]
    log(f"[compress flagship] ResNet-56 bf16, {c['clients']} silos x B={c['batch']}, top-k "
        f"{frac} + error feedback: s/round " + ", ".join(f"{t:.3f}" for t in times)
        + " (the plain flagship's rounds, [cross-silo]: "
        + ", ".join(f"{t:.3f}" for t in plain_flagship_s) + " s); residual stack nonzero "
        f"after round 1: {nonzero} of {sum(v.numel() for v in state['residual'].values())} "
        f"elements; uplink {uplink:.0f} bytes a round = {c['clients']} x {one_client}, dense "
        f"{records[-1][metricslib.COMM_UPLINK_DENSE_BYTES]:.0f}, Comm/CompressionRatio "
        f"{records[-1][metricslib.COMM_RATIO]:.4f}; Train/Loss "
        + ", ".join(f"{rec['Train/Loss']:.5f}" for rec in records)
        + f"; eval {json.dumps({k: round(v, 5) for k, v in evaluated.items()})}; BatchNorm "
        f"running variances below zero: {negative}")
    if uplink != c["clients"] * one_client:
        fail(f"compress flagship: uplink {uplink} bytes, expected {c['clients']} x {one_client}")
    if not all(np.isfinite([v for rec in records for v in rec.values()])):
        fail(f"compress flagship: non-finite round metrics {records}")
    if not all(np.isfinite(list(evaluated.values()))) and negative == 0:
        fail(f"compress flagship: a non-finite eval {evaluated} with no negative running "
             "variance to explain it")
    del sim, variables, state
    torch.cuda.empty_cache()
    return _flash_launches()


GOSSIP = dict(rounds=3, small_clients=8, small_atol=1e-5)


def phase_gossip(torch, mnist_dir):
    """``--algorithm decentralized`` (gossip on a ring of every client, the
    engine's per-client mode) at BASELINE row 1 through the CLI: the
    1000-client LEAF fixture, all 1000 every round, B=10, SGD 0.03, 3
    rounds as one block (the ``[1000, ...]`` model stack the graph's input)
    against per-round dispatch: histories and final stacks bitwise equal
    (LR runs no cuDNN). Prints ``consensus_dist`` each round, the stack's
    bytes and s/round. Then an 8-client ring on the synthetic fixture, 3
    rounds, the card against the CPU from the same variables, within 1e-5.
    Returns the flash launches."""
    from fedml_tpu_torch.sim.engine import FedSim

    final = {}

    def keep_final(original):
        def run(self, *args, **kwargs):
            variables, history = original(self, *args, **kwargs)
            final.setdefault("stacks", []).append({k: v.detach().clone()
                                                   for k, v in variables.items()})
            return variables, history
        return run

    _zero_flash_counters()
    argv = _mnist_argv(mnist_dir, GOSSIP["rounds"], GOSSIP["rounds"], "--algorithm",
                       "decentralized")
    with _wrapped(FedSim, "run", keep_final):
        blocks, wall_b = _cli(torch, argv)
        per_round, wall_p = _per_round_cli(torch, argv)
    gap, where = _history_gap(blocks, per_round)
    (a, b) = final["stacks"]
    same = set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    shape = {k: tuple(v.shape) for k, v in a.items()}
    stack_bytes = sum(v.numel() * v.element_size() for v in a.values())
    log(f"[gossip] decentralized, row 1: ring of {a[next(iter(a))].shape[0]} clients, all "
        f"every round, stack {shape} = {stack_bytes} bytes; consensus_dist by round "
        + ", ".join(f"{rec['consensus_dist']:.6e}" for rec in blocks)
        + f"; {blocks[-1]['round_time']:.4f} s a round in one block, "
        f"{per_round[-1]['round_time']:.4f} s a round per round (runs {wall_b:.2f} s, "
        f"{wall_p:.2f} s); Test/Acc {blocks[-1]['Test/Acc']:.4f}; block vs per round: "
        f"histories largest difference {gap:.3e} ({where}), final stacks bitwise equal {same}")
    if gap != 0.0 or not same:
        fail(f"gossip: block and per-round dispatch differ ({gap:.3e} at {where}, stacks "
             f"equal {same})")
    small = ["--dataset", "synthetic_0.5_0.5", "--model", "lr", "--algorithm", "decentralized",
             "--client_num_in_total", str(GOSSIP["small_clients"]), "--batch_size", "8",
             "--lr", "0.1", "--comm_round", "3", "--frequency_of_the_test", "3",
             "--data_dir", str(BUILD_DIR / "synthetic_none")]
    (card, _), (cpu, _) = _card_then_cpu(torch, small)
    gap, where = _history_gap(card, cpu)
    log(f"[gossip] {GOSSIP['small_clients']} clients on a ring, 3 rounds, card vs CPU from the "
        f"same variables: largest difference {gap:.3e} ({where}); consensus_dist "
        + ", ".join(f"{rec['consensus_dist']:.6e}" for rec in card))
    if not gap <= GOSSIP["small_atol"]:
        fail(f"gossip: the card and the CPU differ by {gap:.3e} at {where}")
    return _flash_launches()


# the full-width LM of the main path, one round of 2 clients x 2 steps, with
# and without remat (ROADMAP §A8b); then a small LM with dropout
LM_REMAT = dict(MAIN, steps=2, rounds=1)
LM_DROPOUT = dict(vocab=90, embed_dim=128, num_layers=2, num_heads=4, seq=64, clients=4,
                  batch=4, steps=2, rate=0.1)


def _lm_tokens(c, rng):
    n_per = c["steps"] * c["batch"]
    n = c["clients"] * n_per
    x = rng.randint(0, c["vocab"], (n, c["seq"])).astype(np.int32)
    arrays = {"x": x, "y": np.roll(x, -1, axis=1), "mask": np.ones((n, c["seq"]), np.float32)}
    return arrays, {i: np.arange(i * n_per, (i + 1) * n_per) for i in range(c["clients"])}


def phase_lm_remat(torch):
    """ROADMAP §A8b on the card. The main path's bf16 TransformerLM at full
    width (scan, flash), one round of 2 clients x 2 steps twice from one
    init: with ``remat=True`` (each block keeps its input and reruns its
    forward in the backward, ``transformer._RematBlock``) and without.
    Losses and variables must be bitwise equal (the replay runs the same
    deterministic kernels on the same inputs), else within the bf16
    tolerance of PERF.md §2, the gap printed; the peak device memory of
    each is printed and must be lower with remat; the flash launches of the
    train steps must be 2L a step with remat and L without. Then a small
    f32 LM with ``dropout_rate=0.1`` (vmapped cohort, flash, masks from the
    round stream on the card) runs a round twice from one seed: bitwise
    equal, and the stream's keep masks keep 0.9 +- 0.01; once more from
    another seed, whose loss must differ (the masks reach the model).
    Returns the flash launches of the phase (its remat and dropout
    rounds)."""
    from fedml_tpu_torch.core.trainer import ClientTrainer, DropoutStream, sgd
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.sim.cohort import FederatedArrays
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    c = LM_REMAT
    arrays, part = _lm_tokens(c, np.random.RandomState(0))
    model = create_model("transformer", c["vocab"], dtype=torch.bfloat16,
                         embed_dim=c["embed_dim"], num_layers=c["num_layers"],
                         num_heads=c["num_heads"], max_len=c["seq"], attn_impl="flash")
    cfg = SimConfig(client_num_in_total=c["clients"], client_num_per_round=c["clients"],
                    batch_size=c["batch"], comm_round=1, epochs=1, seed=0,
                    shuffle_each_round=False, cohort_execution="scan", pipeline_depth=0)
    sim = FedSim(ClientTrainer(module=model, task="nwp", optimizer=sgd(0.01, momentum=0.9)),
                 FederatedArrays(arrays, part), None, cfg)
    init = sim.init_variables()
    runs, launches = {}, {name: 0 for name in KERNELS}
    for remat in (False, True):
        model.remat = remat
        _zero_flash_counters()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        variables, _, metrics = sim.run_round(0, {k: v.clone() for k, v in init.items()})
        loss = float(metrics["Train/Loss"])
        wall = time.perf_counter() - t0
        runs[remat] = (variables, loss, wall, torch.cuda.max_memory_allocated() - held,
                       _flash_launches())
        launches = {k: launches[k] + v for k, v in runs[remat][4].items()}
    model.remat = False
    steps = c["clients"] * c["steps"]
    gap = max(float((runs[True][0][k].double() - runs[False][0][k].double()).abs().max())
              for k in init)
    gap = max(gap, abs(runs[True][1] - runs[False][1]))
    for remat, (_, loss, wall, peak, counts) in runs.items():
        log(f"[lm remat] remat={remat}: D={c['embed_dim']} L={c['num_layers']} "
            f"H={c['num_heads']} T={c['seq']} V={c['vocab']} bf16 flash, {c['clients']} "
            f"clients x {c['steps']} steps x B={c['batch']}: round {wall:.3f} s "
            f"({wall / steps:.3f} s a step), Train/Loss {loss:.6f}, peak device memory above "
            f"the held {peak / 2**30:.3f} GiB, flash launches {counts}")
    log(f"[lm remat] remat against plain: largest difference {gap:.3e} (bitwise "
        f"{gap == 0.0}); peak memory {runs[True][3] / 2**30:.3f} GiB against "
        f"{runs[False][3] / 2**30:.3f} GiB")
    if not gap <= BF16_ATOL:
        fail(f"lm remat: remat and plain differ by {gap:.3e} > {BF16_ATOL}")
    if not runs[True][3] < runs[False][3]:
        fail(f"lm remat: remat's peak memory {runs[True][3]} is not below plain's "
             f"{runs[False][3]}")
    L = c["num_layers"]
    for remat, per_step in ((True, 2 * L), (False, L)):
        expected = {name: (per_step * steps if spec["dtype"] == "bfloat16" else 0)
                    for name, spec in KERNELS.items()}
        if runs[remat][4] != expected:
            fail(f"lm remat: remat={remat} launched {runs[remat][4]}, expected {expected}")
    del sim, model, runs, init
    torch.cuda.empty_cache()

    d = LM_DROPOUT
    arrays, part = _lm_tokens(d, np.random.RandomState(1))
    model = create_model("transformer", d["vocab"], dtype=torch.float32,
                         embed_dim=d["embed_dim"], num_layers=d["num_layers"],
                         num_heads=d["num_heads"], max_len=d["seq"], attn_impl="flash",
                         dropout_rate=d["rate"], remat=True)
    trainer = ClientTrainer(module=model, task="nwp", optimizer=sgd(0.1, momentum=0.9))
    cfg = SimConfig(client_num_in_total=d["clients"], client_num_per_round=d["clients"],
                    batch_size=d["batch"], comm_round=1, epochs=1, seed=3)
    sim = FedSim(trainer, FederatedArrays(arrays, part), None, cfg)
    init = sim.init_variables()
    _zero_flash_counters()
    twice = [sim.run_round(0, {k: v.clone() for k, v in init.items()}) for _ in range(2)]
    other_seed = dataclasses.replace(cfg, seed=cfg.seed + 1)
    other = FedSim(trainer, FederatedArrays(arrays, part), None, other_seed).run_round(
        0, {k: v.clone() for k, v in init.items()})
    counts = _flash_launches()
    launches = {k: launches[k] + v for k, v in counts.items()}
    same = (all(torch.equal(twice[0][0][k], twice[1][0][k]) for k in init)
            and torch.equal(twice[0][2]["Train/Loss"], twice[1][2]["Train/Loss"]))
    masks = DropoutStream(trainer.dropout_sites, cfg.seed, 0, d["clients"], d["batch"],
                          torch.device("cuda")).masks(0)
    kept = float(torch.cat([m.flatten() for m in masks.values()]).float().mean())
    moved = max(float((twice[0][0][k] - init[k]).abs().max()) for k in init)
    loss, other_loss = float(twice[0][2]["Train/Loss"]), float(other[2]["Train/Loss"])
    log(f"[lm dropout] small LM (D={d['embed_dim']} L={d['num_layers']} T={d['seq']}) with "
        f"dropout {d['rate']} and remat, vmapped cohort of {d['clients']}: a round twice from "
        f"seed {cfg.seed} bitwise equal {same}; Train/Loss {loss:.6f}, from seed "
        f"{other_seed.seed} {other_loss:.6f}; the stream's keep share {kept:.5f}; largest "
        f"move of a variable {moved:.3e}; flash launches {counts}")
    if not same:
        fail("lm dropout: two rounds from one seed differ")
    if loss == other_loss:
        fail(f"lm dropout: seeds {cfg.seed} and {other_seed.seed} give one loss {loss}: "
             "the masks do not reach the model")
    if not abs(kept - (1.0 - d["rate"])) <= 0.01:
        fail(f"lm dropout: keep share {kept} outside 0.9 +- 0.01")
    return launches


# FedGAN at BASELINE row 1's fixture: the fedgan recipe's Adam(2e-4, b1 0.5)
FEDGAN = dict(rounds=3, lr=2e-4, small_clients=8, small_atol=1e-9)


def _data_z(base, pad):
    """``base`` (a GAN trainer) with its step's latent ``z`` read from
    ``batch["z"]`` (a padding row's from ``pad``): the card and the CPU then
    see one z, which their own generators would draw apart."""
    class DataZ(base):
        def train_step(self, variables, opt_states, batch, z):
            fill = (1.0 - batch["mask"])[:, None] * pad.to(batch["z"].device)
            return super().train_step(variables, opt_states, batch,
                                      (batch["z"] + fill).to(batch["z"].dtype))
    return DataZ


def _gan_sim(torch, device, dtype, arrays, part, pad):
    from fedml_tpu_torch.algorithms import fedgan
    from fedml_tpu_torch.core.trainer import Adam
    from fedml_tpu_torch.models.gan import Discriminator, Generator
    from fedml_tpu_torch.sim.cohort import FederatedArrays
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    img = tuple(arrays["x"].shape[1:])
    gan = _data_z(fedgan.GANTrainer, pad)(
        Generator(img_shape=img, dtype=dtype, device=device),
        Discriminator(img_shape=img, dtype=dtype, device=device),
        Adam(FEDGAN["lr"], b1=0.5), Adam(FEDGAN["lr"], b1=0.5))
    cfg = SimConfig(client_num_in_total=len(part), client_num_per_round=len(part),
                    batch_size=10, comm_round=1, epochs=1, seed=0)
    return FedSim(gan, FederatedArrays(arrays, part), None, cfg,
                  aggregator=fedgan.fedgan_aggregator(), device=device,
                  local_train_fn=fedgan.make_gan_local_train(gan))


def phase_fedgan(torch, mnist_dir):
    """``--algorithm fedgan`` through the CLI at BASELINE row 1's fixture
    (1000 LEAF clients, 10 a round, B=10, E=1) with the fedgan recipe's
    Adam(2e-4, b1 0.5) on both networks: 3 rounds as one block (a replay of
    the GAN round's CUDA graph, its z in static buffers) against the same
    rounds dispatched one at a time, under deterministic algorithms, held to
    rtol 1e-6 / atol 1e-7; s/round and Train/Loss printed. Then 8 clients
    of the fixture's first, a round on the card and on the CPU from the same
    variables and the same z (read from the data), in float64 (the GAN's
    ``dtype``), within 1e-9: in f32 Adam turns the rounding of the
    BatchNorm-cancelled near-zero gradients into steps of up to lr (1.778e-04
    apart in f32, PERF.md §6, PR 13), in float64 the round reads ~1e-12.
    Returns the flash launches."""
    from fedml_tpu_torch.data.registry import load_partition_data
    from fedml_tpu_torch.sim.engine import FedSim

    final = {}

    def keep_final(original):
        def run(self, *args, **kwargs):
            variables, history = original(self, *args, **kwargs)
            final.setdefault("v", []).append({k: v.detach().clone() for k, v in variables.items()})
            return variables, history
        return run

    _zero_flash_counters()
    argv = _mnist_argv(mnist_dir, FEDGAN["rounds"], FEDGAN["rounds"], "--algorithm", "fedgan",
                       "--lr", str(FEDGAN["lr"]))
    torch.use_deterministic_algorithms(True)
    try:
        with _wrapped(FedSim, "run", keep_final):
            blocks, wall_b = _cli(torch, argv)
            per_round, wall_p = _per_round_cli(torch, argv)
    finally:
        torch.use_deterministic_algorithms(False)
    launches = _flash_launches()
    (over, beyond), (diff, where) = _block_gap(torch, [(final["v"][0], blocks),
                                                       (final["v"][1], per_round)])
    for name, history, wall in (("block", blocks, wall_b), ("per round", per_round, wall_p)):
        log(f"[fedgan] {name}: run {wall:.2f} s; round_time "
            + ", ".join(f"{rec['round_time']:.4f}" for rec in history) + " s; Train/Loss "
            + ", ".join(f"{rec['Train/Loss']:.6f}" for rec in history))
    log(f"[fedgan] one block of {FEDGAN['rounds']} graph replays vs per-round dispatch: "
        f"largest difference {diff:.3e} ({where}), bitwise {diff == 0.0}; records "
        f"{sorted(blocks[-1])}")
    if over > 0:
        fail(f"fedgan: {beyond} differs beyond rtol {BLOCK_RTOL} / atol {BLOCK_ATOL}")
    if not all(np.isfinite(rec["Train/Loss"]) for rec in blocks) or "Test/Acc" in blocks[-1]:
        fail(f"fedgan: records {blocks}")

    ds = load_partition_data("mnist", str(mnist_dir), "hetero", 0.5, MNIST["clients"], 0)
    ids = range(FEDGAN["small_clients"])
    rows = np.concatenate([ds.train.partition[i] for i in ids])
    bounds = np.cumsum([0] + [len(ds.train.partition[i]) for i in ids])
    part = {i: np.arange(bounds[i], bounds[i + 1]) for i in ids}
    rng = np.random.RandomState(5)
    pad = torch.tensor(rng.randn(100).astype(np.float32))
    arrays = {"x": ds.train.arrays["x"][rows].astype(np.float32),
              "y": ds.train.arrays["y"][rows],
              "z": rng.randn(len(rows), 100).astype(np.float32).astype(np.float64)}
    out = {}
    for device in ("cuda", "cpu"):
        sim = _gan_sim(torch, device, torch.float64, arrays, part, pad)
        if device == "cuda":
            init = {k: v.cpu().double() for k, v in sim.init_variables().items()}
        variables, _, m = sim.run_round(0, {k: v.to(device) for k, v in init.items()})
        out[device] = ({k: v.cpu() for k, v in variables.items()}, float(m["Train/Loss"]))
    gap = max([float((out["cuda"][0][k] - out["cpu"][0][k]).abs().max()) for k in init]
              + [abs(out["cuda"][1] - out["cpu"][1])])
    log(f"[fedgan] {FEDGAN['small_clients']} clients of the fixture, one round in float64, "
        f"card vs CPU from the same variables and z: largest difference {gap:.3e}")
    if not gap <= FEDGAN["small_atol"]:
        fail(f"fedgan: card and CPU differ by {gap:.3e} in float64")
    return launches


SPLIT_ATOL = 1e-5


def _starting_from(torch, cls, start):
    """``cls.init`` returning copies of ``start`` (a tuple or list of state
    dicts) for the block: a run from the variables another run drew."""
    def make(original):
        def init(self, *args, **kwargs):
            return type(start)({k: v.clone() for k, v in sd.items()} for sd in start)
        return init
    return _wrapped(cls, "init", make)


def phase_split_and_vertical(torch, mnist_dir):
    """SplitNN through ``exp/main_splitnn`` on BASELINE row 1's fixture
    (1000 LEAF clients, the relay ring of all of them, 1 epoch, B=16, the
    Bottom/Top MLP of hidden 32) on the card, each client's turn then rerun
    on the CPU from the card's variables before it: every turn's loss and
    halves within 1e-5. The free-running CPU relay from the card's start is
    printed against the card's (its metrics and both halves: 4,000
    sequential SGD steps through one shared half compound the products'
    summation orders; 1.174e-05 apart in PR 13's first chip call). Vertical FL through ``exp/main_vfl`` on its
    synthetic default (2 parties, 8 epochs) on the card and on the CPU from
    the card run's initial variables, ``Train/Loss`` and ``Test/Acc``
    within 1e-5. Prints s/epoch and Test/Acc. Returns the flash
    launches."""
    from fedml_tpu_torch.algorithms import splitnn, vertical
    from fedml_tpu_torch.data.registry import load_partition_data
    from fedml_tpu_torch.exp import main_splitnn, main_vfl

    def recorded(module, name, into, host=False):
        def make(original):
            def call(*args, **kwargs):
                out = original(*args, **kwargs)
                into.append(_to_cpu(torch, (args, out)) if host else out)
                return out
            return call
        return _wrapped(module, name, make)

    _zero_flash_counters()
    # hetero, as the CLI phases load the fixture (LEAF keeps its own
    # clients whatever the flag), so the row's data is loaded once
    split_argv = ["--dataset", "mnist", "--data_dir", str(mnist_dir), "--client_number",
                  str(MNIST["clients"]), "--epochs", "1", "--partition_method", "hetero"]
    args = main_splitnn.add_args(argparse.ArgumentParser()).parse_args(split_argv)
    turns, relay_s, inits, relays = [], [], [], []
    with recorded(splitnn, "relay_turn", turns, host=True), recorded(splitnn.SplitNN, "init",
                                                                     inits), \
            recorded(splitnn, "run_splitnn_relay", relays), \
            _wrapped(splitnn, "run_splitnn_relay", _timing(relay_s, torch.cuda.synchronize)):
        t0 = time.perf_counter()
        metrics = main_splitnn.run(args)
        wall = time.perf_counter() - t0
    ds = load_partition_data(args.dataset, args.data_dir, args.partition_method,
                             args.partition_alpha, args.client_number, args.seed)
    cpu_split, cpu_batches = main_splitnn.build(args, ds, torch.device("cpu"))
    gap, where = 0.0, "none"
    for ci, ((_, cv, sv, s_opt, _), (cv_out, sv_out, _, loss)) in enumerate(turns):
        got = splitnn.relay_turn(cpu_split, cv, sv, s_opt, cpu_batches[ci])
        for name, a, b in (("client", cv_out, got[0]), ("server", sv_out, got[1])):
            for k in a:
                d = float((a[k] - b[k]).abs().max())
                if d > gap:
                    gap, where = d, f"turn {ci} {name} {k}"
        if abs(float(loss) - float(got[3])) > gap:
            gap, where = abs(float(loss) - float(got[3])), f"turn {ci} loss"
    args_cpu = main_splitnn.add_args(argparse.ArgumentParser()).parse_args(
        split_argv + ["--device", "cpu"])
    start = tuple({k: v.cpu() for k, v in half.items()} for half in inits[0])
    with _starting_from(torch, splitnn.SplitNN, start), \
            recorded(splitnn, "run_splitnn_relay", relays):
        free = main_splitnn.run(args_cpu)
    (card_c, card_s, _), (free_c, free_s, _) = relays
    free_gap = {"metrics": max(abs(metrics[k] - free[k]) for k in metrics),
                "client halves": max(float((a[k].cpu() - b[k]).abs().max())
                                     for a, b in zip(card_c, free_c) for k in a),
                "server half": max(float((card_s[k].cpu() - free_s[k]).abs().max())
                                   for k in card_s)}
    log(f"[splitnn] main_splitnn, {len(turns)} clients of row 1's fixture in the relay, 1 "
        f"epoch: the relay {relay_s[0]:.2f} s an epoch on the card (run {wall:.2f} s); "
        f"{metrics}; each turn rerun on the CPU from the card's variables: largest difference "
        f"{gap:.3e} ({where}); the free-running CPU relay from the card's start: {free}, "
        f"largest differences " + ", ".join(f"{k} {v:.3e}" for k, v in free_gap.items())
        + " (printed)")
    if not gap <= SPLIT_ATOL:
        fail(f"splitnn: a turn on the card and on the CPU differ by {gap:.3e} > {SPLIT_ATOL}")

    out = {}
    for device in ("cuda", "cpu"):
        args = main_vfl.add_args(argparse.ArgumentParser()).parse_args(["--device", device])
        inits = []
        with (recorded(vertical.VerticalFL, "init", inits) if device == "cuda"
              else _starting_from(torch, vertical.VerticalFL, vstart)):
            t0 = time.perf_counter()
            metrics = main_vfl.run(args)
            wall = time.perf_counter() - t0
        if device == "cuda":
            vstart = [{k: v.cpu() for k, v in party.items()} for party in inits[0]]
        out[device] = (metrics, wall)
    gap = max(abs(out["cuda"][0][k] - out["cpu"][0][k]) for k in out["cuda"][0])
    log(f"[vfl] main_vfl synthetic default, {args.party_num} parties, {args.epochs} epochs: card "
        f"{out['cuda'][1] / args.epochs:.4f} s an epoch, CPU {out['cpu'][1] / args.epochs:.4f}; "
        f"card {out['cuda'][0]}; card vs CPU largest difference {gap:.3e}")
    if not gap <= SPLIT_ATOL:
        fail(f"vfl: card and CPU differ by {gap:.3e} > {SPLIT_ATOL}")
    return _flash_launches()


FEDGKT = dict(clients=10, batch=64, rounds=1, small_atol=1e-4)


def _to_cpu(torch, tree):
    """A nested structure of tuples, lists and dicts with its tensors copied
    to the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_cpu(torch, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _to_cpu(torch, v) for k, v in tree.items()}
    return tree


def phase_fedgkt(torch):
    """FedGKT at the modules' default widths (the client's 1 block, the
    server's 9 blocks a stage: the reference's ResNet-8 / ResNet-56 server
    pair) on ``[cross_silo]``'s CIFAR-10 fixture (50,000 images), 10
    clients, hetero 0.5, B=64, 1 round of E=1 on each side, through
    ``run_fedgkt`` with ``main_fedgkt``'s batches: the feature stack stays on
    the card, and each phase's steps after its first are replays of its
    step's CUDA graph (counted: one fewer than the steps, a client and the
    server). Prints its bytes, s/round and Train/Acc (read off the round's
    feedback logits). Then ``main_fedgkt``'s default run (synthetic_cv, 2
    clients, 2 rounds) on the card and on the CPU from the same variables,
    within 1e-4; and on the card with its steps replayed against the same
    run stepped eagerly, under deterministic algorithms, held to rtol 1e-6 /
    atol 1e-7 (``[blocks]``' bound). Returns the flash launches."""
    from fedml_tpu_torch.algorithms import fedgkt
    from fedml_tpu_torch.core import rng as rnglib
    from fedml_tpu_torch.exp import main_fedgkt

    c = FEDGKT
    _zero_flash_counters()
    args = main_fedgkt.add_args(argparse.ArgumentParser()).parse_args(
        ["--dataset", "cifar10", "--data_dir", str(BUILD_DIR / "cifar10"), "--client_number",
         str(c["clients"]), "--batch_size", str(c["batch"]), "--comm_round", str(c["rounds"])])
    gkt, batches = main_fedgkt.build(args, torch.device("cuda"))
    gkt = fedgkt.FedGKT(type(gkt.client_module)(num_classes=10),
                        type(gkt.server_module)(num_classes=10), gkt.client_opt, gkt.server_opt,
                        gkt.temperature, gkt.alpha)
    feats = []

    def keep_bytes(original):
        def server_train(self, svars, f, *rest):
            feats.append((tuple(f.shape), f.numel() * f.element_size(), str(f.device)))
            return original(self, svars, f, *rest)
        return server_train

    replays = []

    def count_replays(original):
        def replay(self):
            replays.append(1)
            return original(self)
        return replay

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _wrapped(fedgkt.FedGKT, "server_train", keep_bytes), \
            _wrapped(torch.cuda.CUDAGraph, "replay", count_replays):
        cvars, svars, logits = fedgkt.run_fedgkt(gkt, batches, c["rounds"], 1, 1,
                                                 rnglib.generator(0, torch.device("cuda")))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = sum(int(b["y"].shape[0]) for b in batches)  # a client's each, then the server's
    # the server's feedback logits of the last round are its predictions on
    # the features the trained clients extracted: main_fedgkt's Train/Acc
    correct = sum(float(((lg.argmax(-1) == b["y"]).float() * b["mask"]).sum())
                  for lg, b in zip(logits, batches))
    images = sum(int(b["mask"].sum()) for b in batches)
    acc = correct / images
    log(f"[fedgkt] ResNetGKTClient (1 block) / ResNetGKTServer (9 blocks a stage), CIFAR-10 "
        f"fixture {images} images, {c['clients']} clients hetero 0.5, B={c['batch']}, "
        f"{c['rounds']} round of E=1 a side: {wall:.2f} s a round; {2 * steps} train steps, "
        f"{len(replays)} of them graph replays; feature stack {feats[0][0]} "
        f"= {feats[0][1]} bytes on {feats[0][2]}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; Train/Acc {acc:.4f}")
    if not np.isfinite(acc) or not feats[0][2].startswith("cuda"):
        fail(f"fedgkt: Train/Acc {acc}, features on {feats[0][2]}")
    if len(replays) != 2 * steps - len(batches) - 1:
        fail(f"fedgkt: {len(replays)} graph replays, expected {2 * steps - len(batches) - 1}")
    del gkt, batches, cvars, svars, logits
    torch.cuda.empty_cache()

    got, runs = {}, {}
    for device in ("cuda", "cpu"):
        small = main_fedgkt.add_args(argparse.ArgumentParser()).parse_args(["--device", device])
        inits, outs = [], []

        def keep(into):
            def make(original):
                def call(*args, **kwargs):
                    out = original(*args, **kwargs)
                    into.append(out)
                    return out
                return call
            return make

        with (_wrapped(fedgkt.FedGKT, "init", keep(inits)) if device == "cuda"
              else _starting_from(torch, fedgkt.FedGKT, start)), \
                _wrapped(fedgkt, "run_fedgkt", keep(outs)):
            got[device] = main_fedgkt.run(small)
        if device == "cuda":
            start = tuple({k: v.cpu() for k, v in half.items()} for half in inits[0])
        cv, sv, logits = outs[0]
        runs[device] = [t.cpu() for t in [*(v for c_ in cv for v in c_.values()), *sv.values(),
                                          *logits]]
    gap = max([abs(got["cuda"]["Train/Acc"] - got["cpu"]["Train/Acc"])]
              + [float((a - b).abs().max()) for a, b in zip(runs["cuda"], runs["cpu"])])
    log(f"[fedgkt] main_fedgkt default (synthetic_cv, 2 clients, 2 rounds), card vs CPU from "
        f"the same variables: {got['cuda']} against {got['cpu']}; largest difference {gap:.3e} "
        f"(Train/Acc, both client models, the server model, the server's logits)")
    if not gap <= c["small_atol"]:
        fail(f"fedgkt: card and CPU differ by {gap:.3e} > {c['small_atol']}")

    def eagerly(original):
        return lambda fn, like, opt: fn

    stepped = {}
    on_card = tuple({k: v.cuda() for k, v in half.items()} for half in start)
    torch.use_deterministic_algorithms(True)
    try:
        for name in ("replayed", "eager"):
            outs, replays = [], []
            with contextlib.ExitStack() as stack:
                stack.enter_context(_starting_from(torch, fedgkt.FedGKT, on_card))
                stack.enter_context(_wrapped(fedgkt, "run_fedgkt", keep(outs)))
                stack.enter_context(_wrapped(torch.cuda.CUDAGraph, "replay", count_replays))
                if name == "eager":
                    stack.enter_context(_wrapped(fedgkt, "_replayed", eagerly))
                main_fedgkt.run(main_fedgkt.add_args(argparse.ArgumentParser()).parse_args([]))
            cv, sv, logits = outs[0]
            stepped[name] = ([v for c_ in cv for v in c_.values()] + list(sv.values())
                             + list(logits), len(replays))
    finally:
        torch.use_deterministic_algorithms(False)
    worst = max(float(((a - b).abs() - BLOCK_RTOL * b.abs()).max())
                for a, b in zip(stepped["replayed"][0], stepped["eager"][0]))
    diff = max(float((a - b).abs().max())
               for a, b in zip(stepped["replayed"][0], stepped["eager"][0]))
    log(f"[fedgkt] main_fedgkt default on the card, deterministic algorithms: steps replayed "
        f"({stepped['replayed'][1]} replays) against stepped eagerly ({stepped['eager'][1]}): "
        f"largest difference {diff:.3e}, bitwise {diff == 0.0}")
    if stepped["replayed"][1] == 0 or stepped["eager"][1] != 0 or not worst <= BLOCK_ATOL:
        fail(f"fedgkt: replayed steps differ from eager ones by {diff:.3e} beyond rtol "
             f"{BLOCK_RTOL} / atol {BLOCK_ATOL}, or replays {stepped['replayed'][1]} / "
             f"{stepped['eager'][1]}")
    return _flash_launches()


# a round in float64, card against CPU: the same arithmetic to the last bits
# of float64, a check of the card's path that f32's spread cannot blur
F64_ROUND_ATOL = 1e-9
# federated segmentation (ROADMAP §A13): main_fedseg's defaults card against
# CPU, then UNet and DeepLabLite at their full width (features 32/64/128) on a
# seeded 3-channel 128 x 128 fixture with PASCAL VOC's 21 classes, 255 on a
# border band: 8 clients of 16 images, 4 a round, B=8, E=1, Adam 3e-3
FEDSEG = dict(classes=21, clients=8, per_client=16, per_round=4, batch=8, hw=128, band=4,
              lr=3e-3, rounds=2, eval_batch=16)


def _fedseg_fixture(c):
    """Each image four quadrants of a class each, a class's colour plus
    noise; labels 255 on a band of ``band`` pixels along the border."""
    from fedml_tpu_torch.sim.cohort import FederatedArrays

    rng = np.random.RandomState(0)
    n, hw = c["clients"] * c["per_client"], c["hw"]
    quadrants = rng.randint(0, c["classes"], (n, 2, 2))
    y = np.repeat(np.repeat(quadrants, hw // 2, axis=1), hw // 2, axis=2).astype(np.int32)
    palette = rng.rand(c["classes"], 3).astype(np.float32)
    x = palette[y] + 0.1 * rng.randn(n, hw, hw, 3).astype(np.float32)
    b = c["band"]
    y[:, :b], y[:, -b:], y[:, :, :b], y[:, :, -b:] = 255, 255, 255, 255
    per = c["per_client"]
    part = {i: np.arange(i * per, (i + 1) * per) for i in range(c["clients"])}
    return FederatedArrays({"x": x, "y": y}, part), {"x": x[:2 * per], "y": y[:2 * per]}


def _fedseg_args(model, device, *extra):
    """``main_fedseg``'s defaults for ``model``, 1 round with an eval, on
    ``device``."""
    from fedml_tpu_torch.exp import main_fedseg

    return main_fedseg.add_args(argparse.ArgumentParser()).parse_args(
        ["--model", model, "--comm_round", "1", "--frequency_of_the_test", "1", "--device",
         device, *extra])


def _fedseg_logits(torch, sim, variables, x):
    """``sim``'s model on ``variables`` over the images ``x`` (numpy), on
    its device, as f64 CPU tensors."""
    module = sim.trainer.module
    module.load_state_dict({k: v.to(sim.device) for k, v in variables.items()})
    module.eval()
    with torch.no_grad():
        return module(torch.as_tensor(x, device=sim.device)).double().cpu()


def _fedseg_card_vs_cpu(torch, model):
    """``main_fedseg --model <model>``'s defaults, 1 round, on the card
    through ``run``; then from that run's initial variables, on the card and
    on the CPU (``build``): the f32 logits, each client's confusion matrix
    (bitwise but at pixels whose top two logits lie within 1e-4, counted)
    and one batch's gradients within 1e-4; and the round itself in float64
    on both, within 1e-9 (variables, logits, ``evaluate_clients``'s
    records), its confusion matrices equal. After a round of Adam the f32
    runs part by f32's own spread (:func:`fedseg_numerics`): the card's f32
    round is printed against the float64 one."""
    from fedml_tpu_torch.algorithms import fedseg
    from fedml_tpu_torch.core.trainer import segmentation_loss
    from fedml_tpu_torch.exp import main_fedseg
    from fedml_tpu_torch.models.registry import to_float64
    from fedml_tpu_torch.sim.engine import FedSim

    inits, evals = [], []

    def capture(original):
        def init_variables(self):
            v = original(self)
            inits.append({k: t.detach().cpu().clone() for k, t in v.items()})
            return v
        return init_variables

    def record(original):
        def evaluate_clients(self, variables, *a, **kw):
            out = original(self, variables, *a, **kw)
            evals.append((self, {k: t.detach().cpu().clone() for k, t in variables.items()}))
            return out
        return evaluate_clients

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _wrapped(FedSim, "init_variables", capture), \
            _wrapped(fedseg.FedSegSim, "evaluate_clients", record):
        card_out = main_fedseg.run(_fedseg_args(model, "cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    init = inits[0]
    card, card_final = evals[0]
    cpu = main_fedseg.build(_fedseg_args(model, "cpu"))
    x, y, part = cpu.train_data.arrays["x"], cpu.train_data.arrays["y"], cpu.train_data.partition

    # f32, from the same variables: logits, confusion matrices, gradients
    start = {"card": _fedseg_logits(torch, card, init, x),
             "cpu": _fedseg_logits(torch, cpu, init, x)}
    f32_after = _fedseg_logits(torch, card, card_final, x)
    start_err = float((start["card"] - start["cpu"]).abs().max())
    top2 = start["cpu"].topk(2, dim=-1).values
    valid = torch.as_tensor((y >= 0) & (y < start["cpu"].shape[-1]))
    near = ((top2[..., 0] - top2[..., 1]) < E2E_ATOL) & valid
    flipped = (start["card"].argmax(-1) != start["cpu"].argmax(-1)) & valid
    confs = {d: np.asarray(s.evaluate_per_client(
        {k: v.to(s.device) for k, v in init.items()})["confusion"])
        for d, s in (("card", card), ("cpu", cpu))}
    moved = [float(np.abs(confs["card"][c] - confs["cpu"][c]).sum()) for c in sorted(part)]
    allowed = [2 * int(near[part[c]].sum()) for c in sorted(part)]
    grads = {}
    for d, s in (("card", card), ("cpu", cpu)):
        module = s.trainer.module
        module.load_state_dict({k: v.to(s.device) for k, v in init.items()})
        module.train()
        module.zero_grad()
        batch = {"y": torch.as_tensor(y[:4], device=s.device),
                 "mask": torch.ones(4, device=s.device)}
        segmentation_loss(module(torch.as_tensor(x[:4], device=s.device)), batch).backward()
        grads[d] = {k: p.grad.detach().cpu() for k, p in module.named_parameters()}
    grad_err = max(float((grads["card"][k] - grads["cpu"][k]).abs().max()) for k in grads["cpu"])

    # the round in float64 on both (the CPU's sim, and the card's built anew:
    # the card's run may hold its round's CUDA graph)
    f64 = {}
    for name, sim in (("card", main_fedseg.build(_fedseg_args(model, "cuda"))), ("cpu", cpu)):
        to_float64(sim.trainer.module)
        final, history = sim.run(variables={k: v.to(sim.device, torch.float64)
                                            for k, v in init.items()})
        f64[name] = (sim, final, history, sim.evaluate_clients(final),
                     np.asarray(sim.evaluate_per_client(final)["confusion"]))
    (c_sim, c_final, c_hist, (c_clients, c_global), c_conf), \
        (p_sim, p_final, p_hist, (p_clients, p_global), p_conf) = f64["card"], f64["cpu"]
    after64 = {"card": _fedseg_logits(torch, c_sim, c_final, x),
               "cpu": _fedseg_logits(torch, p_sim, p_final, x)}
    f64_err = max([float((after64["card"] - after64["cpu"]).abs().max())]
                  + [float((c_final[k].cpu() - p_final[k]).abs().max()) for k in p_final]
                  + [abs(getattr(c_clients[c], f) - getattr(p_clients[c], f))
                     for c in p_clients for f in ("accuracy", "accuracy_class", "mIoU", "FWIoU",
                                                  "loss")]
                  + [abs(c_global[k] - p_global[k]) for k in p_global]
                  + [abs(c_hist[-1][k] - p_hist[-1][k]) for k in p_hist[-1]
                     if k not in ("round", "round_time")])
    f32_spread = float((f32_after - after64["card"]).abs().max())
    log(f"[fedseg] main_fedseg --model {model} defaults ({len(part)} clients of "
        f"{len(part[0])} images of {x.shape[1]}x{x.shape[2]}x{x.shape[3]}, "
        f"{start['cpu'].shape[-1]} classes, B=4, Adam 3e-3), 1 round on the card in "
        f"{wall:.2f} s of run: {card_out}. From the same variables, card vs CPU in f32: logits "
        f"{start_err:.3e} (up to {float(start['cpu'].abs().max()):.3f}); pixels whose top two "
        f"logits lie within {E2E_ATOL}: {int(near.sum())} of {int(valid.sum())}, argmax "
        f"flipped at {int(flipped.sum())}; per-client confusion counts moved {moved} "
        f"(allowed {allowed}); one batch's gradients {grad_err:.3e}. The round in float64, "
        f"card vs CPU: {f64_err:.3e} (variables, logits, records), confusion matrices equal "
        f"{bool(np.array_equal(c_conf, p_conf))}; the card's f32 round {f32_spread:.3e} from "
        f"it (logits, printed)")
    if not max(start_err, grad_err) <= E2E_ATOL:
        fail(f"fedseg {model}: card and CPU differ in f32 by {start_err:.3e} (logits) / "
             f"{grad_err:.3e} (gradients) > {E2E_ATOL}")
    if bool((flipped & ~near).any()) or any(m > a for m, a in zip(moved, allowed)):
        fail(f"fedseg {model}: the card's confusion matrices differ from the CPU's beyond "
             f"the near-tie pixels: moved {moved}, allowed {allowed}")
    if not f64_err <= F64_ROUND_ATOL or not np.array_equal(c_conf, p_conf):
        fail(f"fedseg {model}: the float64 round on the card and on the CPU differ by "
             f"{f64_err:.3e} > {F64_ROUND_ATOL}, or in their confusion matrices")


def _fedseg_sim(torch, model, device, mode="vmap", f64=False):
    """``main_fedseg.build`` of its defaults for ``model``, 1 round, on
    ``device``, in the cohort mode ``mode``, in float64 with ``f64``."""
    from fedml_tpu_torch.algorithms.fedseg import FedSegSim
    from fedml_tpu_torch.exp import main_fedseg
    from fedml_tpu_torch.models.registry import to_float64

    args = _fedseg_args(model, device)
    sim = main_fedseg.build(args)
    if mode != sim.config.cohort_execution:
        sim = FedSegSim(sim.trainer, sim.train_data, main_fedseg._synthetic_seg(args)[1],
                        dataclasses.replace(sim.config, cohort_execution=mode), device=device)
    if f64:
        to_float64(sim.trainer.module)
    return sim


def fedseg_numerics(torch, model="deeplab", devices=("cuda", "cpu")):
    """Where f32 precision goes in ``main_fedseg``'s round, from the
    variables its defaults draw on the CPU: one batch's gradients (4 images)
    of every parameter in f32 on each of ``devices`` against float64 on the
    first, beside the parameter's largest gradient; then the round (4
    clients x 4 Adam steps) in float64 on both devices and in f32 on each in
    the vmap and the scan cohort modes (on the card also vmap under cuDNN's
    deterministic algorithms): how far the logits on the training images
    after the round, and the variables, lie from the first device's float64
    round. ``devices=("cpu", "cpu")`` checks it on a machine without a card.
    Returns {"grad": ..., "round": ...}."""
    from fedml_tpu_torch.core.trainer import segmentation_loss

    cpu = _fedseg_sim(torch, model, "cpu")
    init = {k: v.clone() for k, v in cpu.init_variables().items()}
    x, y = cpu.train_data.arrays["x"], cpu.train_data.arrays["y"]
    grads = {}
    for name, device, f64 in [("float64", devices[0], True)] + [(d, d, False) for d in devices]:
        module = _fedseg_sim(torch, model, device, f64=f64).trainer.module
        dtype = torch.float64 if f64 else torch.float32
        module.load_state_dict({k: v.to(device, dtype) for k, v in init.items()})
        module.train()
        batch = {"y": torch.as_tensor(y[:4], device=device),
                 "mask": torch.ones(4, device=device)}
        segmentation_loss(module(torch.as_tensor(x[:4], device=device)), batch).backward()
        grads.setdefault(name, {}).update(
            {k: p.grad.detach().double().cpu() for k, p in module.named_parameters()})
    out = {"grad": {}, "round": {}}
    for k, ref in grads["float64"].items():
        rec = out["grad"][k] = {"scale": float(ref.abs().max())}
        rec.update({d: float((grads[d][k] - ref).abs().max()) for d in devices})
        log(f"[fedseg numerics] {model} one batch's gradient {k}: largest {rec['scale']:.3e}, "
            f"f32 error " + ", ".join(f"{d} {rec[d]:.3e}" for d in devices))
    runs = [("float64 " + d, d, True, "vmap", False) for d in devices]
    runs += [(f"f32 {d} {mode}", d, False, mode, False) for d in devices
             for mode in ("vmap", "scan")]
    if devices[0] == "cuda":
        runs.append(("f32 cuda vmap deterministic", "cuda", False, "vmap", True))
    ref = None
    for name, device, f64, mode, deterministic in runs:
        sim = _fedseg_sim(torch, model, device, mode, f64)
        dtype = torch.float64 if f64 else torch.float32
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=deterministic, allow_tf32=False):
            final, _ = sim.run(variables={k: v.to(device, dtype) for k, v in init.items()})
        logits = _fedseg_logits(torch, sim, final, x)
        final = {k: v.double().cpu() for k, v in final.items()}
        ref = ref or (logits, final)
        rec = out["round"][name] = {
            "logits": float((logits - ref[0]).abs().max()),
            "variables": max(float((final[k] - ref[1][k]).abs().max()) for k in final)}
        log(f"[fedseg numerics] {model} round, {name}: from the {runs[0][0]} round, logits "
            f"{rec['logits']:.3e}, variables {rec['variables']:.3e}")
    return out


def _fedseg_full_width(torch, smi):
    """``create_model`` UNet and DeepLabLite at full width on
    :func:`_fedseg_fixture`: 2 rounds as one block (replays of the round's
    CUDA graph) against the rounds dispatched one at a time, deterministic
    cuDNN, bitwise; s/round, images/s, peak memory and
    ``evaluate_clients``'s global metrics."""
    from fedml_tpu_torch.algorithms.fedseg import FedSegSim
    from fedml_tpu_torch.core.trainer import ClientTrainer, adam
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.sim.engine import SimConfig

    c = FEDSEG
    train, test = _fedseg_fixture(c)
    images = c["per_round"] * c["per_client"]
    torch.backends.cudnn.deterministic = True
    try:
        for name in ("unet", "deeplab"):
            runs, init = {}, None
            for mode in ("blocks", "per round"):
                model = create_model(name, c["classes"], device="cuda",
                                     input_shape=train.arrays["x"].shape[1:])
                trainer = ClientTrainer(module=model, task="segmentation",
                                        optimizer=adam(c["lr"]), epochs=1)
                cfg = SimConfig(client_num_in_total=c["clients"],
                                client_num_per_round=c["per_round"], batch_size=c["batch"],
                                comm_round=c["rounds"], epochs=1,
                                frequency_of_the_test=c["rounds"], seed=0,
                                eval_batch_size=c["eval_batch"],
                                block_dispatch=mode == "blocks")
                sim = FedSegSim(trainer, train, test, cfg, device="cuda")
                if init is None:
                    init = {k: v.clone() for k, v in sim.init_variables().items()}
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()  # the graph's pool counts in its peak
                capture_s = (sim.capture_round_graph(variables=init) if mode == "blocks"
                             else 0.0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                final, history = sim.run(variables={k: v.clone() for k, v in init.items()})
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
                per_client, global_m = sim.evaluate_clients(final)
                runs[mode] = (final, history)
                times = [rec["round_time"] for rec in history]
                log(f"[fedseg] {name} ({sum(v.numel() for v in init.values()) / 1e6:.2f}M "
                    f"parameters, f32), {mode}: s/round "
                    + ", ".join(f"{t:.4f}" for t in times)
                    + f" ({images / times[-1]:.1f} images/s in the last round; run "
                    f"{wall:.2f} s, capture {capture_s:.2f} s); Train/Loss "
                    + ", ".join(f"{rec['Train/Loss']:.6f}" for rec in history)
                    + f"; peak device memory {peak / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f} "
                    f"above the {held / 2**30:.2f} held before it ({smi}); "
                    f"evaluate_clients over {len(per_client)} clients: "
                    + ", ".join(f"{k} {v:.6f}" for k, v in global_m.items()))
                values = [v for rec in history for k, v in rec.items() if k != "round"]
                if (len(history) != c["rounds"] or not all(np.isfinite(values))
                        or not all(np.isfinite(list(global_m.values())))):
                    fail(f"fedseg {name} {mode}: bad history {history} or metrics {global_m}")
                del sim, model, trainer
                torch.cuda.empty_cache()
            _, (diff, where) = _block_gap(torch, [runs["blocks"], runs["per round"]])
            log(f"[fedseg] {name}: deterministic cuDNN, one block of {c['rounds']} graph "
                f"replays vs per-round dispatch: largest difference {diff:.3e} ({where}), "
                f"bitwise equal {diff == 0.0}")
            if diff != 0.0:
                fail(f"fedseg {name}: the block and per-round runs differ by {diff:.3e} at "
                     f"{where}")
    finally:
        torch.backends.cudnn.deterministic = False


def phase_fedseg(torch, smi):
    """Federated segmentation: :func:`_fedseg_card_vs_cpu` for UNet and
    DeepLabLite, then :func:`_fedseg_full_width`. Returns the flash
    launches (none)."""
    _zero_flash_counters()
    for model in ("unet", "deeplab"):
        _fedseg_card_vs_cpu(torch, model)
    torch.cuda.empty_cache()
    _fedseg_full_width(torch, smi)
    return _flash_launches()


DOL_RTOL = 1e-5


def phase_dol(torch):
    """``main_dol`` at the entry's defaults (SUSY's 18 features, N=15,
    T=200), DSGD and Push-Sum on the time-varying graph, on the card and on
    the CPU over the same stream: the regret figures within 1e-5 relative,
    and the late half of the stream cheaper than the early half. Returns
    the flash launches (none)."""
    from fedml_tpu_torch.exp import main_dol

    _zero_flash_counters()
    for extra in ([], ["--mode", "pushsum", "--time_varying", "1"]):
        out = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            out[device] = main_dol.main(extra + ["--device", device])
            out[device]["seconds"] = time.perf_counter() - t0
        card, cpu = out["cuda"], out["cpu"]
        keys = ("final_regret", "avg_regret", "early_avg_loss", "late_avg_loss")
        rel = max(abs(card[k] - cpu[k]) / abs(cpu[k]) for k in keys)
        log(f"[dol] main_dol {card['mode']}{' time-varying' if extra else ''}, N=15, T=200: "
            f"card {card['seconds']:.2f} s, final_regret {card['final_regret']:.6f}, "
            f"early_avg_loss {card['early_avg_loss']:.6f}, late_avg_loss "
            f"{card['late_avg_loss']:.6f}; CPU {cpu['seconds']:.2f} s, final_regret "
            f"{cpu['final_regret']:.6f}; largest relative difference {rel:.3e}")
        if not rel <= DOL_RTOL:
            fail(f"dol {card['mode']}: card and CPU differ by {rel:.3e} relative > {DOL_RTOL}")
        if not card["late_avg_loss"] < card["early_avg_loss"]:
            fail(f"dol {card['mode']}: the late half costs {card['late_avg_loss']} >= the "
                 f"early half's {card['early_avg_loss']}")
    return _flash_launches()


# the vision datasets' synthetic fallbacks (the card's machine has no Pillow)
# through the CLI, each with a zoo model: 4 clients, all a round, B=10, SGD at
# lr and weight decay (dataset -> (model, lr, wd)). At the CLI's default lr
# of 0.03 MobileNet V3's round 1 is NaN on the gld23k fallback, in the JAX
# package's main_fedavg as in the port's (tests/test_torch_vision_fed.py)
VISION_FED = {"imagenet": ("resnet18_gn", 0.01, 0.0), "gld23k": ("mobilenet_v3", 1e-3, 1e-3)}


# [vision_fed]'s f32 layers alone: the card's error within this multiple of
# the CPU's for the same layer, or within LAYER_RTOL of the float64 result
LAYER_RTOL, LAYER_CPU_MULTIPLE = 1e-5, 10.0


def _vision_f32_hold(torch, dataset, init):
    """From ``init``, card against CPU in f32 (:func:`_vision_sim`), at the
    zoo's card tolerance: the training forward of client 0's first batch
    of 10 (logits, and a BN model's new statistics) and the eval forward
    of the test images, each within 1e-4 x max(1, the CPU tensor's largest
    entry) or, where the CPU's f32 is further off float64, twice the CPU's
    distance; every layer alone (:func:`_leaf_errors`, from its float64
    input and output gradient of that batch), plain and vmapped over 4
    clients: its f32 output, input gradient and parameter gradients within
    LAYER_RTOL of float64 or LAYER_CPU_MULTIPLE x the CPU's error. The
    batch's whole gradient is compared, not held: ReLU inputs within
    rounding of 0 (counted, by layer outputs of another sign on the card
    than on the CPU) and BatchNorm over near-constant channels move it, on
    the CPU as on the card (its distance from float64 is printed for
    both). Returns (failures, a summary line)."""
    import torch.nn.functional as F

    out, signs = {}, {}
    for name, device, f64 in (("card", "cuda", False), ("cpu", "cpu", False),
                              ("float64", "cpu", True)):
        sim, test = _vision_sim(torch, dataset, device, f64=f64)
        m = sim.trainer.module
        m.load_state_dict({k: v.to(device) for k, v in init.items()})
        arrays, idx = sim.train_data.arrays, sim.train_data.partition[0][:10]
        m.train()
        m.zero_grad()
        rec = signs[name] = {}
        with _recorded(torch, m, rec):
            tr = m(torch.as_tensor(arrays["x"][idx], device=device), train=True)
            tr, stats = tr if isinstance(tr, tuple) else (tr, {})
            F.cross_entropy(tr, torch.as_tensor(arrays["y"][idx], device=device).long()).backward()
        m.eval()
        with torch.no_grad():
            ev = m(torch.as_tensor(test["x"], device=device))
        out[name] = ({"train logits": tr, "eval logits": ev,
                      **{f"statistic {k}": v for k, v in stats.items()}},
                     {k: p.grad for k, p in m.named_parameters()})
        if f64:
            f64_module = m

    def gap(a, b):
        return float((a.detach().double().cpu() - b.detach().double().cpu()).abs().max())

    failures, parts, stats = [], [], []
    for k, ref in out["cpu"][0].items():
        err, scale = gap(out["card"][0][k], ref), float(ref.detach().abs().max())
        bound = max(E2E_ATOL * max(1.0, scale), 2 * gap(ref, out["float64"][0][k]))
        if not err <= bound:
            failures.append(f"{k} {err:.3e} > {bound:.3e}")
        if k.startswith("statistic"):
            stats.append((err, k, bound))
        else:
            parts.append(f"{k} {err:.3e} (bound {bound:.3e}, largest {scale:.3e})")
    if stats:
        parts.append("new BN statistics {:.3e} at {} (bound {:.3e})".format(*max(stats)))
    grads = {name: g for name, (_, g) in out.items()}

    def grad_gap(a, b):
        return _tree_rel(grads[a], grads[b])

    flips = sum(int(((signs["card"][n][2].cpu() > 0) != (signs["cpu"][n][2] > 0)).sum())
                for n in signs["cpu"])
    f64_module.zero_grad()
    off = dict(enabled=True, benchmark=False, deterministic=False, allow_tf32=False)
    layers = _leaf_errors(torch, f64_module, arrays["x"][idx], arrays["y"][idx],
                          {"cpu": ("cpu", off, False), "card": ("cuda", off, False),
                           "card vmap": ("cuda", off, True)})
    worst = (0.0, None)
    for variant in ("card", "card vmap"):
        for layer, errs in layers[variant].items():
            for kind, e, c in zip(("output", "input gradient", "parameter gradient"), errs,
                                  layers["cpu"][layer]):
                bound = max(LAYER_RTOL, LAYER_CPU_MULTIPLE * c)
                worst = max(worst, (e / bound, f"{variant} {layer} {kind} {e:.3e} (CPU {c:.3e})"),
                            key=lambda w: w[0])
                if not e <= bound:
                    failures.append(f"{variant} {layer} {kind} {e:.3e} > {bound:.3e}")
    parts.append(f"{len(layers['card'])} layers alone, the closest to its bound {worst[1]}")
    parts.append(f"the batch's whole gradient card vs CPU {grad_gap('card', 'cpu'):.3e} "
                 f"relative, from float64 card {grad_gap('card', 'float64'):.3e} and CPU "
                 f"{grad_gap('cpu', 'float64'):.3e} (compared, not held; {flips} layer outputs "
                 f"of another sign on the card than on the CPU)")
    return failures, "; ".join(parts)


def phase_vision_fed(torch):
    """``main_fedavg --dataset imagenet --model resnet18_gn`` and ``--dataset
    gld23k --model mobilenet_v3`` on the registry's synthetic fallbacks, 2
    rounds on the card with an eval each; from the card run's initial
    variables, card against CPU in f32 (:func:`_vision_f32_hold`: the
    forwards and one batch's gradients within 1e-4 x max(1, the tensor's
    largest entry)) and round 1 in float64 on both, within 1e-9 (the
    variables, Train/Loss, Train/Acc, Test/Acc, Test/Loss). The card's f32
    round 1 is printed against the float64 one: f32's second SGD step
    already parts from float64 on the CPU as on the card, at ReLU inputs
    within rounding of 0 (:func:`vision_fed_numerics`). Returns the flash
    launches (none)."""
    from fedml_tpu_torch.sim.engine import FedSim

    _zero_flash_counters()
    keys = ("Train/Loss", "Train/Acc", "Test/Acc", "Test/Loss")
    for dataset, (model, lr, wd) in VISION_FED.items():
        init = {}

        def capture(original):
            def init_variables(self):
                v = original(self)
                init.setdefault("v", {k: t.detach().cpu().clone() for k, t in v.items()})
                return v
            return init_variables

        with _wrapped(FedSim, "init_variables", capture):
            card, card_s = _cli(torch, _vision_argv(dataset) + ["--comm_round", "2"])
        start = init["v"]
        t0 = time.perf_counter()
        failures, hold = _vision_f32_hold(torch, dataset, start)
        hold_s = time.perf_counter() - t0
        f64 = {}
        for name, device in (("card", "cuda"), ("cpu", "cpu")):
            sim, _ = _vision_sim(torch, dataset, device, f64=True)
            t0 = time.perf_counter()
            final, history = sim.run(variables={
                k: v.to(device, torch.float64 if v.is_floating_point() else v.dtype)
                for k, v in start.items()})
            f64[name] = ({k: v.double().cpu() for k, v in final.items()}, history[-1],
                           time.perf_counter() - t0)
        gap64 = max(abs(f64["card"][1][k] - f64["cpu"][1][k]) for k in keys)
        var64 = max(float((f64["card"][0][k] - v).abs().max()) for k, v in f64["cpu"][0].items())
        f32_gap = max(abs(card[0][k] - f64["cpu"][1][k]) for k in keys)
        log(f"[vision_fed] main_fedavg --dataset {dataset} --model {model} (the synthetic "
            f"fallback), 4 clients, all a round, B=10, SGD {lr} wd {wd}: card 2 rounds in "
            f"{card_s:.2f} s, s/round " + ", ".join(f"{rec['round_time']:.4f}" for rec in card)
            + f"; {card}; from the same variables card vs CPU in f32 ({hold_s:.2f} s): "
            f"{hold}; round 1 in float64 card vs CPU {gap64:.3e} (metrics; variables "
            f"{var64:.3e}, the head's input rounded to f32 as in the JAX package; card "
            f"{f64['card'][2]:.2f} s, CPU {f64['cpu'][2]:.2f} s); the card's f32 round 1 "
            f"metrics {f32_gap:.3e} from it (printed)")
        values = [v for rec in card for k, v in rec.items() if k != "round"]
        if len(card) != 2 or not all(np.isfinite(values)):
            fail(f"vision_fed {dataset}: bad history {card}")
        if failures:
            fail(f"vision_fed {dataset}: card and CPU differ in f32 beyond their bounds: "
                 + ", ".join(failures))
        if not gap64 <= F64_ROUND_ATOL:
            fail(f"vision_fed {dataset}: round 1 in float64 on the card and on the CPU differ "
                 f"by {gap64:.3e} > {F64_ROUND_ATOL}")
        torch.cuda.empty_cache()
    return _flash_launches()


def _vision_argv(dataset):
    """``main_fedavg``'s flags for ``[vision_fed]``'s run of ``dataset``."""
    model, lr, wd = VISION_FED[dataset]
    return ["--dataset", dataset, "--model", model, "--data_dir",
            str(BUILD_DIR / f"{dataset}_absent"), "--client_num_in_total", "4",
            "--client_num_per_round", "4", "--batch_size", "10", "--lr", str(lr), "--wd",
            str(wd), "--frequency_of_the_test", "1"]


def _vision_sim(torch, dataset, device, mode="vmap", f64=False):
    """``main_fedavg.build`` of ``[vision_fed]``'s run of ``dataset`` for 1
    round on ``device``, in the cohort mode ``mode``, in float64 with
    ``f64``: ``(sim, test arrays)``."""
    from fedml_tpu_torch.data.registry import load_partition_data
    from fedml_tpu_torch.exp import main_fedavg as cli
    from fedml_tpu_torch.models.registry import to_float64
    from fedml_tpu_torch.sim.engine import FedSim

    args = cli.parse_with_config(cli.add_args(argparse.ArgumentParser()),
                                 _vision_argv(dataset) + ["--comm_round", "1", "--device", device])
    sim, cfg = cli.build(args)
    if f64:
        to_float64(sim.trainer.module)
    test = load_partition_data(args.dataset, args.data_dir, args.partition_method,
                               args.partition_alpha, args.client_num_in_total,
                               args.seed).test_arrays
    if mode != cfg.cohort_execution:
        sim = FedSim(sim.trainer, sim.train_data, test,
                     dataclasses.replace(cfg, cohort_execution=mode),
                     aggregator=sim.aggregator, device=device)
    return sim, test


def _leaves(module):
    """The Conv, GroupNorm, BatchNorm and Dense layers of ``module`` by name."""
    from fedml_tpu_torch.models.resnet import BatchNorm, Conv, GroupNorm
    from fedml_tpu_torch.models.transformer import Dense

    return {n: m for n, m in module.named_modules()
            if isinstance(m, (Conv, GroupNorm, BatchNorm, Dense))}


@contextlib.contextmanager
def _recorded(torch, module, record):
    """Within the block each layer of :func:`_leaves` keeps, in
    ``record[name]``, ``[args, kwargs, output, output's gradient]`` of its
    last call (the gradient once the backward reaches it, else None)."""
    def hook(name):
        def keep(mod, args, kwargs, out):
            out = out[0] if isinstance(out, tuple) else out
            entry = record[name] = [tuple(a.detach() if torch.is_tensor(a) else a for a in args),
                                    kwargs, out.detach(), None]
            if out.requires_grad:
                out.register_hook(lambda g: entry.__setitem__(3, g.detach()))
        return keep

    handles = [m.register_forward_hook(hook(n), with_kwargs=True)
               for n, m in _leaves(module).items()]
    try:
        yield record
    finally:
        for h in handles:
            h.remove()


def _rel(a, b):
    """The largest of ``|a - b|`` over the largest ``|b|`` (0 for empty)."""
    if b.numel() == 0:
        return 0.0
    return float((a.double().cpu() - b.double().cpu()).abs().max()
                 / b.double().abs().max().clamp_min(1e-300))


def _tree_rel(a, b):
    """The largest ``|a[k] - b[k]|`` over the largest ``|b[k]|``, over all
    keys of ``b``."""
    return (max(float((a[k].double().cpu() - b[k].double().cpu()).abs().max()) for k in b)
            / max(max(float(v.double().abs().max()) for v in b.values()), 1e-300))


def _leaf_errors(torch, module, x, y, variants):
    """Each layer of :func:`_leaves` of ``module`` (float64, on the CPU)
    alone, from its own float64 input and output gradient in the forward
    and backward of one batch ``x, y``: its f32 output, input gradient and
    parameter gradients under each of ``variants`` (name -> (device, cuDNN
    flags, vmapped over 4 clients, as grouped convolutions)), each as its
    largest error over the float64 one's largest entry (the parameters'
    over all of the layer's). Returns {variant: {layer: (out, dx, dparams)}}."""
    import copy

    seen = {}
    module.train()
    with _recorded(torch, module, seen):
        logits = module(torch.as_tensor(x, dtype=torch.float64), train=True)
        logits = logits[0] if isinstance(logits, tuple) else logits
        torch.nn.functional.cross_entropy(logits, torch.as_tensor(y, dtype=torch.long)).backward()
    leaves = _leaves(module)

    def local(mod, args, kwargs, g, device, vmapped):
        """mod on device in f32, or in float64 on the CPU for ``"f64"`` (4
        clients at once under vmap if asked): (output, input gradient,
        parameter gradients) as float64 CPU tensors."""
        dev = "cpu" if device == "f64" else device
        dt = torch.float64 if device == "f64" else torch.float32
        m = copy.deepcopy(mod).to(dev, dt)
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dt
        x0 = args[0].detach().to(dev, dt, copy=True).requires_grad_()
        rest = args[1:]
        params = dict(m.named_parameters())
        if vmapped:
            stacked = {k: v.detach()[None].repeat(4, *[1] * v.dim()).requires_grad_()
                       for k, v in params.items()}

            def one(p, xi):
                out = torch.func.functional_call(m, p, (xi,) + rest, kwargs)
                return out[0] if isinstance(out, tuple) else out
            out = torch.func.vmap(one)(stacked, x0[None].repeat(4, *[1] * x0.dim()))
            (out * g.to(dev, dt)).sum().backward()
            grads = {k: v.grad[0] for k, v in stacked.items()}
            out, dx = out[0], x0.grad / 4
        else:
            out = m(x0, *rest, **kwargs)
            out = out[0] if isinstance(out, tuple) else out
            (out * g.to(dev, dt)).sum().backward()
            grads, dx = {k: v.grad for k, v in params.items()}, x0.grad
        return (out.detach().double().cpu(), dx.double().cpu(),
                {k: v.double().cpu() for k, v in grads.items()})

    out = {name: {} for name in variants}
    for layer, (args, kwargs, _, g) in seen.items():
        if g is None:
            continue
        ref = local(leaves[layer], args, kwargs, g, "f64", False)
        scale = max([float(v.abs().max()) for v in ref[2].values()] + [1e-300])
        for name, (device, flags, vmapped) in variants.items():
            with torch.backends.cudnn.flags(**flags):
                got = local(leaves[layer], args, kwargs, g, device, vmapped)
            out[name][layer] = (_rel(got[0], ref[0]), _rel(got[1], ref[1]),
                                max([float((got[2][k] - ref[2][k]).abs().max())
                                     for k in ref[2]] + [0.0]) / scale)
    return out


def _second_step(torch, dataset, init, client, devices):
    """Client ``client``'s first two SGD steps of ``[vision_fed]``'s run of
    ``dataset`` (plain module calls on batches of up to 10, half the
    client's images at most; the CLI's lr and weight decay), from
    ``init``, in float64 on the CPU and in f32 on each of ``devices``.
    Returns, for each device, the second step's f32 gradient error over
    the float64 gradient's largest entry (:func:`_tree_rel`): from the
    weights f32's own first step left (``own``), from the float64 step's
    weights rounded to f32 (``rounded``), and of the float64 gradient at
    f32's weights (``float64``); the first layer, in the backward's order, whose output's
    gradient is off float64 by more than 1e-3 of its largest entry; and the
    count of layer outputs whose sign is not float64's (ReLU inputs within
    rounding of 0: the gradient behind them changes with their side)."""
    import torch.nn.functional as F

    from fedml_tpu_torch.models.registry import to_float64

    _, lr, wd = VISION_FED[dataset]
    sim, _ = _vision_sim(torch, dataset, "cpu", f64=True)
    arrays, idx = sim.train_data.arrays, sim.train_data.partition[client]
    x, y = arrays["x"][idx], torch.as_tensor(arrays["y"][idx]).long()

    def module(device, f64):
        m = _vision_sim(torch, dataset, device)[0].trainer.module
        return to_float64(m) if f64 else m

    def grads(m, batch, record=None):
        p0 = next(m.parameters())
        m.train()
        m.zero_grad()
        with _recorded(torch, m, {} if record is None else record):
            logits = m(torch.as_tensor(x[batch], device=p0.device, dtype=p0.dtype), train=True)
            logits = logits[0] if isinstance(logits, tuple) else logits
            F.cross_entropy(logits, y[batch].to(p0.device)).backward()
        return {k: p.grad.detach().double().cpu() for k, p in m.named_parameters()}

    def step(m, g):
        with torch.no_grad():
            for k, p in m.named_parameters():
                p -= lr * (g[k].to(p.device, p.dtype) + wd * p)

    b = max(1, min(10, len(idx) // 2))
    first, second = slice(0, b), slice(b, 2 * b)
    ref = module("cpu", True)
    ref.load_state_dict(init)
    step(ref, grads(ref, first))
    ref_rec = {}
    ref_g = grads(ref, second, ref_rec)
    out = {}
    for device in devices:
        m = module(device, False)
        m.load_state_dict(init)
        step(m, grads(m, first))
        rec = {}
        own = grads(m, second, rec)
        rounded = module(device, False)
        rounded.load_state_dict(ref.state_dict())
        at_f32 = module("cpu", True)
        at_f32.load_state_dict(m.state_dict())
        entry = next((n for n in reversed(list(ref_rec)) if ref_rec[n][3] is not None
                      and rec[n][3] is not None and _rel(rec[n][3], ref_rec[n][3]) > 1e-3), None)
        flips = {n: int(((rec[n][2].cpu() > 0) != (ref_rec[n][2] > 0)).sum()) for n in ref_rec}
        out[device] = {"own": _tree_rel(own, ref_g),
                       "rounded": _tree_rel(grads(rounded, second), ref_g),
                       "float64": _tree_rel(grads(at_f32, second), ref_g), "enters at": entry,
                       "sign flips": sum(flips.values()),
                       "first flip": next((n for n in ref_rec if flips[n]), None)}
    return out


def vision_fed_numerics(torch, devices=("cuda", "cpu")):
    """Where ``[vision_fed]``'s f32 precision goes, card against CPU, for
    each of its runs: every layer alone from its own float64 input
    (:func:`_leaf_errors`) on the CPU and on the card under cuDNN's default,
    deterministic and disabled algorithms, plain and vmapped over 4 clients
    (grouped convolutions); then the CLI's round 1 from the CPU's initial
    variables in f32 on each, in the vmap and the scan cohort modes, against
    the same round in float64 on the CPU (the variables and the four
    metrics). ``devices=("cpu", "cpu")`` checks it on a machine without a
    card. Returns {dataset: {"leaves": ..., "rounds": ...}}."""
    card, cpu = devices
    off = dict(enabled=True, benchmark=False, deterministic=False, allow_tf32=False)
    variants = {"cpu": (cpu, off, False), "cpu vmap": (cpu, off, True),
                "card": (card, off, False), "card vmap": (card, off, True),
                "card deterministic vmap": (card, {**off, "deterministic": True}, True),
                "card no cudnn vmap": (card, {**off, "enabled": False}, True),
                "card autotuned vmap": (card, {**off, "benchmark": True}, True)}
    keys = ("Train/Loss", "Train/Acc", "Test/Acc", "Test/Loss")
    result = {}
    for dataset in VISION_FED:
        ref_sim, _ = _vision_sim(torch, dataset, cpu, f64=True)
        init = {k: v.detach().cpu().clone() for k, v in ref_sim.init_variables().items()}
        arrays = ref_sim.train_data.arrays
        idx = ref_sim.train_data.partition[0][:10]
        ref_sim.trainer.module.load_state_dict(init)
        leaves = _leaf_errors(torch, ref_sim.trainer.module, arrays["x"][idx],
                              arrays["y"][idx], variants)
        for name, layers in leaves.items():
            for kind, i in (("output", 0), ("input gradient", 1), ("parameter gradient", 2)):
                worst = sorted(layers, key=lambda n: -layers[n][i])[:3]
                log(f"[vision_fed numerics] {dataset} {name}: each layer alone, largest "
                    f"relative f32 {kind} error " + ", ".join(
                        f"{n} {layers[n][i]:.3e}" for n in worst)
                    + f"; median {float(np.median([v[i] for v in layers.values()])):.3e}")
        for client in sorted(ref_sim.train_data.partition):
            for device, r in _second_step(torch, dataset, init, client, devices).items():
                log(f"[vision_fed numerics] {dataset} client {client}, {device}: the second SGD "
                    f"step's f32 gradient off float64 by {r['own']:.3e} from f32's own first "
                    f"step, {r['rounded']:.3e} from float64's first step rounded to f32; the "
                    f"float64 gradient at f32's weights {r['float64']:.3e}; the gradient "
                    f"first off by 1e-3 into {r['enters at']}; {r['sign flips']} layer "
                    f"outputs of another sign than float64's, the first in {r['first flip']}")
        ref_final, ref_hist = ref_sim.run(variables={k: v.clone() for k, v in init.items()})
        rounds = {}
        for name, device, mode, flags in (
                ("cpu vmap", cpu, "vmap", off), ("cpu scan", cpu, "scan", off),
                ("card vmap", card, "vmap", off), ("card scan", card, "scan", off),
                ("card deterministic vmap", card, "vmap", {**off, "deterministic": True}),
                ("card no cudnn vmap", card, "vmap", {**off, "enabled": False})):
            sim, _ = _vision_sim(torch, dataset, device, mode)
            with torch.backends.cudnn.flags(**flags):
                final, hist = sim.run(variables={
                    k: v.to(device, torch.float32 if v.is_floating_point() else v.dtype)
                    for k, v in init.items()})
            rounds[name] = (max(float((final[k].double().cpu() - ref_final[k]).abs().max())
                                for k in ref_final),
                            max(abs(hist[-1][k] - ref_hist[-1][k]) for k in keys))
            log(f"[vision_fed numerics] {dataset} round 1 in f32, {name}: from the CPU's "
                f"float64 round, variables {rounds[name][0]:.3e}, metrics {rounds[name][1]:.3e}")
        # the float64 round's own response to its start rounded as f32 rounds
        # a step: each variable times (1 + 2^-24 u), u uniform in [-1, 1]
        sim, _ = _vision_sim(torch, dataset, card, f64=True)
        for seed in range(3):
            u = np.random.RandomState(seed)
            start = {k: (v * (1 + 2.0 ** -24 * torch.as_tensor(u.uniform(-1, 1, v.shape)))
                         if v.is_floating_point() else v).to(card) for k, v in init.items()}
            final, hist = sim.run(variables=start)
            rounds[f"float64 from a start moved 2^-24, seed {seed}"] = (
                max(float((final[k].cpu() - ref_final[k]).abs().max()) for k in ref_final),
                max(abs(hist[-1][k] - ref_hist[-1][k]) for k in keys))
            log(f"[vision_fed numerics] {dataset} round 1 in float64 on the card from the start "
                f"moved by 2^-24 relative (seed {seed}): from the CPU's float64 round, variables "
                f"{rounds[f'float64 from a start moved 2^-24, seed {seed}'][0]:.3e}, metrics "
                f"{rounds[f'float64 from a start moved 2^-24, seed {seed}'][1]:.3e}")
        result[dataset] = {"leaves": leaves, "rounds": rounds}
    return result


# the message-passing wire path (ROADMAP §A11): the cross-silo
# flagship over the loopback fabric at full width, cut in depth to 1 round
# [100] on a CIFAR-10 fixture of 10k/2k images [50k/10k], ~160 eager client
# steps a round [~790], for the script's time budget
WIRE = dict(clients=10, batch=64, lr=0.001, wd=0.001, epochs=1, rounds=1,
            n_train=10_000, n_test=2_000, small_rounds=3,
            mnist_rounds=2, silo_rounds=2, card_atol=1e-5, sim_rtol=2e-4, sim_atol=2e-5,
            ta_atol=1e-3)


def _wire_run(original, buffered=False, into=None):
    """A ``_wrapped`` maker for ``run_distributed_fedavg_loopback``: the run
    over an ``OrderedUplinkFabric`` (the server folds the uploads in sender
    order, so two runs fold alike), with the buffered tally when asked;
    ``into`` gets each run's final variables."""
    from fedml_tpu_torch.algorithms.fedavg_distributed import MyMessage
    from fedml_tpu_torch.comm.loopback import OrderedUplinkFabric

    def run(*args, **kwargs):
        workers = kwargs["worker_num"] if "worker_num" in kwargs else args[2]
        kwargs["fabric"] = OrderedUplinkFabric(workers + 1, workers,
                                               MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER)
        if buffered:
            kwargs["server_kwargs"] = {**(kwargs.get("server_kwargs") or {}),
                                       "buffered_aggregation": True}
        out = original(*args, **kwargs)
        if into is not None:
            into.append({k: v.clone() for k, v in out.items()})
        return out
    return run


@contextlib.contextmanager
def _deterministic(torch):
    """cuDNN's deterministic algorithms, and torch's where it has them (a
    warning, not an error, for an op without one)."""
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def _state_gap(torch, a, b):
    return max(float(torch.max(torch.abs(a[k].cpu().double() - b[k].cpu().double())))
               for k in a)


def _wire_vs_sim(torch):
    """The wire against the port's FedSim at full participation, full batch,
    E=1 and no shuffle, both on the card (``tests/test_comm.py``'s bound),
    and the wire run on the card against the same run on the CPU."""
    from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
    from fedml_tpu_torch.comm.loopback import OrderedUplinkFabric
    from fedml_tpu_torch.core import rng as rnglib
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.data.synthetic import gaussian_blobs
    from fedml_tpu_torch.models.linear import LogisticRegression
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    c = WIRE
    train, test = gaussian_blobs(n_clients=4, samples_per_client=24, seed=6)
    batch = train.max_client_size()
    finals = {}
    start = ClientTrainer(module=LogisticRegression(num_classes=4, in_features=16, device="cpu")
                          ).init(rnglib.generator(0, "cpu"))
    for device in ("cuda", "cpu"):
        trainer = ClientTrainer(module=LogisticRegression(num_classes=4, in_features=16,
                                                          device=device),
                                optimizer=sgd(0.1), epochs=1)
        fabric = OrderedUplinkFabric(5, 4, tfd.MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER)
        finals[device] = tfd.run_distributed_fedavg_loopback(
            trainer, train, 4, c["small_rounds"], batch, fabric=fabric, init_overrides=start)
        if device == "cuda":
            cfg = SimConfig(client_num_in_total=4, client_num_per_round=4, batch_size=batch,
                            comm_round=c["small_rounds"], frequency_of_the_test=100,
                            shuffle_each_round=False)
            sim_vars, _ = FedSim(trainer, train, test, cfg, device="cuda").run(
                variables={k: v.to("cuda") for k, v in start.items()})
    sim_gap = max(float(np.max(np.abs(finals["cuda"][k].numpy() - sim_vars[k].cpu().numpy())
                                 - c["sim_rtol"] * np.abs(sim_vars[k].cpu().numpy())))
                  for k in sim_vars)
    raw_sim = _state_gap(torch, finals["cuda"], sim_vars)
    card_cpu = _state_gap(torch, finals["cuda"], finals["cpu"])
    log(f"[wire] loopback FedAvg (LR, 4 blobs clients, full batch, E=1, {c['small_rounds']} "
        f"rounds) on the card against the port's FedSim on the card: largest difference "
        f"{raw_sim:.3e} (bound atol {c['sim_atol']} + rtol {c['sim_rtol']}); against the same "
        f"wire run on the CPU: {card_cpu:.3e} (bound {c['card_atol']})")
    if sim_gap > c["sim_atol"]:
        fail(f"wire vs FedSim on the card: {raw_sim:.3e} beyond atol {c['sim_atol']} + rtol "
             f"{c['sim_rtol']}")
    if card_cpu > c["card_atol"]:
        fail(f"wire run card vs CPU: {card_cpu:.3e} > {c['card_atol']}")


def _span_totals(tracer) -> tuple[dict, float]:
    """Seconds and count of each span name the tracer recorded, and the
    round's seconds: from the first client's decode of the sync to the end
    of the round's close (one round)."""
    out: dict = {}
    spans = [rec for rec in tracer.events() if rec.get("ph") == "X"]
    for rec in spans:
        s, n = out.get(rec["name"], (0.0, 0))
        out[rec["name"]] = (s + rec["dur"] / 1e6, n + 1)
    start = min(rec["ts"] for rec in spans if rec["name"] == "client/decode")
    end = max(rec["ts"] + rec["dur"] for rec in spans if rec["name"] == "round/close")
    return out, (end - start) / 1e6


def _wire_fixture():
    """The wire flagship's CIFAR-10 fixture (``WIRE``'s size, the
    ``[cross-silo]`` fixture's seed and signal); returns its directory."""
    from fedml_tpu_torch.exp.repro_cross_silo import write_cifar10_fixture

    data_dir = BUILD_DIR / "cifar10_wire"
    write_cifar10_fixture(data_dir, n_train=WIRE["n_train"], n_test=WIRE["n_test"], seed=0,
                          signal=0.045)
    return data_dir


def _flagship_argv(backend, data_dir, clients, per_round, rounds):
    """``main_fedavg``'s argv for the cross-silo flagship over ``backend``:
    CIFAR-10 + ResNet-56 bf16 at ``WIRE``'s recipe, ``per_round`` of
    ``clients`` silos a round, evaluated after the last round."""
    w = WIRE
    return ["--backend", backend, "--dataset", "cifar10", "--model", "resnet56",
            "--model_dtype", "bfloat16", "--data_dir", str(data_dir),
            "--partition_method", "hetero", "--partition_alpha", "0.5",
            "--client_num_in_total", str(clients), "--client_num_per_round", str(per_round),
            "--batch_size", str(w["batch"]), "--lr", str(w["lr"]), "--wd", str(w["wd"]),
            "--epochs", str(w["epochs"]), "--comm_round", str(rounds),
            "--frequency_of_the_test", str(rounds)]


def _captured_run(torch, argv, agg_cls, *wraps):
    """The CLI run of ``argv`` under deterministic algorithms, with every
    upload the server's tally takes (index, bytes, weight, in arrival
    order), the global the round closed with and the global it started
    from, the model payload bytes every sync carried, the blobs the object
    store was given, and the tracer's spans; ``wraps`` are more
    ``(owner, name, make)`` for ``_wrapped``: (history, seconds, capture)."""
    from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
    from fedml_tpu_torch.comm import object_store
    from fedml_tpu_torch.obs import trace

    cap = {"uploads": [], "globals": [], "bases": [], "down": 0, "puts": [0, 0]}

    def keep_upload(original):
        def add(self, index, flat, n):
            cap["uploads"].append((index, np.array(flat), float(n)))
            return original(self, index, flat, n)
        return add

    def keep_global(original):
        def aggregate(self):
            if getattr(self, "get_global", None) is not None:
                cap["bases"].append(np.array(self.get_global()))
            out = original(self)
            cap["globals"].append(np.array(out))
            return out
        return aggregate

    def keep_sync(original):
        def decode(self, msg):
            out = original(self, msg)
            cap["down"] += int(np.asarray(msg.get(tfd.MyMessage.MSG_ARG_KEY_MODEL_PARAMS)).nbytes)
            return out
        return decode

    def keep_put(original):
        def put(self, key, data):
            cap["puts"][0] += 1
            cap["puts"][1] += len(data)
            return original(self, key, data)
        return put

    tracer = trace.install(trace.Tracer())
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(_deterministic(torch))
            for owner, name, make in ((agg_cls, "add_local_trained_result", keep_upload),
                                      (agg_cls, "aggregate", keep_global),
                                      (tfd.FedAvgClientManager, "_decode_model", keep_sync),
                                      (object_store.FileSystemStore, "put", keep_put), *wraps):
                stack.enter_context(_wrapped(owner, name, make))
            history, wall = _cli(torch, argv)
    finally:
        trace.uninstall()
    cap["spans"], cap["round_s"] = _span_totals(tracer)
    return history, wall, cap


def _f64_mean(uploads):
    """The f64 weighted mean of the first upload of each rank, in arrival
    order, as the wire bytes of f32 (the server's streaming fold)."""
    seen, acc, wsum = set(), None, 0.0
    for index, flat, n in uploads:
        if index in seen:
            continue
        seen.add(index)
        x = np.multiply(flat.view(np.float32), n, dtype=np.float64)
        acc = x if acc is None else acc + x
        wsum += n
    return (acc / wsum).astype(np.float32).view(np.uint8)


def _wire_flagship(torch, plain_flagship_s):
    """The cross-silo flagship over the wire: ``main_fedavg --backend
    loopback`` with CIFAR-10 + ResNet-56 bf16, 10 silos all in the round,
    B=64, SGD 0.001 wd 0.001, hetero 0.5, E=1, 1 round, on a CIFAR-10
    fixture of ``WIRE``'s size written as ``[cross-silo]``'s is (its write
    timed), over an OrderedUplinkFabric, under deterministic algorithms.
    Holds (a) the global after the round bitwise the f64 weighted mean of
    the ten captured uploads in arrival order, (b) rank 1's upload bitwise
    ``make_local_train`` called directly on the same batches and converted
    to the JAX layout, (c) a finite eval. Prints the round's seconds, its
    split from the tracer's spans, uplink bytes and peak memory."""
    from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
    from fedml_tpu_torch.core.trainer import make_local_train
    from fedml_tpu_torch.sim.cohort import stack_cohort, steps_per_epoch

    c = WIRE
    t0 = time.perf_counter()
    data_dir = _wire_fixture()
    write_s = time.perf_counter() - t0
    argv = _flagship_argv("loopback", data_dir, c["clients"], c["clients"], c["rounds"])
    rank1 = {}

    def keep_rank1(original):
        def train(trainer, local_train, data, client_idx, batch, round_idx, rng_seed,
                  variables, exec_lock=None):
            out = original(trainer, local_train, data, client_idx, batch, round_idx,
                           rng_seed, variables, exec_lock)
            if rng_seed == 1 * 100003 + round_idx and round_idx == 0:
                rank1.update(trainer=trainer, data=data, client_idx=client_idx,
                             variables={k: v.clone() for k, v in variables.items()},
                             upload=tfd.pack_state(out[0]))
            return out
        return train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    history, wall, cap = _captured_run(
        torch, argv, tfd.FedAvgDistAggregator, (tfd, "train_wire_round", keep_rank1),
        (tfd, "run_distributed_fedavg_loopback", _wire_run))
    peak = torch.cuda.max_memory_allocated()
    with _deterministic(torch):
        # (b): the same round called directly, after the run
        local_train = make_local_train(rank1["trainer"])
        batches, _ = stack_cohort(rank1["data"], np.asarray([rank1["client_idx"]]),
                                  c["batch"], rng=np.random.RandomState(1000))
        direct, _ = local_train(rank1["variables"],
                                {k: torch.from_numpy(v[0]).to("cuda")
                                 for k, v in batches.items()})
        direct_bytes = tfd.pack_state(direct)
    uploads, spans, round_s = cap["uploads"], cap["spans"], cap["round_s"]
    if len(uploads) != c["clients"] or len(cap["globals"]) != c["rounds"]:
        fail(f"wire flagship: {len(uploads)} uploads, {len(cap['globals'])} globals")
    if not np.array_equal(_f64_mean(uploads), cap["globals"][0]):
        fail("wire flagship (a): the global is not the f64 weighted mean of the uploads")
    sent1 = next(flat for i, flat, _ in uploads if i == 0)
    if not (np.array_equal(rank1["upload"], sent1) and np.array_equal(direct_bytes, sent1)):
        fail("wire flagship (b): rank 1's upload differs from make_local_train called directly "
             f"({int(np.sum(direct_bytes != sent1))} bytes differ)")
    last = history[-1]
    if not all(np.isfinite([last["Test/Acc"], last["Test/Loss"]])):
        fail(f"wire flagship (c): non-finite eval {last}")
    uplink = sum(flat.size for _, flat, _ in uploads)
    steps = sum(steps_per_epoch(int(n), c["batch"]) for _, _, n in uploads) * c["epochs"]
    split = {k: spans.get(k, (0.0, 0)) for k in (
        "client/train", "client/decode", "client/encode", "server/decode", "server/fold",
        "server/aggregate", "round/close", "comm/send", "comm/broadcast")}
    log(f"[wire] flagship over the wire (CIFAR-10 fixture {c['n_train']}/{c['n_test']}, "
        f"written in {write_s:.2f} s, + ResNet-56 bf16, {c['clients']} silos x B={c['batch']}, "
        f"E={c['epochs']}, {c['rounds']} round of {steps} client steps, OrderedUplinkFabric, "
        f"deterministic): the round {round_s:.3f} s (first sync decoded to the round's "
        f"close), {wall:.2f} s for the CLI run (data, model, the round, eval); "
        f"(a) global == f64 mean of the {len(uploads)} uploads in arrival order: bitwise; (b) "
        f"rank 1's upload == make_local_train direct, JAX layout: bitwise; (c) Test/Acc "
        f"{last['Test/Acc']:.4f} Test/Loss {last['Test/Loss']:.5f}")
    log("[wire] flagship split (tracer spans, seconds summed over threads, count): "
        + ", ".join(f"{k} {s:.3f} s x{n}" for k, (s, n) in split.items()))
    log(f"[wire] flagship uplink {uplink} bytes ({uplink / len(uploads)} an upload), peak "
        f"device memory {peak / 2**30:.2f} GiB; {round_s / steps * 1e3:.1f} ms a client step; "
        f"[cross-silo]'s vmapped sim round on its {CROSS_SILO['n_train']}-image fixture for "
        f"comparison (printed, not held): {plain_flagship_s[0]:.3f} s")
    return {"round_s": round_s, "split": split, "uplink": uplink, "peak": peak}


def _wire_mnist(torch, mnist_dir):
    """BASELINE row 1 (MNIST + LR, the LEAF fixture) over the wire, 10
    clients a round, 2 rounds: ``--is_mobile 1`` bitwise the native run on
    the card; top-k 0.01 with error feedback and q4, each with the
    streaming and the buffered tally, bitwise alike, their ``Comm/*``
    printed and held to the static byte figure (each upload's encoded
    planes by shape and dtype, plus its descriptor)."""
    import functools

    from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
    from fedml_tpu_torch.comm.message import pack_encoded_update
    from fedml_tpu_torch.compress import make_codec

    c = WIRE
    rounds = c["mnist_rounds"]
    base = _mnist_argv(mnist_dir, rounds, rounds, "--backend", "loopback")
    finals, hist = {}, {}
    for name, extra, buffered in (
            ("native", [], False), ("mobile", ["--is_mobile", "1"], False),
            ("topk", ["--compressor", "topk", "--topk_frac", "0.01", "--error_feedback", "1"],
             False),
            ("topk buffered", ["--compressor", "topk", "--topk_frac", "0.01",
                               "--error_feedback", "1"], True),
            ("q4", ["--compressor", "q4"], False), ("q4 buffered", ["--compressor", "q4"], True)):
        into = []
        with _deterministic(torch), _wrapped(tfd, "run_distributed_fedavg_loopback",
                                             functools.partial(_wire_run, buffered=buffered,
                                                               into=into)):
            hist[name], secs = _cli(torch, base + extra)
        finals[name] = into[0]
        log(f"[wire] row 1 {name}: {rounds} rounds in {secs:.2f} s, final "
            f"{json.dumps(hist[name][-1])}")
    for a, b in (("native", "mobile"), ("topk", "topk buffered"), ("q4", "q4 buffered")):
        gap = _state_gap(torch, finals[a], finals[b])
        if gap != 0.0 or hist[a] != hist[b]:
            fail(f"wire row 1: {a} and {b} differ ({gap:.3e})")
    log("[wire] row 1: mobile == native, streaming == buffered (top-k + EF, q4): bitwise")
    shapes = {"params/Dense_0/bias": (10,), "params/Dense_0/kernel": (784, 10)}
    zeros = {k: torch.zeros(s) for k, s in shapes.items()}
    for spec in ("topk", "q4"):
        codec = make_codec(spec, topk_frac=0.01)
        enc = codec.encode(zeros, _HalfUniforms(torch))
        flat, desc = pack_encoded_update(enc)
        static = c["clients"] * (enc.nbytes + len(desc))
        got = [rec["Comm/UplinkBytes"] for rec in hist[spec]]
        log(f"[wire] row 1 {spec}: Comm/UplinkBytes a round {got}, "
            f"Comm/CompressionRatio {[round(r['Comm/CompressionRatio'], 4) for r in hist[spec]]};"
            f" static figure {static} ({c['clients']} x ({enc.nbytes} plane bytes + "
            f"{len(desc)} descriptor bytes)), dense {c['clients'] * 4 * (784 * 10 + 10)}")
        if any(g != static for g in got):
            fail(f"wire row 1 {spec}: uplink bytes {got} != the static figure {static}")


class _HalfUniforms:
    """Uniforms of 0.5 (the byte figure does not depend on them)."""

    def __init__(self, torch):
        self.torch = torch

    def uniform(self, shape, dtype=None):
        return self.torch.full(tuple(shape), 0.5)


def _wire_families(torch):
    """``run_cross_silo`` with single-device silos, 2 rounds, card against
    CPU from the same variables within 1e-5; ``main_turboaggregate`` at its
    defaults on the card, the secure aggregate within the JAX test's 1e-3 of
    open FedAvg over the same rounds."""
    from fedml_tpu_torch.algorithms import cross_silo, turboaggregate_dist
    from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
    from fedml_tpu_torch.comm.loopback import LoopbackCommManager, OrderedUplinkFabric
    from fedml_tpu_torch.core import rng as rnglib
    from fedml_tpu_torch.core.trainer import ClientTrainer, make_local_train, sgd
    from fedml_tpu_torch.data.synthetic import gaussian_blobs
    from fedml_tpu_torch.exp import main_turboaggregate
    from fedml_tpu_torch.models.linear import LogisticRegression
    from fedml_tpu_torch.sim.cohort import FederatedArrays, stack_cohort

    c = WIRE
    train, _ = gaussian_blobs(n_clients=2, samples_per_client=48, num_classes=4, seed=9)
    silos = []
    for s in range(2):
        idx = train.partition[s]
        silos.append(FederatedArrays({k: v[idx] for k, v in train.arrays.items()},
                                     {0: np.arange(len(idx))}))
    start = ClientTrainer(module=LogisticRegression(num_classes=4, in_features=16, device="cpu")
                          ).init(rnglib.generator(0, "cpu"))

    def from_start(original):
        def init_template(trainer, arrays, batch_size, seed=0, init_overrides=None):
            return original(trainer, arrays, batch_size, seed, init_overrides=start)
        return init_template

    finals = {}
    for device in ("cuda", "cpu"):
        trainer = ClientTrainer(module=LogisticRegression(num_classes=4, in_features=16,
                                                          device=device),
                                optimizer=sgd(0.3), epochs=2)
        fabric = OrderedUplinkFabric(3, 2, tfd.MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER)
        with _wrapped(cross_silo, "init_template", from_start):
            finals[device] = cross_silo.run_cross_silo(
                trainer, silos, c["silo_rounds"], 16, lambda r: LoopbackCommManager(fabric, r),
                silo_meshes=[torch.device(device)] * 2)
    silo_gap = _state_gap(torch, finals["cuda"], finals["cpu"])
    log(f"[wire] run_cross_silo, 2 single-device silos, {c['silo_rounds']} rounds: card vs "
        f"CPU {silo_gap:.3e} (bound {c['card_atol']})")
    if silo_gap > c["card_atol"]:
        fail(f"wire cross-silo card vs CPU {silo_gap:.3e} > {c['card_atol']}")

    got = {}

    def keep_run(original):
        def run(trainer, data, workers, rounds, batch, make_comm, **kwargs):
            got.update(trainer=trainer, data=data, workers=workers, rounds=rounds, batch=batch,
                       seed=kwargs.get("seed", 0))
            got["final"] = original(trainer, data, workers, rounds, batch, make_comm, **kwargs)
            return got["final"]
        return run

    with _wrapped(turboaggregate_dist, "run_turboaggregate", keep_run):
        out = main_turboaggregate.main(["--device", "cuda"])
    trainer, data = got["trainer"], got["data"]
    local_train = make_local_train(trainer)
    global_vars = tfd.init_template(trainer, data.arrays, got["batch"], got["seed"])[0]
    for r in range(got["rounds"]):
        models, ns = [], []
        for rank in range(1, got["workers"] + 1):
            batches, weights = stack_cohort(data, np.asarray([(rank - 1) % data.num_clients]),
                                            got["batch"], rng=np.random.RandomState(1000 + r))
            new, _ = local_train(global_vars, {k: torch.from_numpy(v[0]).to("cuda")
                                               for k, v in batches.items()})
            models.append(new)
            ns.append(float(weights[0]))
        w = np.asarray(ns) / sum(ns)
        global_vars = {k: sum(float(wi) * m[k] for wi, m in zip(w, models)) for k in models[0]}
    ta_gap = _state_gap(torch, got["final"], global_vars)
    log(f"[wire] main_turboaggregate at its defaults ({got['workers']} clients, "
        f"{got['rounds']} rounds): {json.dumps(out)}; secure aggregate vs open FedAvg "
        f"{ta_gap:.3e} (bound {c['ta_atol']})")
    if ta_gap > c["ta_atol"]:
        fail(f"wire TurboAggregate vs FedAvg {ta_gap:.3e} > {c['ta_atol']}")


def wire_client_numerics(torch, device="cuda"):
    """Where a wire client's local round goes (not run by ``main``): one
    client of the flagship (ResNet-56 bf16, B=64, client 0 of the wire
    flagship's CIFAR-10 fixture's hetero split) trained by
    ``make_local_train`` twice each under cuDNN's deterministic algorithms,
    its defaults and its benchmark mode, printing the host's enqueue time
    and the synchronised time; then the deterministic round under
    ``torch.profiler``: device kernels a step and the device's busy time."""
    from fedml_tpu_torch.core import rng as rnglib
    from fedml_tpu_torch.core.trainer import ClientTrainer, make_local_train, sgd
    from fedml_tpu_torch.data.registry import load_partition_data
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.sim.cohort import stack_cohort

    c = WIRE
    data_dir = _wire_fixture()
    ds = load_partition_data("cifar10", str(data_dir), "hetero", 0.5, c["clients"], 0)
    model = create_model("resnet56", 10, "cifar10", dtype="bfloat16", device=device,
                         input_shape=tuple(ds.train.arrays["x"].shape[1:]))
    trainer = ClientTrainer(module=model, optimizer=sgd(c["lr"], weight_decay=c["wd"]),
                            epochs=c["epochs"])
    start = trainer.init(rnglib.generator(0, device))
    batches, _ = stack_cohort(ds.train, np.asarray([0]), c["batch"],
                              rng=np.random.RandomState(1000))
    data = {k: torch.from_numpy(v[0]).to(device) for k, v in batches.items()}
    local_train = make_local_train(trainer)
    steps = data["mask"].shape[0]
    try:
        for mode in ("deterministic", "default", "benchmark", "deterministic"):
            torch.backends.cudnn.deterministic = mode == "deterministic"
            torch.backends.cudnn.benchmark = mode == "benchmark"
            for rep in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                local_train(start, data)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                log(f"[wire client] {mode} call {rep}: {steps} steps, host enqueue "
                    f"{t1 - t0:.3f} s, synchronised {t2 - t0:.3f} s "
                    f"({(t2 - t0) / steps * 1e3:.1f} ms a step)")
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        got = {}
        _profiled(torch, got, local_train, start, data)
        log(f"[wire client] deterministic round under torch.profiler: {got['kernels']} device "
            f"kernels and copies ({got['kernels'] / steps:.0f} a step), device busy "
            f"{got['union_us'] / 1e6:.3f} s of {got['wall']:.3f} s wall "
            f"({1 - got['union_us'] / 1e6 / got['wall']:.1%} idle); host CUDA calls "
            f"{got['api']}")
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = False


def phase_wire(torch, mnist_dir, plain_flagship_s):
    """The message-passing wire path on the card: the wire against
    the sim and the CPU, the cross-silo flagship over the wire at full
    width, row 1's mobile and compressed wire runs, cross-silo and
    TurboAggregate. Returns the flash launches of each path (each must
    be 0)."""
    launches = {}
    for name, fn, args in (("wire_sim", _wire_vs_sim, ()),
                           ("wire_flagship", _wire_flagship, (plain_flagship_s,)),
                           ("wire_mnist", _wire_mnist, (mnist_dir,)),
                           ("wire_families", _wire_families, ())):
        _zero_flash_counters()
        t0 = time.perf_counter()
        fn(torch, *args)
        torch.cuda.synchronize()
        launches[name] = _flash_launches()
        log(f"[wire] {name}: {time.perf_counter() - t0:.2f} s, flash launches {launches[name]}")
        torch.cuda.empty_cache()
    return launches


# the shm, gRPC and MQTT + object-store transports, fault injection,
# heartbeats and the robust wire server. The flagship at full width, cut in
# depth to 1 round [100] of 4 silos taking 1/40 shares of [wire]'s fixture
# [all 10 silos on their 1/10 shares], ~16 eager client steps a run. The
# robust run's norm bound lies far above the honest deltas' norms and far
# below the corrupted upload's, so that only rank 2's upload clips
TRANSPORTS = dict(clients=40, per_round=4, rounds=1, offload_threshold=1 << 14,
                  norm_bound=100.0, fault_spec="1:dup=1.0;2:corrupt=1.0",
                  small_workers=3, small_rounds=3, round_timeout=0.3,
                  recv_delay=1.0, heartbeat_interval=0.03, heartbeat_timeout=2.0)
# the card's machine has grpcio (1.80.0 on the H100 host this script was
# written against), so the gRPC leg runs and its failure fails the script
TRANSPORTS_OVER = ("shm", "mqtt_s3", "grpc")


def _transport_argv(backend, data_dir, store_dir):
    """The flagship's argv at ``TRANSPORTS``' depth over ``backend``, with
    the object store's directory and offload threshold for mqtt_s3."""
    c = TRANSPORTS
    argv = _flagship_argv(backend, data_dir, c["clients"], c["per_round"], c["rounds"])
    if backend == "mqtt_s3":
        argv += ["--object_store_dir", str(store_dir),
                 "--offload_threshold_bytes", str(c["offload_threshold"])]
    return argv


def _free_port_run(n):
    """Base of a run of ``n`` consecutive localhost ports the OS finds free
    (each bound to and released), so that two runs on one machine never
    meet on a fixed block."""
    import socket

    for _ in range(64):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n >= 65535:
            continue
        try:
            for port in range(base, base + n):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", port))
        except OSError:
            continue
        return base
    fail(f"no run of {n} free ports found for the gRPC ranks")


def _transports_flagship(torch, data_dir):
    """(a) The cross-silo flagship over each transport: the global bitwise
    the f64 weighted mean of that run's uploads in arrival order, each
    rank's upload bitwise its upload over the first transport, a finite
    eval. The gRPC ranks listen on a block of free ports, not the runner's
    fixed 29500. Returns each transport's flash launches and the first
    transport's uploads by worker index (``[async]`` holds its runs' uploads
    to them)."""
    import functools
    import shutil

    from fedml_tpu_torch.algorithms import fedavg_distributed as tfd

    c = TRANSPORTS
    launches, first = {}, None
    for backend in TRANSPORTS_OVER:
        store = BUILD_DIR / f"transports_store_{backend}"
        shutil.rmtree(store, ignore_errors=True)
        wraps = []
        if backend == "grpc":
            base = _free_port_run(c["per_round"] + 1)
            wraps.append((tfd, "run_distributed_fedavg_grpc",
                          lambda original: functools.partial(original, base_port=base)))
        _zero_flash_counters()
        history, wall, cap = _captured_run(torch, _transport_argv(backend, data_dir, store),
                                           tfd.FedAvgDistAggregator, *wraps)
        torch.cuda.synchronize()
        launches[f"transports_{backend}"] = _flash_launches()
        ups = cap["uploads"]
        if len(ups) != c["per_round"] or len(cap["globals"]) != c["rounds"]:
            fail(f"[transports] {backend}: {len(ups)} uploads, {len(cap['globals'])} globals")
        if not np.array_equal(_f64_mean(ups), cap["globals"][0]):
            fail(f"[transports] {backend} (1): the global is not the f64 weighted mean of the "
                 "uploads in arrival order")
        by_rank = {i: flat for i, flat, _ in ups}
        if first is None:
            first = (backend, by_rank)
        elif by_rank.keys() != first[1].keys() or not all(
                np.array_equal(by_rank[i], first[1][i]) for i in by_rank):
            fail(f"[transports] {backend} (2): an upload differs from the same rank's over "
                 f"{first[0]}")
        last = history[-1]
        if not all(np.isfinite([last["Test/Acc"], last["Test/Loss"]])):
            fail(f"[transports] {backend} (3): non-finite eval {last}")
        spans = cap["spans"]
        send, recv = spans.get("comm/send", (0.0, 0)), spans.get("comm/recv", (0.0, 0))
        held = ""
        if backend == "grpc":
            held = f"; ranks 0-{c['per_round']} on ports {base}-{base + c['per_round']}"
        if backend == "mqtt_s3":
            left = list(store.iterdir())
            held = (f"; the store was given {cap['puts'][0]} blobs, {cap['puts'][1]} bytes, "
                    f"and holds {len(left)} ({sum(p.stat().st_size for p in left)} bytes) "
                    "after the run (the last broadcast generations)")
        log(f"[transports] {backend}: {c['per_round']} silos of {c['clients']} x B=64, "
            f"{len(ups)} uploads in arrival order {[i + 1 for i, _, _ in ups]}; the round "
            f"{cap['round_s']:.3f} s (first sync decoded to the round's close), the CLI run "
            f"{wall:.2f} s; comm/send {send[0]:.3f} s x{send[1]}, comm/recv {recv[0]:.3f} s "
            f"x{recv[1]} (a client's recv span holds its local round); uplink {sum(f.nbytes for _, f, _ in ups)} bytes, downlink "
            f"{cap['down']} bytes (model payloads of the syncs){held}; (1) global == f64 mean "
            f"in arrival order: bitwise; (2) uploads == over {first[0]}: bitwise; (3) Test/Acc "
            f"{last['Test/Acc']:.4f} Test/Loss {last['Test/Loss']:.5f}")
        torch.cuda.empty_cache()
    return launches, first[1]


def _transports_robust(torch, data_dir):
    """(b) ``--algorithm fedavg_robust --robust_rule median --reservoir_k 0``
    over shm, a norm bound between the honest uploads' delta norms and the
    corrupted one's, rank 1's uploads duplicated and rank 2's corrupted: the
    streaming tally bitwise the buffered replay of the same uploads, rank
    2's upload the only one rejected or clipped and the record's clip
    fraction and filtered count saying so, the duplicate folded once."""
    from fedml_tpu_torch.algorithms import robust_distributed as trd
    from fedml_tpu_torch.algorithms.robust import flat_delta_norm, flat_norm_mask
    from fedml_tpu_torch.comm import faults

    c = TRANSPORTS
    argv = _transport_argv("shm", data_dir, None) + [
        "--algorithm", "fedavg_robust", "--robust_rule", "median", "--reservoir_k", "0",
        "--norm_bound", str(c["norm_bound"]), "--fault_spec", c["fault_spec"]]
    wrappers, servers = [], []

    def keep_wrapper(original):
        def init(self, *a, **kw):
            original(self, *a, **kw)
            wrappers.append(self)
        return init

    def keep_server(original):
        def init(self, *a, **kw):
            original(self, *a, **kw)
            servers.append(self)
        return init

    _zero_flash_counters()
    with _wrapped(faults.FaultyCommManager, "__init__", keep_wrapper), \
            _wrapped(trd.RobustFedAvgServerManager, "__init__", keep_server):
        history, wall, cap = _captured_run(torch, argv, trd.RobustDistAggregator)
    torch.cuda.synchronize()
    launches = _flash_launches()
    server, ups = servers[0], cap["uploads"]
    replay = trd.BufferedRobustDistAggregator(c["per_round"], server.robust_config,
                                              model_desc=server.model_desc)
    replay.get_global = lambda: cap["bases"][0]
    for index, flat, n in ups:
        replay.add_local_trained_result(index, flat, n)
    if not np.array_equal(replay.aggregate(), cap["globals"][0]):
        fail("[transports] robust (1): the streaming tally differs from the buffered replay")
    rec = {k: v for k, v in history[-1].items() if k.startswith("Robust/")}
    if rec != replay.pop_round_stats():
        fail(f"[transports] robust: the record {rec} differs from the buffered replay's")
    indices = [i for i, _, _ in ups]
    if indices.count(0) != 2 or len(set(indices)) != c["per_round"]:
        fail(f"[transports] robust (3): uploads by rank {[i + 1 for i in indices]}, expected "
             "rank 1 twice and every rank")
    # the server's own measures: finiteness on the whole delta, the clip
    # on its norm without the BatchNorm statistics
    base, mask = cap["bases"][0].view(np.float32), flat_norm_mask(server.model_desc)
    deltas = {i + 1: flat.view(np.float32) - base for i, flat, _ in ups}
    rejected = [r for r, d in deltas.items() if not np.isfinite(np.linalg.norm(d))]
    norms = {r: flat_delta_norm(d, mask) for r, d in deltas.items() if r not in rejected}
    clipped = [r for r, v in norms.items() if v > c["norm_bound"]]
    if rejected + clipped != [2]:
        fail(f"[transports] robust (2): rank(s) {rejected} rejected and {clipped} clipped "
             f"(delta norms {norms}, bound {c['norm_bound']}); expected rank 2's corrupted "
             "upload alone")
    verdict = "rejected (non-finite)" if rejected else "clipped, the only one"
    folded = c["per_round"] - len(rejected)
    if rec["Robust/FilteredClients"] != len(rejected) + folded - 1 or \
            rec["Robust/ClipFraction"] != len(clipped) / folded:
        fail(f"[transports] robust (2): the record {rec} does not show {len(rejected)} "
             f"rejected, {len(clipped)} of {folded} clipped and a median over {folded}")
    last = history[-1]
    if not all(np.isfinite([last["Test/Acc"], last["Test/Loss"]])):
        fail(f"[transports] robust: non-finite eval {last}")
    log(f"[transports] robust over shm (median, reservoir_k 0, norm_bound {c['norm_bound']}, "
        f"--fault_spec '{c['fault_spec']}'): the CLI run {wall:.2f} s; uploads by rank "
        f"{[i + 1 for i in indices]} (rank 1's duplicate folded once); clip norms "
        f"{ {k: round(v, 5) for k, v in norms.items()} }; rank 2's corrupted upload {verdict}; "
        f"record {rec}; faults applied "
        f"{ {w.rank: w.applied_counts() for w in wrappers} }; (1) streaming == buffered replay: "
        f"bitwise; Test/Acc {last['Test/Acc']:.4f}")
    torch.cuda.empty_cache()
    return launches


def _transports_heartbeats(torch):
    """(c) LR on the blobs over shm through the Python API: with a round
    timeout, rank 2 dropping every send (uploads and heartbeats) is excluded
    as OFFLINE after two misses; rank 3, whose syncs arrive late
    (``recv_delay``, past the timeout) while it heartbeats, is SLOW with no
    miss. A heartbeating run without faults is bitwise a silent one (two
    workers: two f64 addends fold alike in either order)."""
    import uuid

    from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
    from fedml_tpu_torch.comm.shm import ShmCommManager
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.data.synthetic import gaussian_blobs
    from fedml_tpu_torch.models.linear import LogisticRegression

    c = TRANSPORTS
    train, _ = gaussian_blobs(n_clients=4, samples_per_client=20, seed=5)
    trainer = ClientTrainer(module=LogisticRegression(num_classes=4, in_features=16,
                                                      device="cuda"),
                            optimizer=sgd(0.2), epochs=1)
    log_ = {"transitions": [], "misses": []}

    class Judging(tfd.FedAvgServerManager):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.status.on_transition = lambda cid, s: log_["transitions"].append((cid, s))

        def _round_timed_out(self, expected_round):
            super()._round_timed_out(expected_round)
            log_["misses"].append(dict(self._miss_counts))
            log_["excluded"] = [w + 1 for w in self.aggregator.excluded_workers()]

    def over_shm(workers, delay_tail=0.0, **kw):
        job = f"tr_{uuid.uuid4().hex[:8]}"
        mgrs = {r: ShmCommManager(job, r, workers + 1) for r in range(workers + 1)}
        try:
            return tfd.run_distributed_fedavg(trainer, train, workers, c["small_rounds"], 10,
                                              lambda r: mgrs[r], **kw)
        finally:
            time.sleep(delay_tail)  # the last late syncs land before the rings go
            for m in mgrs.values():
                m.cleanup()

    _zero_flash_counters()
    t0 = time.perf_counter()
    over_shm(c["small_workers"], delay_tail=c["recv_delay"] + 0.2, server_cls=Judging,
             round_timeout=c["round_timeout"], heartbeat_interval=c["heartbeat_interval"],
             heartbeat_timeout=c["heartbeat_timeout"],
             fault_specs=f"2:drop=1.0;3:recv_delay={c['recv_delay']}")
    faulted_s = time.perf_counter() - t0
    trans = log_["transitions"]
    if log_["misses"] != [{1: 1}, {1: 2}, {1: 2}] or log_.get("excluded") != [2]:
        fail(f"[transports] heartbeats: misses {log_['misses']}, excluded "
             f"{log_.get('excluded')}; expected rank 2 to miss twice and go, rank 3 never")
    if (2, "OFFLINE") not in trans or (3, "SLOW") not in trans or (2, "SLOW") in trans:
        fail(f"[transports] heartbeats: transitions {trans}")
    t0 = time.perf_counter()
    runs = [over_shm(2, **kw) for kw in ({}, {"heartbeat_interval": 0.01})]
    pair_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if not all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0]):
        fail("[transports] heartbeats: a heartbeating run differs from a silent one")
    log(f"[transports] heartbeats over shm (LR on the blobs, {c['small_workers']} workers, "
        f"{c['small_rounds']} rounds, round_timeout {c['round_timeout']} s, heartbeats every "
        f"{c['heartbeat_interval']} s, timeout {c['heartbeat_timeout']} s; rank 2 drop=1.0, "
        f"rank 3 recv_delay={c['recv_delay']}): {faulted_s:.2f} s; misses after each timeout "
        f"{log_['misses']} (worker index: count), rank 2 excluded as OFFLINE, rank 3 SLOW "
        f"with no miss; transitions {sorted(set(trans))}; a 10 ms heartbeating run bitwise a "
        f"silent one (2 workers, {pair_s:.2f} s for both)")
    return _flash_launches()


def phase_transports(torch):
    """The shm ring built from the repo's copy, then (a) the flagship over
    shm, mqtt_s3 and gRPC, (b) the robust wire server with faults over shm,
    (c) heartbeats and a timeout over shm. Returns each path's flash
    launches (each must be 0) and the flagship's uploads over shm by worker
    index."""
    from fedml_tpu_torch.comm import shm

    t0 = time.perf_counter()
    lib = shm.build()
    build_s = time.perf_counter() - t0
    port_dir = (Path(__file__).resolve().parent / "fedml_tpu_torch" / "ops" / "_build")
    if lib.resolve().parent != port_dir.resolve():
        fail(f"[transports] the shm ring built outside the port's build directory: {lib}")
    shm._load_lib()
    log(f"[transports] shm ring built from {shm._SRC.relative_to(Path(__file__).resolve().parent)}"
        f" with g++ in {build_s:.2f} s: {lib.name}")
    data_dir = _wire_fixture()
    launches, uploads = {}, None
    for name, fn, args in (("flagship", _transports_flagship, (data_dir,)),
                           ("robust", _transports_robust, (data_dir,)),
                           ("heartbeats", _transports_heartbeats, ())):
        t1 = time.perf_counter()
        out = fn(torch, *args)
        if name == "flagship":
            launches.update(out[0])
            uploads = out[1]
        else:
            launches[f"transports_{name}"] = out
        log(f"[transports] {name}: {time.perf_counter() - t1:.2f} s")
    return launches, uploads


# the barrier-free server plane and the job plane (ROADMAP §A11.3): the
# flagship at TRANSPORTS' depth (40 silos, 4 a round) over loopback; the
# async runs emit 2 versions at a full buffer and 4 at a buffer of 2, the
# 1-tier tree runs 1 round, the (2, 2) ladder 2 (the JAX contract's) and
# its shm run 1, the job plane one round of each job, the sim co-schedule 3
# rounds of two row-1 engines (MNIST + LR, 10 of the 1000 LEAF clients a
# round) (each cut for the script's time budget)
ASYNC = dict(versions_full=2, versions_half=4, half_buffer=2, half_staleness="poly:0.5",
             tree_rounds=1, ladder_rounds=2, shm_rounds=1, sim_rounds=3)


def _async_argv(data_dir, rounds, *extra):
    """The flagship's argv at ``TRANSPORTS``' depth over loopback, ``rounds``
    rounds (versions in async mode), plus ``extra``."""
    c = TRANSPORTS
    return _flagship_argv("loopback", data_dir, c["clients"], c["per_round"], rounds) + list(extra)


def _spanned_cli(torch, argv, *wraps):
    """The CLI run of ``argv`` under deterministic algorithms and a tracer,
    with ``wraps`` (``(owner, name, make)`` for ``_wrapped``) in place, its
    flash launches counted from 0: (history, seconds, spans, launches),
    ``spans`` the seconds and count of each span name."""
    from fedml_tpu_torch.obs import trace

    tracer = trace.install(trace.Tracer())
    _zero_flash_counters()
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(_deterministic(torch))
            for owner, name, make in wraps:
                stack.enter_context(_wrapped(owner, name, make))
            history, wall = _cli(torch, argv)
    finally:
        trace.uninstall()
    torch.cuda.synchronize()
    spans: dict = {}
    for rec in tracer.events():
        if rec.get("ph") == "X":
            t, n = spans.get(rec["name"], (0.0, 0))
            spans[rec["name"]] = (t + rec["dur"] / 1e6, n + 1)
    return history, wall, spans, _flash_launches()


def _span_line(spans, names):
    return ", ".join(f"{k} {spans.get(k, (0.0, 0))[0]:.3f} s x{spans.get(k, (0.0, 0))[1]}"
                     for k in names)


def _async_server_run(torch, argv, buffer_goal, staleness):
    """``argv`` with ``--server_mode async``: every arrival the server's
    handler took (worker index, upload bytes, n, echoed version, in fold
    order) and every emitted global, each emission held bitwise to the
    port's ``replay_async_schedule`` over the arrivals."""
    from fedml_tpu_torch.async_agg import server as asrv
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.sim.async_oracle import AsyncUpload, replay_async_schedule

    arrivals, emits = [], []

    def keep_arrival(original):
        def handler(self, msg):
            arrivals.append((msg.get_sender_id() - 1,
                             np.array(msg.get(Message.MSG_ARG_KEY_MODEL_PARAMS)),
                             float(msg.get(Message.MSG_ARG_KEY_NUM_SAMPLES)),
                             int(msg.get(Message.MSG_ARG_KEY_MODEL_VERSION))))
            return original(self, msg)
        return handler

    def keep_emit(original):
        def emit(self):
            out = original(self)
            emits.append(np.array(out))
            return out
        return emit

    history, wall, spans, launches = _spanned_cli(
        torch, argv + ["--server_mode", "async", "--buffer_goal", str(buffer_goal),
                       "--staleness_weight", staleness],
        (asrv.AsyncFedAvgServerManager, "_on_model_from_client", keep_arrival),
        (asrv.AsyncFedAggregator, "emit", keep_emit))
    models, records = replay_async_schedule(
        [AsyncUpload(flat.view(np.float32), n, v) for _, flat, n, v in arrivals],
        buffer_goal, staleness)
    if len(models) != len(emits) or not emits:
        fail(f"[async] {staleness} buffer {buffer_goal}: {len(emits)} emissions, the replay "
             f"of {len(arrivals)} arrivals gives {len(models)}")
    for k, (model, got) in enumerate(zip(models, emits)):
        if not np.array_equal(model.view(np.uint8), got):
            fail(f"[async] {staleness} buffer {buffer_goal}: emission {k} is not bitwise the "
                 "replay of the arrivals")
    return history, wall, spans, launches, arrivals, records


def _tree_run(torch, argv):
    """``argv`` (a ``--server_mode tree`` run): every global the root closed
    a round with, and every upload a tier's tally took (worker index, bytes,
    n, in its tier's arrival order)."""
    from fedml_tpu_torch.async_agg import tree

    globals_, uploads = [], []

    def keep_global(original):
        def aggregate(self):
            out = original(self)
            globals_.append(np.array(out))
            return out
        return aggregate

    def keep_upload(original):
        def add(self, index, flat, n):
            uploads.append((index, np.array(flat), float(n)))
            return original(self, index, flat, n)
        return add

    def keep_fold(original):
        def fold(self, index, payload, weight, upload_version):
            uploads.append((index, np.array(payload).view(np.uint8), float(weight)))
            return original(self, index, payload, weight, upload_version)
        return fold

    history, wall, spans, launches = _spanned_cli(
        torch, argv, (tree.TierAggregator, "aggregate", keep_global),
        (tree.TierAggregator, "add_local_trained_result", keep_upload),
        (tree.TierAggregator, "fold_async", keep_fold))
    return history, wall, spans, launches, globals_, uploads


def _async_jobs(torch, data_dir, mnist_dir, solo_flagship):
    """(e) ``--jobs`` with the flagship and BASELINE row 1 (MNIST + LR, the
    LEAF fixture, 10 of 1000 clients) on one loopback wire, 1 round each:
    each job's global bitwise the f64 weighted mean of its own arrivals,
    each rank's upload bitwise its solo run's (the flagship's: ``[transports]``'
    run over shm; row 1's: a solo CLI run here)."""
    from fedml_tpu_torch.algorithms import fedavg_distributed as tfd

    def capture(into_up, into_glob):
        def keep_upload(original):
            def add(self, index, flat, n):
                into_up.append((index, np.array(flat), float(n)))
                return original(self, index, flat, n)
            return add

        def keep_global(original):
            def aggregate(self):
                out = original(self)
                into_glob.append(np.array(out))
                return out
            return aggregate

        return ((tfd.FedAvgDistAggregator, "add_local_trained_result", keep_upload),
                (tfd.FedAvgDistAggregator, "aggregate", keep_global))

    m = MNIST
    solo_up, solo_glob = [], []
    _, solo_s, _, solo_launch = _spanned_cli(
        torch, _mnist_argv(mnist_dir, 1, 1, "--backend", "loopback"),
        *capture(solo_up, solo_glob))
    jobs = [{"job_id": "flagship"},
            {"job_id": "mnist_lr", "dataset": "mnist", "model": "lr", "data_dir": str(mnist_dir),
             "client_num_in_total": m["clients"], "client_num_per_round": m["per_round"],
             "batch_size": m["batch"], "lr": m["lr"], "wd": 0.0, "epochs": m["epochs"],
             "comm_round": 1, "frequency_of_the_test": 1, "model_dtype": "float32"}]
    path = BUILD_DIR / "async_jobs.json"
    path.write_text(json.dumps(jobs))
    ups, globs = [], []
    history, wall, spans, launches = _spanned_cli(
        torch, _async_argv(data_dir, 1, "--jobs", str(path)), *capture(ups, globs))
    flag_bytes = next(iter(solo_flagship.values())).nbytes
    for name, solo in (("flagship", solo_flagship),
                       ("mnist_lr", {i: flat for i, flat, _ in solo_up})):
        size = next(iter(solo.values())).nbytes
        mine = [u for u in ups if u[1].nbytes == size]
        glob = [g for g in globs if g.nbytes == size]
        if len(mine) != len(solo) or len(glob) != 1:
            fail(f"[async] (e) job {name}: {len(mine)} uploads, {len(glob)} globals")
        if not np.array_equal(_f64_mean(mine), glob[0]):
            fail(f"[async] (e) job {name}: the global is not the f64 weighted mean of its "
                 "arrivals")
        if any(not np.array_equal(flat, solo[i]) for i, flat, _ in mine):
            fail(f"[async] (e) job {name}: an upload differs from the same rank's solo upload")
    recs = {rec["job"]: rec for rec in history}
    if not all(np.isfinite([r["Test/Acc"], r["Test/Loss"]]).all() for r in recs.values()):
        fail(f"[async] (e) non-finite eval {recs}")
    log(f"[async] (e) --jobs flagship ({len(solo_flagship)} silos, {flag_bytes} bytes an "
        f"upload) + row 1 MNIST + LR ({m['per_round']} of {m['clients']} clients) on one "
        f"loopback wire, 1 round each: {wall:.2f} s (row 1 solo {solo_s:.2f} s); each job's "
        f"global == the f64 mean of its arrivals, each upload == its solo run's: bitwise; "
        + "; ".join(f"{j} Test/Acc {r['Test/Acc']:.4f}" for j, r in sorted(recs.items()))
        + "; " + _span_line(spans, ("comm/send", "comm/recv", "tenancy/dispatch")))
    return {k: launches[k] + solo_launch[k] for k in launches}


def _async_sim(torch, mnist_dir):
    """(f) ``run_multi_job_sim`` over two FedSim engines on the card, each
    BASELINE row 1 at full width (MNIST + LR on the LEAF fixture, 10 of 1000
    clients a round, B=10, the CLI's trainer; seeds 5 and 9 over the row's
    one partition, each engine with its own model), each round dispatched
    alone: each job's per-round globals, metric records and final variables
    bitwise its solo run's (``FedSim.run`` of the same engine, before; the
    co-schedule starts each job afresh from its seed)."""
    from fedml_tpu_torch.data import registry
    from fedml_tpu_torch.exp import main_fedavg
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.sim import engine
    from fedml_tpu_torch.tenancy import run_multi_job_sim

    m, rounds = MNIST, ASYNC["sim_rounds"]
    per_round: dict = {}

    def keep_round(original):
        def run_staged_round(self, staged, variables, server_state=()):
            out = original(self, staged, variables, server_state)
            per_round.setdefault(id(self), []).append(
                {k: v.detach().cpu().clone() for k, v in out[0].items()})
            return out
        return run_staged_round

    def build(seed):
        # the row's partition, read once for the script (``_loaded_once``)
        ds = registry.load_partition_data("mnist", str(mnist_dir), "hetero", 0.5,
                                          m["clients"], 0)
        args = main_fedavg.add_args(argparse.ArgumentParser()).parse_args(
            _mnist_argv(mnist_dir, rounds, rounds))
        model = create_model("lr", ds.class_num, "mnist", dtype=args.model_dtype,
                             device="cuda", input_shape=tuple(ds.train.arrays["x"].shape[1:]))
        cfg = engine.SimConfig(client_num_in_total=ds.train.num_clients,
                               client_num_per_round=m["per_round"], batch_size=m["batch"],
                               comm_round=rounds, epochs=m["epochs"],
                               frequency_of_the_test=rounds, seed=seed, pipeline_depth=0,
                               block_dispatch=False)
        return engine.FedSim(main_fedavg.build_trainer(args, model, "mnist"), ds.train,
                             ds.test_arrays, cfg, device="cuda")

    specs = {"a": 5, "b": 9}
    _zero_flash_counters()
    t0 = time.perf_counter()
    with _wrapped(engine.FedSim, "run_staged_round", keep_round):
        sims = {name: build(seed) for name, seed in specs.items()}
        build_s = time.perf_counter() - t0
        solo = {}
        for name, sim in sims.items():
            final, hist = sim.run()
            solo[name] = (final, hist, per_round.pop(id(sim)))
        solo_s = time.perf_counter() - t0 - build_s
        t1 = time.perf_counter()
        results = run_multi_job_sim(sims)
        torch.cuda.synchronize()
        co_s = time.perf_counter() - t1
    for name, sim in sims.items():
        res = results[name]
        if not res.ok:
            fail(f"[async] (f) job {name} failed: {res.error!r}")
        final, hist, rounds_solo = solo[name]
        rounds_co = per_round.pop(id(sim))
        if len(rounds_co) != rounds or len(rounds_solo) != rounds or any(
                not torch.equal(a[k], b[k]) for a, b in zip(rounds_co, rounds_solo) for k in a):
            fail(f"[async] (f) job {name}: a round's global differs from the solo run's")
        if any(not torch.equal(final[k].cpu(), res.final[k].cpu()) for k in final):
            fail(f"[async] (f) job {name}: the final variables differ from the solo run's")
        solo_recs = [{k: v for k, v in rec.items() if k != "round_time"} for rec in hist]
        if solo_recs != res.rounds:
            fail(f"[async] (f) job {name}: the metric records differ from the solo run's")
    log(f"[async] (f) run_multi_job_sim, two row-1 FedSim engines ({m['per_round']} of "
        f"{m['clients']} clients a round, {rounds} rounds each, per-round dispatch) on the "
        f"card: {co_s:.2f} s co-scheduled, {solo_s:.2f} s for both solo runs, {build_s:.2f} s "
        f"to build both; per-round globals, records and finals == solo: bitwise; final "
        f"Test/Acc " + ", ".join(
            f"{n} {results[n].rounds[-1]['Test/Acc']:.4f}" for n in specs))
    return _flash_launches()


def phase_async(torch, mnist_dir, solo_flagship):
    """The barrier-free server plane and the job plane on the card, the
    flagship at ``TRANSPORTS``' depth under deterministic algorithms: (a)
    async at a full buffer, const, 2 versions: every emission bitwise the
    port's ``replay_async_schedule`` of the arrivals, each version-0 upload
    bitwise the same rank's in ``[transports]``; (b) a buffer of 2,
    ``poly:0.5``, 4 versions: every emission bitwise the replay; (c) the
    1-tier tree ``(1, 4)``: the root's global bitwise the f64 mean of the
    edge's arrivals, each upload bitwise ``[transports]``'; (d) the ``(2,
    2)`` ladder: the sync tree, async edges at a buffer of 2 and the
    none-coded tier uplink bitwise alike per round, and the sync tree over
    shm bitwise over loopback; (e) ``--jobs``; (f) ``run_multi_job_sim``.
    Returns each path's flash launches (each must be 0)."""
    c = ASYNC
    data_dir = _wire_fixture()
    launches = {}
    # (a)
    hist, wall, spans, launches["async_full"], arrivals, _ = _async_server_run(
        torch, _async_argv(data_dir, c["versions_full"]), TRANSPORTS["per_round"], "const")
    v0 = {i: flat for i, flat, _, v in arrivals if v == 0}
    if v0.keys() != solo_flagship.keys() or any(
            not np.array_equal(v0[i], solo_flagship[i]) for i in v0):
        fail("[async] (a) a version-0 upload differs from the same rank's in [transports]")
    if not all(np.isfinite([hist[-1]["Test/Acc"], hist[-1]["Test/Loss"]])):
        fail(f"[async] (a) non-finite eval {hist[-1]}")
    log(f"[async] (a) --server_mode async --buffer_goal {TRANSPORTS['per_round']} "
        f"--staleness_weight const, {c['versions_full']} versions: {len(arrivals)} arrivals "
        f"(worker, version) {[(i + 1, v) for i, _, _, v in arrivals]}, {wall:.2f} s; every "
        f"emission == replay_async_schedule: bitwise; version-0 uploads == [transports]': "
        f"bitwise; Test/Acc {hist[-1]['Test/Acc']:.4f}; "
        + _span_line(spans, ("comm/send", "comm/recv", "async/fold", "async/emit")))
    # (b)
    hist, wall, spans, launches["async_half"], arrivals, records = _async_server_run(
        torch, _async_argv(data_dir, c["versions_half"]), c["half_buffer"],
        c["half_staleness"])
    log(f"[async] (b) --buffer_goal {c['half_buffer']} --staleness_weight "
        f"{c['half_staleness']}, {c['versions_half']} versions: {len(arrivals)} arrivals "
        f"(worker, version) {[(i + 1, v) for i, _, _, v in arrivals]}, {wall:.2f} s; every "
        f"emission == replay_async_schedule: bitwise; per emission (stale folds, fold "
        f"weights): {[(r['stale_folds'], r['fold_weights']) for r in records]}; "
        + _span_line(spans, ("comm/send", "comm/recv", "async/fold", "async/emit")))
    # (c)
    per = TRANSPORTS["per_round"]
    hist, wall, spans, launches["async_tree"], globs, ups = _tree_run(
        torch, _async_argv(data_dir, c["tree_rounds"], "--server_mode", "tree",
                           "--tree_fan_ins", f"1,{per}"))
    if len(globs) != c["tree_rounds"] or not np.array_equal(_f64_mean(ups[:per]), globs[0]):
        fail("[async] (c) the root's global is not the f64 mean of the edge's arrivals")
    if any(not np.array_equal(flat, solo_flagship[i]) for i, flat, _ in ups[:per]):
        fail("[async] (c) a leaf's upload differs from the same rank's in [transports]")
    log(f"[async] (c) --server_mode tree --tree_fan_ins 1,{per}: {wall:.2f} s, the edge's "
        f"arrivals {[i + 1 for i, _, _ in ups[:per]]}; root global == f64 mean of them: "
        f"bitwise; uploads == [transports]': bitwise; Test/Acc {hist[-1]['Test/Acc']:.4f}; "
        + _span_line(spans, ("comm/send", "comm/recv", "tree/fold", "tree/forward")))
    # (d)
    ladder = {}
    for name, rounds, extra in (
            ("sync", c["ladder_rounds"], []),
            ("async edges", c["ladder_rounds"], ["--buffer_goal", "2"]),
            ("none-coded uplink", c["ladder_rounds"], ["--buffer_goal", "2",
                                                       "--tier_compressor", "none"]),
            ("sync over shm", c["shm_rounds"], ["--tree_transport", "shm"])):
        hist, wall, spans, launch, globs, ups = _tree_run(torch, _async_argv(
            data_dir, rounds, "--server_mode", "tree", "--tree_fan_ins", "2,2", *extra))
        launches[f"async_ladder_{name.replace(' ', '_')}"] = launch
        ladder[name] = globs
        if len(globs) != rounds:
            fail(f"[async] (d) {name}: {len(globs)} round closes")
        log(f"[async] (d) (2, 2) {name}: {rounds} round(s) in {wall:.2f} s, "
            f"Test/Acc {hist[-1]['Test/Acc']:.4f}; "
            + _span_line(spans, ("comm/send", "comm/recv", "tree/fold", "tree/forward")))
    for name, globs in ladder.items():
        if any(not np.array_equal(a, b) for a, b in zip(globs, ladder["sync"])):
            fail(f"[async] (d) {name} differs from the sync (2, 2) tree")
    log("[async] (d) (2, 2) ladder: async edges == none-coded uplink == sync tree, bitwise "
        "per round and at the end; shm == loopback: bitwise (its round)")
    torch.cuda.empty_cache()
    launches["async_jobs"] = _async_jobs(torch, data_dir, mnist_dir, solo_flagship)
    launches["async_sim"] = _async_sim(torch, mnist_dir)
    return launches


def _timed(name, fn, *args):
    """``fn(*args)``, its seconds printed under the phase's name."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {name}: {time.perf_counter() - t0:.2f} s")
    return out


def main() -> None:
    import torch

    from fedml_tpu_torch.ops import attention  # noqa: F401  (fails outside the repo)

    t_start = time.perf_counter()
    smi = phase_device(torch)
    _timed("build", phase_build)
    errors = _timed("kernel_vs_plain", phase_kernel_vs_plain, torch)
    _timed("gradient", phase_gradient, torch)
    _timed("e2e scan", phase_small_end_to_end, torch, "scan")
    launches, cli_launches = {}, {}
    for config in (MAIN, MAIN_F32):
        run = _timed(f"main {config['dtype']}", phase_main_path, torch, config)
        launches.update({name: n for name, n in run.items()
                         if KERNELS[name]["dtype"] == config["dtype"]})
        torch.cuda.empty_cache()
        if config is MAIN:
            cli_launches["lm_remat"] = _timed("lm remat", phase_lm_remat, torch)
            torch.cuda.empty_cache()
    times = _timed("kernel_times", phase_kernel_times, torch)
    small_vmap_launches = _timed("e2e vmap", phase_small_end_to_end, torch, "vmap")
    _timed("resnet small", phase_small_resnet, torch)
    plain_flagship_s = _timed("cross_silo", phase_cross_silo, torch)
    loads = []
    cli_launches["zoo_small"] = _timed("zoo small", phase_zoo_small, torch)
    cli_launches["cross_silo_zoo"] = _timed("cross_silo zoo", phase_cross_silo_zoo, torch)
    cli_launches["resnet18_gn"] = _timed("resnet18_gn", phase_resnet18_gn, torch)
    cli_launches["fedgkt"] = _timed("fedgkt", phase_fedgkt, torch)
    cli_launches["fedseg"] = _timed("fedseg", phase_fedseg, torch, smi)
    cli_launches["vision_fed"] = _timed("vision_fed", phase_vision_fed, torch)
    cli_launches["dol"] = _timed("dol", phase_dol, torch)
    with _loaded_once(loads):
        cli_launches["repro_mnist_lr"], mnist_dir, records = _timed(
            "repro_mnist_lr", phase_repro_mnist_lr, torch)
        cli_launches["mnist_lr"] = _timed("mnist_lr", phase_mnist_lr, torch, mnist_dir, records)
        cli_launches["fedprox_lr"] = _timed("fedprox", phase_fedprox_stragglers, torch,
                                            mnist_dir)
        cli_launches["fednova"] = _timed("fednova", phase_fednova, torch, mnist_dir)
        cli_launches["hierarchical"] = _timed("hierarchical", phase_hierarchical, torch,
                                              mnist_dir)
        cli_launches["trace"] = _timed("trace", phase_trace, torch, mnist_dir)
        cli_launches["gossip"] = _timed("gossip", phase_gossip, torch, mnist_dir)
        cli_launches["fedgan"] = _timed("fedgan", phase_fedgan, torch, mnist_dir)
        cli_launches["split_vertical"] = _timed("split and vertical", phase_split_and_vertical,
                                                torch, mnist_dir)
        cli_launches.update(_timed("wire", phase_wire, torch, mnist_dir, plain_flagship_s))
        transports_launches, solo_flagship = _timed("transports", phase_transports, torch)
        cli_launches.update(transports_launches)
        cli_launches.update(_timed("async", phase_async, torch, mnist_dir, solo_flagship))
    log(f"[mnist] the row's 1000-client LEAF JSON loaded once in {loads[0]:.2f} s for its "
        f"runs (repro, four CLI, FedProx, FedNova, hierarchical, trace, gossip, fedgan, "
        f"splitnn, wire, async)")
    femnist_loads = []
    with _loaded_once(femnist_loads):
        cli_launches["femnist_cnn"] = _timed("femnist_cnn", phase_femnist_cnn, torch)
        cli_launches["femnist_blocks"], femnist_runs = _timed("femnist blocks",
                                                              phase_femnist_blocks, torch)
        cli_launches["packed_femnist"] = _timed("packed femnist", phase_packed_femnist, torch,
                                                femnist_runs)
        cli_launches["population"] = _timed("population", phase_population, torch)
        cli_launches["robust"], median_run, saved = _timed("robust", phase_robust, torch,
                                                           femnist_runs)
        cli_launches["compress"] = _timed("compress", phase_compress, torch, femnist_runs,
                                          plain_flagship_s)
        cli_launches["checkpoint"] = _timed("checkpoint", phase_checkpoint, torch, mnist_dir,
                                            median_run[-1], saved)
    log(f"[femnist] the 3400-client fallback built in {femnist_loads[0]:.2f} s, "
        f"{len(femnist_loads)} time(s) for the FEMNIST phases' CLI runs")
    cli_launches["packed_overflow"] = _timed("packed overflow", phase_packed_overflow, torch)
    cli_launches["cli_transformer"] = _timed("small card vs cpu", phase_small_card_vs_cpu,
                                             torch)
    cli_launches["blocks_small"] = _timed("blocks small", phase_blocks_small, torch)
    cli_launches["rnn_small"] = _timed("rnn small", phase_rnn_small, torch)
    cli_launches["shakespeare_cli"] = _timed("shakespeare cli", phase_shakespeare_cli, torch,
                                             smi)
    cli_launches["fedopt"] = _timed("fedopt", phase_fedopt, torch, smi)
    cli_launches["repro_shakespeare"] = _timed("repro_shakespeare", phase_repro_shakespeare,
                                               torch, smi)
    cli_launches["so_nwp"] = _timed("so_nwp", phase_so_nwp, torch, smi)
    cli_launches["so_lr"] = _timed("so_lr", phase_so_lr, torch)
    cli_launches["fednas_small"] = _timed("fednas small", phase_fednas_small, torch)
    cli_launches["fednas"], cli_launches["fednas_unrolled"] = _timed("fednas", phase_fednas,
                                                                     torch, smi)
    for path in ("femnist_blocks", "packed_femnist", "population", "packed_overflow",
                 "blocks_small", "rnn_small", "shakespeare_cli",
                 "repro_shakespeare", "so_nwp", "so_lr", "fednas_small", "fednas",
                 "fednas_unrolled", "fedopt", "fednova", "robust", "hierarchical",
                 "checkpoint", "trace", "zoo_small", "cross_silo_zoo", "resnet18_gn",
                 "compress", "gossip", "fedgan", "split_vertical", "fedgkt", "fedseg",
                 "vision_fed", "dol", "wire_sim", "wire_flagship", "wire_mnist",
                 "wire_families", "transports_shm", "transports_mqtt_s3", "transports_grpc",
                 "transports_robust", "transports_heartbeats", "async_full", "async_half",
                 "async_tree", "async_ladder_sync", "async_ladder_async_edges",
                 "async_ladder_none-coded_uplink", "async_ladder_sync_over_shm", "async_jobs",
                 "async_sim"):
        if any(cli_launches[path].values()):
            fail(f"the {path} path launched the flash kernels: {cli_launches[path]}")
    kernels = [{
        "name": name, "route": "cuda", "source": spec["source"], "replaces": KERNEL_REPLACES,
        "dtype": spec["dtype"], "launches": launches[name], "max_abs_err": errors[name],
        "launches_small_vmap_lm": small_vmap_launches if spec["dtype"] == "float32" else 0,
        "launches_cli_paths": {path: counts[name] for path, counts in cli_launches.items()},
        **times[name],
    } for name, spec in KERNELS.items()]
    log(f"[phase] all: {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
