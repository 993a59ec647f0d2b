"""Where a train step of the full-width LM spends its time on the card.

Run on a machine with an NVIDIA card, from the repository root::

    python3 -m fedml_tpu_torch.breakdown

It builds the main path's model (TransformerLM D=2048, L=8, H=16, T=1024,
V=32000, bf16 compute, flash attention) and times the pieces of the
``cohort_execution="scan"`` round, the mode the full-width LM runs in (as
the JAX LM bench asks for it, ``bench.py:166``), with CUDA events, each the
mean over a few repetitions after a warm-up:

- one client train step, split into forward plus loss, backward, and the
  SGD-momentum update;
- one layer's attention at the step's shape: the bf16 flash kernel forward
  (``csrc/flash_fwd_sm90.cu``) on strided q/k/v views of one qkv projection,
  as the model hands them over, and the torch blockwise backward;
- the per-client work around the steps: loading the global variables into
  the module, copying the trained variables out, and folding one client into
  the weighted mean.

It prints the card's name and power limit, then one JSON object.

``python3 -m fedml_tpu_torch.breakdown resnet56`` does the same for the
cross-silo flagship's step (ResNet-56, bf16, 10 clients x B=64, weight-decay
SGD, augmentation): one vmapped cohort step (``make_vmap_train``) and one
client's step in scan (``make_local_train``), each timed with CUDA events
over a few steps after a warm-up, and each traced once with
``torch.profiler``: the device time its kernels took, against the step's
time the share of it the device sat idle, its kernel count and its costliest
kernels.
"""

from __future__ import annotations

import json
import subprocess

import torch

from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.trainer import ClientTrainer, lm_loss, sgd
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.ops import attention as attn

CONFIG = dict(vocab=32000, embed_dim=2048, num_layers=8, num_heads=16, seq=1024, batch=8)


def _events_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(reps: int = 5) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("fedml_tpu_torch.breakdown needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    c = CONFIG
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = create_model("transformer", c["vocab"], dtype=torch.bfloat16,
                         embed_dim=c["embed_dim"], num_layers=c["num_layers"],
                         num_heads=c["num_heads"], max_len=c["seq"], attn_impl="flash")
    trainer = ClientTrainer(module=model, task="nwp", optimizer=sgd(0.01, momentum=0.9))
    variables = trainer.init(gen)
    shape = (c["batch"], c["seq"])
    batch = {"x": torch.randint(0, c["vocab"], shape, device="cuda", generator=gen),
             "y": torch.randint(0, c["vocab"], shape, device="cuda", generator=gen),
             "mask": torch.ones(shape, device="cuda")}
    opt = trainer.optimizer(model.parameters())
    model.train()
    times = {"forward_loss": 0.0, "backward": 0.0, "optimizer": 0.0}
    for rep in range(reps + 2):  # two warm-up steps, not recorded
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss = lm_loss(model(batch["x"]), batch)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        if rep >= 2:
            for i, k in enumerate(times):
                times[k] += ev[i].elapsed_time(ev[i + 1]) / reps
    step_ms = sum(times.values())

    h, d = c["num_heads"], c["embed_dim"] // c["num_heads"]
    qkv = torch.randn(c["batch"], c["seq"], 3 * h * d, device="cuda", generator=gen,
                      dtype=torch.float32).to(torch.bfloat16)
    q, k, v = (a.reshape(c["batch"], c["seq"], h, d).transpose(1, 2)
               for a in qkv.split(h * d, dim=-1))
    g = torch.randn(q.shape, device="cuda", generator=gen).to(torch.bfloat16)
    scale = d ** -0.5
    mha = model.blocks[0].attn
    out = attn._flash_fwd(q, k, v, True, scale, mha.block_q, mha.block_k)
    attn_fwd_ms = _events_ms(
        lambda: attn._flash_fwd(q, k, v, True, scale, mha.block_q, mha.block_k), reps)
    attn_bwd_ms = _events_ms(
        lambda: attn._blockwise_bwd(q, k, v, out, g, True, scale, mha.block_k), reps)

    trained = {name: t.detach().clone() for name, t in model.state_dict().items()}
    load_ms = _events_ms(lambda: model.load_state_dict(variables), reps)
    copy_ms = _events_ms(lambda: {n: t.detach().clone() for n, t in model.state_dict().items()},
                         reps)
    weights = torch.tensor([1.0, 1.0], device="cuda")
    fold_ms = _events_ms(lambda: treelib.weighted_mean(iter([trained, trained]), weights),
                         reps) / 2

    layers = c["num_layers"]
    result = {
        "config": c, "reps": reps, "step_ms": step_ms,
        **{f"{name}_ms": ms for name, ms in times.items()},
        "attn_fwd_kernel_ms_per_layer": attn_fwd_ms, "attn_bwd_torch_ms_per_layer": attn_bwd_ms,
        "attn_ms_per_step": layers * (attn_fwd_ms + attn_bwd_ms),
        "rest_of_forward_backward_ms": times["forward_loss"] + times["backward"]
        - layers * (attn_fwd_ms + attn_bwd_ms),
        "load_global_ms": load_ms, "copy_trained_ms": copy_ms, "fold_one_client_ms": fold_ms,
        "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(result), flush=True)
    return result


RESNET = dict(clients=10, batch=64, steps=4, warmup_steps=2)


def _profile(fn):
    """Run ``fn`` once under ``torch.profiler``: (wall ms, device ms of its
    kernels, kernel launches, the five costliest kernels as (name, ms))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return (start.elapsed_time(end), sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels),
            [(e.key[:80], e.self_device_time_total / 1e3) for e in top])


def resnet_main(reps: int = 3) -> dict:
    """The flagship's vmapped cohort step and scan client step, by parts."""
    from fedml_tpu_torch.core.trainer import make_local_train, make_vmap_train
    from fedml_tpu_torch.ops.augment import ImageAugment, round_generator

    if not torch.cuda.is_available():
        raise SystemExit("fedml_tpu_torch.breakdown needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    c = RESNET
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = create_model("resnet56", 10, dtype=torch.bfloat16)
    aug = ImageAugment()
    trainer = ClientTrainer(module=model, optimizer=sgd(0.001, weight_decay=0.001),
                            augment=aug)
    variables = trainer.init(gen)
    n, s, b = c["clients"], c["steps"], c["batch"]
    data = {"x": torch.randn(n, s, b, 32, 32, 3, device="cuda", generator=gen),
            "y": torch.randint(0, 10, (n, s, b), device="cuda", generator=gen),
            "mask": torch.ones(n, s, b, device="cuda")}
    draws = [aug.draw(round_generator(0, 0, i), (1, s, b), (32, 32)) for i in range(n)]
    draws = {k: torch.stack([d[k] for d in draws]).cuda() for k in draws[0]}
    budget = torch.full((n,), s, device="cuda")
    vmap_train, local_train = make_vmap_train(trainer), make_local_train(trainer)

    def vmap_round():
        return vmap_train(variables, data, budget, draws)

    def scan_client():
        return local_train(variables, {k: v[0] for k, v in data.items()}, s,
                           {k: v[0] for k, v in draws.items()})

    result = {"config": c, "device": torch.cuda.get_device_name(0)}
    for name, fn, images in (("vmap", vmap_round, n * b), ("scan", scan_client, b)):
        for _ in range(c["warmup_steps"]):
            fn()
        step_ms = _events_ms(fn, reps) / s
        wall, device, launches, top = _profile(fn)
        # the profiler slows the host, not the kernels: the idle share is
        # taken against the step's time without it
        result[name] = {
            "step_ms": step_ms, "images_per_step": images,
            "profiled_wall_ms_per_step": wall / s, "device_ms_per_step": device / s,
            "device_idle_share": 1 - device / s / step_ms,
            "kernel_launches_per_step": launches / s,
            "top_kernels_ms_per_step": [(k, ms / s) for k, ms in top],
        }
    result["vmap_over_scan_per_image"] = (result["vmap"]["step_ms"] / (n * b)) / (
        result["scan"]["step_ms"] / b)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    import sys

    resnet_main() if sys.argv[1:] == ["resnet56"] else main()
