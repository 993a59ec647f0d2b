"""Where a train step of the full-width LM spends its time on the card.

Run on a machine with an NVIDIA card, from the repository root::

    python3 -m fedml_tpu_torch.breakdown

It builds the main path's model (TransformerLM D=2048, L=8, H=16, T=1024,
V=32000, bf16 compute, flash attention) and times with CUDA events, each the
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


if __name__ == "__main__":
    main()
