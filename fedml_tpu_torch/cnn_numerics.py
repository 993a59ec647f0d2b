"""Why two f32 runs of the FedAvg CNNs part, and what the one-channel conv's
training path costs.

Run on a machine with an NVIDIA card, from the repository root::

    python3 -m fedml_tpu_torch.cnn_numerics

TF32 is off, as in ``chip_smoke.py``. Each model runs in two forms of its
one-input-channel conv in training: ``cudnn`` (the port's ``Conv``:
``F.conv2d``, as XLA would call cuDNN for the JAX package on the card) and
``im2col`` (that conv as unfold and a GEMM, with ``F.conv2d`` kept for
multi-channel convs and for eval). It prints:

- ``[wgrad]``: the weight gradient of each conv of ``CNNOriginalFedAvg`` at
  a real step's input and upstream gradient, by cuDNN on the card, by the
  im2col GEMM on the card and by the CPU in f32, each against float64 on the
  CPU (max error over the gradient's max magnitude);
- ``[lockstep]``: 40 SGD steps (B=16, lr 0.05) of ``cnn_original`` and of
  ``cnn`` at dropout rate 0, each step taken on the card and on the CPU from
  the same parameters (the CPU's, which then step on). For every step: the
  largest gradient gap; the max-pool windows whose argmax, taken by each
  device's own pooling kernel, differs between the card and the CPU while
  their maximum is positive (a window whose two largest inputs lie within
  rounding, or tie, sends its gradient to either); and the conv outputs on
  opposite sides of ReLU's kink;
- ``[small]``: the small FedAvg run ``chip_smoke.py`` holds the card to
  (8 clients, 4 a round, B=16, SGD 0.05, 2 rounds, vmap), card against
  CPU, free-running and round by round from the same variables;
- ``[femnist]``: the FEMNIST + CNNDropOut row through the CLI (3400
  clients, 10 a round, B=20, SGD 0.1), 4 rounds, eval every 2, in turns
  im2col, cudnn, cudnn, im2col; the second window's per-round time.

``[lockstep]`` and ``[small]`` run from weights drawn by the card's
generator (as ``chip_smoke.py`` draws them) and by the CPU's.
``--devices cpu,cpu`` runs the first three on the CPU twice (no gap).
It prints the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.models import cnn as cnnlib

LR, BATCH, STEPS = 0.05, 16, 40
# the convs whose ReLU output a 2x2 max-pool takes
POOLED = {"cnn_original": ("conv_0", "conv_1"), "cnn": ("conv_1",)}
_PORT_FORWARD = cnnlib.Conv.forward


def _im2col_forward(self, x):
    """A one-channel conv under autograd as unfold and a GEMM (its weight
    gradient an f32 sum of k*k products); cuDNN otherwise."""
    x, weight, bias = x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype)
    if weight.shape[1] > 1 or not torch.is_grad_enabled():
        return F.conv2d(x, weight, bias, padding=self.padding)
    k = weight.shape[-1]
    h, w = (n + 2 * self.padding - k + 1 for n in x.shape[-2:])
    cols = F.unfold(x, k, padding=self.padding)  # [N, k*k, H*W]
    out = weight.reshape(weight.shape[0], -1) @ cols + bias[:, None]
    return out.reshape(x.shape[0], weight.shape[0], h, w)


@contextlib.contextmanager
def conv_path(name):
    """Train the one-channel convs as im2col (``"im2col"``) or as the port
    does (``"cudnn"``)."""
    cnnlib.Conv.forward = _im2col_forward if name == "im2col" else _PORT_FORWARD
    try:
        yield
    finally:
        cnnlib.Conv.forward = _PORT_FORWARD


def _model(name, device):
    from fedml_tpu_torch.models.registry import create_model

    kwargs = {"dropout_rates": (0.0, 0.0)} if name == "cnn" else {}
    return create_model(name, 62, "femnist", device=device, **kwargs)


def _data():
    from fedml_tpu_torch.data.leaf import synthetic_leaf_mnist

    train, _, _ = synthetic_leaf_mnist(n_clients=8, seed=0)
    rs, n = np.random.RandomState(0), len(train.arrays["y"])  # two shuffled epochs
    order = np.concatenate([rs.permutation(n), rs.permutation(n)])[:STEPS * BATCH]
    return (torch.tensor(train.arrays["x"][order]).reshape(STEPS, BATCH, 28, 28),
            torch.tensor(train.arrays["y"][order]).reshape(STEPS, BATCH).long())


def _step(model, params, x, y, pooled=()):
    """Load ``params``, run one forward and backward: (grads, {conv: (input,
    output, output grad, pool argmax or None)}) for every conv; the argmax
    of the 2x2 max-pool of the ReLU output, for the convs in ``pooled``, is
    taken by the device's own pooling kernel, as the model's forward takes
    it."""
    from fedml_tpu_torch.core.trainer import classification_loss

    model.load_state_dict(params)
    model.zero_grad(set_to_none=True)
    seen = {}

    def hook(name):
        def save(mod, args, out):
            out.retain_grad()
            seen[name] = (args[0].detach(), out)
        return save

    handles = [getattr(model, n).register_forward_hook(hook(n))
               for n in ("conv_0", "conv_1")]
    try:
        logits = model(x, train=True)
        loss = classification_loss(logits, {"y": y, "mask": torch.ones_like(y).float()})
        loss.backward()
    finally:
        for h in handles:
            h.remove()
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    out = {}
    for n, (i, o) in seen.items():
        arg = (F.max_pool2d(F.relu(o.detach()), 2, 2, return_indices=True)[1].cpu()
               if n in pooled else None)
        out[n] = (i.cpu(), o.detach().cpu(), o.grad.cpu(), arg)
    return grads, out


def _pool_flips(pre_b, arg_a, arg_b):
    """Max-pool windows whose argmax differs between the two devices while
    the window's maximum is positive (a ReLU-zero window routes no
    gradient); and the largest gap between the two top inputs of such a
    window (the b side's values)."""
    flipped = (arg_a != arg_b) & (F.max_pool2d(F.relu(pre_b), 2, 2) > 0)
    if not bool(flipped.any()):
        return 0, 0.0
    windows = F.unfold(F.relu(pre_b).reshape(-1, 1, *pre_b.shape[-2:]), 2, stride=2)
    top2 = torch.topk(windows, 2, dim=1).values  # [N*C, 2, L]
    margin = (top2[:, 0] - top2[:, 1]).reshape(flipped.shape)
    return int(flipped.sum()), float(margin[flipped].max())


def _relu_flips(pre_a, pre_b):
    """Conv outputs on opposite sides of ReLU's kink on the two devices."""
    return int(((pre_a > 0) != (pre_b > 0)).sum())


def phase_wgrad(devices):
    """The conv weight gradients at step 0 of cnn_original, against f64."""
    card, host = devices
    x, y = _data()
    model = _model("cnn_original", "cpu")
    params = {k: t.clone() for k, t in model.state_dict().items()}
    _, seen = _step(model, params, x[0], y[0])
    out = {}
    for name, (inp, _, dy, _) in seen.items():
        w = params[f"{name}.weight"]
        pad = getattr(model, name).padding
        ref = torch.nn.grad.conv2d_weight(inp.double(), w.shape, dy.double(), padding=pad)
        scale = float(ref.abs().max())

        def rel(g):
            return float((g.double().cpu() - ref).abs().max()) / scale

        cudnn = torch.nn.grad.conv2d_weight(inp.to(card), w.shape, dy.to(card), padding=pad)
        cols = F.unfold(inp.to(card), w.shape[-1], padding=pad)  # [N, k*k*in, HW]
        dyc = dy.to(card).reshape(dy.shape[0], dy.shape[1], -1)
        gemm = torch.einsum("nol,nkl->ok", dyc, cols).reshape(w.shape)
        host_g = torch.nn.grad.conv2d_weight(inp.to(host), w.shape, dy.to(host), padding=pad)
        out[name] = {"in_channels": int(w.shape[1]), "cudnn_card": rel(cudnn),
                     "im2col_card": rel(gemm), "f32_cpu": rel(host_g)}
        print(f"[wgrad] cnn_original {name} ({w.shape[1]} in, {w.shape[0]} out, "
              f"{w.shape[-1]}x{w.shape[-1]}): max error / max |g| against float64: cuDNN on "
              f"the card {out[name]['cudnn_card']:.3e}, im2col GEMM on the card "
              f"{out[name]['im2col_card']:.3e}, f32 on the CPU {out[name]['f32_cpu']:.3e}",
              flush=True)
    return out


def phase_lockstep(devices, name, path, init):
    card, host = devices
    x, y = _data()
    models = {d: _model(name, d) for d in devices}
    params = {k: t.cpu().clone() for k, t in models[init].state_dict().items()}
    rows = []
    with conv_path(path):
        for s in range(STEPS):
            g_a, seen_a = _step(models[card], {k: t.to(card) for k, t in params.items()},
                                x[s].to(card), y[s].to(card), POOLED[name])
            g_b, seen_b = _step(models[host], params, x[s], y[s], POOLED[name])
            gap = max(float((g_a[k] - g_b[k]).abs().max()) for k in g_b)
            flips = [_pool_flips(seen_b[n][1], seen_a[n][3], seen_b[n][3])
                     for n in POOLED[name]]
            relu = sum(_relu_flips(seen_a[n][1], seen_b[n][1]) for n in seen_b)
            rows.append({"step": s, "grad_gap": gap, "flips": [f[0] for f in flips] + [relu],
                         "flip_margin": max(f[1] for f in flips)})
            params = {k: (t - LR * g_b[k]) if k in g_b else t for k, t in params.items()}
    clean = [r["grad_gap"] for r in rows if not any(r["flips"])]
    flipped = [r for r in rows if any(r["flips"])]
    summary = {
        "model": name, "conv_path": path, "init": init, "steps": STEPS,
        "max_grad_gap_no_flip": max(clean) if clean else None,
        "steps_with_flips": [r["step"] for r in flipped],
        "grad_gap_at_flips": [r["grad_gap"] for r in flipped],
        "flips": [r["flips"] for r in flipped],
        "max_flip_margin": max((r["flip_margin"] for r in flipped), default=None),
    }
    print(f"[lockstep] {name}, {path}, weights drawn on {init}: {STEPS} steps from the same parameters, card vs CPU; "
          f"max gradient gap at steps with no flip {summary['max_grad_gap_no_flip']:.3e}; "
          f"steps with flips {summary['steps_with_flips']} (flipped pool windows per pool "
          f"{POOLED[name]}, then ReLU sign flips: {summary['flips']}; top-two margin of a "
          f"flipped window <= {summary['max_flip_margin']}), their gradient gaps "
          f"{[f'{g:.3e}' for g in summary['grad_gap_at_flips']]}", flush=True)
    return summary


def _small_sim(model, device):
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.data.leaf import synthetic_leaf_mnist
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    train, test, _ = synthetic_leaf_mnist(n_clients=8, seed=0)
    trainer = ClientTrainer(module=_model(model, device), optimizer=sgd(LR), epochs=1)
    cfg = SimConfig(client_num_in_total=8, client_num_per_round=4, batch_size=BATCH,
                    comm_round=2, epochs=1, frequency_of_the_test=1, eval_batch_size=64,
                    seed=0, cohort_execution="vmap")
    return FedSim(trainer, train, test, cfg, device=device)


def _gap(a, b):
    return max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in b)


def phase_small(devices, name, path, init_on):
    card, host = devices
    with conv_path(path):
        sims = {d: _small_sim(name, d) for d in devices}
        init = {k: t.cpu() for k, t in sims[init_on].init_variables().items()}
        runs = {d: sim.run(variables={k: t.to(d) for k, t in init.items()})
                for d, sim in sims.items()}
        free = _gap(runs[card][0], runs[host][0])
        v, by_round = dict(init), []
        for r in range(2):
            out = {d: sim.run_round(r, {k: t.to(d) for k, t in v.items()})
                   for d, sim in sims.items()}
            by_round.append(_gap(out[card][0], out[host][0]))
            v = {k: t.cpu() for k, t in out[host][0].items()}
    print(f"[small] {name}, {path}, weights drawn on {init_on}: 2 vmapped FedAvg rounds, card vs CPU variables: "
          f"free-running {free:.3e}; each round from the same variables "
          f"{[f'{g:.3e}' for g in by_round]}", flush=True)
    return {"model": name, "conv_path": path, "init": init_on, "free_running": free,
            "by_round": by_round}


def phase_femnist():
    from fedml_tpu_torch.exp import main_fedavg as cli

    argv = ["--dataset", "femnist", "--model", "cnn", "--data_dir", "build/cnn_numerics",
            "--client_num_in_total", "3400", "--client_num_per_round", "10",
            "--batch_size", "20", "--lr", "0.1", "--epochs", "1", "--comm_round", "4",
            "--frequency_of_the_test", "2", "--device", "cuda"]
    out = []
    for path in ("im2col", "cudnn", "cudnn", "im2col"):
        args = cli.parse_with_config(cli.add_args(argparse.ArgumentParser()), argv)
        with conv_path(path):
            history = cli.run(args)
        out.append({"conv_path": path, "round_s": history[-1]["round_time"],
                    "first_window_round_s": history[0]["round_time"],
                    "train_loss": [h["Train/Loss"] for h in history]})
        print(f"[femnist] CNNDropOut, {path}: rounds 2-3 {out[-1]['round_s']:.4f} s a round "
              f"(rounds 0-1 {out[-1]['first_window_round_s']:.4f}); Train/Loss "
              f"{[f'{v:.5f}' for v in out[-1]['train_loss']]}", flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--devices", default="cuda,cpu",
                        help="the two devices compared (cpu,cpu checks the script)")
    args = parser.parse_args(argv)
    devices = tuple(args.devices.split(","))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if devices[0] == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    result = {"wgrad": phase_wgrad(devices), "lockstep": [], "small": []}
    for name in ("cnn_original", "cnn"):
        for path in ("cudnn", "im2col"):
            for init in devices:
                result["lockstep"].append(phase_lockstep(devices, name, path, init))
                result["small"].append(phase_small(devices, name, path, init))
    if devices[0] == "cuda":
        result["femnist"] = phase_femnist()
    result["seconds"] = time.perf_counter() - t0
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
