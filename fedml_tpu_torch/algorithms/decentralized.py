"""Decentralized (serverless) federated optimization, the port of
``fedml_tpu/algorithms/decentralized.py``.

Two capabilities from the reference:

1. The decentralized_framework template (fedml_api/distributed/
   decentralized_framework/algorithm_api.py:54-65): every rank is a worker on
   a ring/random topology exchanging models with neighbors. Here the whole
   neighbor exchange is ``mixed = W @ stacked``, one f32 matmul over the
   client axis per leaf, run by the engine's per-client mode
   (``sim/engine.py``: each client trains from its own model).
2. Gossip online learning (fedml_api/standalone/decentralized/): DSGD
   (client_dsgd.py:6) and Push-Sum over time-varying directed graphs
   (client_pushsum.py:7 with ω-weight bookkeeping :36-45), tracking regret on
   streaming data, with torch autograd for the logistic-loss gradients.

The mix runs in full f32: on the card it refuses to run while
``torch.backends.cuda.matmul.allow_tf32`` is set, which would round its
operands to TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.algorithms.base import Aggregator
from fedml_tpu_torch.device import resolve_device

StateDict = dict[str, torch.Tensor]


def _check_f32_matmul(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the gossip mix is an f32 matmul: torch.backends.cuda.matmul.allow_tf32 is "
            "True, which would round it to TF32; set it to False")


def mix(stacked: StateDict, mixing_matrix: torch.Tensor) -> StateDict:
    """One gossip exchange: for every leaf ``[C, ...]``, new_i = Σ_j W[i,j]·x_j,
    in f32, cast back to the leaf's dtype. This single matmul replaces the
    reference's per-neighbor message loop (decentralized_worker_manager.py
    handlers). ``mixing_matrix`` may carry only a block of rows ``[R, C]``."""
    W = mixing_matrix.float()
    _check_f32_matmul(W)
    out = {}
    for k, leaf in stacked.items():
        flat = leaf.reshape(leaf.shape[0], -1).float()
        mixed = W @ flat
        out[k] = mixed.reshape(mixed.shape[:1] + leaf.shape[1:]).to(leaf.dtype)
    return out


def gossip_aggregator(mixing_matrix: np.ndarray) -> Aggregator:
    """Decentralized 'aggregation': no global model; each client's next-round
    model is its neighborhood mixture of this round's locally-trained models.

    ``per_client=True``: the engine keeps the full stacked ``[C, ...]`` model
    set across rounds (each client trains from its OWN model, the property
    that distinguishes gossip from FedAvg), and this aggregate maps trained
    stack -> mixed stack. Slots past the matrix pass through untouched
    (identity mixing rows appended on the fly; the engine validates that
    real clients == the matrix order via ``num_clients``). The metric
    ``consensus_dist`` is the trained models' summed squared distance to
    their mean over the real clients, divided by their count: the quantity
    one gossip exchange then contracts. The matrix is put on the stack's
    device at the first round and kept there (a captured round reads it)."""
    W0 = np.asarray(mixing_matrix, np.float32)
    n = int(W0.shape[0])
    on_device: dict = {}

    def init_state(stacked_variables):
        return ()

    def matrix(c: int, device: torch.device) -> torch.Tensor:
        key = (c, str(device))
        if key not in on_device:
            W = W0
            if c > W0.shape[0]:  # slots past the matrix mix only with themselves
                W = np.eye(c, dtype=np.float32)
                W[: W0.shape[0], : W0.shape[1]] = W0
            on_device[key] = torch.as_tensor(W, device=device)
        return on_device[key]

    def aggregate(prev_stacked, stacked, weights, state, rng=None, extras=None):
        first = next(iter(stacked.values()))
        c = first.shape[0]
        dis = torch.zeros((), dtype=torch.float32, device=first.device)
        for leaf in stacked.values():
            f = leaf.reshape(c, -1).float()[:n]
            dis = dis + torch.sum((f - torch.mean(f, dim=0, keepdim=True)) ** 2)
        metrics = {"consensus_dist": dis / n}
        return mix(stacked, matrix(c, first.device)), state, metrics

    return Aggregator(init_state, aggregate, name="gossip", per_client=True, num_clients=n,
                      stacked=True)


# ---------------------------------------------------------------------------
# Gossip online learning (standalone/decentralized): linear predictors on
# streaming samples, DSGD and Push-Sum, regret metric.
# ---------------------------------------------------------------------------


def _logistic_grad(p: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Per-node logistic losses ``log1p(exp(-y <p, x>))`` and the gradient of
    their sum with respect to ``p``."""
    p = p.detach().requires_grad_(True)
    with torch.enable_grad():
        z = torch.sum(p * x, dim=1) * y
        losses = torch.log1p(torch.exp(-z))
        (grads,) = torch.autograd.grad(torch.sum(losses), p)
    return losses.detach(), grads


def dsgd_online_step(params: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     W: torch.Tensor, lr: float):
    """One DSGD round for all N nodes at once.

    params [N, D]; x [N, D] one streaming sample per node; y [N] ±1 labels.
    Logistic loss grad then neighborhood mixing (client_dsgd.py:78-100).
    Returns (new_params, per-node losses).
    """
    losses, grads = _logistic_grad(params, x, y)
    stepped = params - lr * grads
    _check_f32_matmul(W)
    return W @ stepped, losses


def pushsum_online_step(params: torch.Tensor, omega: torch.Tensor, x: torch.Tensor,
                        y: torch.Tensor, W_col: torch.Tensor, lr: float):
    """Push-Sum over a column-stochastic (possibly time-varying) directed
    graph (client_pushsum.py:7, ω bookkeeping :36-45).

    params [N, D] are the push-sum numerators; omega [N] the weights. The
    de-biased estimate x_i = params_i / ω_i takes the gradient step.
    """
    debiased = params / torch.clamp(omega[:, None], min=1e-12)
    losses, grads = _logistic_grad(debiased, x, y)
    stepped = params - lr * grads
    _check_f32_matmul(W_col)
    return W_col @ stepped, W_col @ omega, losses


def run_online_gossip(xs: np.ndarray, ys: np.ndarray, n_nodes: int, lr: float = 0.1,
                      mode: str = "dsgd", topology: np.ndarray | None = None,
                      time_varying: bool = False, seed: int = 0,
                      device: str | torch.device = "cuda"):
    """Streaming gossip learning driver (decentralized_fl_api.py:11-20):
    xs [T, N, D], ys [T, N]; returns (params [N, D], cumulative regret [T]).
    Runs on ``device`` (the card by default)."""
    from fedml_tpu_torch.topology.topology import ring_topology, time_varying_directed

    dev = resolve_device(device)
    T, N, D = xs.shape
    params = torch.zeros((N, D), dtype=torch.float32, device=dev)
    omega = torch.ones((N,), dtype=torch.float32, device=dev)
    W = torch.as_tensor(topology if topology is not None else ring_topology(N), device=dev)

    losses_hist = []
    for t in range(T):
        x, y = torch.as_tensor(xs[t], device=dev), torch.as_tensor(ys[t], device=dev)
        if mode == "dsgd":
            params, losses = dsgd_online_step(params, x, y, W, lr)
        elif mode == "pushsum":
            Wt = (torch.as_tensor(time_varying_directed(N, t), device=dev)
                  if time_varying else W)
            params, omega, losses = pushsum_online_step(params, omega, x, y, Wt, lr)
        else:
            raise ValueError(f"unknown gossip mode {mode!r}")
        losses_hist.append(losses.mean())
    regret = np.cumsum(torch.stack(losses_hist).cpu().numpy()) if losses_hist else np.zeros(0)
    final = params / torch.clamp(omega[:, None], min=1e-12) if mode == "pushsum" else params
    return final.cpu().numpy(), regret
