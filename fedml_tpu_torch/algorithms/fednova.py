"""FedNova, the port of ``fedml_tpu/algorithms/fednova.py``: normalised
averaging for heterogeneous local work.

Reference: fedml_api/standalone/fednova/fednova.py:10-154 (the ``FedNova``
optimizer: per-step cum_grad accumulation, the local normalising vector
a_i's recurrences for momentum and the proximal variant) and
fednova_trainer.py:97-125 (the server aggregates the normalised gradients
scaled by tau_eff). The arithmetic, as in the JAX package:

- client i runs tau_i local steps; cum_grad_i = x_global - x_i (its delta);
- a_i: plain SGD, tau_i; momentum m, sum over t of (1 - m^t)/(1 - m) by the
  counter recurrence; proximal eta*mu, a <- a(1 - eta*mu) + 1 a step;
- tau_eff = sum_i p_i a_i (p_i = n_i / n; tau_i instead of a_i when mu != 0);
- x' = x - tau_eff * sum_i p_i cum_grad_i / a_i.

The client optimizer (:class:`FedNovaSGD`) keeps the reference's update
order (weight decay, momentum buffer, proximal term, step) in the port's
optimizer idiom, beside ``core/trainer.py``'s ``SGD`` and ``Adam``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from fedml_tpu_torch.algorithms.base import Aggregator
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.trainer import _StepsOf

StateDict = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FedNovaSGD:
    """Client-side FedNova SGD (reference fednova.py:79-154 ``step()``), the
    JAX package's ``fednova_optimizer``, in the two forms of the port's
    optimizers: :meth:`init` and :meth:`update` over state dicts whose
    tensors may carry a leading client axis (the vmap mode's), and, called
    on parameters, a ``torch.optim.Optimizer`` stepping each parameter with
    them (the scan mode's). The state is flat: ``buf/<name>``, the momentum
    buffer (from zero: the first step makes it ``(1 - dampening) * d``, as
    the JAX package does), and ``old/<name>``, the parameters at
    :meth:`init`, the proximal term's anchor."""

    lr: float
    momentum: float = 0.0
    mu: float = 0.0
    dampening: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    def __call__(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        return _StepsOf(params, self)

    def init(self, params: StateDict, lead: tuple[int, ...] = ()) -> StateDict:
        state = {f"buf/{k}": torch.zeros_like(v) for k, v in params.items()}
        state.update({f"old/{k}": v.detach().clone() for k, v in params.items()})
        return state

    def update(self, grads: StateDict, state: StateDict,
               params: StateDict) -> tuple[StateDict, StateDict]:
        new_params, new_state = {}, {}
        for k, p in params.items():
            d = grads[k]
            if self.weight_decay:
                d = d + self.weight_decay * p
            buf = state[f"buf/{k}"]
            if self.momentum:
                buf = self.momentum * buf + (1.0 - self.dampening) * d
                d = d + self.momentum * buf if self.nesterov else buf
            if self.mu:
                d = d + self.mu * (p - state[f"old/{k}"])
            new_params[k] = p + (-self.lr * d)
            new_state[f"buf/{k}"], new_state[f"old/{k}"] = buf, state[f"old/{k}"]
        return new_params, new_state


def fednova_optimizer(lr: float, momentum: float = 0.0, mu: float = 0.0,
                      dampening: float = 0.0, nesterov: bool = False,
                      weight_decay: float = 0.0) -> FedNovaSGD:
    return FedNovaSGD(lr, momentum, mu, dampening, nesterov, weight_decay)


def normalizing_vector(tau: torch.Tensor, momentum: float, etamu: float,
                       max_tau: int) -> torch.Tensor:
    """a_i for tau local steps (reference fednova.py:139-151 recurrences).
    ``tau`` is a [C] float tensor; the recursion runs ``max_tau`` steps on
    its device, each client's masked past its own tau, with no host read, so
    a CUDA graph of the round captures it."""
    tau = tau.float()
    counter = torch.zeros_like(tau)
    a = torch.zeros_like(tau)
    for t in range(int(max_tau)):
        live = t < tau
        active = live.float()
        if momentum != 0.0:
            counter = torch.where(live, counter * momentum + 1.0, counter)
            a = a + active * counter
        if etamu != 0.0:
            a = torch.where(live, a * (1.0 - etamu) + 1.0, a)
        if momentum == 0.0 and etamu == 0.0:
            a = a + active
    return a


def fednova_aggregator(client_lr: float, momentum: float = 0.0, mu: float = 0.0,
                       batch_size: int = 32, epochs: int = 1,
                       max_client_samples: int = 1 << 20) -> Aggregator:
    """The FedNova server rule over the stacked cohort: ``tau`` and its
    bound ``max_tau`` from the engine's ``extras`` (else derived from the
    sample counts), the parameters moved by ``tau_eff`` times the
    normalised weighted deltas, the model state weight-averaged; the round's
    ``tau_eff`` is a metric."""
    etamu = client_lr * mu
    default_max_tau = epochs * max(1, -(-max_client_samples // batch_size))

    def init_state(global_variables):
        return ()

    def aggregate(global_variables, stacked, weights, state, rng=None, extras=None):
        if extras is not None and "tau" in extras:
            tau = extras["tau"]
            mt = int(extras.get("max_tau", default_max_tau))
        else:
            tau = epochs * torch.ceil(torch.clamp(weights.float(), min=1.0) / batch_size)
            mt = default_max_tau
        # tau and a stay consistent even if the bound is misconfigured
        tau = torch.clamp(tau.float(), max=float(mt))
        a = normalizing_vector(tau, momentum, etamu, mt)
        w = weights.float()
        p = w / torch.clamp(torch.sum(w), min=1e-12)
        tau_eff = torch.sum(p * (tau if mu != 0.0 else a))
        coeff = tau_eff * p / torch.clamp(a, min=1e-12)
        new_global = {}
        aux = {k: v for k, v in stacked.items() if treelib.is_model_state(k)}
        new_aux = treelib.stacked_weighted_mean(aux, weights) if aux else {}
        for k, g in global_variables.items():
            if k in new_aux:
                new_global[k] = new_aux[k]
                continue
            delta = g.unsqueeze(0) - stacked[k]
            cb = coeff.reshape((-1,) + (1,) * (delta.dim() - 1))
            new_global[k] = g - torch.sum(cb * delta, dim=0)
        return new_global, state, {"tau_eff": tau_eff}

    return Aggregator(init_state, aggregate, name="fednova", stacked=True)
