"""FedOpt, the port of ``fedml_tpu/algorithms/fedopt.py``: server-side
adaptive optimisation (FedAdam, FedYogi, FedAdagrad, FedAvgM, ...).

Reference: fedml_api/distributed/fedopt/FedOptAggregator.py:94-120: the
client models are weight-averaged, the *pseudo-gradient* ``old - avg`` is set
on the global parameters, and a server optimizer looked up by name
(optrepo.py:7-25) steps with ``server_lr`` / ``server_momentum``. Only the
parameters get the optimizer; the model state (BN statistics) is plainly
averaged.

The JAX package's server optimizers are optax transformations. The port
writes each one out with optax's arithmetic and defaults
(:func:`server_optimizer`), as a pure function of state dicts, its state
a dict of tensors: the step ``count`` is an int32 tensor on the device, not
a Python int, so a CUDA graph of the round (``sim/graphs.py``) carries it
from replay to replay and the bias correction sees the true step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from fedml_tpu_torch.algorithms.base import Aggregator
from fedml_tpu_torch.core import tree as treelib

StateDict = dict[str, torch.Tensor]

_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class ServerOptimizer:
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, state)``, optax's ``GradientTransformation`` over state dicts;
    ``apply`` adds the updates to the parameters."""

    name: str
    init: Callable[[StateDict], dict]
    update: Callable[[StateDict, dict, StateDict], tuple[StateDict, dict]]


def _count0(params: StateDict) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)


def _increment(count: torch.Tensor) -> torch.Tensor:
    """optax's ``safe_increment``: +1, saturating at the dtype's maximum."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def _bias_correction(moment: torch.Tensor, decay: float, count: torch.Tensor) -> torch.Tensor:
    return moment / (1 - decay ** count).to(moment.dtype)


def _adam(lr: float, b1: float, b2: float, eps: float, weight_decay: float = 0.0
          ) -> tuple[Callable, Callable]:
    """optax ``scale_by_adam`` (eps outside the square root, bias correction
    from the step count), then ``add_decayed_weights`` when ``weight_decay``
    (adamw), then ``scale_by_learning_rate``."""

    def init(params):
        return {"count": _count0(params),
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(grads, state, params):
        count = _increment(state["count"])
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g ** 2) + b2 * state["nu"][k] for k, g in grads.items()}
        updates = {}
        for k in grads:
            u = _bias_correction(mu[k], b1, count) / (
                torch.sqrt(_bias_correction(nu[k], b2, count)) + eps)
            if weight_decay:
                u = u + weight_decay * params[k]
            updates[k] = -lr * u
        return updates, {"count": count, "mu": mu, "nu": nu}

    return init, update


def _yogi(lr: float, b1: float, b2: float = 0.999, eps: float = 1e-3,
          initial: float = 1e-6) -> tuple[Callable, Callable]:
    """optax ``scale_by_yogi``: both moments start at ``initial``; the second
    moves by ``-(1 - b2) * sign(nu - g^2) * g^2``; bias correction as adam's."""

    def init(params):
        return {"count": _count0(params),
                "mu": {k: torch.full_like(v, initial) for k, v in params.items()},
                "nu": {k: torch.full_like(v, initial) for k, v in params.items()}}

    def update(grads, state, params):
        count = _increment(state["count"])
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {}
        for k, g in grads.items():
            v, g2 = state["nu"][k], g * g
            nu[k] = v - (1 - b2) * torch.sign(v - g2) * g2
        updates = {k: -lr * (_bias_correction(mu[k], b1, count) / (
            torch.sqrt(_bias_correction(nu[k], b2, count)) + eps)) for k in grads}
        return updates, {"count": count, "mu": mu, "nu": nu}

    return init, update


def _adagrad(lr: float, initial: float = 0.1, eps: float = 1e-7) -> tuple[Callable, Callable]:
    """optax ``scale_by_rss``: the sum of squares starts at ``initial``, the
    update is ``g * rsqrt(sum + eps)`` where the sum is positive, else 0."""

    def init(params):
        return {"sum_of_squares": {k: torch.full_like(v, initial) for k, v in params.items()}}

    def update(grads, state, params):
        sums = {k: g * g + state["sum_of_squares"][k] for k, g in grads.items()}
        updates = {k: -lr * (torch.where(sums[k] > 0, torch.rsqrt(sums[k] + eps), 0.0) * g)
                   for k, g in grads.items()}
        return updates, {"sum_of_squares": sums}

    return init, update


def _trace_init(params):
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _rmsprop(lr: float, momentum: float, decay: float = 0.9, eps: float = 1e-8
             ) -> tuple[Callable, Callable]:
    """optax ``rmsprop``: ``scale_by_rms`` (nu from 0, eps inside the square
    root), ``scale_by_learning_rate``, then momentum as a ``trace``."""

    def init(params):
        return {"nu": {k: torch.zeros_like(v) for k, v in params.items()},
                "trace": _trace_init(params)}

    def update(grads, state, params):
        nu = {k: (1 - decay) * (g ** 2) + decay * state["nu"][k] for k, g in grads.items()}
        scaled = {k: -lr * (torch.rsqrt(nu[k] + eps) * g) for k, g in grads.items()}
        trace = {k: u + momentum * state["trace"][k] for k, u in scaled.items()}
        return trace, {"nu": nu, "trace": trace}

    return init, update


def _sgd(lr: float, momentum: float) -> tuple[Callable, Callable]:
    """optax ``sgd``: momentum as a ``trace`` (from zero), then
    ``scale_by_learning_rate``."""

    def init(params):
        return {"trace": _trace_init(params)}

    def update(grads, state, params):
        trace = {k: g + momentum * state["trace"][k] for k, g in grads.items()}
        return {k: -lr * t for k, t in trace.items()}, {"trace": trace}

    return init, update


def server_optimizer(name: str, server_lr: float = 1.0,
                     server_momentum: float = 0.9) -> ServerOptimizer:
    """Name dispatch mirroring OptRepo.name2cls (fedopt/optrepo.py:25), with
    the JAX package's optax choices and optax's defaults: ``adam`` b1 =
    ``server_momentum``, b2 0.999, eps 1e-3; ``yogi`` eps 1e-3, moments from
    1e-6; ``adagrad`` from 0.1, eps 1e-7; ``rmsprop`` decay 0.9, eps 1e-8
    inside the square root, momentum ``server_momentum``; ``adamw`` b1 =
    ``server_momentum``, eps 1e-8, weight decay 1e-4; ``sgd`` momentum
    ``server_momentum``."""
    key = name.lower()
    if key in ("sgd", "fedavgm"):
        made = _sgd(server_lr, server_momentum)
    elif key in ("adam", "fedadam"):
        made = _adam(server_lr, server_momentum, 0.999, 1e-3)
    elif key in ("yogi", "fedyogi"):
        made = _yogi(server_lr, server_momentum)
    elif key in ("adagrad", "fedadagrad"):
        made = _adagrad(server_lr)
    elif key == "rmsprop":
        made = _rmsprop(server_lr, server_momentum)
    elif key == "adamw":
        made = _adam(server_lr, server_momentum, 0.999, 1e-8, weight_decay=1e-4)
    else:
        raise ValueError(f"unknown server optimizer {name!r}")
    return ServerOptimizer(key, *made)


def fedopt_aggregator(opt: ServerOptimizer) -> Aggregator:
    """The weighted mean of the client models (FedAvg's arithmetic), then a
    server step on the parameters with the pseudo-gradient ``old - avg``
    (FedOptAggregator.set_model_global_grads:109-120); the model state
    takes the mean."""

    def init_state(global_variables):
        return opt.init(treelib.params_of(global_variables))

    def aggregate(global_variables, local_variables, weights, opt_state, rng=None,
                  extras=None):
        avg = treelib.weighted_mean(local_variables, weights)
        params = treelib.params_of(global_variables)
        pseudo_grad = {k: p - avg[k] for k, p in params.items()}
        updates, opt_state = opt.update(pseudo_grad, opt_state, params)
        new_global = {k: (params[k] + updates[k]).to(params[k].dtype) if k in params else v
                      for k, v in avg.items()}
        return new_global, opt_state, {}

    return Aggregator(init_state, aggregate, name="fedopt")
