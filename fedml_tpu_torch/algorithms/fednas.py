"""Federated NAS (FedNAS), the port of ``fedml_tpu/algorithms/fednas.py``:
clients run the DARTS bilevel search, and the server averages weights, α
and BN statistics together.

Variables are a flat dict of tensors (``DARTSNetwork.state_dict()`` names),
split into the weights (the parameters), α (``darts.ARCH``) and the model
state (the BN buffers). Each step is ``torch.func`` over explicit dicts,
with the optimizers' functional ``init``/``update`` (``core/trainer.py``):

- the α step comes first, on the *validation* batch, from the step's
  starting weights, with ``arch_opt``;
- then the weight step on the *training* batch with the updated α, with
  ``w_opt``. Only its forward's BN statistics become the new model state;
  every forward runs in training mode, on batch statistics.

Both architect orders of the JAX package: first order, ``∇α L_val(w, α)``;
second order (``unrolled=True``, DARTS eq. 7): w' is one real ``w_opt``
update on ``L_train`` from the live optimizer state, then ``(∂α, v) =
∇_{α,w'} L_val(w', α)`` and ``∂α − η·∇²_{α,w} L_train(w, α)·v``, the last
term exact: ``torch.func.jvp`` of ``torch.func.grad``.

GDAS noise: each forward of ``search_mode="gdas"`` takes Gumbel noise drawn
from a ``torch.Generator``. A search step draws the α step's noise, then
the weight step's; the unrolled ``L_train`` forwards reuse the weight
step's draw, as the JAX package passes the weight step's key to them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from fedml_tpu_torch.algorithms.base import Aggregator
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.trainer import classification_loss
from fedml_tpu_torch.models.darts import ARCH, DARTSNetwork, Genotype, decode_genotype

StateDict = dict[str, torch.Tensor]
Batch = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FedNASTrainer:
    """A :class:`DARTSNetwork`, the weight and α optimizers (``sgd``/``adam``
    of ``core/trainer.py``), the local epoch count, and the architect's
    order: ``unrolled`` with ``unrolled_eta``, the η that scales the implicit
    term (the network's lr)."""

    network: DARTSNetwork
    w_opt: Any
    arch_opt: Any
    epochs: int = 1
    unrolled: bool = False
    unrolled_eta: float = 0.025

    def init(self, generator: torch.Generator) -> StateDict:
        """Fresh variables drawn from ``generator``, as a detached copy."""
        self.network.reset_parameters(generator)
        return {k: v.detach().clone() for k, v in self.network.state_dict().items()}

    @staticmethod
    def split(variables: StateDict) -> tuple[StateDict, StateDict, StateDict]:
        """``(weights, α, model state)`` of a variables dict."""
        arch = {k: variables[k] for k in ARCH}
        params, state = {}, {}
        for k, v in variables.items():
            if k in ARCH:
                continue
            (state if k.endswith((".running_mean", ".running_var")) else params)[k] = v
        return params, arch, state

    def _loss(self, params, arch, state, batch, noise):
        """The masked cross-entropy of a training-mode forward and its new BN
        statistics."""
        logits, new_state = torch.func.functional_call(
            self.network, {**params, **arch, **state}, (batch["x"],),
            {"train": True, "noise": noise})
        return classification_loss(logits, batch), new_state

    def arch_grads_unrolled(self, params, arch, state, w_opt_state, train_batch, val_batch,
                            t_noise=None, v_noise=None):
        """Second-order α gradient: ``(val_loss, α grads)``."""
        def loss_t(p, a):
            return self._loss(p, a, state, train_batch, t_noise)[0]

        def loss_v(p, a):
            return self._loss(p, a, state, val_batch, v_noise)[0]

        g_w = torch.func.grad(loss_t)(params, arch)
        w_unrolled, _ = self.w_opt.update(g_w, w_opt_state, params)
        (dalpha, vector), val_loss = torch.func.grad_and_value(
            lambda a, p: loss_v(p, a), argnums=(0, 1))(arch, w_unrolled)
        # exact ∇²_{α,w} L_train(w, α) · vector: ∇α L_train differentiated
        # along ``vector`` in w
        _, implicit = torch.func.jvp(
            lambda p: torch.func.grad(loss_t, argnums=1)(p, arch), (params,), (vector,))
        return val_loss, {k: dalpha[k] - self.unrolled_eta * implicit[k] for k in dalpha}

    def search_step(self, variables: StateDict, opt_states, train_batch: Batch,
                    val_batch: Batch, generator: torch.Generator | None = None):
        """One bilevel alternation: ``(variables, opt_states, {"train_loss",
        "val_loss"})``. ``generator`` draws the gdas noise (unused for
        ``darts``)."""
        a_noise = w_noise = None
        if self.network.search_mode == "gdas":
            if generator is None:
                raise ValueError("gdas search needs a torch.Generator for its Gumbel noise")
            a_noise = self.network.gumbel_noise(generator)
            w_noise = self.network.gumbel_noise(generator)
        params, arch, state = self.split(variables)
        w_opt_state, a_opt_state = opt_states

        if self.unrolled:
            val_loss, a_grads = self.arch_grads_unrolled(
                params, arch, state, w_opt_state, train_batch, val_batch, w_noise, a_noise)
        else:
            a_grads, val_loss = torch.func.grad_and_value(
                lambda a: self._loss(params, a, state, val_batch, a_noise)[0])(arch)
        arch, a_opt_state = self.arch_opt.update(a_grads, a_opt_state, arch)

        w_grads, (train_loss, new_state) = torch.func.grad_and_value(
            lambda p: self._loss(p, arch, state, train_batch, w_noise), has_aux=True)(params)
        params, w_opt_state = self.w_opt.update(w_grads, w_opt_state, params)
        return ({**params, **arch, **new_state}, (w_opt_state, a_opt_state),
                {"train_loss": train_loss, "val_loss": val_loss})

    def local_search(self, global_variables: StateDict, train_batches: Batch,
                     val_batches: Batch, generator: torch.Generator | None = None):
        """``epochs`` passes of alternating search over the S stacked
        (train, val) batch pairs (``[S, B, ...]`` tensors), with both
        optimizer states fresh: ``(variables, {"train_loss"})``, the loss the
        last epoch's mean weight-step loss."""
        params, arch, _ = self.split(global_variables)
        opt_states = (self.w_opt.init(params), self.arch_opt.init(arch))
        variables = global_variables
        S = train_batches["mask"].shape[0]
        for _ in range(self.epochs):
            losses = []
            for s in range(S):
                variables, opt_states, m = self.search_step(
                    variables, opt_states, {k: v[s] for k, v in train_batches.items()},
                    {k: v[s] for k, v in val_batches.items()}, generator)
                losses.append(m["train_loss"])
            epoch_loss = torch.stack(losses).mean()
        return variables, {"train_loss": epoch_loss}


def fednas_aggregator() -> Aggregator:
    """The sample-count-weighted mean of the whole variables, weights, α and
    BN statistics, over a stacked ``[C, ...]`` cohort:
    ``aggregate(global, stacked, weights, state) -> (new_global, state,
    {})``."""

    def init_state(global_variables):
        return ()

    def aggregate(global_variables, stacked, weights, state):
        return treelib.stacked_weighted_mean(stacked, weights), state, {}

    return Aggregator(init_state, aggregate, name="fednas")


def global_genotype(variables: StateDict) -> Genotype:
    """Decode the current global architecture (on the host)."""
    return decode_genotype(
        np.asarray(variables["alphas_normal"].detach().cpu()),
        np.asarray(variables["alphas_reduce"].detach().cpu()),
    )
