"""Federated GAN, the port of ``fedml_tpu/algorithms/fedgan.py``.

Clients run an adversarial loop on a (generator, discriminator) pair and the
server averages the pair. The pair's variables are one flat state dict,
``generator.<name>`` and ``discriminator.<name>``, so the FedAvg weighted
mean over it is the reference's nested two-network average.

A step (:meth:`GANTrainer.train_step`, ``fedml_tpu/algorithms/fedgan.py:51-91``)
is a pure function of the variables, the two Adam states, the batch and the
latent draw ``z``: a discriminator step on the real images and the
generator's (detached) fakes, then a generator step through the updated
discriminator, both on the same ``z``. The generator runs in training mode
in both; only the generator step's BatchNorm statistics are kept (the JAX
step throws the discriminator step's away), and the port's BatchNorm writes
no buffer, so nothing needs undoing.

``z`` is drawn by the engine's round stream
(:class:`~fedml_tpu_torch.core.trainer.DropoutStream`, seeded from the run's
seed, the round and the step): :attr:`GANTrainer.dropout_sites` names one
site of standard normals, ``[C, B, latent_dim]`` a step for the cohort, so
the client-by-client and the vmapped cohort modes see the same ``z``, and a
round a CUDA graph replays reads it from static buffers filled before each
replay (``sim/graphs.py``). JAX threads PRNG keys through the scan instead;
those draws cannot be reproduced here, so the parity tests give both
packages the same ``z``.

:func:`make_gan_local_train` is the round program ``FedSim`` takes as
``local_train_fn``: called, one client's local training (the scan mode);
its ``vmap`` attribute trains the whole cohort at once (``torch.func.vmap``
of the same step). Every step is computed and then kept or dropped under
``torch.where`` (an empty batch, or a step past the client's budget, leaves
the weights, the BatchNorm state and both Adam states, step count included,
bitwise as they were), so nothing reads the device from the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from fedml_tpu_torch.algorithms.base import Aggregator, fedavg_aggregator
from fedml_tpu_torch.core.trainer import _masked_mean, _sigmoid_bce

StateDict = dict[str, torch.Tensor]
_NETS = ("generator", "discriminator")


@dataclasses.dataclass(frozen=True)
class GANTrainer:
    """The pair of modules, their optimizers (the port's
    :class:`~fedml_tpu_torch.core.trainer.Adam`, whose functional form the
    step uses), the latent width and the local epoch count, the JAX fields in
    their order."""

    generator: Any
    discriminator: Any
    g_opt: Any
    d_opt: Any
    latent_dim: int = 100
    epochs: int = 1

    @property
    def dropout_sites(self) -> dict:
        """The step's draws the engine's round stream serves: ``z``, one
        example's ``latent_dim`` standard normals (a site of rate None)."""
        return {"z": ((self.latent_dim,), None)}

    def init(self, generator: torch.Generator) -> StateDict:
        """Fresh variables of the pair drawn from ``generator`` (the
        generator's first), as a detached copy."""
        out = {}
        for net in _NETS:
            module = getattr(self, net)
            module.reset_parameters(generator)
            out.update({f"{net}.{k}": v.detach().clone()
                        for k, v in module.state_dict().items()})
        return out

    def split(self, variables: StateDict) -> dict[str, tuple[StateDict, StateDict]]:
        """``{net: (params, state)}`` of the pair's flat variables, each
        keyed by the module's own names."""
        out = {}
        for net in _NETS:
            module = getattr(self, net)
            names = {k for k, _ in module.named_parameters()}
            own = {k[len(net) + 1:]: v for k, v in variables.items()
                   if k.startswith(net + ".")}
            out[net] = ({k: v for k, v in own.items() if k in names},
                        {k: v for k, v in own.items() if k not in names})
        return out

    def init_opt_states(self, variables: StateDict, lead: tuple[int, ...] = ()):
        """Fresh ``(g_opt, d_opt)`` states for the pair's parameters."""
        nets = self.split(variables)
        return (self.g_opt.init(nets["generator"][0], lead),
                self.d_opt.init(nets["discriminator"][0], lead))

    def _call(self, net: str, variables: StateDict, x, train: bool):
        return torch.func.functional_call(getattr(self, net), variables, (x,),
                                          {"train": True} if train else {})

    def train_step(self, variables: StateDict, opt_states, batch: dict, z: torch.Tensor):
        """One non-saturating GAN step on ``batch`` (its ``x`` and ``mask``)
        with the latent draw ``z`` ``[B, latent_dim]``: ``(variables,
        opt_states, {"d_loss", "g_loss"})``. Pure: nothing is written."""
        nets = self.split(variables)
        gp, gs = nets["generator"]
        dp, ds = nets["discriminator"]
        g_state, d_state = opt_states
        real, mask = batch["x"], batch["mask"]
        ones = torch.ones(real.shape[0], dtype=torch.float32, device=real.device)

        def d_loss_fn(dp):
            fake, _ = self._call("generator", {**gp, **gs}, z, True)  # BN update dropped
            dv = {**dp, **ds}
            real_logit = self._call("discriminator", dv, real, True)
            fake_logit = self._call("discriminator", dv, fake.detach(), True)
            loss = (_sigmoid_bce(real_logit[:, 0], ones)
                    + _sigmoid_bce(fake_logit[:, 0], torch.zeros_like(ones)))
            return _masked_mean(loss, mask)

        d_grads, d_loss = torch.func.grad_and_value(d_loss_fn)(dp)
        dp, d_state = self.d_opt.update(d_grads, d_state, dp)

        def g_loss_fn(gp):
            fake, new_gs = self._call("generator", {**gp, **gs}, z, True)
            fake_logit = self._call("discriminator", {**dp, **ds}, fake, True)
            return _masked_mean(_sigmoid_bce(fake_logit[:, 0], ones), mask), new_gs

        g_grads, (g_loss, gs) = torch.func.grad_and_value(g_loss_fn, has_aux=True)(gp)
        gp, g_state = self.g_opt.update(g_grads, g_state, gp)
        new = {**{f"generator.{k}": v for k, v in {**gp, **gs}.items()},
               **{f"discriminator.{k}": v for k, v in {**dp, **ds}.items()}}
        return ({k: new[k] for k in variables}, (g_state, d_state),
                {"d_loss": d_loss, "g_loss": g_loss})

    def masked_step(self, variables: StateDict, opt_states, batch: dict, z: torch.Tensor,
                    in_budget: torch.Tensor):
        """:meth:`train_step`, kept only where the batch holds data and
        ``in_budget`` (a bool tensor) holds (``fedgan.py:112-120``):
        ``(variables, opt_states, g_loss + d_loss)``, the loss the step
        computed either way."""
        new_vars, new_opts, losses = self.train_step(variables, opt_states, batch, z)
        active = (torch.sum(batch["mask"]) > 0) & in_budget

        def keep(new, old):
            return {k: torch.where(active, new[k], old[k]) for k in old}

        opt_states = tuple(keep(n, o) for n, o in zip(new_opts, opt_states))
        return keep(new_vars, variables), opt_states, losses["g_loss"] + losses["d_loss"]


def _in_budget(t: int, num_steps, device) -> torch.Tensor:
    if num_steps is None:
        return torch.ones((), dtype=torch.bool, device=device)
    return torch.as_tensor(num_steps, device=device) > t


def make_gan_local_train(trainer: GANTrainer):
    """The GAN's round program (``fedml_tpu/algorithms/fedgan.py:93-137``).

    Called, ``local_train(global_variables, data, num_steps=None,
    draws=None, dropout=None, slot=0) -> (variables, metrics)``: one
    client's training on its ``[S, B, ...]`` batches, the contract of
    :func:`~fedml_tpu_torch.core.trainer.make_local_train` (``dropout`` is
    the round's stream, whose ``z`` draw the client takes row ``slot`` of;
    ``draws`` is unused). ``local_train.vmap(global_variables, data,
    num_steps, draws=None, dropout=None)`` is the whole cohort's on ``[C, S,
    B, ...]`` batches and ``[C]`` budgets, that of
    :func:`~fedml_tpu_torch.core.trainer.make_vmap_train`. Each client
    starts from the global pair with fresh Adam states; a step is a no-op on
    an empty batch or at or past the client's ``num_steps``.
    ``metrics["train_loss"]`` is the last epoch's mean of ``g_loss +
    d_loss`` over all its S steps, as the JAX scan's ``losses.mean()``."""
    vstep = torch.func.vmap(trainer.masked_step)

    def local_train(global_variables: StateDict, data: dict, num_steps=None, draws=None,
                    dropout=None, slot: int = 0):
        if dropout is None:
            raise ValueError("the GAN draws z from the round's stream: local_train needs it")
        device = data["mask"].device
        variables = dict(global_variables)
        opt_states = trainer.init_opt_states(variables)
        S = data["mask"].shape[0]
        total = None
        for e in range(trainer.epochs):
            total = torch.zeros((), dtype=torch.float32, device=device)
            for s in range(S):
                t = e * S + s
                variables, opt_states, loss = trainer.masked_step(
                    variables, opt_states, {k: v[s] for k, v in data.items()},
                    dropout.masks(t)["z"][slot], _in_budget(t, num_steps, device))
                total = total + loss
        variables = {k: v.detach().clone() for k, v in variables.items()}
        return variables, {"train_loss": total / S}

    def vmap_train(global_variables: StateDict, data: dict, num_steps: torch.Tensor,
                   draws=None, dropout=None):
        if dropout is None:
            raise ValueError("the GAN draws z from the round's stream: vmap_train needs it")
        C, S = data["mask"].shape[:2]
        device = data["mask"].device
        variables = {k: v.unsqueeze(0).expand((C,) + v.shape)
                     for k, v in global_variables.items()}
        opt_states = trainer.init_opt_states(variables, (C,))
        total = None
        for e in range(trainer.epochs):
            total = torch.zeros(C, dtype=torch.float32, device=device)
            for s in range(S):
                t = e * S + s
                variables, opt_states, loss = vstep(
                    variables, opt_states, {k: v[:, s] for k, v in data.items()},
                    dropout.masks(t)["z"], num_steps > t)
                total = total + loss
        return dict(variables), {"train_loss": total / S}

    local_train.vmap = vmap_train
    return local_train


def fedgan_aggregator() -> Aggregator:
    """The nested two-network weighted average (``fedgan.py:140-144``):
    FedAvg over the pair's flat state dict, named ``"fedgan"``."""
    inner = fedavg_aggregator()
    return Aggregator(inner.init_state, inner.aggregate, name="fedgan")
