"""SplitNN, the port of ``fedml_tpu/algorithms/splitnn.py``: a model split at
a cut layer between a client half and a server half.

The client runs its half to the cut and hands the activations over; the
server finishes the forward on a detached copy of them, takes the loss,
steps its half and returns the loss's gradient in the activations; the
client runs that gradient back through its half (``torch.autograd.grad``
from the activations, the counterpart of ``jax.vjp``) and steps. Clients
take turns against one server half in a relay ring.

Variables are the port's flat state dicts, one per half; the optimizers are
the port's functional ones (:func:`~fedml_tpu_torch.core.trainer.sgd`'s
``init``/``update``), so a step is a pure function of its inputs. This is
the single-process simulation path; ``splitnn_dist.py`` runs the same
protocol over the comm layer, its step factored into three programs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from fedml_tpu_torch.core.trainer import _cross_entropy, _masked_mean

StateDict = dict[str, torch.Tensor]


def _split(module: torch.nn.Module, variables: StateDict):
    names = {k for k, _ in module.named_parameters()}
    return ({k: v for k, v in variables.items() if k in names},
            {k: v for k, v in variables.items() if k not in names})


@dataclasses.dataclass
class SplitNN:
    """``client_module``: x -> activations; ``server_module``: activations ->
    logits; each half's optimizer, the JAX fields in their order."""

    client_module: Any
    server_module: Any
    client_opt: Any
    server_opt: Any

    def init(self, generator: torch.Generator) -> tuple[StateDict, StateDict]:
        """Fresh ``(client, server)`` variables drawn from ``generator``,
        the client half's first."""
        out = []
        for module in (self.client_module, self.server_module):
            module.reset_parameters(generator)
            out.append({k: v.detach().clone() for k, v in module.state_dict().items()})
        return out[0], out[1]

    def train_step(self, cvars: StateDict, svars: StateDict, c_opt_state, s_opt_state,
                   batch: dict[str, torch.Tensor]):
        """One split step (``splitnn.py:47-79``): ``(cvars, svars,
        c_opt_state, s_opt_state, loss)``."""
        x, y, mask = batch["x"], batch["y"], batch["mask"]
        cp, cs = _split(self.client_module, cvars)
        sp, ss = _split(self.server_module, svars)
        with torch.enable_grad():
            # the client's forward to the cut
            cp_ = {k: v.detach().requires_grad_() for k, v in cp.items()}
            acts = torch.func.functional_call(self.client_module, {**cp_, **cs}, (x,),
                                              {"train": True})
            # the server's forward, loss and gradients, in its parameters and
            # in the activations it was sent
            acts_in = acts.detach().requires_grad_()
            sp_ = {k: v.detach().requires_grad_() for k, v in sp.items()}
            logits = torch.func.functional_call(self.server_module, {**sp_, **ss}, (acts_in,),
                                                {"train": True})
            loss = _masked_mean(_cross_entropy(logits, y), mask)
            *s_grads, acts_grad = torch.autograd.grad(loss, [*sp_.values(), acts_in])
            # the activations' gradient back through the client's half
            c_grads = torch.autograd.grad(acts, list(cp_.values()), acts_grad)
        sp, s_opt_state = self.server_opt.update(dict(zip(sp, s_grads)), s_opt_state, sp)
        cp, c_opt_state = self.client_opt.update(dict(zip(cp, c_grads)), c_opt_state, cp)
        loss = loss.detach()
        return {**cp, **cs}, {**sp, **ss}, c_opt_state, s_opt_state, loss


def relay_turn(split: SplitNN, cvars: StateDict, svars: StateDict, s_opt_state,
               batches: dict[str, torch.Tensor]):
    """One client's turn in the relay: its ``[S, B, ...]`` batches in order
    against the server half, with a fresh client optimizer. Returns
    ``(cvars, svars, s_opt_state, loss)``, the loss the mean over the turn's
    steps (a device scalar)."""
    c_opt_state = split.client_opt.init(_split(split.client_module, cvars)[0])
    total = 0.0
    S = batches["x"].shape[0]
    for s in range(S):
        cvars, svars, c_opt_state, s_opt_state, loss = split.train_step(
            cvars, svars, c_opt_state, s_opt_state, {k: v[s] for k, v in batches.items()})
        total = total + loss
    return cvars, svars, s_opt_state, total / S


def run_splitnn_relay(split: SplitNN, client_batches: list[dict[str, torch.Tensor]],
                      epochs: int, generator: torch.Generator):
    """Relay training (``splitnn.py:82-120``): each epoch, the clients in
    turn (:func:`relay_turn`) train on their ``[S, B, ...]`` batch stacks
    against the shared server half. Every client starts from the same client
    half and keeps its own; the server half and its optimizer state carry
    across the relay; the start is drawn from ``generator``. Returns
    ``(client variables per client, server variables, losses)``, a loss per
    turn."""
    cvars0, svars = split.init(generator)
    cvars = [{k: v.clone() for k, v in cvars0.items()} for _ in client_batches]
    s_opt_state = split.server_opt.init(_split(split.server_module, svars)[0])
    losses = []
    for _ in range(epochs):
        for ci, batches in enumerate(client_batches):  # the relay ring
            cvars[ci], svars, s_opt_state, loss = relay_turn(split, cvars[ci], svars,
                                                             s_opt_state, batches)
            losses.append(float(loss))
    return cvars, svars, losses


@torch.no_grad()
def splitnn_eval(split: SplitNN, cvars: StateDict, svars: StateDict,
                 batches: dict[str, torch.Tensor]) -> float:
    """Accuracy of the two halves over ``[S, B, ...]`` batches
    (``splitnn.py:123-132``)."""
    correct = total = 0.0
    for b in range(batches["x"].shape[0]):
        x, y, m = batches["x"][b], batches["y"][b], batches["mask"][b]
        acts = torch.func.functional_call(split.client_module, cvars, (x,))
        logits = torch.func.functional_call(split.server_module, svars, (acts,))
        correct += float(torch.sum((torch.argmax(logits, -1) == y).float() * m))
        total += float(torch.sum(m))
    return correct / max(total, 1.0)
