"""Classical vertical (feature-partitioned) federated learning, the port of
``fedml_tpu/algorithms/vertical.py``.

The guest (party 0) holds the labels and its feature columns, the hosts the
other columns. Per batch every party computes its logit contribution, the
guest sums them, takes the BCE loss and returns the loss's gradient in the
sum to every party, and each party steps its own model through its own
``torch.func.vjp`` (the JAX ``jax.vjp``). Variables are the port's flat
state dicts, one per party; the optimizer is the port's functional one.
This is the single-process simulation path; the JAX package's
``vertical_dist.py`` (the same protocol over the comm layer) is ROADMAP
§A11.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
from torch import nn

from fedml_tpu_torch.core.trainer import _sigmoid_bce, sgd
from fedml_tpu_torch.models.resnet import reset_flax
from fedml_tpu_torch.models.transformer import Dense

StateDict = dict[str, torch.Tensor]


class PartyModel(nn.Module):
    """Dense feature extractor -> scalar logit contribution
    (``party_models.py:12``): Dense to ``hidden``, ReLU, Dense to 1,
    ``[B]`` out. torch sizes the first layer up front: ``in_features`` is
    the party's column count."""

    def __init__(self, in_features: int, hidden: int = 16, device=None):
        super().__init__()
        self.dense_0 = Dense(in_features, hidden, device=device)
        self.dense_1 = Dense(hidden, 1, device=device)

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_flax(self, generator)

    def forward(self, x, train: bool = False):
        return self.dense_1(torch.relu(self.dense_0(x.float())))[:, 0]


@dataclasses.dataclass
class VerticalFL:
    """N-party VFL: party 0 is the guest (has the labels), 1..N-1 are hosts."""

    party_modules: Sequence[Any]
    optimizer: Any

    def init(self, generator: torch.Generator) -> list[StateDict]:
        """Fresh variables of every party, drawn in party order."""
        out = []
        for m in self.party_modules:
            m.reset_parameters(generator)
            out.append({k: v.detach().clone() for k, v in m.state_dict().items()})
        return out

    def train_step(self, party_vars: list[StateDict], opt_states, feature_splits,
                   y: torch.Tensor, mask: torch.Tensor):
        """The two-phase batch-synchronous protocol (``vertical.py:56-81``):
        ``(party variables, optimizer states, loss)``."""
        vjps, logits = [], []
        for m, v, x in zip(self.party_modules, party_vars, feature_splits):
            out, vjp = torch.func.vjp(
                lambda p, m=m, x=x: torch.func.functional_call(m, p, (x,), {"train": True}), v)
            logits.append(out)
            vjps.append(vjp)
        total_logit = sum(logits)  # the guest sums the hosts' contributions

        def loss_fn(z):
            bce = _sigmoid_bce(z, y.to(torch.float32))
            return torch.sum(bce * mask) / torch.clamp(torch.sum(mask), min=1.0)

        dz, loss = torch.func.grad_and_value(loss_fn)(total_logit)
        new_vars, new_opts = [], []
        for v, vjp, opt_state in zip(party_vars, vjps, opt_states):
            (g,) = vjp(dz)  # the per-party gradient the guest returns
            v, opt_state = self.optimizer.update(g, opt_state, v)
            new_vars.append(v)
            new_opts.append(opt_state)
        return new_vars, new_opts, loss

    @torch.no_grad()
    def predict(self, party_vars: list[StateDict], feature_splits) -> torch.Tensor:
        total = sum(torch.func.functional_call(m, v, (x,))
                    for m, v, x in zip(self.party_modules, party_vars, feature_splits))
        return torch.sigmoid(total)


def run_vfl(feature_splits_train: Sequence[torch.Tensor], y_train: torch.Tensor,
            epochs: int = 5, batch_size: int = 32, lr: float = 0.05, hidden: int = 16,
            seed: int = 0):
    """The standalone VFL driver (``vertical.py:84-119``): ``n // batch_size``
    full batches an epoch in order, the tail dropped (one batch of all when
    ``n < batch_size``), plain SGD. The parties' models live on the features'
    device, drawn from ``seed``. Returns ``(vfl, party variables,
    losses)``, a loss per step."""
    from fedml_tpu_torch.core import rng as rnglib

    device = feature_splits_train[0].device
    n = len(y_train)
    parties = [PartyModel(x.shape[1], hidden=hidden, device=device)
               for x in feature_splits_train]
    vfl = VerticalFL(parties, sgd(lr))
    pvars = vfl.init(rnglib.generator(seed, device))
    opts = [vfl.optimizer.init(v) for v in pvars]
    losses = []
    steps = max(1, n // batch_size)
    for _ in range(epochs):
        for s in range(steps):
            sl = slice(s * batch_size, (s + 1) * batch_size)
            yb = y_train[sl]
            mask = torch.ones(yb.shape[0], dtype=torch.float32, device=device)
            pvars, opts, loss = vfl.train_step(pvars, opts, [x[sl] for x in feature_splits_train],
                                               yb, mask)
            losses.append(float(loss))
    return vfl, pvars, losses
