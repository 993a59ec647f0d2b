"""Client trainer, the port of ``fedml_tpu/core/trainer.py``.

A :class:`ClientTrainer` bundles a torch module with a task's loss/metric
pair, an optimizer, the local epoch count and an optional training-batch
augmentation. Batches are ``{"x": [B, ...], "y": [B, ...], "mask": [B] or
[B, T]}``; padding has mask 0 and contributes nothing to losses, gradients or
metrics. Model variables are flat state dicts (name -> tensor): the module's
parameters and its buffers, the model state (BN running statistics), which is
updated by training and federated with the weights.

A module with buffers takes ``train=True`` and then returns ``(logits,
new_state)``, the new values of its buffers, instead of writing them in place
(flax's ``mutable=["batch_stats"]``); called without it, it returns logits.
A module with dropout names its sites in ``dropout_sites`` (site -> (one
example's activation shape, rate)) and takes its keep masks in training as
``module(x, train=True, dropout=masks)``: the masks are drawn outside the
module by :class:`DropoutStream`, one draw per step for the whole cohort,
so the vmapped and the client-by-client modes see the same masks.

FedProx (``ClientTrainer.prox_mu``) adds ``0.5 * mu * ||params -
global_params||^2`` over the parameters (not the model state) to the loss.

Two local-training programs, one per cohort mode of the engine:

- :func:`make_local_train` (``cohort_execution="scan"``): one client at a
  time, a Python loop over steps on the module's own parameters with a fresh
  ``torch.optim`` optimizer; an empty or over-budget step is skipped on the
  host, or, given the budget as a device tensor, is a masked no-op decided
  on the device (a round that a CUDA graph captures);
- :func:`make_vmap_train` (``"vmap"``): the whole cohort at once, a pure
  function of ``(params, model_state, opt_state)`` stacked ``[C, ...]``,
  stepped by ``torch.func.vmap`` of ``torch.func.grad_and_value`` over a
  functional apply of the module and the optimizer's functional form.

:func:`make_lane_step` is the same step for packed lanes
(``SimConfig.pack_lanes``): a lane resets its carry to the global model at
each client boundary, and :class:`LaneDropout` serves each lane the masks
its client would draw in the padded round.

In a data-parallel silo (the ``silo`` axis bound to a process group,
``parallel/collectives.py`` :func:`~fedml_tpu_torch.parallel.collectives.bind`)
each rank trains on its rows of every batch: its loss is its rows' share
of the whole batch's masked mean, a step runs where any rank's rows hold
data, and the ranks' gradients, loss shares and mask counts are summed in
one reduce before the optimizer's update (BatchNorm reduces its moments
itself, ``ops/syncbn.py``). Without a bound silo nothing changes, bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.parallel import collectives
from fedml_tpu_torch.parallel.mesh import SILO_AXIS

Batch = dict[str, torch.Tensor]
StateDict = dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# Task losses / metrics
# ---------------------------------------------------------------------------


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The masked mean over the whole batch: in a data-parallel silo (a
    bound ``silo`` axis) each rank's total over the count of every rank's
    rows, its share of the mean (the silo sums the shares)."""
    total = torch.sum(values * mask)
    count = torch.clamp(collectives.axis_sum(torch.sum(mask), SILO_AXIS), min=1.0)
    return total / count


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.softmax_cross_entropy_with_integer_labels: per-position
    log-sum-exp of the logits minus the label's logit."""
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long(),
                         reduction="none")
    return ce.reshape(labels.shape)


def classification_loss(logits: torch.Tensor, batch: Batch) -> torch.Tensor:
    return _masked_mean(_cross_entropy(logits, batch["y"]), batch["mask"])


def classification_metrics(logits: torch.Tensor, batch: Batch) -> dict[str, torch.Tensor]:
    ce = _cross_entropy(logits, batch["y"])
    correct = (torch.argmax(logits, -1) == batch["y"]).float()
    m = batch["mask"]
    return {
        "test_correct": torch.sum(correct * m),
        "test_loss": torch.sum(ce * m),
        "test_total": torch.sum(m),
    }


def lm_loss(logits: torch.Tensor, batch: Batch) -> torch.Tensor:
    """Next-token loss for [B, T, V] logits with per-token mask [B, T]
    (reference my_model_trainer_nwp.py — Shakespeare / StackOverflow NWP)."""
    return _masked_mean(_cross_entropy(logits, batch["y"]), batch["mask"])


def lm_metrics(logits: torch.Tensor, batch: Batch) -> dict[str, torch.Tensor]:
    return classification_metrics(logits, batch)


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy: ``-y * log_sigmoid(x) - (1 - y) *
    log_sigmoid(-x)`` per element."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def tag_loss(logits: torch.Tensor, batch: Batch) -> torch.Tensor:
    """Multi-label (tag prediction, stackoverflow_lr): sigmoid BCE against a
    multi-hot target, summed over tags (reference
    my_model_trainer_tag_prediction.py)."""
    return _masked_mean(_sigmoid_bce(logits, batch["y"]).sum(-1), batch["mask"])


def tag_metrics(logits: torch.Tensor, batch: Batch) -> dict[str, torch.Tensor]:
    """Precision-style counts, as the reference reports them: a predicted
    tag is a logit above 0, ``test_correct`` the true positives and
    ``test_total`` the predicted tags (at least 1); ``test_precision`` and
    ``test_recall`` are this batch's ratios."""
    bce = _sigmoid_bce(logits, batch["y"]).sum(-1)
    pred = (logits > 0.0).float()
    y = batch["y"]
    m = batch["mask"][:, None]
    tp = torch.sum(pred * y * m)
    predicted = torch.clamp(torch.sum(pred * m), min=1.0)
    return {
        "test_correct": tp,
        "test_loss": torch.sum(bce * batch["mask"]),
        "test_total": predicted,
        "test_precision": tp / predicted,
        "test_recall": tp / torch.clamp(torch.sum(y * m), min=1.0),
    }


def _pixel_mask(batch: Batch, ce: torch.Tensor) -> torch.Tensor:
    """An example-level ``[B]`` (or pixel-level ``[B, H, W]``) mask broadcast
    to the per-pixel CE's shape."""
    m = batch["mask"]
    while m.ndim < ce.ndim:
        m = m[..., None]
    return m.expand(ce.shape)


def _masked_seg_ce(logits: torch.Tensor, batch: Batch):
    """The validity contract the segmentation loss and metrics share: a label
    outside ``[0, C)`` (the 255 ignore label) leaves the mask, and the CE
    runs on the clipped label (an out-of-range label's CE times a 0 mask
    would be NaN). Returns (ce, mask, clipped labels)."""
    num_classes = logits.shape[-1]
    y = batch["y"]
    valid = ((y >= 0) & (y < num_classes)).float()
    y_safe = torch.clamp(y, 0, num_classes - 1)
    ce = _cross_entropy(logits, y_safe)
    return ce, _pixel_mask(batch, ce) * valid, y_safe


def segmentation_loss(logits: torch.Tensor, batch: Batch) -> torch.Tensor:
    """Per-pixel CE of ``[B, H, W, C]`` logits against ``[B, H, W]`` integer
    labels, averaged over the valid pixels."""
    ce, m, _ = _masked_seg_ce(logits, batch)
    return torch.sum(ce * m) / torch.clamp(collectives.axis_sum(torch.sum(m), SILO_AXIS),
                                           min=1.0)


def segmentation_metrics(logits: torch.Tensor, batch: Batch) -> dict[str, torch.Tensor]:
    """Summed pixel counts and the ``[C, C]`` confusion matrix, indexed
    (true, predicted) and weighted by the mask. The matrix is an
    out-of-place ``scatter_add``, which ``torch.func.vmap`` maps over the
    clients of a per-client evaluation; its counts are integers in f32,
    exact up to 2^24 a cell in any order of addition."""
    num_classes = logits.shape[-1]
    pred = torch.argmax(logits, -1)
    ce, m, y_safe = _masked_seg_ce(logits, batch)
    correct = (pred == batch["y"]).float()
    idx = (y_safe.long() * num_classes + pred).reshape(-1)  # in bounds, masked to 0 if ignored
    conf = torch.zeros(num_classes * num_classes, dtype=torch.float32,
                       device=logits.device).scatter_add(0, idx, m.reshape(-1).float())
    return {
        "test_correct": torch.sum(correct * m),
        "test_loss": torch.sum(ce * m),  # per-pixel sum; the engine divides by the total
        "test_total": torch.sum(m),
        "confusion": conf.reshape(num_classes, num_classes),
    }


TASKS: dict[str, tuple[Callable, Callable]] = {
    "classification": (classification_loss, classification_metrics),
    "nwp": (lm_loss, lm_metrics),
    "char_lm": (lm_loss, lm_metrics),
    "tag": (tag_loss, tag_metrics),
    "segmentation": (segmentation_loss, segmentation_metrics),
}


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.chain(optax.add_decayed_weights(weight_decay), optax.sgd(lr,
    momentum))`` (``repro_cross_silo.py:246-249``) in two forms that agree:

    - called on parameters, a fresh ``torch.optim.SGD`` (the scan mode's
      per-client optimizer). With ``dampening=0`` torch adds the decay to the
      gradient, keeps optax's ``trace`` (g + momentum * trace, from zero) as
      its momentum buffer and subtracts ``lr`` times it;
    - :meth:`init` and :meth:`update`, the same arithmetic as a pure function
      of state dicts whose tensors may carry a leading client axis (the vmap
      mode's).

    Decay applies to what the optimizer is given, the parameters; the model
    state (BN statistics) is never decayed."""

    lr: float
    momentum: float = 0.0
    weight_decay: float = 0.0

    def __call__(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        params = list(params)
        optimizer = _SGD(params, lr=self.lr, momentum=self.momentum, dampening=0.0,
                         weight_decay=self.weight_decay)
        if self.momentum:
            # optax's trace from zero, made up front: torch's first step would
            # clone the gradient, 0 * momentum + g is the same value, and a
            # masked step (_SGD.step_where) then has a buffer to keep
            for p in params:
                optimizer.state[p]["momentum_buffer"] = torch.zeros_like(p)
        return optimizer

    def init(self, params: StateDict, lead: tuple[int, ...] = ()) -> StateDict:
        """The momentum trace, zero (empty without momentum); ``lead`` (the
        client axis, already on the parameters) is :class:`Adam`'s."""
        return {k: torch.zeros_like(v) for k, v in params.items()} if self.momentum else {}

    def update(self, grads: StateDict, state: StateDict,
               params: StateDict) -> tuple[StateDict, StateDict]:
        """``(new_params, new_state)`` after one step."""
        new_params, new_state = {}, {}
        for k, p in params.items():
            g = grads[k]
            if self.weight_decay:
                g = g + self.weight_decay * p
            if self.momentum:
                g = g + self.momentum * state[k]
                new_state[k] = g
            new_params[k] = p - self.lr * g
        return new_params, new_state


def sgd(lr: float, momentum: float = 0.0, weight_decay: float = 0.0) -> SGD:
    return SGD(lr, momentum, weight_decay)


def _write(active: torch.Tensor | None, new: torch.Tensor, old: torch.Tensor) -> None:
    """``old = new``, in place; given ``active`` (a bool tensor on the
    device), only where it holds."""
    if active is None:
        old.copy_(new)
    else:
        torch.where(active, new, old, out=old)


class _SGD(torch.optim.SGD):
    """``torch.optim.SGD`` with :meth:`step_where`, a step a CUDA graph can
    hold as a no-op on the device."""

    @torch.no_grad()
    def step_where(self, active: torch.Tensor) -> None:
        """:meth:`step`, written only where ``active`` (a bool tensor on the
        device, never read on the host) holds: torch's multi-tensor
        arithmetic (per device and dtype, the momentum buffers made up
        front), each new parameter and buffer computed aside and written
        under ``torch.where``."""
        for group in self.param_groups:
            lr, momentum, decay = group["lr"], group["momentum"], group["weight_decay"]
            kinds: dict = {}
            for p in group["params"]:
                if p.grad is not None:
                    kinds.setdefault((p.device, p.dtype), []).append(p)
            for params in kinds.values():
                grads = [p.grad for p in params]
                if decay:
                    grads = torch._foreach_add(grads, params, alpha=decay)
                if momentum:
                    bufs = [self.state[p]["momentum_buffer"] for p in params]
                    new_bufs = torch._foreach_mul(bufs, momentum)
                    torch._foreach_add_(new_bufs, grads, alpha=1.0)
                    for new, old in zip(new_bufs, bufs):
                        _write(active, new, old)
                    grads = new_bufs
                for new, old in zip(torch._foreach_add(params, grads, alpha=-lr), params):
                    _write(active, new, old)


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.chain(optax.add_decayed_weights(weight_decay), optax.adam(lr))``
    (``main_fedavg.py:335-341``): b1 0.9, b2 0.999, eps 1e-8 added outside
    the square root, bias correction from the step count. The decay is added
    to the gradient (L2, not AdamW). Two forms that agree, as :class:`SGD`'s:

    - :meth:`init` and :meth:`update`, optax's arithmetic as a pure function
      of state dicts whose tensors may carry a leading client axis. The state
      is flat: ``mu/<name>``, ``nu/<name>`` and ``count``, the count shaped
      ``lead`` (the client axis) so that ``torch.func.vmap`` maps it;
    - called on parameters, a fresh ``torch.optim.Optimizer`` whose step is
      :meth:`update` on each parameter. ``torch.optim.Adam`` is the same
      algorithm in another arithmetic (``sqrt(nu) / sqrt(1 - b2^t)``, a
      ``lerp`` for the first moment), ~1e-6 from optax after five steps
      where :meth:`update` stays within 3e-8."""

    lr: float
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def __call__(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        return _StepsOf(params, self)

    def init(self, params: StateDict, lead: tuple[int, ...] = ()) -> StateDict:
        state = {f"{m}/{k}": torch.zeros_like(v) for m in ("mu", "nu") for k, v in params.items()}
        device = next(iter(params.values())).device
        state["count"] = torch.zeros(lead, dtype=torch.int32, device=device)
        return state

    def update(self, grads: StateDict, state: StateDict,
               params: StateDict) -> tuple[StateDict, StateDict]:
        count = state["count"] + 1
        corrections = {}  # optax's bias corrections, in each parameter dtype
        new_params, new_state = {}, {"count": count}
        for k, p in params.items():
            if p.dtype not in corrections:
                t = count.to(p.dtype)
                corrections[p.dtype] = (1 - self.b1 ** t, 1 - self.b2 ** t)
            c1, c2 = corrections[p.dtype]
            g = grads[k]
            if self.weight_decay:
                g = g + self.weight_decay * p
            mu = (1 - self.b1) * g + self.b1 * state[f"mu/{k}"]
            nu = (1 - self.b2) * (g * g) + self.b2 * state[f"nu/{k}"]
            new_state[f"mu/{k}"], new_state[f"nu/{k}"] = mu, nu
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            new_params[k] = p + u * (-self.lr)
        return new_params, new_state


def adam(lr: float, weight_decay: float = 0.0) -> Adam:
    return Adam(lr, weight_decay)


class _StepsOf(torch.optim.Optimizer):
    """A ``torch.optim.Optimizer`` that steps each parameter with a
    functional optimizer's ``init``/``update`` (its state per parameter,
    made up front)."""

    def __init__(self, params, functional):
        super().__init__(params, {})
        self._functional = functional
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p].update(functional.init({"p": p}))

    @torch.no_grad()
    def step(self, closure=None):
        self.step_where(None)

    @torch.no_grad()
    def step_where(self, active: torch.Tensor | None) -> None:
        """:meth:`step`, written only where ``active`` (a bool tensor on the
        device, never read on the host) holds; ``None``: everywhere."""
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                new_p, new_state = self._functional.update({"p": p.grad}, state, {"p": p})
                _write(active, new_p["p"], p)
                for k, v in new_state.items():
                    _write(active, v, state[k])


# ---------------------------------------------------------------------------
# Dropout masks
# ---------------------------------------------------------------------------


def draw_dropout_masks(sites: dict, generator: torch.Generator,
                       lead: tuple[int, ...]) -> dict[str, torch.Tensor]:
    """Keep masks for ``sites`` (site -> (one example's shape, rate)):
    ``lead + shape`` bools, each True with probability ``1 - rate`` (flax's
    ``bernoulli(keep_prob)``: a uniform draw below ``keep_prob``), drawn in
    site order from ``generator`` on its device. A site whose rate is None
    draws f32 standard normals instead (the GAN's latent ``z``,
    ``algorithms/fedgan.py``)."""
    out = {}
    for name, (shape, rate) in sites.items():
        size = lead + tuple(shape)
        if rate is None:
            out[name] = torch.randn(size, generator=generator, device=generator.device)
        else:
            out[name] = torch.rand(size, generator=generator, device=generator.device) < 1.0 - rate
    return out


def site_dtype(rate) -> torch.dtype:
    """The dtype of a site's draw: bool keep masks, f32 normals for a rate
    of None."""
    return torch.float32 if rate is None else torch.bool


class DropoutStream:
    """One round's dropout masks: step ``t`` (``e * S + s``) of the round
    draws ``[C, B, ...]`` masks for the whole cohort from a generator on
    ``device`` seeded from ``(seed, round_idx, t)``, so a step's masks are a
    pure function of those three. The vmapped mode takes them whole, the
    client-by-client mode takes client ``c``'s slice of the same draw. The
    draw reseeds the generator, which a CUDA graph cannot capture: a round
    replayed from a graph reads the same masks from buffers filled before
    the replay (``sim/graphs.py``)."""

    def __init__(self, sites: dict, seed: int, round_idx: int, cohort: int, batch: int,
                 device: torch.device):
        self.sites, self.seed, self.round_idx = sites, int(seed), int(round_idx)
        self.lead = (int(cohort), int(batch))
        self._generator = torch.Generator(device=device)

    def masks(self, step: int) -> dict[str, torch.Tensor]:
        mixed = np.random.SeedSequence(
            [self.seed, self.round_idx, int(step), 0xD80]).generate_state(1, np.uint64)[0]
        self._generator.manual_seed(int(mixed))
        return draw_dropout_masks(self.sites, self._generator, self.lead)


class LaneDropout:
    """A packed pass's dropout keep masks, ``[S_lane, L, B, ...]`` buffers
    served by lane step: lane ``l`` at lane step ``t`` runs client slot
    ``c`` at chain step ``g`` and reads slice ``c`` of step ``g``'s draw of
    the round's :class:`DropoutStream`, the masks the padded round gives
    that client at that step. :meth:`fill` draws each distinct chain step
    of the pass once and scatters its slices into place; a lane step that
    runs no client keeps stale masks, which its fully padded batch never
    uses. The buffers are fixed, so a CUDA graph of the pass reads them."""

    def __init__(self, sites: dict, s_lane: int, lanes: int, batch: int,
                 device: torch.device):
        self.buffers = {name: torch.zeros((s_lane, lanes, batch) + tuple(shape),
                                          dtype=torch.bool, device=device)
                        for name, (shape, _) in sites.items()}

    def masks(self, t: int) -> dict[str, torch.Tensor]:
        return {k: b[t] for k, b in self.buffers.items()}

    def fill(self, stream: DropoutStream, order) -> None:
        """``order`` is the pass's ``(pos, slots, groups)``: ``pos`` the flat
        ``t * L + l`` positions of its live lane steps and ``slots`` their
        client slots (device tensors, sorted by chain step), ``groups`` the
        host's ``(g, lo, hi)`` runs of one chain step ``g`` in them."""
        pos, slots, groups = order
        for g, lo, hi in groups:
            for k, m in stream.masks(g).items():
                flat = self.buffers[k].view((-1,) + tuple(m.shape[1:]))
                flat.index_copy_(0, pos[lo:hi], m.index_select(0, slots[lo:hi]))


# ---------------------------------------------------------------------------
# In-silo data parallelism
# ---------------------------------------------------------------------------


def silo_size() -> int:
    """The rank count of the bound ``silo`` axis (1 outside a silo)."""
    return collectives.group_size(collectives.bound(SILO_AXIS))


def silo_sum(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each tensor summed over the bound ``silo`` axis, in one reduce of
    their concatenation (in their promoted dtype), each cast back: a silo
    step's gradients, loss and mask count. Under ``torch.func.vmap`` the
    cohort's ``[C_local, ...]`` tensors go in the same one call."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    total = collectives.axis_sum(torch.cat([t.reshape(-1).to(dtype) for t in tensors]),
                                 SILO_AXIS)
    out, at = [], 0
    for t in tensors:
        out.append(total[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


# ---------------------------------------------------------------------------
# ClientTrainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClientTrainer:
    """A module (whose variables are the working copy of the client model),
    a task, an optimizer (:class:`SGD` or :class:`Adam`), the local epoch
    count and FedProx's proximal coefficient ``prox_mu``, the JAX fields in
    their order; then an optional augmentation of training batches
    (:class:`~fedml_tpu_torch.ops.augment.ImageAugment`; evaluation never
    sees it), which the JAX package adds by wrapping the trainer."""

    module: torch.nn.Module
    task: str = "classification"
    optimizer: Any = dataclasses.field(default_factory=lambda: sgd(0.03))
    epochs: int = 1
    prox_mu: float = 0.0
    augment: Any = None

    def __post_init__(self):
        if self.task not in TASKS:
            raise ValueError(f"unknown task {self.task!r} (one of {sorted(TASKS)})")

    @property
    def loss_and_metrics(self):
        return TASKS[self.task]

    @property
    def stateful(self) -> bool:
        """Whether the module carries model state (buffers)."""
        return next(self.module.buffers(), None) is not None

    def init(self, generator: torch.Generator) -> StateDict:
        """Fresh variables drawn from ``generator`` (the module's own
        initialisers), as a detached copy."""
        self.module.reset_parameters(generator)
        return {k: v.detach().clone() for k, v in self.module.state_dict().items()}

    @property
    def dropout_sites(self) -> dict:
        """The module's dropout sites with a rate above 0 (site -> (one
        example's shape, rate)); empty for a module without dropout."""
        return dict(getattr(self.module, "dropout_sites", {}))

    def _train_kwargs(self, masks) -> dict:
        if self.dropout_sites:
            return {"train": True, "dropout": masks}
        if self.stateful:
            return {"train": True}
        return {}

    def forward_train(self, x: torch.Tensor, masks=None) -> tuple[torch.Tensor, StateDict]:
        """A training forward on the module's own variables: ``(logits,
        new model state)``; ``masks`` are the step's dropout keep masks."""
        out = self.module(x, **self._train_kwargs(masks))
        return out if self.stateful else (out, {})

    def apply_train(self, params: StateDict, state: StateDict, x: torch.Tensor,
                    masks=None) -> tuple[torch.Tensor, StateDict]:
        """:meth:`forward_train` as a pure function of the variables."""
        out = torch.func.functional_call(self.module, {**params, **state}, (x,),
                                         self._train_kwargs(masks))
        return out if self.stateful else (out, {})

    def prox_term(self, params: StateDict, global_params: StateDict) -> torch.Tensor:
        """FedProx's ``0.5 * mu * ||params - global_params||^2`` over the
        parameters (``fedml_tpu/core/trainer.py:206-210``)."""
        total = 0.0
        for k, p in params.items():
            d = p - global_params[k]
            total = total + torch.sum(d * d)
        return 0.5 * self.prox_mu * total

    def train_step(self, optimizer: torch.optim.Optimizer, batch: Batch,
                   has_data: bool | None = None, global_params: StateDict | None = None,
                   masks=None, active: torch.Tensor | None = None) -> torch.Tensor:
        """One masked step on the module's variables; returns the loss (the
        proximal term included when ``prox_mu`` > 0, taken against
        ``global_params``). ``masks`` are the step's dropout keep masks. The
        model state takes the values the training forward returned. A fully
        padded batch (mask all zero) is a no-op that leaves parameters,
        optimizer state and model state untouched, and reports loss 0 (the
        masked mean of nothing). ``has_data`` may be passed when the caller
        already knows it, to spare a device-to-host read. Given ``active`` (a
        bool tensor on the device), the step is computed and written only
        where it holds, with no host read: the parameters and the optimizer
        state through the optimizer's ``step_where`` (the port's
        :func:`sgd` and :func:`adam` have one), the model state under
        ``torch.where``."""
        if active is not None:
            if not hasattr(optimizer, "step_where"):
                raise TypeError(f"a step masked on the device needs an optimizer with "
                                f"step_where (the port's sgd or adam), not {type(optimizer)}")
            has_data = True
        if has_data is None:
            has_data = bool(collectives.axis_sum(torch.sum(batch["mask"]), SILO_AXIS) > 0)
        if not has_data:
            return torch.zeros((), dtype=torch.float32, device=batch["mask"].device)
        self.module.train()
        optimizer.zero_grad(set_to_none=True)
        logits, new_state = self.forward_train(batch["x"], masks)
        loss = self.loss_and_metrics[0](logits, batch)
        del logits  # backward keeps what it needs; the LM's [B, T, V] logits are ~1 GiB
        n_silo = silo_size()
        if self.prox_mu > 0.0:
            prox = self.prox_term(dict(self.module.named_parameters()), global_params)
            # in a silo each rank adds its share: the shares' gradients sum
            loss = loss + (prox if n_silo == 1 else prox / n_silo)
        loss.backward()
        if n_silo > 1:
            # the silo's gradient is the sum of its ranks' (DDP's all-reduce)
            params = [p for p in self.module.parameters() if p.grad is not None]
            *grads, loss = silo_sum([p.grad for p in params] + [loss.detach()])
            for p, g in zip(params, grads):
                p.grad = g
        if active is None:
            optimizer.step()
        else:
            optimizer.step_where(active)
        if new_state:
            buffers = dict(self.module.named_buffers())
            with torch.no_grad():
                for k, v in new_state.items():
                    buffers[k].copy_(v if active is None else torch.where(active, v, buffers[k]))
        return loss.detach()

    @torch.no_grad()
    def eval_batch(self, batch: Batch) -> dict[str, torch.Tensor]:
        """Summed metrics of the module's current variables on one batch."""
        self.module.eval()
        return self.loss_and_metrics[1](self.module(batch["x"]), batch)


# ---------------------------------------------------------------------------
# Local training and evaluation programs
# ---------------------------------------------------------------------------


def _last_epoch(num_steps, steps: int, epochs: int):
    """The last epoch with an executed step under the budget ``num_steps``."""
    if num_steps is None:
        return epochs - 1
    if isinstance(num_steps, torch.Tensor):
        return torch.clamp(torch.clamp((num_steps - 1) // steps, max=epochs - 1), min=0)
    return max(min((int(num_steps) - 1) // steps, epochs - 1), 0)


def _augmented(trainer: ClientTrainer, batch: Batch, draws, e: int, s: int) -> Batch:
    """The training batch of epoch ``e``, step ``s``, augmented with the
    round's draws (``[..., E, S, B]`` tensors) when the trainer augments."""
    if trainer.augment is None:
        return batch
    return {**batch, "x": trainer.augment.apply(batch["x"],
                                                {k: d[..., e, s, :] for k, d in draws.items()})}


def make_local_train(trainer: ClientTrainer):
    """Returns ``local_train(global_variables, data, num_steps=None,
    draws=None, dropout=None, slot=0) -> (variables, metrics)``, one client's
    training.

    ``data`` holds one client's epoch of batches stacked on a leading steps
    axis: ``{"x": [S, B, ...], "y": [S, B, ...], "mask": [S, B, ...]}``. The
    module is loaded with ``global_variables`` and trained for
    ``trainer.epochs`` passes over the S batches with a fresh optimizer.
    A step whose batch is fully padded, or whose global index ``e * S + s``
    is not below ``num_steps`` (the straggler budget), trains nothing. With
    ``num_steps`` an int (or None) the host skips such steps, reading which
    steps hold data from the device once; with ``num_steps`` a tensor on the
    device every step runs and such a step is a masked no-op
    (:meth:`ClientTrainer.train_step` given ``active``), decided on the device as the
    vmapped step and the JAX scan mode decide it: nothing waits for the
    device, so a CUDA graph can capture the round (``sim/graphs.py``). The
    two give bitwise-equal results; skipping does not compute the steps it
    skips. ``draws`` are the client's augmentation draws for the round
    (``[E, S, B]`` tensors, :meth:`ImageAugment.draw`), needed when the
    trainer augments; ``dropout`` is the round's :class:`DropoutStream`, of
    which the client takes cohort row ``slot``, needed when the module has
    dropout. ``metrics["train_loss"]`` is the mean loss over the executed
    steps of the last executed epoch. The returned variables are a copy of
    the trained parameters and model state."""

    def local_train(global_variables: StateDict, data: Batch, num_steps=None, draws=None,
                    dropout: DropoutStream | None = None, slot: int = 0):
        if trainer.dropout_sites and dropout is None:
            raise ValueError("the module has dropout: local_train needs the round's "
                             "DropoutStream")
        trainer.module.load_state_dict(global_variables)
        optimizer = trainer.optimizer(trainer.module.parameters())
        global_params = ({k: global_variables[k] for k, _ in trainer.module.named_parameters()}
                         if trainer.prox_mu > 0.0 else None)
        S, E = data["mask"].shape[0], trainer.epochs
        device = data["mask"].device
        # a step runs where any of a silo's ranks has data in it
        has_data = collectives.axis_sum(data["mask"].reshape(S, -1).sum(1), SILO_AXIS) > 0
        masked = isinstance(num_steps, torch.Tensor)
        if masked:
            active = has_data & (torch.arange(E * S, device=device).reshape(E, S) < num_steps)
        else:
            has_data = has_data.tolist()
        loss_sums, w_sums = [], []
        for e in range(E):
            total = torch.zeros((), dtype=torch.float32, device=device)
            w = torch.zeros((), dtype=torch.float32, device=device)
            for s in range(S):
                if not masked and (not has_data[s]
                                   or (num_steps is not None and e * S + s >= num_steps)):
                    continue
                batch = _augmented(trainer, {k: v[s] for k, v in data.items()}, draws, e, s)
                masks = (None if not trainer.dropout_sites else
                         {k: m[slot] for k, m in dropout.masks(e * S + s).items()})
                if masked:
                    loss = trainer.train_step(optimizer, batch, global_params=global_params,
                                              masks=masks, active=active[e, s])
                    total = total + torch.where(active[e, s], loss, 0.0)
                    w = w + active[e, s].float()
                else:
                    total = total + trainer.train_step(optimizer, batch, has_data=True,
                                                       global_params=global_params,
                                                       masks=masks)
                    w = w + 1.0
            loss_sums.append(total)
            w_sums.append(w)
        last = _last_epoch(num_steps, S, E)
        trainer.module.zero_grad(set_to_none=True)
        variables = {k: v.detach().clone() for k, v in trainer.module.state_dict().items()}
        sums, counts = torch.stack(loss_sums), torch.stack(w_sums)
        if masked:  # the last epoch is a device index, read on the device
            last = last.long()
            sums, counts = torch.take(sums, last), torch.take(counts, last)
        else:
            sums, counts = sums[last], counts[last]
        return variables, {"train_loss": sums / torch.clamp(counts, min=1.0)}

    return local_train


def _functional_step(trainer: ClientTrainer):
    """One client's step as a pure function, ``step(params, state,
    opt_state, batch, global_params) -> (params, state, opt_state, loss,
    w)``, to be batched by ``torch.func.vmap``: ``torch.func.grad_and_value``
    over the functional apply of the module, the optimizer's functional
    update, and a no-op (``torch.where(has_data, new, old)`` on all three)
    when the batch is fully padded. ``w`` is 1.0 where the step saw data.
    Raises when the trainer's optimizer has no functional form."""
    opt = trainer.optimizer
    if not (callable(getattr(opt, "init", None)) and callable(getattr(opt, "update", None))):
        raise TypeError(
            "cohort_execution='vmap' steps the optimizer's functional form (init/update, "
            f"e.g. fedml_tpu_torch.core.trainer.sgd or adam); {opt!r} has none")
    loss_of = trainer.loss_and_metrics[0]

    def loss_fn(params, state, batch, global_params):
        logits, new_state = trainer.apply_train(params, state, batch["x"],
                                                batch.get("dropout"))
        loss = loss_of(logits, batch)
        if trainer.prox_mu > 0.0:
            prox = trainer.prox_term(params, global_params)
            n_silo = silo_size()
            loss = loss + (prox if n_silo == 1 else prox / n_silo)
        return loss, new_state

    def step(params, state, opt_state, batch, global_params):
        grads, (loss, new_state) = torch.func.grad_and_value(loss_fn, has_aux=True)(
            params, state, batch, global_params)
        count = torch.sum(batch["mask"])
        if silo_size() > 1:
            # a silo's step: its ranks' gradients, loss shares and mask
            # counts summed in one reduce before the update
            names = list(grads)
            *summed, loss, count = silo_sum([grads[k] for k in names] + [loss, count])
            grads = dict(zip(names, summed))
        has_data = count > 0
        new_params, new_opt_state = opt.update(grads, opt_state, params)

        def keep(new, old):
            return {k: torch.where(has_data, new[k], old[k]) for k in old}

        return (keep(new_params, params), keep(new_state, state),
                keep(new_opt_state, opt_state), loss, has_data.float())

    return step


def make_vmap_train(trainer: ClientTrainer, per_client: bool = False):
    """Returns ``vmap_train(global_variables, data, num_steps, draws=None) ->
    (stacked_variables, metrics)``, the whole cohort's training at once
    (``fedml_tpu/core/trainer.py:247-312`` under ``jax.vmap``).

    ``data`` is the cohort's ``[C, S, B, ...]`` batch stack, ``num_steps``
    the ``[C]`` per-client step budgets, ``draws`` the ``[C, E, S, B]``
    augmentation draws, ``dropout`` the round's :class:`DropoutStream` (each
    step's ``[C, B, ...]`` masks enter the mapped step as batched inputs).
    Every client starts from ``global_variables`` with a fresh optimizer
    state; the proximal term takes ``global_variables``' parameters
    unbatched; ``(params, model_state, opt_state)`` are carried
    stacked ``[C, ...]`` through E epochs x S steps, each step one
    ``torch.func.vmap`` of :func:`_functional_step`. A client's step is a
    no-op when its batch is fully padded or past its budget.
    ``metrics["train_loss"]`` ``[C]`` is each client's mean loss over the
    executed steps of its last executed epoch. The variables come back
    stacked ``[C, ...]`` in ``global_variables``' key order.

    With ``per_client`` (the engine's per-client mode, ``var_axis = 0`` in
    ``fedml_tpu/sim/engine.py:893-905``) ``global_variables`` is already the
    ``[C, ...]`` stack of the clients' own models: client c starts from row
    c, and the proximal term takes row c's parameters.

    Raises when the trainer's optimizer has no functional form: the vmap
    mode never falls back to training clients one at a time."""
    opt = trainer.optimizer
    vstep = torch.func.vmap(_functional_step(trainer),
                            in_dims=(0, 0, 0, 0, 0 if per_client else None))
    param_names = [k for k, _ in trainer.module.named_parameters()]

    def vmap_train(global_variables: StateDict, data: Batch, num_steps: torch.Tensor,
                   draws=None, dropout: DropoutStream | None = None):
        if trainer.dropout_sites and dropout is None:
            raise ValueError("the module has dropout: vmap_train needs the round's "
                             "DropoutStream")
        C, S = data["mask"].shape[:2]
        stacked = (global_variables if per_client else
                   {k: v.unsqueeze(0).expand((C,) + v.shape) for k, v in global_variables.items()})
        params = {k: stacked[k] for k in param_names}
        state = {k: v for k, v in stacked.items() if k not in params}
        global_params = ({k: global_variables[k] for k in param_names}
                         if trainer.prox_mu > 0.0 else {})
        opt_state = opt.init(params, (C,))
        loss_sums, w_sums = [], []
        for e in range(trainer.epochs):
            total = torch.zeros(C, dtype=torch.float32, device=data["mask"].device)
            w = torch.zeros_like(total)
            for s in range(S):
                batch = {k: v[:, s] for k, v in data.items()}
                active = ((e * S + s) < num_steps).float()
                batch["mask"] = batch["mask"] * active.reshape(
                    (C,) + (1,) * (batch["mask"].dim() - 1))
                batch = _augmented(trainer, batch, draws, e, s)
                if trainer.dropout_sites:
                    batch["dropout"] = dropout.masks(e * S + s)
                params, state, opt_state, loss, w_s = vstep(params, state, opt_state, batch,
                                                            global_params)
                total = total + loss * w_s
                w = w + w_s
            loss_sums.append(total)
            w_sums.append(w)
        last = _last_epoch(num_steps, S, trainer.epochs)
        rows = torch.arange(C, device=last.device)
        train_loss = (torch.stack(loss_sums)[last, rows]
                      / torch.clamp(torch.stack(w_sums)[last, rows], min=1.0))
        merged = {**params, **state}
        return {k: merged[k] for k in global_variables}, {"train_loss": train_loss}

    return vmap_train


def make_lane_step(trainer: ClientTrainer):
    """One packed-lane step (``fedml_tpu/core/trainer.py:315-342``):
    ``lane_step(params, state, opt_state, global_variables, opt0, batch,
    is_first, global_params) -> (params, state, opt_state, loss, w)``.

    The packed execution mode (``SimConfig.pack_lanes``) runs a lane that
    carries one client's training state at a time; ``is_first`` marks a
    client boundary: the carry is reset to the broadcast global variables
    and the fresh optimizer state ``opt0`` by a pure select
    (``torch.where``, no arithmetic, so the reset is bit-exact), then the
    ordinary step of :func:`make_vmap_train` runs (:func:`_functional_step`).
    ``w`` is the step's loss weight (did the step see data).
    ``global_params`` are the proximal term's (empty without one). Written
    to be batched by ``torch.func.vmap`` over the lane axis, with
    ``global_variables``, ``opt0`` and ``global_params`` unbatched and
    ``is_first`` a per-lane bool."""
    step = _functional_step(trainer)

    def lane_step(params: StateDict, state: StateDict, opt_state: StateDict,
                  global_variables: StateDict, opt0: StateDict, batch: Batch,
                  is_first: torch.Tensor, global_params: StateDict):
        def reset(fresh, carried):
            return {k: torch.where(is_first, fresh[k], carried[k]) for k in carried}

        return step(reset(global_variables, params), reset(global_variables, state),
                    reset(opt0, opt_state), batch, global_params)

    return lane_step


def make_local_update(trainer: ClientTrainer, codec=None, local_train_fn=None):
    """Compressed local-update program (``fedml_tpu/core/trainer.py:345-378``):
    ``local_update(global_variables, data, rng, residual=None,
    num_steps=None, draws=None, dropout=None, slot=0) -> (payload,
    new_residual, metrics)``.

    Runs :func:`make_local_train` (``draws``, ``dropout`` and ``slot`` are
    its), takes the model delta, adds the carried error-feedback
    ``residual`` (``compress/error_feedback.py``) and encodes it with
    ``codec`` (``compress/codec.py``), whose uniforms come from ``rng``
    (``rng.uniform(shape)``, e.g. a
    :class:`~fedml_tpu_torch.core.rng.RoundNoise`): the client side of the
    update-compression subsystem. ``codec=None`` returns the raw delta
    (``payload`` is a state dict); otherwise ``payload`` is an
    ``EncodedUpdate`` and ``metrics`` gains ``uplink_bytes`` and
    ``uplink_dense_bytes`` (f32 tensors)."""
    from fedml_tpu_torch.compress import error_feedback as ef
    from fedml_tpu_torch.compress.codec import tree_bytes
    from fedml_tpu_torch.core import tree as treelib

    local_train = local_train_fn or make_local_train(trainer)

    def local_update(global_variables: StateDict, data: Batch, rng, residual=None,
                     num_steps=None, draws=None, dropout: DropoutStream | None = None,
                     slot: int = 0):
        new_vars, metrics = local_train(global_variables, data, num_steps, draws, dropout, slot)
        delta = treelib.sub(new_vars, global_variables)
        if codec is None:
            return delta, residual, metrics
        comp = ef.compensate(delta, residual)
        enc, _, new_residual = ef.encode_with_feedback(codec, comp, rng)
        device = data["mask"].device
        metrics = dict(metrics)
        metrics["uplink_bytes"] = torch.full((), float(enc.nbytes), device=device)
        metrics["uplink_dense_bytes"] = torch.full((), float(tree_bytes(delta)), device=device)
        return enc, new_residual, metrics

    return local_update


def make_local_eval(trainer: ClientTrainer):
    """``local_eval(variables, data) -> summed metric dict`` over
    ``[S, B, ...]`` batches."""

    def local_eval(variables: StateDict, data: Batch) -> dict[str, torch.Tensor]:
        trainer.module.load_state_dict(variables)
        summed: dict[str, torch.Tensor] = {}
        for s in range(data["mask"].shape[0]):
            m = trainer.eval_batch({k: v[s] for k, v in data.items()})
            summed = {k: summed.get(k, 0) + v for k, v in m.items()}
        return summed

    return local_eval
