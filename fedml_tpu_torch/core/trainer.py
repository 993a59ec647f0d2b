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

Two local-training programs, one per cohort mode of the engine:

- :func:`make_local_train` (``cohort_execution="scan"``): one client at a
  time, a Python loop over steps on the module's own parameters with a fresh
  ``torch.optim.SGD``;
- :func:`make_vmap_train` (``"vmap"``): the whole cohort at once, a pure
  function of ``(params, model_state, opt_state)`` stacked ``[C, ...]``,
  stepped by ``torch.func.vmap`` of ``torch.func.grad_and_value`` over a
  functional apply of the module and the optimizer's functional form.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import torch
import torch.nn.functional as F

Batch = dict[str, torch.Tensor]
StateDict = dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# Task losses / metrics
# ---------------------------------------------------------------------------


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    total = torch.sum(values * mask)
    count = torch.clamp(torch.sum(mask), min=1.0)
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


TASKS: dict[str, tuple[Callable, Callable]] = {
    "classification": (classification_loss, classification_metrics),
    "nwp": (lm_loss, lm_metrics),
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
        return torch.optim.SGD(params, lr=self.lr, momentum=self.momentum, dampening=0.0,
                               weight_decay=self.weight_decay)

    def init(self, params: StateDict) -> StateDict:
        """The momentum trace, zero (empty without momentum)."""
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


# ---------------------------------------------------------------------------
# ClientTrainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClientTrainer:
    """A module (whose variables are the working copy of the client model),
    a task, an optimizer (:class:`SGD`), the local epoch count and an
    optional augmentation of training batches
    (:class:`~fedml_tpu_torch.ops.augment.ImageAugment`; evaluation never
    sees it)."""

    module: torch.nn.Module
    task: str = "classification"
    optimizer: SGD = dataclasses.field(default_factory=lambda: sgd(0.03))
    epochs: int = 1
    augment: Any = None

    def __post_init__(self):
        if self.task not in TASKS:
            raise NotImplementedError(
                f"task {self.task!r} is not ported yet (ported: {sorted(TASKS)}); "
                "ROADMAP §A3 and the slices that need it")

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

    def forward_train(self, x: torch.Tensor) -> tuple[torch.Tensor, StateDict]:
        """A training forward on the module's own variables: ``(logits,
        new model state)``."""
        if self.stateful:
            return self.module(x, train=True)
        return self.module(x), {}

    def apply_train(self, params: StateDict, state: StateDict,
                    x: torch.Tensor) -> tuple[torch.Tensor, StateDict]:
        """:meth:`forward_train` as a pure function of the variables."""
        if state:
            return torch.func.functional_call(self.module, {**params, **state}, (x,),
                                              {"train": True})
        return torch.func.functional_call(self.module, params, (x,)), {}

    def train_step(self, optimizer: torch.optim.Optimizer, batch: Batch,
                   has_data: bool | None = None) -> torch.Tensor:
        """One masked SGD step on the module's variables; returns the loss.
        The model state takes the values the training forward returned. A
        fully padded batch (mask all zero) is a no-op that leaves parameters,
        optimizer state and model state untouched, and reports loss 0 (the
        masked mean of nothing). ``has_data`` may be passed when the caller
        already knows it, to spare a device-to-host read."""
        if has_data is None:
            has_data = bool(torch.sum(batch["mask"]) > 0)
        if not has_data:
            return torch.zeros((), dtype=torch.float32, device=batch["mask"].device)
        self.module.train()
        optimizer.zero_grad(set_to_none=True)
        logits, new_state = self.forward_train(batch["x"])
        loss = self.loss_and_metrics[0](logits, batch)
        del logits  # backward keeps what it needs; the LM's [B, T, V] logits are ~1 GiB
        loss.backward()
        optimizer.step()
        if new_state:
            buffers = dict(self.module.named_buffers())
            with torch.no_grad():
                for k, v in new_state.items():
                    buffers[k].copy_(v)
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
    draws=None) -> (variables, metrics)``, one client's training.

    ``data`` holds one client's epoch of batches stacked on a leading steps
    axis: ``{"x": [S, B, ...], "y": [S, B, ...], "mask": [S, B, ...]}``. The
    module is loaded with ``global_variables`` and trained for
    ``trainer.epochs`` passes over the S batches with a fresh optimizer.
    Steps with global index ``e * S + s >= num_steps`` are masked no-ops (the
    straggler budget). ``draws`` are the client's augmentation draws for the
    round (``[E, S, B]`` tensors, :meth:`ImageAugment.draw`), needed when the
    trainer augments. ``metrics["train_loss"]`` is the mean loss over the
    executed steps of the last executed epoch. The returned variables are a
    copy of the trained parameters and model state."""

    def local_train(global_variables: StateDict, data: Batch, num_steps=None, draws=None):
        trainer.module.load_state_dict(global_variables)
        optimizer = trainer.optimizer(trainer.module.parameters())
        S = data["mask"].shape[0]
        has_data = (data["mask"].reshape(S, -1).sum(1) > 0).tolist()
        loss_sums, w_sums = [], []
        for e in range(trainer.epochs):
            total = torch.zeros((), dtype=torch.float32, device=data["mask"].device)
            w = 0
            for s in range(S):
                if not has_data[s] or (num_steps is not None and e * S + s >= num_steps):
                    continue
                batch = _augmented(trainer, {k: v[s] for k, v in data.items()}, draws, e, s)
                total = total + trainer.train_step(optimizer, batch, has_data=True)
                w += 1
            loss_sums.append(total)
            w_sums.append(w)
        last = _last_epoch(num_steps, S, trainer.epochs)
        trainer.module.zero_grad(set_to_none=True)
        variables = {k: v.detach().clone() for k, v in trainer.module.state_dict().items()}
        return variables, {"train_loss": loss_sums[last] / max(w_sums[last], 1)}

    return local_train


def make_vmap_train(trainer: ClientTrainer):
    """Returns ``vmap_train(global_variables, data, num_steps, draws=None) ->
    (stacked_variables, metrics)``, the whole cohort's training at once
    (``fedml_tpu/core/trainer.py:247-312`` under ``jax.vmap``).

    ``data`` is the cohort's ``[C, S, B, ...]`` batch stack, ``num_steps``
    the ``[C]`` per-client step budgets, ``draws`` the ``[C, E, S, B]``
    augmentation draws. Every client starts from ``global_variables`` with a
    fresh optimizer state; ``(params, model_state, opt_state)`` are carried
    stacked ``[C, ...]`` through E epochs x S steps, each step one
    ``torch.func.vmap`` of ``torch.func.grad_and_value`` over the functional
    apply of the module. A client's step is a no-op (``torch.where(has_data,
    new, old)`` on all three) when its batch is fully padded or past its
    budget. ``metrics["train_loss"]`` ``[C]`` is each client's mean loss over
    the executed steps of its last executed epoch. The variables come back
    stacked ``[C, ...]`` in ``global_variables``' key order.

    Raises when the trainer's optimizer has no functional form: the vmap
    mode never falls back to training clients one at a time."""
    opt = trainer.optimizer
    if not (callable(getattr(opt, "init", None)) and callable(getattr(opt, "update", None))):
        raise TypeError(
            "cohort_execution='vmap' steps the optimizer's functional form (init/update, "
            f"e.g. fedml_tpu_torch.core.trainer.sgd); {opt!r} has none")
    loss_of = trainer.loss_and_metrics[0]
    param_names = [k for k, _ in trainer.module.named_parameters()]

    def loss_fn(params, state, batch):
        logits, new_state = trainer.apply_train(params, state, batch["x"])
        return loss_of(logits, batch), new_state

    def step(params, state, opt_state, batch):
        grads, (loss, new_state) = torch.func.grad_and_value(loss_fn, has_aux=True)(
            params, state, batch)
        has_data = torch.sum(batch["mask"]) > 0
        new_params, new_opt_state = opt.update(grads, opt_state, params)

        def keep(new, old):
            return {k: torch.where(has_data, new[k], old[k]) for k in old}

        return (keep(new_params, params), keep(new_state, state),
                keep(new_opt_state, opt_state), loss, has_data.float())

    vstep = torch.func.vmap(step)

    def vmap_train(global_variables: StateDict, data: Batch, num_steps: torch.Tensor,
                   draws=None):
        C, S = data["mask"].shape[:2]
        stacked = {k: v.unsqueeze(0).expand((C,) + v.shape) for k, v in global_variables.items()}
        params = {k: stacked[k] for k in param_names}
        state = {k: v for k, v in stacked.items() if k not in params}
        opt_state = opt.init(params)
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
                params, state, opt_state, loss, w_s = vstep(params, state, opt_state, batch)
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
