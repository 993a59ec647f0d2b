"""Client trainer, the port of ``fedml_tpu/core/trainer.py``.

A :class:`ClientTrainer` bundles a torch module with a task's loss/metric
pair, an optimizer factory and the local epoch count. Batches are
``{"x": [B, ...], "y": [B, ...], "mask": [B] or [B, T]}``; padding has mask 0
and contributes nothing to losses, gradients or metrics. Model variables are
flat state dicts (name -> tensor).

Where the JAX package compiles the local epochs into one ``lax.scan``, the
port runs them as a Python loop over steps on the module's own parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import torch
import torch.nn.functional as F

Batch = dict[str, torch.Tensor]
StateDict = dict[str, torch.Tensor]
OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]

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


def sgd(lr: float, momentum: float = 0.0) -> OptimizerFactory:
    """optax.sgd(lr, momentum) as a factory of fresh ``torch.optim.SGD``.
    With ``dampening=0`` torch's momentum buffer is optax's ``trace``
    (g + momentum * trace, from zero) and the step subtracts ``lr`` times
    it, as ``scale_by_learning_rate`` does."""
    return lambda params: torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0)


# ---------------------------------------------------------------------------
# ClientTrainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClientTrainer:
    """A module (whose parameters are the working copy of the client model),
    a task, a factory of fresh optimizers and the local epoch count."""

    module: torch.nn.Module
    task: str = "classification"
    optimizer: OptimizerFactory = dataclasses.field(default_factory=lambda: sgd(0.03))
    epochs: int = 1

    def __post_init__(self):
        if self.task not in TASKS:
            raise NotImplementedError(
                f"task {self.task!r} is not ported yet (ported: {sorted(TASKS)}); "
                "ROADMAP §A3 and the slices that need it")

    @property
    def loss_and_metrics(self):
        return TASKS[self.task]

    def init(self, generator: torch.Generator) -> StateDict:
        """Fresh variables drawn from ``generator`` (the module's own
        initialisers), as a detached copy."""
        self.module.reset_parameters(generator)
        return {k: v.detach().clone() for k, v in self.module.state_dict().items()}

    def train_step(self, optimizer: torch.optim.Optimizer, batch: Batch,
                   has_data: bool | None = None) -> torch.Tensor:
        """One masked SGD step on the module's parameters; returns the loss.
        A fully padded batch (mask all zero) is a no-op that leaves
        parameters and optimizer state untouched, and reports loss 0 (the
        masked mean of nothing). ``has_data`` may be passed when the caller
        already knows it, to spare a device-to-host read."""
        if has_data is None:
            has_data = bool(torch.sum(batch["mask"]) > 0)
        if not has_data:
            return torch.zeros((), dtype=torch.float32, device=batch["mask"].device)
        self.module.train()
        optimizer.zero_grad(set_to_none=True)
        loss = self.loss_and_metrics[0](self.module(batch["x"]), batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_batch(self, batch: Batch) -> dict[str, torch.Tensor]:
        """Summed metrics of the module's current parameters on one batch."""
        self.module.eval()
        return self.loss_and_metrics[1](self.module(batch["x"]), batch)


# ---------------------------------------------------------------------------
# Local training and evaluation programs
# ---------------------------------------------------------------------------


def make_local_train(trainer: ClientTrainer):
    """Returns ``local_train(global_variables, data, num_steps=None) ->
    (variables, metrics)``.

    ``data`` holds one client's epoch of batches stacked on a leading steps
    axis: ``{"x": [S, B, ...], "y": [S, B, ...], "mask": [S, B, ...]}``. The
    module is loaded with ``global_variables`` and trained for
    ``trainer.epochs`` passes over the S batches with a fresh optimizer.
    Steps with global index ``e * S + s >= num_steps`` are masked no-ops (the
    straggler budget). ``metrics["train_loss"]`` is the mean loss over the
    executed steps of the last executed epoch. The returned variables are a
    copy of the trained parameters."""

    def local_train(global_variables: StateDict, data: Batch, num_steps=None):
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
                batch = {k: v[s] for k, v in data.items()}
                total = total + trainer.train_step(optimizer, batch, has_data=True)
                w += 1
            loss_sums.append(total)
            w_sums.append(w)
        if num_steps is None:
            last = trainer.epochs - 1
        else:
            last = max(min((int(num_steps) - 1) // S, trainer.epochs - 1), 0)
        trainer.module.zero_grad(set_to_none=True)
        variables = {k: v.detach().clone() for k, v in trainer.module.state_dict().items()}
        return variables, {"train_loss": loss_sums[last] / max(w_sums[last], 1)}

    return local_train


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
