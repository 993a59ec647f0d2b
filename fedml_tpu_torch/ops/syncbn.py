"""Synchronized BatchNorm across the silo (in-silo data-parallel) axis, the
port of ``fedml_tpu/ops/syncbn.py``.

Reference: fedml_api/model/cv/batchnorm_utils.py gathers per-GPU batch
moments under DataParallel and broadcasts the global statistics back. In
the JAX package a flax BatchNorm given ``axis_name`` reduces its moments
over that mesh axis; under GSPMD plain BatchNorm already sees the whole
batch. The port runs a silo's ranks as processes, each with its rows of
the batch: the port's BatchNorm (``models/resnet.py``) reduces the sum of
``x``, the sum of ``x²`` and the count over the group bound to its axis
(``parallel/collectives.py`` :func:`bind`, :func:`batch_moments`) and
keeps flax's fast variance (``E[x²] − E[x]²``, clamped at 0). Its backward
is a sum over the silo of the ranks' gradients. ``torch.nn.SyncBatchNorm``
is not this: it refuses the CPU, and its Welford merge is not flax's
formula.

- :class:`SyncBatchNorm` — that BatchNorm with the JAX module's arguments:
  statistics reduced over the ``silo`` axis where one is bound, plain
  BatchNorm where none is, so the same module runs on one rank and in a
  silo.
- Cross-CLIENT statistics are deliberately NOT synchronized: each client's
  BN sees only its own data (federated semantics); the running averages are
  then federated like ordinary weights.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.models.resnet import BatchNorm, batch_moments  # noqa: F401
from fedml_tpu_torch.parallel.mesh import SILO_AXIS


class SyncBatchNorm(BatchNorm):
    """Drop-in BatchNorm (flax's ``BatchNorm(momentum, epsilon)`` over the
    N, H, W axes of NCHW input, or N of ``[N, F]``) whose batch statistics
    reduce over the ``axis_name`` axis where it is bound. ``forward(x,
    train)`` returns ``(y, new_stats)``; ``train`` None reads
    ``use_running_average``, as the JAX module does."""

    def __init__(self, features, use_running_average: bool | None = None, momentum: float = 0.9,
                 epsilon: float = 1e-5, axis_name: str | None = SILO_AXIS,
                 dtype=torch.float32, device=None):
        super().__init__(features, dtype=dtype, momentum=momentum, eps=epsilon, device=device)
        self.use_running_average, self.axis_name = use_running_average, axis_name

    def forward(self, x, train: bool | None = None):
        return super().forward(x, not self.use_running_average if train is None else train)
