"""Linear models, the port of ``fedml_tpu/models/linear.py``.

``LogisticRegression`` flattens its input to ``[B, -1]``, casts it to f32
and applies one Dense that produces logits; the loss applies the link
function. torch needs the input width when the layer is built, which flax
infers at its first call: ``in_features`` is the flattened width of one
example (784 for the 28 x 28 digit datasets).
"""

from __future__ import annotations

import torch
from torch import nn

from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.models.transformer import Dense


class LogisticRegression(nn.Module):
    """flax ``Dense_0`` is ``dense_0`` (weight ``[out, in]``, the transpose
    of flax's kernel)."""

    def __init__(self, num_classes: int = 10, in_features: int = 784, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dense_0 = Dense(in_features, num_classes, device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initialisers: lecun-normal kernel, zero bias."""
        self.dense_0.reset_parameters(generator)

    def forward(self, x, train: bool = False):
        return self.dense_0(x.reshape(x.shape[0], -1).float())
