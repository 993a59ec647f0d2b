"""The FedAvg-paper CNNs and LeNet, the port of ``fedml_tpu/models/cnn.py``
(``CNNOriginalFedAvg``, ``CNNDropOut``, ``LeNet``).

Images come in ``[B, 28, 28]`` or NHWC ``[B, 28, 28, 1]`` as the datasets
hold them (a channel axis is added only to 3-D input, as flax's
``_ensure_nhwc`` does); the network computes in NCHW. flax's semantics are
kept where they differ from torch's:

- *Flatten order.* flax flattens NHWC activations before the first Dense,
  so its kernel's rows run over (h, w, c). The port permutes its NCHW
  activations to NHWC before the flatten, so a converted kernel applies
  unchanged (``tests/test_torch_cnn.py`` checks this on asymmetric weights).
- *Padding.* ``"SAME"`` on a 5x5 stride-1 conv is torch's ``padding=2``;
  ``"VALID"`` is ``padding=0`` (``CNNDropOut``: 28 -> 26 -> 24, a 2x2 pool to
  12).
- *dtypes.* Parameters stay f32; each conv and hidden Dense casts its input
  and parameters to the compute ``dtype``; the input is cast to f32 first and
  the head runs in f32.
- *Dropout* (``CNNDropOut``). flax's ``nn.Dropout(rate)`` keeps an element
  with probability ``1 - rate`` and scales it by ``1 / (1 - rate)``; a rate of
  0 is the identity. The keep masks are not drawn inside the module: a
  random op inside a function mapped by ``torch.func.vmap`` raises, and the
  cohort's clients must see the same masks in both cohort modes. The module
  names its sites (:attr:`CNNDropOut.dropout_sites`), the trainer draws the
  masks (:func:`fedml_tpu_torch.core.trainer.draw_dropout_masks`) and passes
  them in: ``forward(x, train=True, dropout={site: keep mask})``.

flax's ``Conv_i`` / ``Dense_i`` are ``conv_i`` / ``dense_i`` here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.models.transformer import _LECUN_STD, Dense


class Conv(nn.Module):
    """flax ``Conv(features, (k, k), padding, dtype)`` with its bias, on
    NCHW input: ``weight [out, in, k, k]`` (flax's HWIO kernel as OIHW)."""

    def __init__(self, in_channels, out_channels, kernel, padding, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        self.padding, self.dtype = padding, dtype

    def forward(self, x):
        x, weight, bias = x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype)
        return F.conv2d(x, weight, bias, padding=self.padding)

    def reset_parameters(self, generator: torch.Generator | None = None):
        # flax lecun_normal over fan_in = k * k * in; zero bias
        std = math.sqrt(1.0 / self.weight[0].numel()) / _LECUN_STD
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        nn.init.zeros_(self.bias)


def _nchw(x):
    """flax's ``_ensure_nhwc`` (a channel axis only for ``[B, H, W]``) and
    the f32 cast, then NCHW."""
    if x.dim() == 3:
        x = x.unsqueeze(-1)
    return x.float().permute(0, 3, 1, 2)


def _flatten_nhwc(x):
    """flax's ``x.reshape((B, -1))`` on the NHWC activations it holds."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _hw(input_shape) -> tuple[int, int]:
    return int(input_shape[0]), int(input_shape[1])


class _CNN(nn.Module):
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initialisers from ``generator``: lecun-normal kernels, zero
        biases."""
        for mod in self.modules():
            if isinstance(mod, (Conv, Dense)):
                mod.reset_parameters(generator)


class CNNOriginalFedAvg(_CNN):
    """2 x (conv5x5 SAME + ReLU + maxpool) + FC512 + head; ~1.66M parameters
    for FEMNIST."""

    def __init__(self, num_classes=62, only_digits=False, dtype=torch.float32,
                 input_shape=(28, 28), device="cuda"):
        super().__init__()
        device = resolve_device(device)
        h, w = _hw(input_shape)
        self.dtype = dtype
        self.conv_0 = Conv(1, 32, 5, 2, dtype, device)
        self.conv_1 = Conv(32, 64, 5, 2, dtype, device)
        self.dense_0 = Dense((h // 4) * (w // 4) * 64, 512, dtype=dtype, device=device)
        self.dense_1 = Dense(512, 10 if only_digits else num_classes, device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def forward(self, x, train: bool = False):
        x = F.max_pool2d(F.relu(self.conv_0(_nchw(x))), 2, 2)
        x = F.max_pool2d(F.relu(self.conv_1(x)), 2, 2)
        x = F.relu(self.dense_0(_flatten_nhwc(x)))
        return self.dense_1(x.float())


class CNNDropOut(_CNN):
    """The TFF dropout variant: conv3x3(32) -> conv3x3(64) -> pool ->
    dropout(0.25) -> FC128 -> dropout(0.5) -> head. ``dropout_rates`` are
    flax's two rates (fixed there); parity tests set them to 0."""

    def __init__(self, num_classes=62, only_digits=False, dtype=torch.float32,
                 input_shape=(28, 28), dropout_rates=(0.25, 0.5), device="cuda"):
        super().__init__()
        device = resolve_device(device)
        h, w = _hw(input_shape)
        self.dtype = dtype
        self.conv_0 = Conv(1, 32, 3, 0, dtype, device)
        self.conv_1 = Conv(32, 64, 3, 0, dtype, device)
        pooled = ((h - 4) // 2, (w - 4) // 2)
        self.dense_0 = Dense(pooled[0] * pooled[1] * 64, 128, dtype=dtype, device=device)
        self.dense_1 = Dense(128, 10 if only_digits else num_classes, device=device)
        # per-example shapes of the activations each dropout masks (NCHW)
        shapes = ((64,) + pooled, (128,))
        self.dropout_sites = {f"dropout_{i}": (shape, float(rate))
                              for i, (shape, rate) in enumerate(zip(shapes, dropout_rates))
                              if rate > 0.0}
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def _dropout(self, name, x, train, masks):
        if not train or name not in self.dropout_sites:
            return x
        if masks is None or name not in masks:
            raise ValueError(f"CNNDropOut in training needs the keep mask of {name!r} "
                             "(fedml_tpu_torch.core.trainer.draw_dropout_masks)")
        keep = 1.0 - self.dropout_sites[name][1]
        return torch.where(masks[name], x / keep, 0.0)

    def forward(self, x, train: bool = False, dropout=None):
        x = F.relu(self.conv_0(_nchw(x)))
        x = F.relu(self.conv_1(x))
        x = self._dropout("dropout_0", F.max_pool2d(x, 2, 2), train, dropout)
        x = F.relu(self.dense_0(_flatten_nhwc(x)))
        x = self._dropout("dropout_1", x, train, dropout)
        return self.dense_1(x.float())


class LeNet(_CNN):
    """LeNet-5 of the mobile client family: conv 1->20 5x5, pool, ReLU, conv
    20->50 5x5, pool, ReLU, FC 800->500 + ReLU, head (all VALID)."""

    def __init__(self, num_classes=10, dtype=torch.float32, input_shape=(28, 28),
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        h, w = _hw(input_shape)
        self.dtype = dtype
        self.conv_0 = Conv(1, 20, 5, 0, dtype, device)
        self.conv_1 = Conv(20, 50, 5, 0, dtype, device)
        flat = ((h - 4) // 2 - 4) // 2 * (((w - 4) // 2 - 4) // 2) * 50
        self.dense_0 = Dense(flat, 500, dtype=dtype, device=device)
        self.dense_1 = Dense(500, num_classes, device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def forward(self, x, train: bool = False):
        h = F.relu(F.max_pool2d(self.conv_0(_nchw(x)), 2, 2))
        h = F.relu(F.max_pool2d(self.conv_1(h), 2, 2))
        h = F.relu(self.dense_0(_flatten_nhwc(h)))
        return self.dense_1(h.float())
