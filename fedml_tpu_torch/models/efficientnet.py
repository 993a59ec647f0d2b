"""EfficientNet b0-b8, the port of ``fedml_tpu/models/efficientnet.py``.

MBConv inverted-residual blocks with squeeze-excite, SiLU activations and
GroupNorm (flax's: eps 1e-6, statistics in f32; ``_gn_groups`` groups),
compound-scaled by the paper's (width, depth, resolution, dropout)
coefficients (:data:`SCALING`). ``SCALING``, ``BASE_BLOCKS``,
``round_filters``, ``round_repeats`` and ``_gn_groups`` are copies.

Images come in NHWC ``[N, H, W, 3]``; the network computes in NCHW, every
conv and GroupNorm in the compute ``dtype``, the mean pool and the head in
f32. SiLU is ``x * sigmoid(x)`` in the activation's dtype. The 5x5 stride-2
depthwise convs pad SAME as flax does, (1, 2) on an even size. The
squeeze-excite squeezes to ``max(1, int(0.25 * C_in))`` channels of the
**block input's** width ``C_in`` (a biased 1x1 conv, SiLU, a biased 1x1
conv back to the expanded width, sigmoid).

Two kinds of dropout, both sites (:attr:`EfficientNet.dropout_sites`) whose
keep masks the trainer draws
(:class:`~fedml_tpu_torch.core.trainer.DropoutStream`) and passes in with
``forward(x, train=True, dropout=masks)``: drop-connect on the residual
branch of each block with a residual, one draw per example (mask ``[B, 1,
1, 1]``, kept branches scaled by ``1 / keep``, at ``drop_connect_rate *
block / blocks``), and the head's dropout. JAX draws them from per-site
keys, which torch cannot reproduce, so parity tests set both rates to 0.
The network has no state: ``forward`` returns the logits in training too.

flax's ``Conv_i``/``GroupNorm_i``/``Dense_0`` are ``conv_i``/``gn_i``/
``dense_0``, ``MBConv_i`` ``mbconvs.i`` and its ``SqueezeExcite_0`` ``se``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.models.resnet import Conv, GroupNorm, reset_flax
from fedml_tpu_torch.models.transformer import Dense

# (width_coefficient, depth_coefficient, resolution, dropout_rate) — reference
# efficientnet_utils.efficientnet_params
SCALING = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
    "efficientnet-b8": (2.2, 3.6, 672, 0.5),
}

# (expand_ratio, channels, repeats, stride, kernel) — the 7-stage b0 backbone
BASE_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def _gn_groups(c: int, target: int = 8) -> int:
    g = min(target, c)
    while c % g:
        g -= 1
    return g


def silu(x):
    return x * torch.sigmoid(x)


def _conv_gn(module, i, cin, cout, kernel, stride, dtype, device, groups=1):
    module.add_module(f"conv_{i}", Conv(cin, cout, kernel, stride, dtype, device, groups=groups))
    module.add_module(f"gn_{i}", GroupNorm(cout, _gn_groups(cout), dtype, device=device))


def _gn(module, i, x):
    return getattr(module, f"gn_{i}")(getattr(module, f"conv_{i}")(x))[0]


class SqueezeExcite(nn.Module):
    """Mean over H, W, a biased 1x1 conv to ``max(1, int(features *
    se_ratio))`` channels, SiLU, a biased 1x1 conv back to ``channels``,
    sigmoid, a channel scale."""

    def __init__(self, features, channels, se_ratio=0.25, dtype=torch.float32, device=None):
        super().__init__()
        squeezed = max(1, int(features * se_ratio))
        self.conv_0 = Conv(channels, squeezed, 1, 1, dtype, device, bias=True)
        self.conv_1 = Conv(squeezed, channels, 1, 1, dtype, device, bias=True)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = self.conv_1(silu(self.conv_0(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """1x1 expansion (``expand_ratio`` > 1) + GN + SiLU, a depthwise
    ``kernel`` x ``kernel`` conv at ``stride`` + GN + SiLU, squeeze-excite,
    a 1x1 projection + GN, and the residual (with drop-connect in training)
    where stride is 1 and the width is kept."""

    def __init__(self, in_channels, out_features, expand_ratio, stride, kernel,
                 drop_rate=0.0, dtype=torch.float32, device=None):
        super().__init__()
        self.expands = expand_ratio != 1
        c, i = in_channels * expand_ratio, 0
        if self.expands:
            _conv_gn(self, 0, in_channels, c, 1, 1, dtype, device)
            i = 1
        _conv_gn(self, i, c, c, kernel, stride, dtype, device, groups=c)
        self.se = SqueezeExcite(in_channels, c, dtype=dtype, device=device)
        _conv_gn(self, i + 1, c, out_features, 1, 1, dtype, device)
        self.n_convs = i + 2
        self.residual = stride == 1 and in_channels == out_features
        self.drop_rate = float(drop_rate) if self.residual else 0.0

    def forward(self, x, mask=None):
        """``mask``: the drop-connect keep mask ``[B, 1, 1, 1]`` (training
        with a rate above 0), else None."""
        h = x
        for i in range(self.n_convs - 1):
            h = silu(_gn(self, i, h))
        h = self.se(h)
        h = _gn(self, self.n_convs - 1, h)
        if self.residual:
            if mask is not None:
                keep = 1.0 - self.drop_rate
                h = torch.where(mask, h / keep, 0.0)
            h = h + x
        return h


class EfficientNet(nn.Module):
    """EfficientNet at ``width`` and ``depth`` scaling, head dropout
    ``dropout_rate`` and drop-connect ``drop_connect_rate``."""

    def __init__(self, num_classes=10, width=1.0, depth=1.0, dropout_rate=0.2,
                 drop_connect_rate=0.2, stem_features=32, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        stem = round_filters(stem_features, width)
        _conv_gn(self, 0, 3, stem, 3, 2, dtype, device)
        total = sum(round_repeats(r, depth) for _, _, r, _, _ in BASE_BLOCKS)
        blocks, channels = [], stem
        for expand, feats, repeats, stride, kernel in BASE_BLOCKS:
            feats = round_filters(feats, width)
            for i in range(round_repeats(repeats, depth)):
                blocks.append(MBConv(channels, feats, expand, stride if i == 0 else 1, kernel,
                                     drop_connect_rate * len(blocks) / total, dtype, device))
                channels = feats
        self.mbconvs = nn.ModuleList(blocks)
        head = round_filters(1280, width)
        _conv_gn(self, 1, channels, head, 1, 1, dtype, device)
        self.dense_0 = Dense(head, num_classes, device=device)
        sites = {f"drop_connect_{i}": ((1, 1, 1), b.drop_rate)
                 for i, b in enumerate(blocks) if b.drop_rate > 0.0}
        if dropout_rate > 0.0:
            sites["dropout"] = ((head,), float(dropout_rate))
        self.dropout_sites = sites
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_flax(self, generator)

    def forward(self, x, train: bool = False, dropout=None):
        if train and self.dropout_sites and (dropout is None
                                             or set(dropout) != set(self.dropout_sites)):
            raise ValueError("EfficientNet in training needs the keep masks of its sites "
                             f"{sorted(self.dropout_sites)} "
                             "(fedml_tpu_torch.core.trainer.draw_dropout_masks)")
        masks = dropout if train and self.dropout_sites else {}
        h = silu(_gn(self, 0, x.permute(0, 3, 1, 2)))
        for i, block in enumerate(self.mbconvs):
            h = block(h, masks.get(f"drop_connect_{i}"))
        h = silu(_gn(self, 1, h))
        h = h.float().mean((2, 3))
        if "dropout" in masks:
            h = torch.where(masks["dropout"], h / (1.0 - self.dropout_sites["dropout"][1]), 0.0)
        return self.dense_0(h)


def efficientnet(name: str = "efficientnet-b0", num_classes: int = 10, dtype=torch.float32,
                 device="cuda", **kwargs) -> EfficientNet:
    """The JAX factory (``EfficientNet.from_name``'s dispatch); ``kwargs``
    set the network's other fields (``dropout_rate``,
    ``drop_connect_rate``)."""
    width, depth, _res, dropout = SCALING[name]
    return EfficientNet(num_classes=num_classes, width=width, depth=depth, dtype=dtype,
                        device=device, **{"dropout_rate": dropout, **kwargs})
