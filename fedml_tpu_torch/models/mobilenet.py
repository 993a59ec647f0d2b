"""MobileNet V1 and V3, the port of ``fedml_tpu/models/mobilenet.py``
(``DepthwiseSeparable``, ``MobileNet``, ``SqueezeExcite``,
``InvertedResidual``, ``MobileNetV3`` small and large): the cross-silo CV
models.

Images come in NHWC ``[N, H, W, 3]``; the network computes in NCHW. The
layers are the ResNet's (``models/resnet.py``), with flax's semantics:

- a depthwise conv is a :class:`~fedml_tpu_torch.models.resnet.Conv` with
  ``groups`` = channels, SAME-padded as flax pads it (a 3x3 or 5x5 stride-2
  conv on an even size pads (0, 1) or (1, 2), not torch's symmetric pad);
- every BatchNorm is flax's **default**: momentum 0.99, eps 1e-5 (the
  ResNets use 0.9);
- dtypes: the input is cast to f32, every conv, BatchNorm and the V3
  squeeze-excite's Dense layers compute in the compute ``dtype``; the mean
  pool and the head run in f32, V3's ``Dense(1280 | 1024)`` before the head
  too (it has no compute dtype in the JAX package);
- ``hard_swish(x) = x * relu6(x + 3) / 6``, in the activation's dtype.

flax's ``Conv_i``/``BatchNorm_i`` are ``conv_i``/``bn_i`` here, numbered in
the order flax creates them (an inverted residual without an expansion
conv starts at ``conv_0`` with its depthwise conv);
``DepthwiseSeparable_i`` is ``separables.i``, ``InvertedResidual_i``
``inverted.i``, ``SqueezeExcite_0`` ``se`` (its ``Dense_0``/``Dense_1``
``fc_0``/``fc_1``), the top-level ``Dense_i`` ``dense_i``. In training
``forward(x, train=True)`` returns ``(logits, new_state)``, the new BN
statistics by buffer name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.models.resnet import BatchNorm, Conv, StateDict, _normed, reset_flax
from fedml_tpu_torch.models.transformer import Dense

FLAX_MOMENTUM = 0.99  # flax BatchNorm's default momentum


def hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x):
    return x * hard_sigmoid(x)


class _BNNet(nn.Module):
    """Helpers of a network of numbered convs and flax-default BatchNorms."""

    def _conv_bn(self, i, cin, cout, kernel, stride=1, groups=1):
        self.add_module(f"conv_{i}", Conv(cin, cout, kernel, stride, self.dtype, self._device,
                                          groups=groups))
        self.add_module(f"bn_{i}", BatchNorm(cout, self.dtype, FLAX_MOMENTUM,
                                             device=self._device))

    def _cbn(self, i, x, train, stats):
        """``bn_i(conv_i(x))``, the new statistics recorded in ``stats``."""
        return _normed(getattr(self, f"bn_{i}"), f"bn_{i}", getattr(self, f"conv_{i}")(x),
                       train, stats)


class DepthwiseSeparable(_BNNet):
    """3x3 depthwise conv + BN + ReLU, then 1x1 conv + BN + ReLU."""

    def __init__(self, in_channels, filters, stride=1, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype, self._device = dtype, device
        self._conv_bn(0, in_channels, in_channels, 3, stride, groups=in_channels)
        self._conv_bn(1, in_channels, filters, 1)

    def forward(self, x, train: bool = False):
        stats: StateDict = {}
        x = F.relu(self._cbn(0, x, train, stats))
        return F.relu(self._cbn(1, x, train, stats)), stats


def _run_blocks(blocks, name, x, train, stats):
    for i, block in enumerate(blocks):
        x, block_stats = block(x, train)
        stats.update({f"{name}.{i}.{k}": v for k, v in block_stats.items()})
    return x


_V1 = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
       (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1)]


class MobileNet(_BNNet):
    """MobileNet V1 (width 1.0). ``small_input`` keeps a stride-1 stem for
    CIFAR."""

    def __init__(self, num_classes=10, small_input=True, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self._device = dtype, device
        self._conv_bn(0, 3, 32, 3, 1 if small_input else 2)
        blocks, channels = [], 32
        for filters, stride in _V1:
            blocks.append(DepthwiseSeparable(channels, filters, stride, dtype, device))
            channels = filters
        self.separables = nn.ModuleList(blocks)
        self.dense_0 = Dense(channels, num_classes, device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_flax(self, generator)

    def forward(self, x, train: bool = False):
        stats: StateDict = {}
        x = F.relu(self._cbn(0, x.float().permute(0, 3, 1, 2), train, stats))
        x = _run_blocks(self.separables, "separables", x, train, stats)
        logits = self.dense_0(x.float().mean((2, 3)))
        return (logits, stats) if train else logits


class SqueezeExcite(nn.Module):
    """V3's squeeze-excite: mean over H, W, ``Dense(max(C / reduce, 8))``,
    ReLU, ``Dense(C)``, hard sigmoid, a channel scale; the Dense layers in
    the compute dtype."""

    def __init__(self, channels, reduce=4, dtype=torch.float32, device=None):
        super().__init__()
        hidden = max(channels // reduce, 8)
        self.fc_0 = Dense(channels, hidden, dtype=dtype, device=device)
        self.fc_1 = Dense(hidden, channels, dtype=dtype, device=device)

    def forward(self, x):
        s = F.relu(self.fc_0(x.mean((2, 3))))
        s = hard_sigmoid(self.fc_1(s))
        return x * s[:, :, None, None]


class InvertedResidual(_BNNet):
    """1x1 expansion (where ``expand`` differs from the input width), a
    ``kernel`` x ``kernel`` depthwise conv at ``stride``, an optional
    squeeze-excite, a 1x1 projection with BN and no activation, and the
    residual where stride is 1 and the width is kept. ``use_hs``: hard swish,
    else ReLU."""

    def __init__(self, in_channels, expand, filters, kernel, stride, use_se, use_hs,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype, self._device = dtype, device
        self.act = hard_swish if use_hs else F.relu
        self.expands = expand != in_channels
        i = 0
        if self.expands:
            self._conv_bn(i, in_channels, expand, 1)
            i += 1
        self._conv_bn(i, expand, expand, kernel, stride, groups=expand)
        self.se = SqueezeExcite(expand, dtype=dtype, device=device) if use_se else None
        self._conv_bn(i + 1, expand, filters, 1)
        self.n_convs = i + 2
        self.residual = stride == 1 and in_channels == filters

    def forward(self, x, train: bool = False):
        stats: StateDict = {}
        y = x
        for i in range(self.n_convs - 1):
            y = self.act(self._cbn(i, y, train, stats))
        if self.se is not None:
            y = self.se(y)
        y = self._cbn(self.n_convs - 1, y, train, stats)
        if self.residual:
            y = y + x
        return y, stats


# (expand, filters, kernel, stride, SE, hard-swish) per the MobileNetV3 paper
_V3_LARGE = [
    (16, 16, 3, 1, False, False), (64, 24, 3, 2, False, False),
    (72, 24, 3, 1, False, False), (72, 40, 5, 2, True, False),
    (120, 40, 5, 1, True, False), (120, 40, 5, 1, True, False),
    (240, 80, 3, 2, False, True), (200, 80, 3, 1, False, True),
    (184, 80, 3, 1, False, True), (184, 80, 3, 1, False, True),
    (480, 112, 3, 1, True, True), (672, 112, 3, 1, True, True),
    (672, 160, 5, 2, True, True), (960, 160, 5, 1, True, True),
    (960, 160, 5, 1, True, True),
]
_V3_SMALL = [
    (16, 16, 3, 2, True, False), (72, 24, 3, 2, False, False),
    (88, 24, 3, 1, False, False), (96, 40, 5, 2, True, True),
    (240, 40, 5, 1, True, True), (240, 40, 5, 1, True, True),
    (120, 48, 5, 1, True, True), (144, 48, 5, 1, True, True),
    (288, 96, 5, 2, True, True), (576, 96, 5, 1, True, True),
    (576, 96, 5, 1, True, True),
]


class MobileNetV3(_BNNet):
    """MobileNet V3, ``mode`` "small" or "large"."""

    def __init__(self, num_classes=10, mode="small", small_input=True, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self._device = dtype, device
        self._conv_bn(0, 3, 16, 3, 1 if small_input else 2)
        blocks, channels = [], 16
        for cfg in (_V3_SMALL if mode == "small" else _V3_LARGE):
            blocks.append(InvertedResidual(channels, *cfg, dtype=dtype, device=device))
            channels = cfg[1]
        self.inverted = nn.ModuleList(blocks)
        head = 576 if mode == "small" else 960
        self._conv_bn(1, channels, head, 1)
        hidden = 1280 if mode == "large" else 1024
        self.dense_0 = Dense(head, hidden, device=device)
        self.dense_1 = Dense(hidden, num_classes, device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_flax(self, generator)

    def forward(self, x, train: bool = False):
        stats: StateDict = {}
        x = hard_swish(self._cbn(0, x.float().permute(0, 3, 1, 2), train, stats))
        x = _run_blocks(self.inverted, "inverted", x, train, stats)
        x = hard_swish(self._cbn(1, x, train, stats))
        x = hard_swish(self.dense_0(x.float().mean((2, 3))))
        logits = self.dense_1(x)
        return (logits, stats) if train else logits
