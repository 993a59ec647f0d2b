"""CIFAR ResNets with BatchNorm, the port of ``fedml_tpu/models/resnet.py``
(``BasicBlock``, ``CifarResNet``, ``resnet56``, ``resnet110``; norm "bn").

3 stages of (depth - 2) / 6 BasicBlocks at 16/32/64 channels, option-B
(1x1 conv + BN) shortcuts where the shape changes, a global mean pool and a
Dense head. Images come in NHWC ``[N, H, W, 3]`` as the datasets hold them;
the network computes in NCHW (the permuted input is a channels-last view).

Flax's semantics are kept where they differ from torch's:

- ``padding="SAME"``: each conv pads explicitly, ``total = max((ceil(n / s)
  - 1) * s + k - n, 0)`` split low ``total // 2``, high the rest, so a 3x3
  stride-2 conv on an even size pads (0, 1), not torch's ``padding=1``
  (1, 1); the 1x1 stride-2 shortcut pads nothing.
- dtypes: parameters stay f32; each conv casts its input and kernel to the
  compute ``dtype``; the network casts its input to f32 first; the mean pool
  and the head run in f32.
- BatchNorm is flax's (``flax/linen/normalization.py``), written
  functionally: in training it reduces its statistics in f32 (even in bf16
  compute; in f64 for f64 input, as flax promotes) with the biased fast variance ``max(E[x^2] - E[x]^2, 0)``, which
  both normalises the batch and enters the running average ``0.9 * ra + 0.1
  * batch``; eps 1e-5; output in the compute dtype. It receives no mask, so
  the zero-filled padding rows of a partly filled batch count in its batch
  statistics, as they do in the JAX package. It returns its new statistics
  instead of writing its buffers (flax's ``mutable=["batch_stats"]``), which
  is what lets ``torch.func.vmap`` map it over the cohort's clients:
  ``forward(x, train=True)`` returns ``(logits, new_state)``.

``norm="gn"`` (``resnet18_gn``) is not ported yet and raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.models.transformer import _LECUN_STD, Dense

StateDict = dict[str, torch.Tensor]


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax/XLA ``"SAME"`` padding of one spatial axis: (low, high)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Flax ``Conv(features, (k, k), strides, padding="SAME", use_bias=False,
    feature_group_count=groups, dtype)`` on NCHW input: ``weight [out, in /
    groups, k, k]`` (flax's HWIO kernel as OIHW), cast with the input to the
    compute dtype."""

    def __init__(self, in_channels, out_channels, kernel, stride=1, dtype=torch.float32,
                 device=None, groups=1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, kernel,
                                               kernel, device=device))
        self.kernel, self.stride, self.dtype, self.groups = kernel, stride, dtype, groups

    def forward(self, x):
        (top, bottom), (left, right) = (same_padding(n, self.kernel, self.stride)
                                        for n in x.shape[-2:])
        x = x.to(self.dtype)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                        groups=self.groups)

    def reset_parameters(self, generator: torch.Generator | None = None):
        # flax lecun_normal: truncated normal, variance 1 / (k * k * in)
        std = math.sqrt(1.0 / self.weight[0].numel()) / _LECUN_STD
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std, generator=generator)


class BatchNorm(nn.Module):
    """Flax ``BatchNorm(momentum=0.9, epsilon=1e-5, dtype)`` over the N, H, W
    axes of NCHW input. ``forward(x, train)`` returns ``(y, new_stats)``:
    ``new_stats`` is ``(running_mean, running_var)`` after the update in
    training and None in evaluation, which normalises with the running
    statistics."""

    def __init__(self, features, dtype=torch.float32, momentum=0.9, eps=1e-5, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))
        self.dtype, self.momentum, self.eps = dtype, momentum, eps

    def forward(self, x, train: bool = False):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
            new = (self.momentum * self.running_mean + (1 - self.momentum) * mean,
                   self.momentum * self.running_var + (1 - self.momentum) * var)
        else:
            mean, var, new = self.running_mean, self.running_var, None
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype), new

    def reset_parameters(self, generator: torch.Generator | None = None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


def _normed(bn: BatchNorm, name: str, x, train: bool, stats: StateDict):
    """``bn(x)``, with its new statistics recorded in ``stats`` under the
    buffer names ``name.running_mean`` and ``name.running_var``."""
    y, new = bn(x, train)
    if new is not None:
        stats[f"{name}.running_mean"], stats[f"{name}.running_var"] = new
    return y


class BasicBlock(nn.Module):
    """Two 3x3 conv + BN layers and a residual; ``conv_2``/``bn_2`` project
    the shortcut where the channels or the stride change (flax's
    ``Conv_0``, ``BatchNorm_0``, ..., ``Conv_2``, ``BatchNorm_2``)."""

    def __init__(self, in_channels, filters, stride=1, dtype=torch.float32, device=None):
        super().__init__()
        self.conv_0 = Conv(in_channels, filters, 3, stride, dtype, device)
        self.bn_0 = BatchNorm(filters, dtype, device=device)
        self.conv_1 = Conv(filters, filters, 3, 1, dtype, device)
        self.bn_1 = BatchNorm(filters, dtype, device=device)
        self.projects = in_channels != filters or stride != 1
        if self.projects:
            self.conv_2 = Conv(in_channels, filters, 1, stride, dtype, device)
            self.bn_2 = BatchNorm(filters, dtype, device=device)

    def forward(self, x, train: bool = False):
        stats: StateDict = {}
        y = F.relu(_normed(self.bn_0, "bn_0", self.conv_0(x), train, stats))
        y = _normed(self.bn_1, "bn_1", self.conv_1(y), train, stats)
        if self.projects:
            x = _normed(self.bn_2, "bn_2", self.conv_2(x), train, stats)
        return F.relu(x + y), stats


class CifarResNet(nn.Module):
    """3-stage CIFAR ResNet; depth = 6n + 2 (56 -> n = 9, 110 -> n = 18).
    ``forward(x, train=False)``: NHWC images to f32 logits; with
    ``train=True``, ``(logits, new_state)`` where ``new_state`` maps every
    BN buffer name to its updated value."""

    def __init__(self, depth=56, num_classes=10, norm="bn", dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        if norm != "bn":
            raise NotImplementedError(
                f"CifarResNet norm={norm!r} is not ported yet (GroupNorm, resnet18_gn): "
                "ROADMAP §A7")
        if (depth - 2) % 6:
            raise ValueError(f"CifarResNet depth must be 6n + 2, got {depth}")
        device = resolve_device(device)
        n = (depth - 2) // 6
        self.conv_0 = Conv(3, 16, 3, 1, dtype, device)
        self.bn_0 = BatchNorm(16, dtype, device=device)
        blocks, channels = [], 16
        for stage, filters in enumerate([16, 32, 64]):
            for block in range(n):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(BasicBlock(channels, filters, stride, dtype, device))
                channels = filters
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(channels, num_classes, device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Flax's initialisers from ``generator``: convs and the head
        lecun-normal (zero head bias), BN scale 1 and bias 0, running mean 0
        and variance 1."""
        for mod in self.modules():
            if isinstance(mod, (Conv, BatchNorm, Dense)):
                mod.reset_parameters(generator)

    def forward(self, x, train: bool = False):
        stats: StateDict = {}
        x = x.float().permute(0, 3, 1, 2)
        x = F.relu(_normed(self.bn_0, "bn_0", self.conv_0(x), train, stats))
        for i, block in enumerate(self.blocks):
            x, block_stats = block(x, train)
            stats.update({f"blocks.{i}.{k}": v for k, v in block_stats.items()})
        logits = self.head(x.float().mean((2, 3)))
        return (logits, stats) if train else logits


def resnet56(class_num: int = 10, dtype=torch.float32, device="cuda") -> CifarResNet:
    return CifarResNet(depth=56, num_classes=class_num, dtype=dtype, device=device)


def resnet110(class_num: int = 10, dtype=torch.float32, device="cuda") -> CifarResNet:
    return CifarResNet(depth=110, num_classes=class_num, dtype=dtype, device=device)
