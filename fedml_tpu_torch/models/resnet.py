"""The ResNets, the port of ``fedml_tpu/models/resnet.py`` (``BasicBlock``,
``CifarResNet``, ``ResNet18``, ``resnet56``, ``resnet110``, ``resnet18_gn``),
and the conv and norm layers the other CIFAR models share.

``CifarResNet``: 3 stages of (depth - 2) / 6 BasicBlocks at 16/32/64
channels; ``ResNet18``: 4 stages of 2 BasicBlocks at 64/128/256/512 channels
behind a 3x3 stem (``small_input``) or a 7x7 stride-2 stem and a 3x3
stride-2 SAME max-pool. Both use option-B (1x1 conv + norm) shortcuts where
the shape changes, a global mean pool and a Dense head, and either
BatchNorm (``norm="bn"``) or GroupNorm with 2 groups (``norm="gn"``, the
fed_cifar100 ResNet-18). Images come in NHWC ``[N, H, W, 3]`` as the
datasets hold them; the network computes in NCHW (the permuted input is a
channels-last view).

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
  ``forward(x, train=True)`` returns ``(logits, new_state)``. The ResNets
  use momentum 0.9; the other CIFAR models flax's default, 0.99.
- GroupNorm is flax's too: statistics over each example's group in f32 (f64
  for f64 input) with the same fast variance, eps **1e-6**, ``scale`` and
  ``bias`` per channel (``weight`` and ``bias`` here), output in the compute
  dtype. It has no state, so a GroupNorm network has no buffers and its
  ``forward(x, train=True)`` returns the logits alone.
- SAME max-pooling pads with -inf, (0, 1) on an even size for a 3x3 stride-2
  window.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.models.transformer import _LECUN_STD, Dense
from fedml_tpu_torch.parallel import collectives
from fedml_tpu_torch.parallel.mesh import SILO_AXIS

StateDict = dict[str, torch.Tensor]


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax/XLA ``"SAME"`` padding of one spatial axis: (low, high)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Flax ``Conv(features, (k, k), strides, padding="SAME", use_bias=False,
    feature_group_count=groups, kernel_dilation=dilation, dtype)`` on NCHW
    input: ``weight [out, in / groups, k, k]`` (flax's HWIO kernel as OIHW),
    cast with the input to the compute dtype. A dilated kernel pads as its
    dilated extent ``(k - 1) * dilation + 1`` does, as XLA pads it."""

    def __init__(self, in_channels, out_channels, kernel, stride=1, dtype=torch.float32,
                 device=None, groups=1, bias=False, dilation=1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, kernel,
                                               kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device)) if bias else None
        self.kernel, self.stride, self.dtype, self.groups = kernel, stride, dtype, groups
        self.dilation = dilation

    def forward(self, x):
        extent = (self.kernel - 1) * self.dilation + 1
        (top, bottom), (left, right) = (same_padding(n, extent, self.stride)
                                        for n in x.shape[-2:])
        x = x.to(self.dtype)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, stride=self.stride,
                        dilation=self.dilation, groups=self.groups)

    def reset_parameters(self, generator: torch.Generator | None = None):
        # flax lecun_normal: truncated normal, variance 1 / (k * k * in / groups)
        std = math.sqrt(1.0 / self.weight[0].numel()) / _LECUN_STD
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


def batch_moments(xf: torch.Tensor, dims: tuple[int, ...], axis_name: str | None = SILO_AXIS):
    """``(mean, var)`` of ``xf`` over ``dims`` and, where ``axis_name`` is
    bound (``parallel/collectives.py`` :func:`~fedml_tpu_torch.parallel.collectives.bind`),
    over the ranks of its group: the sums of ``x`` and ``x²`` and the
    element count reduced in one call, flax's ``E[x²] − E[x]²`` clamped at 0.
    Unbound (or ``axis_name`` None): the mean of ``x`` and of ``x²`` on this
    rank's rows alone, as a single-device flax BatchNorm computes them."""
    group = collectives.bound(axis_name) if axis_name is not None else None
    if group is None:
        mean = xf.mean(dims)
        return mean, torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
    count = 1
    for d in dims:
        count *= xf.shape[d]
    s1 = xf.sum(dims)
    local = torch.stack([s1, (xf * xf).sum(dims), torch.full_like(s1, float(count)).detach()])
    total = collectives.axis_sum(local, axis_name)
    mean, mean2 = total[0] / total[2], total[1] / total[2]
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


class BatchNorm(nn.Module):
    """Flax ``BatchNorm(momentum=0.9, epsilon=1e-5, dtype)`` over the N, H, W
    axes of NCHW input (N of ``[N, F]`` input). ``forward(x, train)`` returns
    ``(y, new_stats)``: ``new_stats`` is ``(running_mean, running_var)``
    after the update in training and None in evaluation, which normalises
    with the running statistics. In a data-parallel silo (the ``axis_name``
    axis bound) the training moments are the whole batch's, every rank's
    rows (:func:`batch_moments`), as GSPMD's BatchNorm sees the whole
    sharded batch in the JAX package."""

    axis_name: str | None = SILO_AXIS

    def __init__(self, features, dtype=torch.float32, momentum=0.9, eps=1e-5, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))
        self.dtype, self.momentum, self.eps = dtype, momentum, eps

    def forward(self, x, train: bool = False):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims, shape = ((0,), (1, -1)) if xf.dim() == 2 else ((0, 2, 3), (1, -1, 1, 1))
        if train:
            mean, var = batch_moments(xf, dims, self.axis_name)
            new = (self.momentum * self.running_mean + (1 - self.momentum) * mean,
                   self.momentum * self.running_var + (1 - self.momentum) * var)
        else:
            mean, var, new = self.running_mean, self.running_var, None
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.dtype), new

    def reset_parameters(self, generator: torch.Generator | None = None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


class GroupNorm(nn.Module):
    """Flax ``GroupNorm(num_groups, epsilon=1e-6, dtype)`` over each
    example's ``C / num_groups`` channels x H x W of NCHW input. Its
    ``forward(x, train)`` returns ``(y, None)``, as :class:`BatchNorm` does
    in evaluation: it has no statistics to update."""

    def __init__(self, features, num_groups, dtype=torch.float32, eps=1e-6, device=None):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"GroupNorm: {num_groups} groups do not divide {features} channels")
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.num_groups, self.dtype, self.eps = num_groups, dtype, eps

    def forward(self, x, train: bool = False):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        n, c = xf.shape[:2]
        groups = xf.reshape(n, self.num_groups, -1)
        mean = groups.mean(-1)
        var = torch.clamp((groups * groups).mean(-1) - mean * mean, min=0.0)
        size = c // self.num_groups
        mean = mean.repeat_interleave(size, dim=1)[:, :, None, None]
        mul = (torch.rsqrt(var + self.eps).repeat_interleave(size, dim=1)
               * self.weight)[:, :, None, None]
        y = (xf - mean) * mul + self.bias[:, None, None]
        return y.to(self.dtype), None

    def reset_parameters(self, generator: torch.Generator | None = None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


def norm_layer(kind: str, features: int, dtype=torch.float32, device=None):
    """The JAX ``_norm``: BatchNorm (momentum 0.9) for ``"bn"``, GroupNorm
    with 2 groups for ``"gn"``."""
    if kind == "bn":
        return BatchNorm(features, dtype, device=device)
    if kind == "gn":
        return GroupNorm(features, 2, dtype, device=device)
    raise ValueError(f"unknown norm {kind!r}")


def _normed(bn: nn.Module, name: str, x, train: bool, stats: StateDict):
    """``bn(x)``, with its new statistics, if any, recorded in ``stats``
    under the buffer names ``name.running_mean`` and ``name.running_var``."""
    y, new = bn(x, train)
    if new is not None:
        stats[f"{name}.running_mean"], stats[f"{name}.running_var"] = new
    return y


def max_pool_same(x, kernel: int, stride: int):
    """flax ``max_pool(x, (k, k), (s, s), padding="SAME")`` on NCHW input:
    -inf padding, split as :func:`same_padding` splits it."""
    (top, bottom), (left, right) = (same_padding(n, kernel, stride) for n in x.shape[-2:])
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def reset_flax(module: nn.Module, generator: torch.Generator | None = None):
    """Flax's initialisers from ``generator`` on every layer of ``module``:
    convs and Dense layers lecun-normal with zero biases, norms scale 1 and
    bias 0, BatchNorm's running mean 0 and variance 1."""
    for mod in module.modules():
        if isinstance(mod, (Conv, BatchNorm, GroupNorm, Dense)):
            mod.reset_parameters(generator)


class BasicBlock(nn.Module):
    """Two 3x3 conv + norm layers and a residual; ``conv_2`` and its norm
    project the shortcut where the channels or the stride change (flax's
    ``Conv_0``, ``BatchNorm_0``, ..., ``Conv_2``, ``BatchNorm_2``; the norms
    are ``bn_i``, or ``gn_i`` for flax's ``GroupNorm_i``)."""

    def __init__(self, in_channels, filters, stride=1, dtype=torch.float32, device=None,
                 norm="bn"):
        super().__init__()
        self.prefix = "bn" if norm == "bn" else "gn"
        self.projects = in_channels != filters or stride != 1
        convs = [Conv(in_channels, filters, 3, stride, dtype, device),
                 Conv(filters, filters, 3, 1, dtype, device)]
        if self.projects:
            convs.append(Conv(in_channels, filters, 1, stride, dtype, device))
        for i, conv in enumerate(convs):
            self.add_module(f"conv_{i}", conv)
            self.add_module(f"{self.prefix}_{i}", norm_layer(norm, filters, dtype, device))

    def _norm(self, i, x, train, stats):
        name = f"{self.prefix}_{i}"
        return _normed(getattr(self, name), name, x, train, stats)

    def forward(self, x, train: bool = False):
        stats: StateDict = {}
        y = F.relu(self._norm(0, self.conv_0(x), train, stats))
        y = self._norm(1, self.conv_1(y), train, stats)
        if self.projects:
            x = self._norm(2, self.conv_2(x), train, stats)
        return F.relu(x + y), stats


class _ResNet(nn.Module):
    """A stem, BasicBlocks and the mean-pool head. ``forward(x,
    train=False)``: NHWC images to f32 logits; with ``train=True`` and
    BatchNorm, ``(logits, new_state)`` where ``new_state`` maps every BN
    buffer name to its updated value (a GroupNorm network has no state and
    returns the logits)."""

    def _build(self, stem, stages, blocks_per_stage, num_classes, norm, dtype, device):
        self.norm = norm
        self.prefix = "bn" if norm == "bn" else "gn"
        self.add_module(f"{self.prefix}_0", norm_layer(norm, stem, dtype, device))
        blocks, channels = [], stem
        for stage, filters in enumerate(stages):
            for block in range(blocks_per_stage):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(BasicBlock(channels, filters, stride, dtype, device, norm))
                channels = filters
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(channels, num_classes, device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Flax's initialisers from ``generator`` (:func:`reset_flax`)."""
        reset_flax(self, generator)

    def forward(self, x, train: bool = False):
        stats: StateDict = {}
        x = x.float().permute(0, 3, 1, 2)
        name = f"{self.prefix}_0"
        x = F.relu(_normed(getattr(self, name), name, self.conv_0(x), train, stats))
        if self.pool:
            x = max_pool_same(x, 3, 2)
        for i, block in enumerate(self.blocks):
            x, block_stats = block(x, train)
            stats.update({f"blocks.{i}.{k}": v for k, v in block_stats.items()})
        logits = self.head(x.float().mean((2, 3)))
        return (logits, stats) if train and self.norm == "bn" else logits


class CifarResNet(_ResNet):
    """3-stage CIFAR ResNet; depth = 6n + 2 (56 -> n = 9, 110 -> n = 18)."""

    def __init__(self, depth=56, num_classes=10, norm="bn", dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        if (depth - 2) % 6:
            raise ValueError(f"CifarResNet depth must be 6n + 2, got {depth}")
        device = resolve_device(device)
        self.pool = False
        self.conv_0 = Conv(3, 16, 3, 1, dtype, device)
        self._build(16, [16, 32, 64], (depth - 2) // 6, num_classes, norm, dtype, device)


class ResNet18(_ResNet):
    """The 4-stage ResNet-18; ``norm="gn"`` is the fed_cifar100 model
    (``resnet18_gn``). ``small_input`` keeps a 3x3 stride-1 stem without the
    max-pool, for CIFAR-sized images."""

    def __init__(self, num_classes=100, norm="gn", small_input=True, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.pool = not small_input
        self.conv_0 = (Conv(3, 64, 3, 1, dtype, device) if small_input
                       else Conv(3, 64, 7, 2, dtype, device))
        self._build(64, [64, 128, 256, 512], 2, num_classes, norm, dtype, device)


def resnet56(class_num: int = 10, norm: str = "bn", dtype=torch.float32,
             device="cuda") -> CifarResNet:
    return CifarResNet(depth=56, num_classes=class_num, norm=norm, dtype=dtype, device=device)


def resnet110(class_num: int = 10, norm: str = "bn", dtype=torch.float32,
              device="cuda") -> CifarResNet:
    return CifarResNet(depth=110, num_classes=class_num, norm=norm, dtype=dtype, device=device)


def resnet18_gn(class_num: int = 100, dtype=torch.float32, device="cuda") -> ResNet18:
    return ResNet18(num_classes=class_num, norm="gn", dtype=dtype, device=device)
