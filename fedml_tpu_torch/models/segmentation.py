"""The segmentation models, the port of ``fedml_tpu/models/segmentation.py``
(``_gn``, ``_interp_matrix``, ``upsample_2d``, ``ConvBlock``, ``UNet``,
``ASPP``, ``DeepLabLite``): the compact UNet and DeepLabV3-shaped models the
federated segmentation task (``algorithms/fedseg.py``) trains.

Images come in NHWC ``[B, H, W, C]``, as the datasets hold them; the
networks compute in NCHW and return logits in the JAX package's order,
``[B, H, W, num_classes]``, which the segmentation task and the engine's
per-client evaluation read. Flax's semantics are kept where torch's differ:

- GroupNorm is flax's (``models/resnet.py`` ``GroupNorm``: eps 1e-6, the
  fast variance), with ``_gn(8, c)`` groups;
- every conv pads as XLA's ``"SAME"``: the decoder's 2x2 conv (0, 1), a
  3x3 conv of dilation d by d on each side;
- upsampling is two contractions with the JAX package's ``[dst, src]``
  interpolation matrices, built in numpy by a copy of ``_interp_matrix``
  (nearest with half-pixel centres, bilinear clamped at the edges), each
  copied to the device once per module (:class:`Interp`): a CUDA graph
  capture cannot copy from the host.

A model has parameters and no buffers, so its training forward returns the
logits alone. ``dtype`` is the compute dtype (f32; f64 for the parity
tests); the JAX models take none, and the registry refuses one.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.models.resnet import Conv, GroupNorm, reset_flax


def _gn(groups: int, c: int) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def _interp_matrix(src: int, dst: int, method: str) -> np.ndarray:
    """[dst, src] 1-D interpolation matrix (half-pixel centers), f32."""
    if method == "nearest":
        src_idx = np.clip(((np.arange(dst) + 0.5) * src / dst).astype(int), 0, src - 1)
        m = np.zeros((dst, src), np.float32)
        m[np.arange(dst), src_idx] = 1.0
        return m
    # bilinear
    coords = (np.arange(dst) + 0.5) * src / dst - 0.5
    lo = np.clip(np.floor(coords).astype(int), 0, src - 1)
    hi = np.clip(lo + 1, 0, src - 1)
    frac = np.clip(coords - lo, 0.0, 1.0)
    m = np.zeros((dst, src), np.float32)
    np.add.at(m, (np.arange(dst), lo), 1.0 - frac)
    np.add.at(m, (np.arange(dst), hi), frac)
    return m


class Interp:
    """The interpolation matrices of one module, on the device and in the
    dtype of the activations they meet, made at their first use."""

    def __init__(self):
        self._matrices: dict[tuple, torch.Tensor] = {}

    def matrix(self, src: int, dst: int, method: str, like: torch.Tensor) -> torch.Tensor:
        key = (src, dst, method, like.device, like.dtype)
        if key not in self._matrices:
            self._matrices[key] = torch.as_tensor(_interp_matrix(src, dst, method),
                                                  device=like.device).to(like.dtype)
        return self._matrices[key]


def upsample_2d(x: torch.Tensor, out_hw: tuple[int, int], method: str = "nearest",
                interp: Interp | None = None) -> torch.Tensor:
    """NCHW ``[B, C, H, W]`` -> ``[B, C, out_h, out_w]``: ``mh @ x @ mw^T``,
    the JAX package's ``einsum("hH,bHWc,wW->bhwc")`` in NCHW. ``interp``
    keeps the matrices across calls (a fresh one each call without it)."""
    interp = interp or Interp()
    mh = interp.matrix(x.shape[-2], out_hw[0], method, x)
    mw = interp.matrix(x.shape[-1], out_hw[1], method, x)
    return torch.matmul(torch.matmul(mh, x), mw.transpose(0, 1))


class ConvBlock(nn.Module):
    """Two (3x3 conv without bias, GroupNorm, ReLU) layers: flax's
    ``Conv_0``, ``GroupNorm_0``, ``Conv_1``, ``GroupNorm_1`` are ``conv_0``,
    ``gn_0``, ``conv_1``, ``gn_1``."""

    def __init__(self, in_channels, features, dilation=1, dtype=torch.float32, device=None):
        super().__init__()
        for i in range(2):
            self.add_module(f"conv_{i}", Conv(in_channels if i == 0 else features, features,
                                              3, 1, dtype, device, dilation=dilation))
            self.add_module(f"gn_{i}", GroupNorm(features, _gn(8, features), dtype,
                                                 device=device))

    def forward(self, x):
        for i in range(2):
            x = F.relu(getattr(self, f"gn_{i}")(getattr(self, f"conv_{i}")(x))[0])
        return x


class _SegNet(nn.Module):
    """What the two networks share: flax's initialisers, the NHWC entry and
    exit, the interpolation matrices."""

    def __init__(self):
        super().__init__()
        self._interp = Interp()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Flax's initialisers from ``generator`` (:func:`reset_flax`)."""
        reset_flax(self, generator)

    def forward(self, x, train: bool = False):
        logits = self._nchw(x.to(self.dtype).permute(0, 3, 1, 2))
        return logits.permute(0, 2, 3, 1)


class UNet(_SegNet):
    """The encoder/decoder with skip connections: a ConvBlock and a 2x2
    max-pool per level but the last, a ConvBlock at the bottom, then per
    level nearest upsampling, a 2x2 biased conv, the skip concatenated and a
    ConvBlock; a 1x1 biased head. Flax's ``ConvBlock_i`` are
    ``convblocks.i`` (encoder, bottom, decoder in order), its top-level
    ``Conv_0``, ``Conv_1`` the decoder's 2x2 convs and ``Conv_2`` the head,
    ``conv_i`` here."""

    def __init__(self, num_classes: int = 21, features: Sequence[int] = (32, 64, 128),
                 in_channels: int = 3, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        features = tuple(features)
        blocks, c = [], in_channels
        for f in features:
            blocks.append(ConvBlock(c, f, dtype=dtype, device=device))
            c = f
        convs = []
        for f in reversed(features[:-1]):
            convs.append(Conv(c, f, 2, 1, dtype, device, bias=True))
            blocks.append(ConvBlock(2 * f, f, dtype=dtype, device=device))
            c = f
        convs.append(Conv(c, num_classes, 1, 1, dtype, device, bias=True))
        self.convblocks = nn.ModuleList(blocks)
        for i, conv in enumerate(convs):
            self.add_module(f"conv_{i}", conv)
        self.levels = len(features) - 1
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def _nchw(self, x):
        skips = []
        for i in range(self.levels):
            x = self.convblocks[i](x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.convblocks[self.levels](x)
        for j, skip in enumerate(reversed(skips)):
            x = upsample_2d(x, skip.shape[-2:], "nearest", self._interp)
            x = getattr(self, f"conv_{j}")(x)
            x = torch.cat([x, skip], dim=1)
            x = self.convblocks[self.levels + 1 + j](x)
        return getattr(self, f"conv_{self.levels}")(x)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (the DeepLabV3 head): a ConvBlock per
    rate (``convblocks.k``, flax's ``ConvBlock_k``), the image-pooling
    branch (the mean over H x W, a 1x1 biased conv ``conv_0``, broadcast
    back over H x W), concatenated and projected by the 1x1 biased
    ``conv_1``."""

    def __init__(self, in_channels, features=128, rates: Sequence[int] = (1, 2, 4),
                 dtype=torch.float32, device=None):
        super().__init__()
        self.convblocks = nn.ModuleList(ConvBlock(in_channels, features, r, dtype, device)
                                        for r in rates)
        self.conv_0 = Conv(in_channels, features, 1, 1, dtype, device, bias=True)
        self.conv_1 = Conv(features * (len(rates) + 1), features, 1, 1, dtype, device,
                           bias=True)
        self.features = features

    def forward(self, x):
        branches = [block(x) for block in self.convblocks]
        pooled = self.conv_0(x.mean((2, 3), keepdim=True))
        branches.append(pooled.expand(x.shape[0], self.features, x.shape[2], x.shape[3]))
        return self.conv_1(torch.cat(branches, dim=1))


class DeepLabLite(_SegNet):
    """Two (ConvBlock, 2x2 max-pool) levels, a ConvBlock of dilation 2, ASPP
    (``aspp``, flax's ``ASPP_0``), a 1x1 biased head (``conv_0``) and
    bilinear upsampling back to the input's size."""

    def __init__(self, num_classes: int = 21, features: Sequence[int] = (32, 64, 128),
                 in_channels: int = 3, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        f0, f1, f2 = features
        self.convblocks = nn.ModuleList([
            ConvBlock(in_channels, f0, dtype=dtype, device=device),
            ConvBlock(f0, f1, dtype=dtype, device=device),
            ConvBlock(f1, f2, dilation=2, dtype=dtype, device=device)])
        self.aspp = ASPP(f2, f2, dtype=dtype, device=device)
        self.conv_0 = Conv(f2, num_classes, 1, 1, dtype, device, bias=True)
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def _nchw(self, x):
        in_hw = x.shape[-2:]
        x = F.max_pool2d(self.convblocks[0](x), 2, 2)
        x = F.max_pool2d(self.convblocks[1](x), 2, 2)
        x = self.aspp(self.convblocks[2](x))
        return upsample_2d(self.conv_0(x), in_hw, "bilinear", self._interp)
