"""The split ResNets of Group Knowledge Transfer, the port of
``fedml_tpu/models/resnet_gkt.py``.

- :class:`ResNetGKTClient` (the reference's ``resnet8_56`` client): a 3x3
  stem and ``blocks`` BasicBlocks at 16 channels, then a mean pool and its
  own classifier; returns ``(features, logits)``.
- :class:`ResNetGKTServer` (``resnet56_server``): takes the client's
  feature maps through two stages of ``blocks_per_stage`` BasicBlocks at 32
  and 64 channels (each stage's first block strides 2) and the classifier.

Built from the port's ResNet parts (:class:`~fedml_tpu_torch.models.resnet.BasicBlock`,
the flax BatchNorm, SAME-padded convs), with their semantics: images come in
NHWC as the datasets hold them; the features are NCHW ``[B, 16, H, W]``, the
port's own layout (the JAX package's are NHWC: compare them after a
transpose), and the server takes them so. In training with BatchNorm,
``forward(x, train=True)`` returns ``(out, new_state)``, ``out`` being the
evaluation's output. ``dtype`` is the compute dtype of every layer (f32 by
default, as flax computes these; the mean pool and the head run in f32, or
in float64 for a float64 ``dtype``, which the parity tests use and which
keeps the variables in float64 too). Names
follow :mod:`fedml_tpu_torch.convert` (flax's
``Conv_0``, ``BatchNorm_0``, ``BasicBlock_i`` and the top-level ``Dense_0``
are ``conv_0``, ``bn_0``, ``blocks.i`` and ``head``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.models.resnet import BasicBlock, Conv, _normed, norm_layer, reset_flax
from fedml_tpu_torch.models.transformer import Dense

StateDict = dict[str, torch.Tensor]


def _head_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def _keep_float64(module: nn.Module, dtype) -> None:
    """Float64 compute keeps float64 variables (f32 otherwise, as flax's)."""
    if dtype == torch.float64:
        module.double()


def _run_blocks(blocks, x, train: bool, stats: StateDict):
    for i, block in enumerate(blocks):
        x, block_stats = block(x, train)
        stats.update({f"blocks.{i}.{k}": v for k, v in block_stats.items()})
    return x


class ResNetGKTClient(nn.Module):
    def __init__(self, num_classes: int = 10, blocks: int = 1, norm: str = "bn",
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.norm, self.prefix = norm, "bn" if norm == "bn" else "gn"
        self.conv_0 = Conv(3, 16, 3, 1, dtype, device)
        self.add_module(f"{self.prefix}_0", norm_layer(norm, 16, dtype, device))
        self.blocks = nn.ModuleList(BasicBlock(16, 16, 1, dtype, device, norm)
                                    for _ in range(blocks))
        self.head = Dense(16, num_classes, dtype=_head_dtype(dtype), device=device)
        _keep_float64(self, dtype)
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_flax(self, generator)

    def forward(self, x, train: bool = False):
        stats: StateDict = {}
        name = f"{self.prefix}_0"
        h = x.float().permute(0, 3, 1, 2)
        h = F.relu(_normed(getattr(self, name), name, self.conv_0(h), train, stats))
        features = _run_blocks(self.blocks, h, train, stats)
        logits = self.head(features.to(self.head.dtype).mean((2, 3)))
        out = (features, logits)
        return (out, stats) if train and self.norm == "bn" else out


class ResNetGKTServer(nn.Module):
    def __init__(self, num_classes: int = 10, blocks_per_stage: int = 9, norm: str = "bn",
                 in_channels: int = 16, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.norm = norm
        blocks, channels = [], in_channels
        for filters in (32, 64):
            for block in range(blocks_per_stage):
                blocks.append(BasicBlock(channels, filters, 2 if block == 0 else 1, dtype, device,
                                         norm))
                channels = filters
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(channels, num_classes, dtype=_head_dtype(dtype), device=device)
        _keep_float64(self, dtype)
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_flax(self, generator)

    def forward(self, features, train: bool = False):
        stats: StateDict = {}
        h = _run_blocks(self.blocks, features.float().to(self.head.dtype), train, stats)
        logits = self.head(h.to(self.head.dtype).mean((2, 3)))
        return (logits, stats) if train and self.norm == "bn" else logits
