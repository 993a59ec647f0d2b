"""VGG-11/13/16/19, the port of ``fedml_tpu/models/vgg.py``.

Images come in NHWC ``[N, H, W, 3]``; the network computes in NCHW. Each
3x3 SAME conv (biased only without BatchNorm) is followed by flax's default
BatchNorm (momentum 0.99, eps 1e-5) and a ReLU, each ``"M"`` by a 2x2
VALID max-pool; then ``Dense(512)`` in the compute dtype, ReLU,
``Dropout(0.5)`` and an f32 head. flax flattens NHWC activations before the
first Dense, so the port permutes to NHWC before the flatten and a
converted kernel applies at any spatial size.

The dropout is a site (:attr:`VGG.dropout_sites`) whose keep mask the
trainer draws (:class:`~fedml_tpu_torch.core.trainer.DropoutStream`) and
passes in: ``forward(x, train=True, dropout={site: mask})`` returns
``(logits, new_state)``, the new BN statistics by buffer name. flax's
``Conv_i``/``BatchNorm_i``/``Dense_i`` are ``conv_i``/``bn_i``/``dense_i``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.models.mobilenet import FLAX_MOMENTUM
from fedml_tpu_torch.models.resnet import BatchNorm, Conv, StateDict, _normed, reset_flax
from fedml_tpu_torch.models.transformer import Dense

_CFG = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512,
         "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512,
         512, 512, 512, "M"],
}


class VGG(nn.Module):
    """VGG of ``depth`` 11, 13, 16 or 19 with optional BatchNorm;
    ``input_shape`` (H, W, ...) sizes the first Dense; ``dropout_rate`` is
    flax's fixed 0.5 (parity tests set it to 0)."""

    def __init__(self, depth=16, num_classes=10, batch_norm=True, dtype=torch.float32,
                 input_shape=(32, 32, 3), dropout_rate=0.5, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.batch_norm = _CFG[depth], batch_norm
        channels, (h, w), i = 3, input_shape[:2], 0
        for v in self.cfg:
            if v == "M":
                h, w = h // 2, w // 2
                continue
            self.add_module(f"conv_{i}", Conv(channels, v, 3, 1, dtype, device,
                                              bias=not batch_norm))
            if batch_norm:
                self.add_module(f"bn_{i}", BatchNorm(v, dtype, FLAX_MOMENTUM, device=device))
            channels, i = v, i + 1
        self.dense_0 = Dense(h * w * channels, 512, dtype=dtype, device=device)
        self.dense_1 = Dense(512, num_classes, device=device)
        self.dropout_sites = ({"dropout_0": ((512,), float(dropout_rate))}
                              if dropout_rate > 0.0 else {})
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_flax(self, generator)

    def forward(self, x, train: bool = False, dropout=None):
        stats: StateDict = {}
        x = x.float().permute(0, 3, 1, 2)
        i = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = getattr(self, f"conv_{i}")(x)
            if self.batch_norm:
                x = _normed(getattr(self, f"bn_{i}"), f"bn_{i}", x, train, stats)
            x = F.relu(x)
            i += 1
        x = F.relu(self.dense_0(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)))
        if train and self.dropout_sites:
            if dropout is None or "dropout_0" not in dropout:
                raise ValueError("VGG in training needs the keep mask of 'dropout_0' "
                                 "(fedml_tpu_torch.core.trainer.draw_dropout_masks)")
            keep = 1.0 - self.dropout_sites["dropout_0"][1]
            x = torch.where(dropout["dropout_0"], x / keep, 0.0)
        logits = self.dense_1(x.float())
        if not train:
            return logits
        return (logits, stats) if self.batch_norm else logits
