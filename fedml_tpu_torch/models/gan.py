"""The MNIST GAN, the port of ``fedml_tpu/models/gan.py`` (the fedgan
workload's generator and discriminator).

- :class:`Generator`: z ``[B, latent_dim]`` -> Dense 128, 256, 512, 1024,
  each but the first followed by BatchNorm, each then leaky ReLU 0.2; a
  ``tanh`` Dense to ``prod(img_shape)``, reshaped to ``[B, *img_shape]``.
- :class:`Discriminator`: images flattened -> Dense 512, 256 (leaky ReLU
  0.2 each) -> one logit ``[B, 1]``; the loss applies the sigmoid.

BatchNorm is flax's with ``momentum=0.8`` (the running average keeps 0.8
of itself: torch's ``momentum=0.2``) and eps 1e-5, written functionally as
the ResNets' (:class:`~fedml_tpu_torch.models.resnet.BatchNorm` on a
``[B, F, 1, 1]`` view): ``Generator.forward(z, train=True)`` returns
``(images, new_state)`` and writes no buffer, so a forward whose statistics
are to be thrown away (the GAN's discriminator step) leaves them as they
were. ``dtype`` (the port's own field, f32 by default as flax computes
these layers) is the compute dtype of every layer, the parity tests' float64;
each network casts its input to f32 first, as the flax modules do. Leaky
ReLU is JAX's ``where(x >= 0, x, 0.2 * x)``, whose gradient at 0 is 1
(torch's ``leaky_relu`` takes the slope there): a zero-filled padding row
meets 0 exactly while the biases are 0. Names follow :mod:`fedml_tpu_torch.convert`: flax's ``Dense_i`` is
``dense_i``, ``BatchNorm_i`` is ``bn_i``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.models.resnet import BatchNorm, _normed, reset_flax
from fedml_tpu_torch.models.transformer import Dense

StateDict = dict[str, torch.Tensor]

_WIDTHS = ((128, False), (256, True), (512, True), (1024, True))


def leaky_relu(x, slope: float = 0.2):
    """``jax.nn.leaky_relu``: gradient 1 at 0."""
    return torch.where(x >= 0, x, slope * x)


class Generator(nn.Module):
    def __init__(self, latent_dim: int = 100, img_shape=(28, 28, 1), dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.latent_dim, self.img_shape, self.dtype = latent_dim, tuple(img_shape), dtype
        width, n_bn = latent_dim, 0
        self.norms = []  # per hidden Dense: the name of its BatchNorm, or None
        for i, (out, norm) in enumerate(_WIDTHS):
            self.add_module(f"dense_{i}", Dense(width, out, dtype=dtype, device=device))
            if norm:
                self.add_module(f"bn_{n_bn}", BatchNorm(out, dtype, momentum=0.8, device=device))
                self.norms.append(f"bn_{n_bn}")
                n_bn += 1
            else:
                self.norms.append(None)
            width = out
        self.dense_4 = Dense(width, math.prod(self.img_shape), dtype=dtype, device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Flax's initialisers (:func:`~fedml_tpu_torch.models.resnet.reset_flax`)."""
        reset_flax(self, generator)

    def forward(self, z, train: bool = False):
        stats: StateDict = {}
        h = z.float().to(self.dtype)
        for i, name in enumerate(self.norms):
            h = getattr(self, f"dense_{i}")(h)
            if name is not None:
                h = _normed(getattr(self, name), name, h[:, :, None, None], train,
                            stats)[:, :, 0, 0]
            h = leaky_relu(h)
        h = torch.tanh(self.dense_4(h))
        img = h.reshape((h.shape[0],) + self.img_shape)
        return (img, stats) if train else img


class Discriminator(nn.Module):
    def __init__(self, img_shape=(28, 28, 1), dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.dense_0 = Dense(math.prod(tuple(img_shape)), 512, dtype=dtype, device=device)
        self.dense_1 = Dense(512, 256, dtype=dtype, device=device)
        self.dense_2 = Dense(256, 1, dtype=dtype, device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_flax(self, generator)

    def forward(self, img, train: bool = False):
        h = img.reshape(img.shape[0], -1).float().to(self.dtype)
        h = leaky_relu(self.dense_0(h))
        h = leaky_relu(self.dense_1(h))
        return self.dense_2(h)
