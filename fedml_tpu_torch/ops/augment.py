"""On-device image augmentation, the port of ``fedml_tpu/ops/augment.py``.

The reference CIFAR train pipeline, per example: pad by 4 with zeros (on the
normalised image) and crop back at a random offset, flip horizontally with
p = 0.5, and zero an exactly 16 x 16 window ``[c - 8, c + 8)`` around a
random centre, clipped at the edges. Evaluation is never augmented.

JAX draws each example's offsets from threefry keys inside the round
program; those bits cannot be reproduced in torch. The port splits drawing
from applying instead: :meth:`ImageAugment.draw` draws a round's crop
offsets, flip bits and cutout centres as integer tensors from an explicit
``torch.Generator`` (:func:`round_generator`, seeded from the seed, the round
and the client slot), and :meth:`ImageAugment.apply` applies them as
deterministic tensor ops on NHWC batches of any leading shape. The scan and
vmap modes then train on the same augmented batches, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


def round_generator(seed: int, round_idx: int, slot: int) -> torch.Generator:
    """A CPU generator for client slot ``slot`` of round ``round_idx``, its
    seed mixed from ``(seed, round_idx, slot)`` by numpy's SeedSequence."""
    mixed = np.random.SeedSequence([seed, round_idx, slot]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))


@dataclasses.dataclass(frozen=True)
class ImageAugment:
    """Crop -> flip -> cutout, each per example (``ImageAugment`` of the JAX
    package, ``fedml_tpu/ops/augment.py:66``)."""

    padding: int = 4
    cutout_length: int = 16
    flip: bool = True

    def draw(self, generator: torch.Generator, shape: tuple[int, ...],
             image: tuple[int, int]) -> dict[str, torch.Tensor]:
        """Per-example draws for batches of ``shape`` (e.g. ``(E, S, B)``)
        of ``image = (H, W)`` images: crop offsets ``dy``/``dx`` in
        ``[0, 2 * padding]``, ``flip`` in {0, 1}, cutout centres ``cy`` in
        ``[0, H)`` and ``cx`` in ``[0, W)``, int64 on the generator's
        device, drawn in that order."""
        h, w = image
        span = 2 * self.padding + 1

        def randint(high):
            return torch.randint(0, high, shape, generator=generator,
                                 device=generator.device)

        return {"dy": randint(span), "dx": randint(span), "flip": randint(2),
                "cy": randint(h), "cx": randint(w)}

    def apply(self, x: torch.Tensor, draws: dict[str, torch.Tensor]) -> torch.Tensor:
        """Augment ``x`` ``[..., H, W, C]`` with ``draws`` of its leading
        shape ``[...]``."""
        if x.dim() < 4:
            raise ValueError(
                f"ImageAugment needs [..., B, H, W, C] images; got shape {tuple(x.shape)}")
        lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
        x = x.reshape((-1, h, w, c))
        d = {k: v.reshape(-1).to(x.device) for k, v in draws.items()}
        n = x.shape[0]
        p = self.padding
        # random_crop: zero padding, then the (dy, dx) window of every image
        padded = F.pad(x, (0, 0, p, p, p, p))
        rows = d["dy"][:, None] + torch.arange(h, device=x.device)
        cols = d["dx"][:, None] + torch.arange(w, device=x.device)
        x = padded[torch.arange(n, device=x.device)[:, None, None], rows[:, :, None],
                   cols[:, None, :]]
        if self.flip:
            x = torch.where(d["flip"].bool()[:, None, None, None], x.flip(-2), x)
        if self.cutout_length:
            half = self.cutout_length // 2
            ys = torch.arange(h, device=x.device)[None, :, None]
            xs = torch.arange(w, device=x.device)[None, None, :]
            cy, cx = d["cy"][:, None, None], d["cx"][:, None, None]
            mask = (ys >= cy - half) & (ys < cy + half) & (xs >= cx - half) & (xs < cx + half)
            x = x * (1.0 - mask.to(x.dtype))[..., None]
        return x.reshape(lead + (h, w, c))
