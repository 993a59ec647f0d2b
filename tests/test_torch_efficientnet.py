"""The port's EfficientNet (fedml_tpu_torch/models/efficientnet.py) against
the JAX package's: b0 at full width and depth on a batch of 8 images of
16 x 16 (its 5x5 stride-2 depthwise convs pad (1, 2) on the even 4 x 4 and
2 x 2 maps; GroupNorm's statistics are each example's; the card runs
32 x 32),
GroupNorm at eps 1e-6, the squeeze-excite squeezed from the block input's
width. Drop-connect and the head dropout draw per-site JAX keys that torch
cannot reproduce, so the parity runs with both rates at 0; the port's
masks are checked on their own (shape, rate, scaling, only on the residual
branch). The harness and its tolerances are ``tests/_torch_zoo.py``'s:
f32 eval and training logits and one SGD step of the cross-silo recipe
through ``make_local_train`` within 1e-4 of float64; bf16 eval logits
within 2^-6 + 2^-7 |x|; the converter round trip bitwise. The pure-Python
tables are copies, compared whole."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import numpy as np
import pytest
import torch

from fedml_tpu.models import efficientnet as jeff
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch.core.trainer import DropoutStream
from fedml_tpu_torch.models import efficientnet as teff
from fedml_tpu_torch.models.registry import create_model
from tests import _torch_zoo as zoo


def test_efficientnet_b0_matches_jax(rng):
    data = zoo.batch(rng, 8, 16, 10)
    ref = zoo.jax_reference(
        lambda dtype: jeff.EfficientNet(num_classes=10, dropout_rate=0.0,
                                        drop_connect_rate=0.0, dtype=dtype),
        data, zoo.CROSS_SILO, rng)

    def port(dtype):
        return create_model("efficientnet-b0", 10, "cifar10", dtype=dtype, device="cpu",
                            dropout_rate=0.0, drop_connect_rate=0.0)

    zoo.check_parity(ref, port(torch.float32), port(torch.bfloat16), data, zoo.CROSS_SILO)


def test_tables_are_copies():
    assert teff.SCALING == jeff.SCALING and teff.BASE_BLOCKS == jeff.BASE_BLOCKS
    for c in range(1, 700):
        assert teff._gn_groups(c) == jeff._gn_groups(c)
    for width in (1.0, 1.1, 1.4, 2.2):
        for f in (16, 24, 32, 40, 320, 1280):
            assert teff.round_filters(f, width) == jeff.round_filters(f, width)
    for depth in (1.0, 1.1, 3.6):
        assert [teff.round_repeats(r, depth) for r in range(1, 5)] == [
            jeff.round_repeats(r, depth) for r in range(1, 5)]


def test_drop_connect_and_dropout_sites():
    """Drop-connect: one keep draw per example on the residual branch of
    each residual block, at ``0.2 * block / 16``, kept branches scaled by
    ``1 / keep``; the head's dropout at the b0 rate 0.2."""
    model = create_model("efficientnet", 10, "cifar10", device="cpu")
    sites = model.dropout_sites
    assert sites["dropout"] == ((1280,), 0.2)
    residual = [i for i, b in enumerate(model.mbconvs) if b.residual]
    assert sorted(k for k in sites if k.startswith("drop_connect")) == sorted(
        f"drop_connect_{i}" for i in residual if i > 0)
    for i in residual:
        assert model.mbconvs[i].drop_rate == pytest.approx(0.2 * i / 16)
    block = model.mbconvs[residual[-1]]
    x = torch.randn(4, block.gn_0.weight.shape[0] // 6, 2, 2)
    keep = 1.0 - block.drop_rate
    mask = torch.tensor([True, False, True, False])[:, None, None, None]
    branch = block(x) - x  # no mask: the whole branch
    np.testing.assert_allclose((block(x, mask) - x).detach().numpy(),
                               torch.where(mask, branch / keep, 0.0).detach().numpy(),
                               atol=1e-6)
    masks = DropoutStream(sites, 0, 0, 2, 4, torch.device("cpu")).masks(0)
    out = model(torch.randn(2 * 4, 32, 32, 3)[:4], train=True,
                dropout={k: m[0] for k, m in masks.items()})
    assert out.shape == (4, 10) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="keep masks"):
        model(torch.zeros(1, 32, 32, 3), train=True)


@pytest.mark.parametrize("name", ["efficientnet", "efficientnet-b1", "efficientnet-b4"])
def test_registry_builds_the_jax_shapes(name):
    zoo.check_shapes(jax_create_model(name, 10, "cifar10"),
                     create_model(name, 10, "cifar10", dtype="bfloat16", device="cpu"))
