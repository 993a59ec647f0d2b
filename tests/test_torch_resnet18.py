"""The port's ResNet-18 with GroupNorm (``resnet18_gn``, the fed_cifar100
model; fedml_tpu_torch/models/resnet.py) against the JAX package's, at full
width on a batch of 8 images of 16 x 16 (GroupNorm's statistics are each
example's, so a smaller image changes no conditioning; the card runs
32 x 32), and its 7x7 stride-2 stem with
the SAME max-pool (``small_input=False``), whose -inf padding is (0, 1) on
an even size. The harness and its tolerances are ``tests/_torch_zoo.py``'s:
f32 eval and training logits and one SGD step of the fed_cifar100 recipe
(lr 0.1) through ``make_local_train`` within 1e-4 of float64; bf16 eval
logits within 2^-6 + 2^-7 |x| (GroupNorm's statistics in f32, as flax
takes them under a bf16 compute dtype); the converter round trip bitwise.
GroupNorm has no state: no ``batch_stats``, no buffers."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.models.resnet import ResNet18 as JaxResNet18
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.models.resnet import GroupNorm, ResNet18, max_pool_same
from tests import _torch_zoo as zoo


def test_resnet18_gn_matches_jax(rng):
    data = zoo.batch(rng, 8, 16, 100)
    ref = zoo.jax_reference(lambda dtype: JaxResNet18(num_classes=100, dtype=dtype), data,
                            zoo.FED_CIFAR100, rng)
    assert set(ref["variables"]) == {"params"}
    zoo.check_parity(ref, ResNet18(num_classes=100, device="cpu"),
                     ResNet18(num_classes=100, dtype=torch.bfloat16, device="cpu"), data,
                     zoo.FED_CIFAR100)


def test_large_input_stem_and_same_max_pool_match_jax(rng):
    """The 7x7 stride-2 stem and the 3x3 stride-2 SAME max-pool, eval
    logits on 32x32 and 33x33 images (even and odd sizes)."""
    for size in (32, 33):
        x = rng.randn(2, size, size, 3).astype(np.float32)
        jm = JaxResNet18(num_classes=10, small_input=False)
        variables = zoo.numpy_variables(jm, {"x": x}, rng)
        ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
        tm = ResNet18(num_classes=10, small_input=False, device="cpu")
        tm.load_state_dict(zoo.convert.from_flax(variables))
        np.testing.assert_allclose(tm(torch.tensor(x)).detach().numpy(), ref, atol=zoo.ATOL)


@pytest.mark.parametrize("size", [8, 7])
def test_same_max_pool_pads_with_minus_inf(rng, size):
    x = rng.randn(2, size, size, 3).astype(np.float32) - 5.0  # all negative: 0-padding would win
    ref = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    got = max_pool_same(torch.tensor(x).permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_group_norm_matches_flax(rng, dtype):
    """eps 1e-6, f32 statistics, output in the compute dtype."""
    x = (rng.randn(3, 5, 5, 8) * 2 + 1).astype(np.float32)
    gn = nn.GroupNorm(num_groups=2, dtype=dtype)
    variables = {"params": {"scale": (1 + 0.1 * rng.randn(8)).astype(np.float32),
                            "bias": (0.1 * rng.randn(8)).astype(np.float32)}}
    xin = jnp.asarray(x, dtype)
    ref = np.asarray(gn.apply(variables, xin).astype(jnp.float32))
    port = GroupNorm(8, 2, torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    port.load_state_dict({"weight": torch.tensor(variables["params"]["scale"]),
                          "bias": torch.tensor(variables["params"]["bias"])})
    got, new = port(torch.tensor(np.asarray(xin.astype(jnp.float32))).to(port.dtype)
                    .permute(0, 3, 1, 2))
    assert new is None and got.dtype == port.dtype
    got = got.detach().float().permute(0, 2, 3, 1).numpy()
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, ref, atol=1e-5)
    else:  # one rounding of the same f32 value: at most one bf16 ulp apart
        assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-6)


def test_registry_builds_the_jax_shapes():
    zoo.check_shapes(jax_create_model("resnet18_gn", 100, "fed_cifar100"),
                     create_model("resnet18_gn", 100, "fed_cifar100", dtype="bfloat16",
                                  device="cpu"))
    assert not list(create_model("resnet18_gn", 100, device="cpu").buffers())
