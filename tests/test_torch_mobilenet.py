"""The port's MobileNet V1 and V3 (fedml_tpu_torch/models/mobilenet.py)
against the JAX package's, at full width on a batch of 8 CIFAR-sized
images (32 x 32: every stride, the SAME padding of the 3x3 and 5x5
stride-2 depthwise convs on even sizes, and BatchNorm at flax's default
momentum 0.99 in training, its statistics over at least 8 x 2 x 2 values). The harness and its
tolerances are ``tests/_torch_zoo.py``'s: f32 eval and training logits,
new BN statistics and one SGD step through ``make_local_train`` within
1e-4; bf16 eval logits within 2^-6 + 2^-7 |x|; the converter round trip
bitwise."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax.numpy as jnp
import pytest
import torch

from fedml_tpu.models import mobilenet as jmob
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch.models import mobilenet as tmob
from fedml_tpu_torch.models.registry import create_model
from tests import _torch_zoo as zoo

CASES = {
    "v1": (lambda dtype: jmob.MobileNet(num_classes=10, dtype=dtype),
           lambda dtype: tmob.MobileNet(num_classes=10, dtype=dtype, device="cpu")),
    "v3_small": (lambda dtype: jmob.MobileNetV3(num_classes=10, mode="small", dtype=dtype),
                 lambda dtype: tmob.MobileNetV3(num_classes=10, mode="small", dtype=dtype,
                                                device="cpu")),
    "v3_large": (lambda dtype: jmob.MobileNetV3(num_classes=10, mode="large", dtype=dtype),
                 lambda dtype: tmob.MobileNetV3(num_classes=10, mode="large", dtype=dtype,
                                                device="cpu")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mobilenet_matches_jax(rng, case):
    jax_of, port_of = CASES[case]
    data = zoo.batch(rng, 8, 32, 10)
    ref = zoo.jax_reference(jax_of, data, zoo.CROSS_SILO, rng)
    zoo.check_parity(ref, port_of(torch.float32), port_of(torch.bfloat16), data, zoo.CROSS_SILO)


@pytest.mark.parametrize("name", ["mobilenet", "mobilenet_v3"])
def test_registry_builds_the_jax_shapes(name):
    zoo.check_shapes(jax_create_model(name, 10, "cifar10"),
                     create_model(name, 10, "cifar10", dtype="bfloat16", device="cpu"))


def test_depthwise_kernel_converts_to_grouped_weight():
    """A depthwise HWIO kernel ``[3, 3, 1, C]`` is the grouped OIHW weight
    ``[C, 1, 3, 3]``."""
    m = create_model("mobilenet", 10, "cifar10", device="cpu")
    assert m.separables[0].conv_0.weight.shape == (32, 1, 3, 3)
    assert m.separables[0].conv_0.groups == 32
