"""The port's VGG (fedml_tpu_torch/models/vgg.py) against the JAX
package's, VGG-11 and VGG-16 at full width on a batch of 8 CIFAR-sized
images (32 x 32: five 2x2 VALID pools take them to 1x1). Its
``Dropout(0.5)`` is flax's fixed rate: the port gets the keep masks the
JAX training forward drew, read off its output (``tests/_torch_zoo.py``),
in the training forward and in the SGD step. The harness and its
tolerances are ``tests/_torch_zoo.py``'s: f32 eval and training logits,
new BN statistics (flax's default momentum 0.99) and one SGD step of the
cross-silo recipe through ``make_local_train`` within 1e-4 of float64;
bf16 eval logits within 2^-6 + 2^-7 |x|; the converter round trip
bitwise."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.models.vgg import VGG as JaxVGG
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.models.vgg import VGG
from tests import _torch_zoo as zoo


@pytest.mark.parametrize("depth", [11, 16])
def test_vgg_matches_jax(rng, depth):
    data = zoo.batch(rng, 8, 32, 10)
    ref = zoo.jax_reference(lambda dtype: JaxVGG(depth=depth, num_classes=10, dtype=dtype),
                            data, zoo.CROSS_SILO, rng, dropout=True)
    assert ref["new"]["intermediates"]  # the JAX forward really dropped
    zoo.check_parity(ref, VGG(depth, 10, device="cpu"),
                     VGG(depth, 10, dtype=torch.bfloat16, device="cpu"), data, zoo.CROSS_SILO)


def test_flatten_is_nhwc_at_another_size(rng):
    """The first Dense's rows run over (h, w, c) as flax flattens: eval
    logits at 64 x 64 (a 2 x 2 x 512 map before the flatten)."""
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    jm = JaxVGG(depth=11, num_classes=10)
    variables = zoo.numpy_variables(jm, {"x": x}, rng)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tm = VGG(11, 10, input_shape=(64, 64, 3), device="cpu")
    tm.load_state_dict(zoo.convert.from_flax(variables))
    np.testing.assert_allclose(tm(torch.tensor(x)).detach().numpy(), ref, atol=zoo.ATOL)


@pytest.mark.parametrize("name", ["vgg11", "vgg13", "vgg16", "vgg19", "vgg"])
def test_registry_builds_the_jax_shapes(name):
    model = create_model(name, 10, "cifar10", device="cpu")
    zoo.check_shapes(jax_create_model(name, 10, "cifar10"), model)
    assert model.dropout_sites == {"dropout_0": ((512,), 0.5)}
