"""The port's CIFAR ResNet (fedml_tpu_torch/models/resnet.py) against the JAX
package's, from the same JAX-initialised variables converted by
fedml_tpu_torch/convert.py. A depth-8 ``CifarResNet`` (one BasicBlock per
stage) on 8x8 images keeps every hazard (both strides, both shortcuts,
BatchNorm in train and eval) at a size the CPU runs in a blink.

Tolerances, fixed before the first run:
- f32 eval logits, train-mode logits and new batch statistics, and one SGD
  step with weight decay and momentum: atol 1e-5. The same f32 arithmetic
  through eight conv/BN layers with sums taken in other orders.
- stride-2 SAME padding and the converter round trip: bitwise.
- bf16 compute: both packages round every conv output, BN output and
  residual add to bf16 (8 significant bits), at places where they fuse and
  accumulate differently, so neither is closer to the exact function than
  bf16's own rounding lets it be. Each is held to the f32 logits of the
  same variables: the port's distance from them may be at most twice the
  JAX package's (``d_port <= 2 d_jax``), and the two bf16 runs may differ by
  at most their two distances summed, bounded by ``3 d_jax`` (triangle
  inequality). Eval and train-mode logits alike."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.models.resnet import CifarResNet as JaxResNet
from fedml_tpu.models.resnet import resnet18_gn as jax_resnet18_gn
from fedml_tpu.models.resnet import resnet56 as jax_resnet56
from fedml_tpu_torch import convert
from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.models.resnet import CifarResNet, Conv, same_padding

ATOL = 1e-5


def _images(rng, n=6, size=8, padded=2):
    x = rng.randn(n, size, size, 3).astype(np.float32)
    if padded:
        x[-padded:] = 0.0  # zero-filled padding rows, as the engine's gather makes them
    return x


def _pair(rng, dtype=None):
    """(JAX module, its f32 variables as numpy, port module loaded with them)."""
    jm = JaxResNet(depth=8, num_classes=10, dtype=dtype or jnp.float32)
    variables = jax.tree.map(np.asarray,
                             jax.jit(jm.init)(jax.random.key(0), jnp.asarray(_images(rng))))
    tm = CifarResNet(depth=8, num_classes=10, device="cpu",
                     dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    tm.load_state_dict(convert.from_flax(variables))
    return jm, variables, tm


def test_eval_logits_match_jax(rng):
    jm, variables, tm = _pair(rng)
    x = _images(rng)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    np.testing.assert_allclose(tm(torch.tensor(x)).detach().numpy(), ref, atol=ATOL)


def test_train_logits_and_batch_stats_match_jax(rng):
    """Train mode on a batch whose last two rows are zero padding: the
    padding counts in the batch statistics, in both packages."""
    jm, variables, tm = _pair(rng)
    x = _images(rng)
    j_logits, j_new = jax.jit(
        lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    t_logits, t_new = tm(torch.tensor(x), train=True)
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(j_logits), atol=ATOL)
    j_stats = convert.from_flax(jax.tree.map(np.asarray, dict(j_new)))
    assert set(t_new) == set(j_stats) == {k for k, _ in tm.named_buffers()}
    for k in j_stats:
        np.testing.assert_allclose(t_new[k].detach().numpy(), j_stats[k].numpy(), atol=ATOL,
                                   err_msg=k)
    # the padding rows moved the statistics: without them they differ
    _, no_pad = tm(torch.tensor(x[:-2]), train=True)
    assert not torch.allclose(no_pad["bn_0.running_mean"], t_new["bn_0.running_mean"])
    # evaluation writes nothing
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tm(torch.tensor(x))
    assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())


def test_one_sgd_step_with_weight_decay_matches_optax(rng):
    """One step of add_decayed_weights(wd) + sgd(lr, momentum) on the
    cross-entropy of a padded batch: parameters and BN statistics."""
    jm, variables, tm = _pair(rng)
    x = _images(rng)
    y = rng.randint(0, 10, len(x)).astype(np.int32)
    mask = np.ones(len(x), np.float32)
    mask[-2:] = 0.0
    batch = {"x": x, "y": y, "mask": mask}
    lr, momentum, wd = 0.1, 0.9, 0.01
    jtr = JaxTrainer(module=jm, optimizer=optax.chain(optax.add_decayed_weights(wd),
                                                      optax.sgd(lr, momentum)))
    opt_state = jtr.optimizer.init(variables["params"])
    j_vars, _, j_loss = jax.jit(jtr.train_step)(
        variables, opt_state, variables["params"], {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(0))
    ttr = ClientTrainer(module=tm, optimizer=sgd(lr, momentum, wd))
    t_loss = ttr.train_step(ttr.optimizer(tm.parameters()),
                            {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(t_loss), float(j_loss), atol=ATOL)
    j_sd = convert.from_flax(jax.tree.map(np.asarray, dict(j_vars)))
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), j_sd[k].numpy(), atol=ATOL, err_msg=k)
    # a fully padded batch leaves parameters and model state untouched
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    zero = {k: torch.tensor(v) for k, v in batch.items()}
    zero["mask"] = torch.zeros(len(x))
    assert float(ttr.train_step(ttr.optimizer(tm.parameters()), zero)) == 0.0
    assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())


@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("kernel", [3, 1])
def test_stride2_same_padding_matches_flax(rng, size, kernel):
    """flax SAME with stride 2 pads (0, 1) on even sizes, where torch's
    padding=1 pads (1, 1) and computes a different function."""
    x = rng.randn(2, size, size, 4).astype(np.float32)
    conv = nn.Conv(5, (kernel, kernel), strides=2, padding="SAME", use_bias=False)
    params = conv.init(jax.random.key(1), jnp.asarray(x))
    ref = np.asarray(conv.apply(params, jnp.asarray(x)))
    port = Conv(4, 5, kernel, stride=2)
    port.weight.data = torch.tensor(np.asarray(params["params"]["kernel"]).transpose(3, 2, 0, 1))
    out = port(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    if kernel == 3 and size % 2 == 0:
        assert same_padding(size, 3, 2) == (0, 1)
        naive = torch.nn.functional.conv2d(torch.tensor(x).permute(0, 3, 1, 2), port.weight,
                                           stride=2, padding=1).permute(0, 2, 3, 1)
        assert np.abs(naive.detach().numpy() - ref).max() > 1e-2
    if kernel == 1:
        assert same_padding(size, 1, 2) == (0, 0)


def test_converter_round_trip_bitwise(rng):
    _, variables, tm = _pair(rng)
    back = convert.to_flax(tm.state_dict())
    assert sorted(back) == ["batch_stats", "params"]
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, dict(variables)))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(dict(variables))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    again = convert.from_flax(back)
    assert all(torch.equal(again[k], v) for k, v in tm.state_dict().items())


def test_resnet56_shapes_match_jax():
    """The registry's ResNet-56 has the JAX ResNet-56's variables, name for
    name and shape for shape; ResNet-110 and ResNet-18 with GroupNorm too,
    and the fedseg UNet, whose ConvBlocks take the ResNet's Conv and
    GroupNorm."""
    for name, jax_model in (("resnet56", jax_resnet56()), ("resnet110", JaxResNet(depth=110))):
        shapes = jax.eval_shape(jax_model.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
        model = create_model(name, 10, dtype="bfloat16", device="cpu")
        assert {k: tuple(v.shape) for k, v in convert.from_flax(zeros).items()} == {
            k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert all(p.dtype == torch.float32 for p in model.parameters())
    shapes = jax.eval_shape(jax_create_model("unet", 10).init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    assert {k: tuple(v.shape) for k, v in convert.from_flax(zeros).items()} == {
        k: tuple(v.shape) for k, v in create_model("unet", 10, device="cpu").state_dict().items()}
    # the GroupNorm ResNet-18 builds with the JAX resnet18_gn's shapes
    shapes = jax.eval_shape(jax_resnet18_gn().init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    model = create_model("resnet18_gn", 100, dtype="bfloat16", device="cpu")
    assert {k: tuple(v.shape) for k, v in convert.from_flax(zeros).items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("train", [False, True])
def test_bf16_forward_tracks_jax_bf16(rng, train):
    jm32, variables, tm32 = _pair(rng)
    jm16 = JaxResNet(depth=8, num_classes=10, dtype=jnp.bfloat16)
    tm16 = CifarResNet(depth=8, num_classes=10, dtype=torch.bfloat16, device="cpu")
    tm16.load_state_dict(convert.from_flax(variables))
    x = _images(rng)

    def jax_logits(m):
        if train:
            return np.asarray(jax.jit(lambda v, x: m.apply(v, x, train=True,
                                                           mutable=["batch_stats"])[0])(
                variables, jnp.asarray(x)))
        return np.asarray(jax.jit(m.apply)(variables, jnp.asarray(x)))

    def port_logits(m):
        out = m(torch.tensor(x), train=train)
        return (out[0] if train else out).detach().numpy()

    f32 = jax_logits(jm32)
    j16, t16 = jax_logits(jm16), port_logits(tm16)
    assert j16.dtype == t16.dtype == np.float32  # the head runs in f32
    d_jax = np.abs(j16 - f32).max()
    d_port = np.abs(t16 - f32).max()
    assert d_jax > 0  # bf16 really rounded
    assert d_port <= 2 * d_jax, (d_port, d_jax)
    assert np.abs(t16 - j16).max() <= 3 * d_jax
    np.testing.assert_allclose(port_logits(tm32), f32, atol=ATOL)
