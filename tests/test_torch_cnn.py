"""The port's LogisticRegression and FedAvg-paper CNNs (fedml_tpu_torch.models)
against the JAX package's on the same numpy-made inputs, after converting
the JAX-initialised weights, and the port's dropout masks.

Tolerances:
- forwards, f32: atol 1e-5 on the logits (the same products and sums in f32,
  convolutions and Dense rows summed in other orders);
- local training of a CNN client over eight masked steps (a partly filled
  and an empty batch among them) against the same steps in JAX, one jitted
  step at a time: atol 1e-5 on parameters and the loss;
- flatten order: on the same converted (random, asymmetric) weights, an NCHW
  flatten in place of the NHWC one must disagree with JAX by more than 1e-2,
  which shows the port permutes to NHWC before the first Dense;
- dropout masks: the keep share of 160,000 draws within 0.01 of 1 - rate
  (binomial standard deviation ~0.0011); kept elements scaled by exactly
  1 / (1 - rate), dropped ones exactly 0; the same seed, round and step give
  bitwise-equal masks.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import cnn as jax_cnn
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch import convert
from fedml_tpu_torch.core.trainer import DropoutStream, draw_dropout_masks
from fedml_tpu_torch.models import cnn as port_cnn
from fedml_tpu_torch.models.registry import create_model, task_for_dataset

ATOL = 1e-5

MODELS = {
    "lr": (lambda: JaxLR(num_classes=10), 10),
    "cnn_original": (lambda: jax_cnn.CNNOriginalFedAvg(num_classes=62), 62),
    "cnn": (lambda: jax_cnn.CNNDropOut(num_classes=62), 62),
    "lenet": (lambda: jax_cnn.LeNet(num_classes=10), 10),
}


def _pair(name, rng, channel_axis=False, **kwargs):
    jax_factory, classes = MODELS[name]
    jmodel = jax_factory()
    x = rng.rand(3, 28, 28, 1).astype(np.float32) if channel_axis else \
        rng.rand(3, 28, 28).astype(np.float32)
    variables = jmodel.init(jax.random.key(int(rng.randint(1 << 30))), jnp.asarray(x))
    tmodel = create_model(name, classes, "femnist", device="cpu", **kwargs)
    tmodel.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, dict(variables))))
    return jmodel, variables, tmodel, x


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("channel_axis", [False, True])
def test_forward_matches_jax(rng, name, channel_axis):
    jmodel, variables, tmodel, x = _pair(name, rng, channel_axis)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    got = tmodel(torch.tensor(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the state dict round-trips to the JAX layout
    back = convert.to_flax(tmodel.state_dict())
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(variables))[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


@pytest.mark.parametrize("name", ["cnn_original", "cnn", "lenet"])
def test_flatten_is_nhwc(rng, name, monkeypatch):
    jmodel, variables, tmodel, x = _pair(name, rng)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    monkeypatch.setattr(port_cnn, "_flatten_nhwc", lambda h: h.reshape(h.shape[0], -1))
    nchw = tmodel(torch.tensor(x)).detach().numpy()
    assert np.abs(nchw - want).max() > 1e-2


def test_cnn_dropout_train_at_rate_zero_and_eval_match_jax(rng, monkeypatch):
    """Eval mode at flax's rates; training with the rate forced to 0 on both
    sides (JAX's threefry masks cannot be reproduced)."""
    jmodel, variables, tmodel, x = _pair("cnn", rng)
    np.testing.assert_allclose(
        tmodel(torch.tensor(x), train=False).detach().numpy(),
        np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False)), atol=ATOL)
    zero = create_model("cnn", 62, "femnist", device="cpu", dropout_rates=(0.0, 0.0))
    zero.load_state_dict(tmodel.state_dict())
    assert zero.dropout_sites == {}
    flax_dropout = fnn.Dropout
    monkeypatch.setattr(jax_cnn.nn, "Dropout",
                        lambda rate, deterministic: flax_dropout(0.0, deterministic=deterministic))
    want = jmodel.apply(variables, jnp.asarray(x), train=True,
                        rngs={"dropout": jax.random.key(0)})
    np.testing.assert_allclose(zero(torch.tensor(x), train=True, dropout={}).detach().numpy(),
                               np.asarray(want), atol=ATOL)


def test_dropout_masks_rate_scale_and_determinism(rng):
    model = create_model("cnn", 62, "femnist", device="cpu")
    assert model.dropout_sites == {"dropout_0": ((64, 12, 12), 0.25),
                                   "dropout_1": ((128,), 0.5)}
    sites = {"a": ((40_000,), 0.25), "b": ((40_000,), 0.5)}
    masks = draw_dropout_masks(sites, torch.Generator().manual_seed(3), (4,))
    assert masks["a"].shape == (4, 40_000) and masks["a"].dtype == torch.bool
    for name, (_, rate) in sites.items():
        assert abs(masks[name].float().mean().item() - (1 - rate)) < 0.01
    # kept elements scaled by 1 / (1 - rate), dropped ones 0
    x = torch.tensor(rng.rand(2, 128).astype(np.float32)) + 1.0
    keep = draw_dropout_masks({"dropout_1": ((128,), 0.5)}, torch.Generator().manual_seed(5),
                              (2,))["dropout_1"]
    out = model._dropout("dropout_1", x, True, {"dropout_1": keep})
    assert torch.equal(out[keep], x[keep] / 0.5) and bool((out[~keep] == 0).all())
    assert torch.equal(model._dropout("dropout_1", x, False, None), x)
    with pytest.raises(ValueError, match="keep mask"):
        model(torch.zeros(2, 28, 28), train=True)
    # same (seed, round, step): the same masks; another step, other masks
    a = DropoutStream(model.dropout_sites, 7, 3, 4, 5, torch.device("cpu"))
    b = DropoutStream(model.dropout_sites, 7, 3, 4, 5, torch.device("cpu"))
    m_a, m_b = a.masks(2), b.masks(2)
    assert m_a["dropout_0"].shape == (4, 5, 64, 12, 12)
    assert all(torch.equal(m_a[k], m_b[k]) for k in m_a)
    assert not torch.equal(a.masks(3)["dropout_1"], m_a["dropout_1"])


def test_cnn_local_training_matches_jax_steps(rng):
    """The port's client-by-client training (``make_local_train``) against
    JAX's ``ClientTrainer.train_step`` jitted per step, on one client's
    epoch of eight batches of 10: six full, one with a single example, one
    empty (a no-op)."""
    import optax

    from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
    from fedml_tpu_torch.core.trainer import ClientTrainer, make_local_train, sgd

    jmodel, variables, tmodel, _ = _pair("cnn_original", rng)
    x = rng.rand(8, 10, 28, 28).astype(np.float32)
    y = rng.randint(0, 62, (8, 10)).astype(np.int32)
    mask = np.ones((8, 10), np.float32)
    mask[6, 1:] = 0.0
    mask[7] = 0.0
    x[mask == 0] = 0.0
    jtrainer = JaxTrainer(module=jmodel, optimizer=optax.sgd(0.05))
    step = jax.jit(jtrainer.train_step)
    jv, opt_state = dict(variables), jtrainer.optimizer.init(variables["params"])
    losses = []
    for s in range(8):
        batch = {"x": jnp.asarray(x[s]), "y": jnp.asarray(y[s]), "mask": jnp.asarray(mask[s])}
        jv, opt_state, loss = step(jv, opt_state, variables["params"], batch,
                                   jax.random.key(s))
        losses.append(float(loss))
    local_train = make_local_train(ClientTrainer(module=tmodel, optimizer=sgd(0.05)))
    tv, metrics = local_train(convert.from_flax(jax.tree.map(np.asarray, dict(variables))),
                              {"x": torch.tensor(x), "y": torch.tensor(y),
                               "mask": torch.tensor(mask)})
    back = convert.to_flax(tv)
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(jv))[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=ATOL, err_msg=str(path))
    np.testing.assert_allclose(float(metrics["train_loss"]), np.mean(losses[:7]), atol=ATOL)


def test_registry_names_and_tasks():
    assert create_model("lr", 10, "mnist", device="cpu").dense_0.weight.shape == (10, 784)
    assert create_model("lr", 10, "synthetic", device="cpu",
                        input_shape=(60,)).dense_0.weight.shape == (10, 60)
    with pytest.raises(ValueError, match="does not take a compute dtype"):
        create_model("lr", 10, "mnist", dtype="bfloat16", device="cpu")
    m = create_model("cnn_original", 62, "femnist", dtype="bfloat16", device="cpu")
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert m(torch.zeros(2, 28, 28)).dtype == torch.float32
    # the fedseg models build (channels from the input shape) and, as in the
    # JAX registry, take no compute dtype
    assert create_model("unet", 10, "mnist", device="cpu",
                        input_shape=(28, 28, 1))(torch.zeros(2, 28, 28, 1)).shape == (2, 28, 28,
                                                                                      10)
    with pytest.raises(ValueError, match="does not take a compute dtype"):
        create_model("unet", 10, dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        create_model("alexnet", 10, device="cpu")
    # the CIFAR zoo's names build with the JAX package's parameter shapes
    for name in ("mobilenet", "vgg16"):
        shapes = jax.eval_shape(jax_create_model(name, 10, "cifar10").init,
                                jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
        assert {k: tuple(v.shape) for k, v in convert.from_flax(zeros).items()} == {
            k: tuple(v.shape)
            for k, v in create_model(name, 10, "cifar10", device="cpu").state_dict().items()}
    assert task_for_dataset("stackoverflow_nwp") == "nwp"
    assert task_for_dataset("shakespeare") == "char_lm"
    assert task_for_dataset("femnist") == "classification"
