"""The DARTS search space (``fedml_tpu_torch/models/darts.py``) and its
converter arm against the JAX package, on the same numpy-made inputs and
the JAX modules' variables, converted.

Tolerances, fixed before the first run:
- each primitive at stride 1 and 2 (even and odd sizes) against the JAX
  ``_Op``: atol 1e-5 on the output, in training (with the new BN
  statistics) and in evaluation (running statistics);
- the network forward, eval and train with its new ``batch_stats``, darts
  and gdas (gdas training fed fixed noise): atol 1e-5;
- ``convert.to_flax(convert.from_flax(v))``: bitwise, at the small width on
  real variables and at the DARTS search width (16 channels, 8 cells, 4
  steps) on the JAX tree's shapes filled with random numbers;
- ``num_edges``, ``steps_from_edges`` and ``decode_genotype`` on random
  alphas for steps 2, 3 and 4: equal, genotypes as lists;
- ``gumbel_hard_weights`` given ``jax.random.gumbel``'s noise: value and
  straight-through gradient, atol 1e-6."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import darts as jdarts
from fedml_tpu_torch import convert
from fedml_tpu_torch.models import darts

SMALL = dict(num_classes=4, channels=4)


def _np(tree):
    return jax.tree.map(np.asarray, dict(tree))


def _perturbed(variables, seed=1):
    """The variables with non-trivial BN scale/bias, running statistics and
    alphas, so that each enters the comparison."""
    rng = np.random.RandomState(seed)
    out = jax.tree.map(lambda a: a + 0.1 * rng.randn(*a.shape).astype(a.dtype), variables)
    if "batch_stats" in out:
        out["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5, out["batch_stats"])
    return out


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("hw", [8, 7])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", darts.PRIMITIVES)
def test_primitive_matches_jax(kind, stride, hw):
    rng = np.random.RandomState(0)
    c = 4
    x = rng.randn(3, hw, hw, c).astype(np.float32)
    jop = jdarts._Op(kind, c, stride)
    v = _perturbed(_np(jop.init(jax.random.key(0), jnp.asarray(x), train=False)))
    op = darts._Op(kind, c, c, stride, device="cpu")
    op.load_state_dict(convert.from_flax(v) if v else {})

    y_eval = np.asarray(jop.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = op(_nchw(x), False, {}).permute(0, 2, 3, 1).numpy()
    assert got.shape == y_eval.shape
    np.testing.assert_allclose(got, y_eval, atol=1e-5)

    if "batch_stats" in v:
        y_train, new = jop.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        stats = {}
        with torch.no_grad():
            got = op(_nchw(x), True, stats).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, np.asarray(y_train), atol=1e-5)
        mean, var = stats[op.bn_0]
        bs = _np(new["batch_stats"])["BatchNorm_0"]
        np.testing.assert_allclose(mean.numpy(), bs["mean"], atol=1e-5)
        np.testing.assert_allclose(var.numpy(), bs["var"], atol=1e-5)


def _pair(layers, steps, search_mode="darts", x_shape=(4, 8, 8, 3)):
    jnet = jdarts.DARTSNetwork(layers=layers, steps=steps, search_mode=search_mode, **SMALL)
    x = np.random.RandomState(0).rand(*x_shape).astype(np.float32)
    v = _perturbed(_np(jnet.init({"params": jax.random.key(0)}, jnp.asarray(x), train=False)))
    net = darts.DARTSNetwork(layers=layers, steps=steps, search_mode=search_mode,
                             device="cpu", **SMALL)
    net.load_state_dict(convert.from_flax(v))
    return jnet, net, v, x


@pytest.mark.parametrize("layers,steps", [(3, 2), (2, 2), (4, 3)])
@pytest.mark.parametrize("train", [False, True])
def test_network_forward_matches_jax(layers, steps, train):
    jnet, net, v, x = _pair(layers, steps)
    with torch.no_grad():
        out = net(torch.tensor(x), train=train)
    if not train:
        np.testing.assert_allclose(out.numpy(), np.asarray(jnet.apply(v, jnp.asarray(x))),
                                   atol=1e-5)
        return
    logits, new_state = out
    j_logits, j_new = jnet.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-5)
    want = convert.from_flax({"batch_stats": _np(j_new["batch_stats"])})
    assert set(new_state) == set(want) == {k for k, _ in net.named_buffers()}
    for k, t in want.items():
        np.testing.assert_allclose(new_state[k].numpy(), t.numpy(), atol=1e-5, err_msg=k)


def test_gdas_forward_matches_jax(monkeypatch):
    """gdas: the argmax one-hot in evaluation; in training the straight-through
    hard sample, with the JAX module's noise fixed to what the port is fed
    (normal first, then reduce, as the JAX forward draws them)."""
    jnet, net, v, x = _pair(3, 2, "gdas")
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.tensor(x)).numpy(),
                                   np.asarray(jnet.apply(v, jnp.asarray(x))), atol=1e-5)
    noise = net.gumbel_noise(torch.Generator().manual_seed(3))
    drawn = iter([jnp.asarray(noise[0].numpy()), jnp.asarray(noise[1].numpy())])

    def fixed_noise(alphas, rng, tau):
        soft = jax.nn.softmax((alphas + next(drawn)) / tau, axis=-1)
        hard = jax.nn.one_hot(jnp.argmax(soft, axis=-1), alphas.shape[-1])
        return hard + soft - jax.lax.stop_gradient(soft)

    monkeypatch.setattr(jdarts, "gumbel_hard_weights", fixed_noise)
    j_logits, j_new = jnet.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"],
                                 rngs={"gumbel": jax.random.key(0)})
    with torch.no_grad():
        logits, new_state = net(torch.tensor(x), train=True, noise=noise)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-5)
    want = convert.from_flax({"batch_stats": _np(j_new["batch_stats"])})
    assert max(float((new_state[k] - t).abs().max()) for k, t in want.items()) <= 1e-5
    with pytest.raises(ValueError, match="noise"):
        net(torch.tensor(x), train=True)


def test_converter_round_trip_small():
    _, net, v, _ = _pair(3, 2)
    sd = convert.from_flax(v)
    assert set(sd) == set(net.state_dict())
    back = convert.to_flax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_converter_round_trip_search_width():
    """The DARTS search width (16 channels, 8 cells, 4 steps): the JAX tree's
    shapes (no init run), filled with random numbers, round-trip bitwise, and
    name and shape every variable of the port's network."""
    jnet = jdarts.DARTSNetwork(num_classes=10, channels=16, layers=8, steps=4)
    shapes = jax.eval_shape(lambda: jnet.init({"params": jax.random.key(0)},
                                              jnp.zeros((2, 32, 32, 3)), train=False))
    rng = np.random.RandomState(0)
    v = jax.tree.map(lambda s: rng.randn(*s.shape).astype(s.dtype), dict(shapes))
    assert set(v["params"]) == {"Conv_0", "BatchNorm_0", "Dense_0"} | {
        f"Cell_{k}" for k in range(8)}
    sd = convert.from_flax(v)
    back = convert.to_flax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)))
    net = darts.DARTSNetwork(num_classes=10, channels=16, layers=8, steps=4, device="cpu")
    port = net.state_dict()
    assert {k: tuple(t.shape) for k, t in sd.items()} == {
        k: tuple(t.shape) for k, t in port.items()}
    n_params = sum(t.numel() for k, t in net.named_parameters() if k not in darts.ARCH)
    assert n_params == sum(a.size for a in jax.tree.leaves(v["params"]))


@pytest.mark.parametrize("steps", [2, 3, 4])
def test_genotype_decode_matches_jax(steps):
    E = darts.num_edges(steps)
    assert E == jdarts.num_edges(steps)
    assert darts.steps_from_edges(E) == jdarts.steps_from_edges(E) == steps
    with pytest.raises(ValueError):
        darts.steps_from_edges(E + 1)
    rng = np.random.RandomState(steps)
    for _ in range(5):
        a_n = rng.randn(E, len(darts.PRIMITIVES))
        a_r = rng.randn(E, len(darts.PRIMITIVES)).astype(np.float32)
        got, want = darts.decode_genotype(a_n, a_r), jdarts.decode_genotype(a_n, a_r)
        assert (got.normal, got.reduce) == (want.normal, want.reduce)
        assert len(got.normal) == len(got.reduce) == 2 * steps
        assert darts.decode_genotype(a_n, a_r, steps=steps) == got


def test_gumbel_hard_weights_matches_jax():
    rng = np.random.RandomState(0)
    alphas = rng.randn(9, 6).astype(np.float32)
    c = rng.randn(9, 6).astype(np.float32)
    key = jax.random.key(7)
    noise = np.asarray(jax.random.gumbel(key, alphas.shape))
    for tau in (5.0, 0.5):
        def f(a):
            return jnp.sum(jdarts.gumbel_hard_weights(a, key, tau) * c)

        want = np.asarray(jdarts.gumbel_hard_weights(jnp.asarray(alphas), key, tau))
        want_grad = np.asarray(jax.grad(f)(jnp.asarray(alphas)))
        a = torch.tensor(alphas, requires_grad=True)
        got = darts.gumbel_hard_weights(a, torch.tensor(noise), tau)
        torch.sum(got * torch.tensor(c)).backward()
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
        np.testing.assert_allclose(a.grad.numpy(), want_grad, atol=1e-6)
        np.testing.assert_array_equal(np.argmax(got.detach().numpy(), -1),
                                      np.argmax(want, -1))


def test_gumbel_noise_is_seeded_and_darts_draws_none():
    net = darts.DARTSNetwork(layers=3, steps=2, search_mode="gdas", device="cpu", **SMALL)
    a = net.gumbel_noise(torch.Generator().manual_seed(1))
    b = net.gumbel_noise(torch.Generator().manual_seed(1))
    assert a.shape == (2, darts.num_edges(2), 6) and torch.equal(a, b)
    assert torch.isfinite(a).all()
    plain = darts.DARTSNetwork(layers=3, steps=2, device="cpu", **SMALL)
    assert plain.gumbel_noise(torch.Generator().manual_seed(1)) is None


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="cuda"):
        darts.DARTSNetwork()
