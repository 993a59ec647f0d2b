"""FedNAS (``fedml_tpu_torch/algorithms/fednas.py``,
``fedml_tpu_torch/exp/main_fednas.py``) against the JAX package, from the
JAX variables converted and the same numpy-made batches. The network is
the small width: 4 channels, 3 cells (two of them reductions), 2 steps,
8x8 images, B=4, S=2, with one padding row (mask 0, zero image), which
counts in the BN statistics and not in the loss.

Each JAX reference is computed once, in a module-scoped fixture (one
``jax.jit`` each: the first-order step, the unrolled α gradient, the gdas
step). ``local_search`` and the CLI are ``tests/test_torch_fednas_cli.py``'s
(the file was split in two for the tier-1 suite's time: one xdist worker
each).

Tolerances, fixed before the first run:
- one first-order ``search_step``: atol 1e-4 on weights, α, BN statistics
  and losses;
- ``arch_grads_unrolled`` (second order, exact Hessian-vector term) against
  the JAX package's, f32, from a non-zero momentum trace: atol 1e-4;
- the port's unrolled α gradient against the float64 finite-difference
  oracle of the reference architect (DARTS eq. 8), torch alone: relative
  1e-4 per leaf (step R = 1e-6 / |v|, see the test);
- a gdas ``search_step`` with the JAX module's Gumbel noise fixed to what
  the port draws: atol 1e-4;
- the aggregator: atol 1e-6."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms import fednas as jfednas
from fedml_tpu.core.tree import tree_stack
from fedml_tpu.models import darts as jdarts
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fednas
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.trainer import adam, sgd
from fedml_tpu_torch.models import darts

NET = dict(num_classes=4, channels=4, layers=3, steps=2)
LR, ARCH_LR, MOMENTUM = 0.05, 3e-3, 0.9


def _np(tree):
    return jax.tree.map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def batches():
    rng = np.random.RandomState(0)
    S, B = 2, 4
    b = {"x": rng.rand(S, B, 8, 8, 3).astype(np.float32),
         "y": rng.randint(0, 4, (S, B)).astype(np.int32),
         "mask": np.ones((S, B), np.float32)}
    b["x"][1, 3] = 0.0
    b["mask"][1, 3] = 0.0
    return b


def _step(b, s):
    return {k: v[s] for k, v in b.items()}


def _jax_trainer(search_mode="darts", unrolled=False, epochs=1, momentum=0.0):
    net = jdarts.DARTSNetwork(search_mode=search_mode, **NET)
    return jfednas.FedNASTrainer(net, optax.sgd(LR, momentum=momentum or None),
                                 optax.adam(ARCH_LR), epochs=epochs, unrolled=unrolled,
                                 unrolled_eta=LR)


def _port_trainer(search_mode="darts", unrolled=False, epochs=1, momentum=0.0,
                  dtype=torch.float32):
    net = darts.DARTSNetwork(search_mode=search_mode, dtype=dtype, device="cpu", **NET)
    return fednas.FedNASTrainer(net, sgd(LR, momentum=momentum), adam(ARCH_LR),
                                epochs=epochs, unrolled=unrolled, unrolled_eta=LR)


@pytest.fixture(scope="module")
def init(batches):
    """The JAX network's initial variables (numpy), with the BN statistics
    moved off their initial values so that the momentum update shows."""
    v = _np(_jax_trainer().init(jax.random.key(0), jnp.asarray(batches["x"][0])))
    rng = np.random.RandomState(2)
    v["batch_stats"] = jax.tree.map(lambda a: np.abs(a + 0.1 * rng.randn(*a.shape))
                                    .astype(np.float32), v["batch_stats"])
    return v


def _torch_batch(b):
    return {k: torch.tensor(v) for k, v in b.items()}


def _max_err(port: dict, jax_vars: dict) -> float:
    want = convert.from_flax(_np(jax_vars))
    assert set(port) == set(want)
    return max(float((port[k] - want[k]).abs().max()) for k in want)


def _jax_step(tr, init, batches, rng=1):
    opt = (tr.w_opt.init(init["params"]), tr.arch_opt.init(init["arch"]))
    out, _, m = jax.jit(tr.search_step)(init, opt, _step(batches, 0), _step(batches, 1),
                                        jax.random.key(rng))
    return _np(out), {k: float(v) for k, v in m.items()}


def _port_step(tr, init, batches, generator=None):
    sd = convert.from_flax(init)
    params, arch, _ = tr.split(sd)
    out, _, m = tr.search_step(sd, (tr.w_opt.init(params), tr.arch_opt.init(arch)),
                               _torch_batch(_step(batches, 0)),
                               _torch_batch(_step(batches, 1)), generator)
    return out, {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def first_order_ref(init, batches):
    return _jax_step(_jax_trainer(), init, batches)


def test_search_step_matches_jax(first_order_ref, init, batches):
    want, want_m = first_order_ref
    got, got_m = _port_step(_port_trainer(), init, batches)
    assert _max_err(got, want) <= 1e-4
    for k in ("train_loss", "val_loss"):
        assert abs(got_m[k] - want_m[k]) <= 1e-4
    # α moved (the α step), and the BN statistics are the weight step's
    sd = convert.from_flax(init)
    assert float((got["alphas_normal"] - sd["alphas_normal"]).abs().max()) > 1e-3
    assert float((got["alphas_reduce"] - sd["alphas_reduce"]).abs().max()) > 1e-3


def _momentum_trace(params, seed=3):
    rng = np.random.RandomState(seed)
    return {k: 0.1 * rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}


@pytest.fixture(scope="module")
def unrolled_ref(init, batches):
    """The JAX second-order α gradient from a non-zero momentum trace."""
    tr = _jax_trainer(unrolled=True, momentum=MOMENTUM)
    trace = convert.to_flax({k: torch.tensor(v) for k, v in _momentum_trace(
        convert.from_flax({"params": init["params"]})).items()})["params"]
    w_state = tr.w_opt.init(init["params"])
    w_state = (w_state[0]._replace(trace=trace),) + tuple(w_state[1:])
    state = {"batch_stats": init["batch_stats"]}
    val_loss, grads = jax.jit(tr.arch_grads_unrolled)(
        init["params"], init["arch"], state, w_state, _step(batches, 0), _step(batches, 1),
        jax.random.key(1), jax.random.key(2))
    return float(val_loss), _np(grads)


def test_arch_grads_unrolled_matches_jax(unrolled_ref, init, batches):
    want_loss, want = unrolled_ref
    tr = _port_trainer(unrolled=True, momentum=MOMENTUM)
    params, arch, state = tr.split(convert.from_flax(init))
    trace = {k: torch.tensor(v) for k, v in _momentum_trace(params).items()}
    val_loss, grads = tr.arch_grads_unrolled(params, arch, state, trace,
                                             _torch_batch(_step(batches, 0)),
                                             _torch_batch(_step(batches, 1)))
    assert abs(float(val_loss) - want_loss) <= 1e-4
    for k in darts.ARCH:
        np.testing.assert_allclose(grads[k].numpy(), want[k], atol=1e-4)
    # the implicit term is there: first order gives another gradient
    first = torch.func.grad(lambda a: tr._loss(params, a, state, _torch_batch(
        _step(batches, 1)), None)[0])(arch)
    assert max(float((first[k] - grads[k]).abs().max()) for k in darts.ARCH) > 1e-6


def test_arch_grads_unrolled_matches_finite_difference_oracle(init, batches):
    """The exact term against the reference architect's ±R finite difference
    of the Hessian-vector product (DARTS eq. 8), all in float64. R = 1e-6 /
    |v|: at these variables and this momentum trace a step of 1e-4 / |v|
    crosses a ReLU or max-pool kink (the difference is then 0.65 off, in
    relative terms), where 1e-6 / |v| agrees with the exact term to ~4e-11."""
    tr = _port_trainer(unrolled=True, momentum=MOMENTUM, dtype=torch.float64)
    sd = {k: v.double() for k, v in convert.from_flax(init).items()}
    params, arch, state = tr.split(sd)
    tb = {k: v.double() if v.is_floating_point() else v
          for k, v in _torch_batch(_step(batches, 0)).items()}
    vb = {k: v.double() if v.is_floating_point() else v
          for k, v in _torch_batch(_step(batches, 1)).items()}
    trace = {k: torch.tensor(v).double() for k, v in _momentum_trace(params).items()}
    _, exact = tr.arch_grads_unrolled(params, arch, state, trace, tb, vb)

    def loss_t(p, a):
        return tr._loss(p, a, state, tb, None)[0]

    def loss_v(p, a):
        return tr._loss(p, a, state, vb, None)[0]

    g_w = torch.func.grad(loss_t)(params, arch)
    w_unrolled, _ = tr.w_opt.update(g_w, trace, params)
    dalpha, vector = torch.func.grad(lambda a, p: loss_v(p, a), argnums=(0, 1))(
        arch, w_unrolled)
    vnorm = torch.sqrt(sum(torch.sum(v * v) for v in vector.values()))
    R = 1e-6 / vnorm
    g_plus = torch.func.grad(loss_t, argnums=1)(
        {k: p + R * vector[k] for k, p in params.items()}, arch)
    g_minus = torch.func.grad(loss_t, argnums=1)(
        {k: p - R * vector[k] for k, p in params.items()}, arch)
    oracle = {k: dalpha[k] - LR * (g_plus[k] - g_minus[k]) / (2 * R) for k in dalpha}
    for k in darts.ARCH:
        e, a = exact[k].numpy(), oracle[k].numpy()
        assert e.dtype == np.float64
        assert np.linalg.norm(a) > 1e-8
        assert np.linalg.norm(e - a) / np.linalg.norm(a) < 1e-4, k


@pytest.fixture(scope="module")
def gdas_noise():
    """The noise the port's step draws from a generator seeded 11: the α
    step's, then the weight step's, each [normal, reduce]."""
    net = darts.DARTSNetwork(search_mode="gdas", device="cpu", **NET)
    g = torch.Generator().manual_seed(11)
    return net.gumbel_noise(g).numpy(), net.gumbel_noise(g).numpy()


@pytest.fixture(scope="module")
def gdas_ref(init, batches, gdas_noise):
    drawn = iter([a[i] for a in gdas_noise for i in (0, 1)])

    def fixed_noise(alphas, rng, tau):  # gumbel_hard_weights with the port's noise
        soft = jax.nn.softmax((alphas + jnp.asarray(next(drawn))) / tau, axis=-1)
        hard = jax.nn.one_hot(jnp.argmax(soft, axis=-1), alphas.shape[-1])
        return hard + soft - jax.lax.stop_gradient(soft)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdarts, "gumbel_hard_weights", fixed_noise)
        out = _jax_step(_jax_trainer("gdas"), init, batches)
    assert next(drawn, None) is None  # four draws, each traced once
    return out


def test_gdas_search_step_matches_jax(gdas_ref, init, batches):
    want, want_m = gdas_ref
    got, got_m = _port_step(_port_trainer("gdas"), init, batches,
                            torch.Generator().manual_seed(11))
    assert _max_err(got, want) <= 1e-4
    for k in ("train_loss", "val_loss"):
        assert abs(got_m[k] - want_m[k]) <= 1e-4
    with pytest.raises(ValueError, match="Generator"):
        _port_step(_port_trainer("gdas"), init, batches)


def test_aggregator_matches_jax(init):
    rng = np.random.RandomState(4)
    clients = [jax.tree.map(lambda a: (a + rng.randn(*a.shape)).astype(a.dtype), init)
               for _ in range(3)]
    weights = np.asarray([3.0, 1.0, 12.0], np.float32)
    want, _, _ = jfednas.fednas_aggregator().aggregate(
        init, tree_stack(clients), jnp.asarray(weights), (), jax.random.key(0))
    agg = fednas.fednas_aggregator()
    stacked = treelib.stack([convert.from_flax(c) for c in clients])
    got, state, metrics = agg.aggregate(convert.from_flax(init), stacked,
                                        torch.tensor(weights), agg.init_state(None))
    assert _max_err(got, want) <= 1e-6
    assert state == () and metrics == {}
    genotype = fednas.global_genotype(got)
    want_genotype = jdarts.decode_genotype(np.asarray(want["arch"]["alphas_normal"]),
                                           np.asarray(want["arch"]["alphas_reduce"]))
    assert (genotype.normal, genotype.reduce) == (want_genotype.normal, want_genotype.reduce)
