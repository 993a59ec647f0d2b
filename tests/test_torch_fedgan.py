"""The port's federated GAN (``models/gan.py``, ``algorithms/fedgan.py``, the
engine's ``local_train_fn`` hook and ``--algorithm fedgan``) against the JAX
package's, from the same variables converted by ``convert.py``.

JAX draws the latent ``z`` from PRNG keys threaded through its scan, which
the port cannot reproduce; the port draws it from the round's seeded stream.
So both sides are given the same ``z``: the JAX side through a test-only
``GANTrainer`` subclass whose ``jax.random.normal`` returns ``batch["z"]``
(staged as a data array), the port's through a subclass whose step reads
``batch["z"]`` in place of the stream's draw.

Tolerances:

- the generator and discriminator forwards, eval and train mode (the
  BatchNorm statistics too): atol 1e-5 (f32 products summed in other
  orders);
- one ``train_step`` with the same ``z``, both packages in float64: both
  losses, both networks, the BatchNorm state and both Adam states atol
  1e-5. Float64, because Adam moves a weight by about ``lr * g / (|g| +
  1e-8)``: where a gradient is a cancellation near 1e-8 (the first Dense's
  bias, whose output the next BatchNorm centres), f32 rounding of it moves
  the step by a share of ``lr`` (in f32, at the recipe's lr 2e-4, 8 of the
  128 biases parted by up to 1.1e-4);
- the discriminator step's BatchNorm update is dropped: the generator's
  statistics after a step are bitwise those of a generator-only forward
  from the step's start;
- an empty batch and a step past the budget are bitwise no-ops, Adam's
  step counts included;
- FedSim, 8 of 8 clients (the JAX engine's 8-device CPU mesh pads
  nothing), 2 rounds of 2 epochs, vmap and scan, against the JAX engine
  with the same ``z``, both in float64: the pair and ``Train/Loss`` atol
  1e-5 each round, each round from the JAX engine's previous aggregate.
  Both engines average in f32, in other summation orders, so their
  aggregates part by an ulp or two (2.4e-7 on a BatchNorm scale near 1),
  which a round of Adam's normalised steps on the GAN's near-zero gradients
  grows to 1.4e-5 (round 1 run on from each engine's own round 0). Blocks
  (run eagerly on the CPU; their CUDA graph runs only on the card), f32:
  the 2-round block bitwise the per-round run;
- the stream's ``z``, in float64, a round of 2 epochs: two vmap runs from
  one seed bitwise equal, and the scan mode within 1e-9 of them (the same
  draws; vmap batches the products);
- ``--algorithm fedgan`` through the CLI: finite losses, no eval keys.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms import fedgan as jfedgan
from fedml_tpu.core import rng as jrng
from fedml_tpu.models import gan as jgan
from fedml_tpu.sim import cohort as jcohort
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fedgan
from fedml_tpu_torch.core.trainer import Adam
from fedml_tpu_torch.exp import main_fedavg as port_cli
from fedml_tpu_torch.models.gan import Discriminator, Generator
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import FedSim, SimConfig

ATOL = 1e-5
LATENT, IMG, LR = 8, (4, 4, 1), 2e-4


# a padding row's z: the engines zero-fill padding, but a drawn z is never
# 0, and a zero row meets the leaky ReLU's kink exactly while the biases are
# 0, where the two packages' last-bit differences pick different slopes
PAD_Z = np.random.RandomState(9).randn(LATENT).astype(np.float32)


def _staged_z(batch, xp):
    return batch["z"] + (1.0 - batch["mask"])[:, None] * xp.asarray(PAD_Z)


class JaxZGAN(jfedgan.GANTrainer):
    """The JAX trainer with ``z`` read from ``batch["z"]``."""

    def train_step(self, variables, opt_states, batch, rng):
        z = _staged_z(batch, jnp)
        with mock.patch.object(jax.random, "normal", lambda key, shape: z):
            return super().train_step(variables, opt_states, batch, rng)


class PortZGAN(fedgan.GANTrainer):
    """The port's trainer with ``z`` read from ``batch["z"]``."""

    def train_step(self, variables, opt_states, batch, z):
        return super().train_step(variables, opt_states, batch,
                                  _staged_z(batch, torch).to(batch["z"].dtype))


def _jax_gan(epochs=1):
    return JaxZGAN(jgan.Generator(latent_dim=LATENT, img_shape=IMG),
                   jgan.Discriminator(img_shape=IMG), optax.adam(LR, b1=0.5),
                   optax.adam(LR, b1=0.5), latent_dim=LATENT, epochs=epochs)


def _port_gan(cls=PortZGAN, epochs=1, dtype=torch.float64):
    return cls(Generator(LATENT, IMG, dtype, device="cpu"), Discriminator(IMG, dtype, device="cpu"),
               Adam(LR, b1=0.5), Adam(LR, b1=0.5), latent_dim=LATENT, epochs=epochs)


def _f32_values(a):
    return a.astype(np.float32).astype(np.float64)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def pair():
    """JAX-initialised pair variables (numpy) and a batch with its z."""
    rng = np.random.RandomState(0)
    # f32 values held in f64: the JAX networks cast their input to f32
    batch = {"x": _f32_values(rng.uniform(-1, 1, (6,) + IMG)),
             "mask": np.array([1, 1, 1, 1, 0, 0], np.float32),
             "z": _f32_values(rng.randn(6, LATENT))}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.tree.map(np.asarray, _jax_gan().init(jax.random.key(0), jb))
    # non-trivial BatchNorm statistics
    for name, stats in variables["generator"]["batch_stats"].items():
        stats["mean"] = rng.randn(*stats["mean"].shape).astype(np.float32) * 0.1
        stats["var"] = rng.uniform(0.5, 1.5, stats["var"].shape).astype(np.float32)
    return _f64(variables), batch


def _close_pair(want, got: dict, atol=ATOL, msg=""):
    back = convert.to_flax(got)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=atol, err_msg=f"{msg} {path}")


def _port_vars(variables):
    return convert.from_flax(variables)


def test_forwards_match_jax(pair):
    variables, batch = pair
    sd = _port_vars(variables)
    assert set(convert.to_flax(sd)) == {"generator", "discriminator"}
    f64 = torch.float64
    gen, disc = Generator(LATENT, IMG, f64, device="cpu"), Discriminator(IMG, f64, device="cpu")
    gen, disc = gen.double(), disc.double()
    gen.load_state_dict({k[10:]: v for k, v in sd.items() if k.startswith("generator.")})
    disc.load_state_dict({k[14:]: v for k, v in sd.items() if k.startswith("discriminator.")})
    jg, jd = jgan.Generator(latent_dim=LATENT, img_shape=IMG), jgan.Discriminator(img_shape=IMG)
    z = torch.tensor(batch["z"])
    with jax.enable_x64(True):
        want_eval = jg.apply(variables["generator"], batch["z"])
        want, want_state = jg.apply(variables["generator"], batch["z"], train=True,
                                    mutable=["batch_stats"])
        want_d = jd.apply(variables["discriminator"], batch["x"])
    assert want.dtype == jnp.float64
    np.testing.assert_allclose(gen(z).detach().numpy(), np.asarray(want_eval), atol=ATOL)
    got, got_state = gen(z, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    _close_pair({"generator": {"batch_stats": want_state["batch_stats"]}},
                {f"generator.{k}": v for k, v in got_state.items()})
    assert all(torch.equal(b, sd[f"generator.{k}"]) for k, b in gen.named_buffers())
    np.testing.assert_allclose(disc(torch.tensor(batch["x"])).detach().numpy(),
                               np.asarray(want_d), atol=ATOL)


def test_train_step_matches_jax_and_drops_the_d_step_bn_update(pair):
    variables, batch = pair
    jg = _jax_gan()
    with jax.enable_x64(True):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        opts = (jg.g_opt.init(variables["generator"]["params"]),
                jg.d_opt.init(variables["discriminator"]["params"]))
        j_vars, j_opts, j_loss = jax.jit(jg.train_step)(variables, opts, jb,
                                                        jax.random.key(1))
        j_vars, j_opts = jax.tree.map(np.asarray, (j_vars, j_opts))
    gan = _port_gan()
    t_vars = _port_vars(variables)
    t_opts = gan.init_opt_states(t_vars)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    new_vars, new_opts, losses = gan.train_step(t_vars, t_opts, tb, tb["z"])
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(losses[k]), float(j_loss[k]), atol=ATOL, err_msg=k)
    _close_pair(jax.tree.map(np.asarray, j_vars), new_vars)
    # Adam states: optax's (ScaleByAdamState(count, mu, nu), EmptyState) per network
    for (j_state, t_state), net in zip(zip(j_opts, new_opts), ("generator", "discriminator")):
        adam = j_state[0]
        assert int(t_state["count"]) == int(adam.count) == 1
        for moment in ("mu", "nu"):
            sub = {f"{net}.{k[len(moment) + 1:]}": v for k, v in t_state.items()
                   if k.startswith(moment + "/")}
            _close_pair({net: {"params": jax.tree.map(np.asarray, getattr(adam, moment))}},
                        sub, msg=moment)
    # the kept BN statistics are the generator step's: a forward from the
    # step's start on the same z, in train mode
    gen = Generator(LATENT, IMG, torch.float64, device="cpu").double()
    gen.load_state_dict({k[10:]: v for k, v in t_vars.items() if k.startswith("generator.")})
    _, once = gen(_staged_z(tb, torch).double(), train=True)
    for k, v in once.items():
        assert torch.equal(new_vars[f"generator.{k}"], v), k
    # and the trainer's module kept its own buffers (its fresh statistics)
    for k, b in gan.generator.named_buffers():
        assert torch.equal(b, torch.zeros_like(b) if k.endswith("mean") else torch.ones_like(b))


@pytest.mark.parametrize("why", ["empty batch", "past budget"])
def test_masked_step_is_a_bitwise_no_op(pair, why):
    variables, batch = pair
    gan = _port_gan()
    t_vars = _port_vars(variables)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    t_opts = gan.init_opt_states(t_vars)
    t_vars, t_opts, _ = gan.masked_step(t_vars, t_opts, tb, tb["z"], torch.tensor(True))
    if why == "empty batch":
        tb["mask"] = torch.zeros_like(tb["mask"])
    in_budget = torch.tensor(why != "past budget")
    out_vars, out_opts, _ = gan.masked_step(t_vars, t_opts, tb, tb["z"], in_budget)
    for k in t_vars:
        assert torch.equal(out_vars[k], t_vars[k]), k
    for new, old in zip(out_opts, t_opts):
        assert int(new["count"]) == 1
        for k in old:
            assert torch.equal(new[k], old[k]), k


def _gan_data(n_clients=8):
    rng = np.random.RandomState(3)
    sizes = [5, 9, 3, 12, 7, 1, 10, 6][:n_clients]
    n = sum(sizes)
    arrays = {"x": _f32_values(rng.uniform(-1, 1, (n,) + IMG)),
              "y": rng.randint(0, 4, n).astype(np.int32),
              "z": _f32_values(rng.randn(n, LATENT))}
    bounds = np.cumsum([0] + sizes)
    part = {c: np.arange(bounds[c], bounds[c + 1]) for c in range(n_clients)}
    return arrays, part


def _cfg(**kw):
    return dict(dict(client_num_in_total=8, client_num_per_round=8, batch_size=4,
                     comm_round=2, epochs=2, frequency_of_the_test=1, seed=5), **kw)


@pytest.fixture(scope="module")
def jax_rounds():
    """The JAX engine's two rounds of the GAN with z from the data."""
    arrays, part = _gan_data()
    gan = _jax_gan(epochs=2)
    with jax.enable_x64(True):
        jsim = JaxSim(gan, jcohort.FederatedArrays(arrays, part), None, JaxConfig(**_cfg()),
                      aggregator=jfedgan.fedgan_aggregator(),
                      local_train_fn=jfedgan.make_gan_local_train(gan))
        init = _f64(jsim.init_variables())
        j_vars = jax.tree.map(jnp.asarray, init)
        root = jrng.root_key(_cfg()["seed"])
        hist = []
        for r in range(2):
            j_vars, _, j_m = jsim.run_round(r, j_vars, (), root)
            hist.append((jax.tree.map(np.asarray, j_vars), float(j_m["Train/Loss"])))
    return init, hist


def _port_sim(mode, cls=PortZGAN, dtype=torch.float64, **kw):
    arrays, part = _gan_data()
    gan = _port_gan(cls, epochs=2, dtype=dtype)
    return FedSim(gan, FederatedArrays(arrays, part), None,
                  SimConfig(**_cfg(cohort_execution=mode, **kw)),
                  aggregator=fedgan.fedgan_aggregator(),
                  local_train_fn=fedgan.make_gan_local_train(gan), device="cpu")


@pytest.mark.parametrize("mode", ["vmap", "scan", "blocks"])
def test_fedsim_rounds_match_jax(jax_rounds, mode):
    init, hist = jax_rounds
    sim = _port_sim("scan" if mode == "scan" else "vmap",
                    block_dispatch=True if mode == "blocks" else None)
    assert sim.aggregator.name == "fedgan"
    if mode == "blocks":
        # a block of both rounds is the per-round run, bitwise (f32)
        sim = _port_sim("vmap", block_dispatch=True, dtype=torch.float32)
        start = {k: v.float() for k, v in _port_vars(init).items()}
        t_vars, _, m = sim.run_block(0, 2, start, ())
        step = _port_sim("vmap", dtype=torch.float32)
        r0, _, m0 = step.run_round(0, start, ())
        r1, _, m1 = step.run_round(1, r0, ())
        assert m["Train/Loss"].tolist() == [float(m0["Train/Loss"]), float(m1["Train/Loss"])]
        for k in r1:
            assert torch.equal(t_vars[k], r1[k]), k
        return
    start = init
    for r, (want, loss) in enumerate(hist):
        t_vars, _, m = sim.run_round(r, _port_vars(start), ())
        _close_pair(want, t_vars, msg=f"{mode} round {r}")
        np.testing.assert_allclose(float(m["Train/Loss"]), loss, atol=ATOL)
        start = _f64(want)
    assert sim.evaluate(t_vars) == {}


def test_stream_z_is_the_same_in_both_modes_and_repeatable():
    runs = {}
    for mode in ("vmap", "scan", "vmap"):
        sim = _port_sim(mode, cls=fedgan.GANTrainer, comm_round=1)
        final, history = sim.run()
        assert "Test/Acc" not in history[-1]
        runs.setdefault(mode, []).append((final, [h["Train/Loss"] for h in history]))
    (a, la), (b, lb) = runs["vmap"]
    (c, lc), = runs["scan"]
    assert la == lb
    for k in a:
        assert torch.equal(a[k], b[k]), k
        torch.testing.assert_close(a[k], c[k], atol=1e-9, rtol=0)
    np.testing.assert_allclose(la, lc, atol=1e-9)
    assert all(np.isfinite(la))


def test_fedgan_cli_runs(tmp_path):
    final = port_cli.main(["--algorithm", "fedgan", "--device", "cpu", "--client_num_in_total",
                           "4", "--client_num_per_round", "2", "--comm_round", "2",
                           "--batch_size", "8", "--lr", "2e-4", "--data_dir",
                           str(tmp_path / "none")])
    assert np.isfinite(final["Train/Loss"])
    assert not any(k.startswith("Test/") for k in final)
