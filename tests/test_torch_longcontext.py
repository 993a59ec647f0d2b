"""The sequence axis: ring attention (``parallel/ring_attention.py``) and the
sequence-parallel LM train step (``parallel/sequence.py``) over two gloo
ranks, against the JAX package from the same numpy inputs and variables
(``tests/test_longcontext.py``'s problems).

One launch of two ranks runs every job in a module fixture. Tolerances,
fixed before the first run:

- ring attention against JAX's ``attention_reference``, causal and full:
  atol 1e-5 on the output (``tests/test_longcontext.py:52-66``) and 1e-4 on
  the gradients of ``sum(out * dy)`` (the flash gradients' tolerance there,
  ``:39-49``);
- one step of the port's SP step over two ranks against JAX's single-device
  reference step (``:70-112``): loss atol 1e-5, parameters atol 1e-4; the
  same step on one rank (a ring of one) too.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.models.transformer import TransformerLM as JaxLM
from fedml_tpu.ops.attention import attention_reference as jax_reference
from fedml_tpu_torch import convert
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.parallel import launch, rehearsal
from fedml_tpu_torch.parallel.ring_attention import ring_attention

CPU = torch.device("cpu")


def _attention(causal, seed=0, b=2, h=2, t=64, d=8):
    rng = np.random.RandomState(seed)
    spec = {k: rng.randn(b, h, t, d).astype(np.float32) for k in ("q", "k", "v", "dy")}
    spec["causal"] = causal
    return spec


def _lm(vocab=31, b=2, t=64):
    rng = np.random.RandomState(0)
    x = rng.randint(0, vocab, (b, t))
    batch = {"x": x.astype(np.int32), "y": np.roll(x, -1, axis=1).astype(np.int32),
             "mask": np.ones((b, t), np.float32)}
    model = dict(vocab_size=vocab, embed_dim=32, num_layers=2, num_heads=2, max_len=t)
    ref = JaxLM(**model, attn_impl="xla")
    params = ref.init(jax.random.key(0), jnp.asarray(batch["x"]))["params"]
    init = {k: v.numpy() for k, v in convert.from_flax(
        jax.tree.map(np.asarray, {"params": params})).items()}
    return dict(model=model, init=init, batch=batch, lr=0.1), ref, params


JOBS = ["causal", "full", "sp_step"]


@pytest.fixture(scope="module")
def lm():
    return _lm()


@pytest.fixture(scope="module")
def two_ranks(lm):
    jobs = [("ring_attention_check", _attention(True)), ("ring_attention_check", _attention(False)),
            ("sp_lm_step", lm[0])]
    return launch.launch(rehearsal.run_jobs, 2, jobs, backend="gloo", platform="cpu",
                         timeout_s=300.0)


def _jax_attention(spec):
    q, k, v, dy = (jnp.asarray(spec[n]) for n in ("q", "k", "v", "dy"))

    def loss(q, k, v):
        return jnp.sum(jax_reference(q, k, v, causal=spec["causal"]) * dy)

    out = jax_reference(q, k, v, causal=spec["causal"])
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", ["causal", "full"])
def test_ring_attention_over_two_ranks_is_exact(two_ranks, name):
    spec = _attention(name == "causal")
    out, grads = _jax_attention(spec)
    ranks = [r[JOBS.index(name)] for r in two_ranks]
    t = out.shape[2] // 2
    for r in ranks:
        rows = slice(r["rank"] * t, (r["rank"] + 1) * t)
        np.testing.assert_allclose(r["out"], out[:, :, rows], atol=1e-5)
        for g, want in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(r[g], want[:, :, rows], atol=1e-4, err_msg=g)
        # one hop of K and V a rank forward (the last is skipped); the
        # backward's hop of K, V, dK, dV and the accumulators' hop home
        assert r["traffic"]["ppermute"]["calls"] == 3


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_on_one_rank_is_attention(causal):
    spec = _attention(causal)
    out, grads = _jax_attention(spec)
    q, k, v = (torch.tensor(spec[n], requires_grad=True) for n in ("q", "k", "v"))
    got = ring_attention(q, k, v, "sp", causal=causal)
    torch.sum(got * torch.tensor(spec["dy"])).backward()
    np.testing.assert_allclose(got.detach().numpy(), out, atol=1e-5)
    for t, want in zip((q, k, v), grads):
        np.testing.assert_allclose(t.grad.numpy(), want, atol=1e-4)


def _jax_step(ref, params, batch):
    def loss(p):
        logits = ref.apply({"params": p}, jnp.asarray(batch["x"]), train=True)
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(batch["y"])))

    value, grads = jax.value_and_grad(loss)(params)
    opt = optax.sgd(0.1)
    updates, _ = opt.update(grads, opt.init(params), params)
    new = optax.apply_updates(params, updates)
    return float(value), convert.from_flax(jax.tree.map(np.asarray, {"params": new}))


@pytest.mark.parametrize("where", ["two ranks", "one rank"])
def test_sp_step_matches_the_single_device_step(two_ranks, lm, where):
    spec, ref, params = lm
    loss, want = _jax_step(ref, params, spec["batch"])
    got = (two_ranks[0][JOBS.index("sp_step")] if where == "two ranks"
           else rehearsal.sp_lm_step(CPU, spec))
    if where == "two ranks":
        other = two_ranks[1][JOBS.index("sp_step")]
        assert other["loss"] == got["loss"]
        for k in got["params"]:
            np.testing.assert_array_equal(other["params"][k], got["params"][k])
    np.testing.assert_allclose(got["loss"], loss, atol=1e-5)
    assert set(got["params"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got["params"][k], v.numpy(), atol=1e-4, err_msg=k)


def test_ring_lm_is_the_xla_lm_on_one_rank(lm):
    spec = lm[0]
    models = [TransformerLM(**spec["model"], attn_impl=impl, device="cpu")
              for impl in ("ring", "xla")]
    for m in models:
        m.load_state_dict({k: torch.as_tensor(v) for k, v in spec["init"].items()})
    x = torch.as_tensor(spec["batch"]["x"])
    ring, xla = (m(x, pos_offset=0).detach().numpy() for m in models)
    np.testing.assert_allclose(ring, xla, atol=1e-5)
