"""The recurrent family (``fedml_tpu_torch/models/rnn.py``), its converter
arm and its registry arms against the JAX package, on the same numpy-made
inputs and the JAX modules' variables, converted.

Tolerances, fixed before the first run:
- one LSTM cell step against flax ``OptimizedLSTMCell``: atol 1e-6 (the
  same f32 products and gate functions; products summed in other orders);
- both models at small widths against the JAX modules, T = 14: logits and
  the gradients of the masked ``lm_loss`` against ``jax.grad``, atol 1e-5
  (14 recurrent steps, through two layers for ``RNNOriginalFedAvg``);
- ``convert.to_flax(convert.from_flax(v))`` at full width: bitwise;
- the port's vmapped cohort step against its client-by-client steps, 3
  ragged clients, 2 epochs: atol 1e-6, with every warning an error (a
  per-client fallback of ``torch.func.vmap`` warns);
- the port's ``FedSim`` (vmap) against the JAX ``FedSim`` (vmap), 6 clients,
  3 rounds, small RNN: atol 1e-4 on variables, losses and eval metrics."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from fedml_tpu.core import rng as jrng
from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.core.trainer import lm_loss as jax_lm_loss
from fedml_tpu.models import rnn as jax_rnn
from fedml_tpu.sim import cohort as jcohort
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.core.trainer import (ClientTrainer, lm_loss, make_local_train,
                                          make_vmap_train, sgd)
from fedml_tpu_torch.models import rnn
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import FedSim, SimConfig

MODELS = {
    "original": (jax_rnn.RNNOriginalFedAvg, rnn.RNNOriginalFedAvg,
                 dict(vocab_size=30, embedding_dim=8, hidden_size=16)),
    "stackoverflow": (jax_rnn.RNNStackOverflow, rnn.RNNStackOverflow,
                      dict(vocab_size=50, embedding_dim=12, hidden_size=20)),
}
T = 14


def _sd(tree):
    return convert.from_flax(jax.tree.map(np.asarray, dict(tree)))


def _lm_batch(rng, vocab, b=3, t=T):
    x = rng.randint(0, vocab, (b, t)).astype(np.int32)
    y = rng.randint(0, vocab, (b, t)).astype(np.int32)
    mask = (rng.rand(b, t) > 0.2).astype(np.float32)
    return {"x": x, "y": y, "mask": mask}


def test_lstm_cell_step_matches_flax(rng):
    b, d_in, h = 5, 7, 12
    cell = fnn.OptimizedLSTMCell(h)
    x = rng.randn(b, d_in).astype(np.float32)
    c0 = rng.randn(b, h).astype(np.float32)
    h0 = rng.randn(b, h).astype(np.float32)
    v = cell.init(jax.random.key(0), (jnp.asarray(c0), jnp.asarray(h0)), jnp.asarray(x))
    # non-zero biases, so the bias's place in the sum is checked
    v = jax.tree.map(lambda a: a + 0.1 if a.ndim == 1 else a, v)
    (c_j, h_j), out_j = cell.apply(v, (jnp.asarray(c0), jnp.asarray(h0)), jnp.asarray(x))
    sd = convert.from_flax({"params": {"OptimizedLSTMCell_0": jax.tree.map(
        np.asarray, dict(v["params"]))}})
    h_t, c_t = rnn.lstm_cell(torch.nn.functional.linear(torch.tensor(x), sd["lstm_0.weight_ih"]),
                             torch.tensor(h0), torch.tensor(c0), sd["lstm_0.weight_hh"],
                             sd["lstm_0.bias_hh"])
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(out_j), np.asarray(h_j))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_logits_and_grads_match_jax(rng, name):
    jax_cls, port_cls, kw = MODELS[name]
    batch = _lm_batch(rng, kw["vocab_size"])
    jm = jax_cls(**kw)
    v = jm.init(jax.random.key(1), jnp.asarray(batch["x"]))
    v = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, v)  # non-zero biases
    model = port_cls(device="cpu", **kw)
    model.load_state_dict(_sd(v))
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    tb = {k: torch.tensor(a) for k, a in batch.items()}
    logits = model(tb["x"])
    assert logits.shape == (3, T, kw["vocab_size"]) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jm.apply(v, jb["x"])),
                               atol=1e-5)
    g_j = _sd(jax.grad(lambda p: jax_lm_loss(jm.apply({"params": p}, jb["x"]), jb))(
        v["params"]))
    lm_loss(model(tb["x"]), tb).backward()
    grads = dict(model.named_parameters())
    assert set(g_j) == set(grads)
    for k, g in g_j.items():
        np.testing.assert_allclose(grads[k].grad.numpy(), g.numpy(), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_full_width_variables_round_trip_bitwise(name):
    jax_cls, port_cls, _ = MODELS[name]
    v = jax.tree.map(np.asarray, dict(jax_cls().init(jax.random.key(2),
                                                     jnp.zeros((1, 4), jnp.int32))))
    sd = convert.from_flax(v)
    assert {k: tuple(t.shape) for k, t in sd.items()} == {
        k: tuple(t.shape) for k, t in port_cls(device="cpu").state_dict().items()}
    back = convert.to_flax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_port_initialisers_follow_flax():
    """Orthogonal recurrent gate kernels, zero biases, and the spread of the
    lecun-normal and embedding initialisers (variance 1 / fan-in)."""
    model = rnn.RNNOriginalFedAvg(device="cpu")
    assert not any(isinstance(m, torch.nn.RNNBase) for m in model.modules())
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    for gate in sd["lstm_1.weight_hh"].split(256):
        np.testing.assert_allclose((gate @ gate.T).numpy(), np.eye(256), atol=1e-5)
    assert not sd["lstm_0.bias_hh"].any() and not sd["dense_0.bias"].any()
    # 262,144 and 720 draws: the sample spreads within 2% and 10%
    assert abs(float(sd["lstm_1.weight_ih"].std()) * 256 ** 0.5 - 1) < 0.02
    assert abs(float(sd["embed.weight"].std()) * 8 ** 0.5 - 1) < 0.1


def _client_stack(rng, vocab, sizes, batch=4, t=T):
    """``[C, S, B, T]`` batches of ragged clients (-1 slots padded)."""
    steps = -(-max(sizes) // batch)
    arrays = _lm_batch(rng, vocab, b=sum(sizes), t=t)
    idx = np.full((len(sizes), steps * batch), -1, np.int32)
    start = 0
    for c, n in enumerate(sizes):
        idx[c, :n] = np.arange(start, start + n)
        start += n
    idx = torch.tensor(idx.reshape(len(sizes), steps, batch))
    return FedSim._gather_batches({k: torch.tensor(v) for k, v in arrays.items()}, idx)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_vmapped_step_matches_scan_without_fallback(rng, name):
    _, port_cls, kw = MODELS[name]
    model = port_cls(device="cpu", **kw)
    trainer = ClientTrainer(module=model, task="nwp", optimizer=sgd(0.5), epochs=2)
    g = {k: v.detach().clone() for k, v in model.state_dict().items()}
    data = _client_stack(rng, kw["vocab_size"], [7, 3, 5])
    budgets = torch.tensor([4, 4, 4])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        stacked, metrics = make_vmap_train(trainer)(g, data, budgets)
    local = make_local_train(trainer)
    for c in range(3):
        alone, m = local(g, {k: v[c] for k, v in data.items()}, 4)
        for k in g:
            np.testing.assert_allclose(stacked[k][c].numpy(), alone[k].numpy(), atol=1e-6,
                                       err_msg=f"client {c} {k}")
        np.testing.assert_allclose(float(metrics["train_loss"][c]), float(m["train_loss"]),
                                   atol=1e-6)


def test_fedsim_vmap_matches_jax_vmap(rng):
    kw = dict(vocab_size=24, embedding_dim=8, hidden_size=16)
    sizes = [9, 4, 6, 11, 3, 7]
    n = sum(sizes)
    arrays = _lm_batch(rng, kw["vocab_size"], b=n + 8, t=12)
    starts = np.cumsum([0] + sizes)
    part = {c: np.arange(starts[c], starts[c + 1]) for c in range(len(sizes))}
    train = {k: v[:n] for k, v in arrays.items()}
    test = {k: v[n:] for k, v in arrays.items()}
    cfg = dict(client_num_in_total=6, client_num_per_round=4, batch_size=4, comm_round=3,
               epochs=1, frequency_of_the_test=1, eval_batch_size=8, seed=5)
    jsim = JaxSim(JaxTrainer(module=jax_rnn.RNNOriginalFedAvg(**kw), task="nwp",
                             optimizer=optax.sgd(1.0)),
                  jcohort.FederatedArrays(train, part), test,
                  JaxConfig(cohort_execution="vmap", **cfg))
    j_vars = jsim.init_round_variables()
    j_state = jsim.aggregator.init_state(j_vars)
    tsim = FedSim(ClientTrainer(module=rnn.RNNOriginalFedAvg(device="cpu", **kw), task="nwp",
                                optimizer=sgd(1.0)),
                  FederatedArrays(train, part), test, SimConfig(cohort_execution="vmap", **cfg),
                  device="cpu")
    t_vars = _sd(j_vars)
    root = jrng.root_key(cfg["seed"])
    for r in range(cfg["comm_round"]):
        j_vars, j_state, j_m = jsim.run_round(r, j_vars, j_state, root)
        t_vars, _, t_m = tsim.run_round(r, t_vars)
        j_sd = _sd(j_vars)
        assert set(j_sd) == set(t_vars)
        for k in j_sd:
            np.testing.assert_allclose(t_vars[k].numpy(), j_sd[k].numpy(), atol=1e-4,
                                       err_msg=f"round {r} {k}")
        np.testing.assert_allclose(float(t_m["Train/Loss"]), float(j_m["Train/Loss"]),
                                   atol=1e-4)
        j_eval, t_eval = jsim.evaluate(j_vars), tsim.evaluate(t_vars)
        assert set(t_eval) == set(j_eval)
        for k in j_eval:
            np.testing.assert_allclose(t_eval[k], j_eval[k], atol=1e-4, err_msg=k)


def test_registry_rnn_arms():
    so = create_model("rnn", 7, "stackoverflow_nwp", device="cpu")
    assert isinstance(so, rnn.RNNStackOverflow)
    assert so.dense_1.weight.shape == (10004, 96)  # output_dim ignored, as in JAX
    for dataset in ("shakespeare", "fed_shakespeare", ""):
        m = create_model("rnn", 7, dataset, device="cpu")
        assert isinstance(m, rnn.RNNOriginalFedAvg) and m.dense_0.weight.shape == (90, 256)
    assert create_model("rnn", 7, "shakespeare", dtype="float32", device="cpu") is not None
    with pytest.raises(ValueError, match="does not take a compute dtype"):
        create_model("rnn", 90, "shakespeare", dtype="bfloat16", device="cpu")
    small = create_model("rnn", 0, "stackoverflow_nwp", device="cpu", vocab_size=40,
                         embedding_dim=6, hidden_size=10)
    assert small(torch.zeros(2, 5, dtype=torch.int32)).shape == (2, 5, 40)
