"""The port's staging, tree ops, trainer and FedSim (fedml_tpu_torch) against
the JAX package's on the same numpy-made inputs.

Tolerances:
- numpy staging (sample_clients, cohort_index_map, stack_cohort,
  batch_array) is a copy of the reference, so it is held bitwise equal;
- tree ops and the SGD-momentum update: atol 1e-6 (f32 sums and products
  in other orders);
- one client's local training and two FedAvg rounds with eval: atol 1e-5 on
  parameters, losses and normalised eval metrics, rtol 1e-6 on summed eval
  metrics (sums over every token of the batches). Several SGD steps of f32
  arithmetic through a small TransformerLM with sums taken in other orders
  (observed differences ~3e-7, relative ~2e-7 on sums)."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.core import rng as jrng
from fedml_tpu.core import tree as jtree
from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.core.trainer import make_local_eval as jax_local_eval
from fedml_tpu.core.trainer import make_local_train as jax_local_train
from fedml_tpu.models.transformer import TransformerLM as JaxLM
from fedml_tpu.sim import cohort as jcohort
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.core import rng as trng
from fedml_tpu_torch.core import tree as ttree
from fedml_tpu_torch.core.trainer import ClientTrainer, make_local_eval, make_local_train, sgd
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.sim import cohort as tcohort
from fedml_tpu_torch.sim.engine import FedSim, SimConfig

ATOL = 1e-5
VOCAB, T = 23, 16


def _lm_data(rng, n_clients=6, per_client=10):
    n = n_clients * per_client
    x = rng.randint(0, VOCAB, (n, T)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    mask = np.ones((n, T), np.float32)
    mask[::3, 12:] = 0.0
    # uneven clients: some hold fewer samples than the population max
    part = {c: np.arange(c * per_client, (c + 1) * per_client - (c % 3))
            for c in range(n_clients)}
    return {"x": x, "y": y, "mask": mask}, part


def _models():
    kw = dict(vocab_size=VOCAB, embed_dim=16, num_layers=1, num_heads=2, max_len=T)
    return JaxLM(**kw), TransformerLM(device="cpu", **kw)


def _close_to_jax(variables_jax, state_dict, atol):
    back = convert.to_flax(state_dict)
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(variables_jax))[0]:
        other = back
        for p in path:
            other = other[p.key]
        np.testing.assert_allclose(other, np.asarray(leaf), atol=atol, err_msg=str(path))


# -- numpy staging: bitwise copies -------------------------------------------


def test_sample_clients_bitwise():
    for r in range(5):
        for total, per in ((10, 10), (100, 7), (37, 36)):
            np.testing.assert_array_equal(trng.sample_clients(r, total, per),
                                          jrng.sample_clients(r, total, per))
    elig = np.array([3, 5, 8, 13, 21])
    np.testing.assert_array_equal(trng.sample_clients(4, 30, 3, elig),
                                  jrng.sample_clients(4, 30, 3, elig))


@pytest.mark.parametrize("steps", [None, 4])
def test_cohort_staging_bitwise(rng, steps):
    arrays, part = _lm_data(rng)
    jdata = jcohort.FederatedArrays(arrays, part)
    tdata = tcohort.FederatedArrays(arrays, part)
    cohort = np.array([4, 0, 5, 2])
    for seed in (0, 1_000_003 + 1):
        j_idx, j_w = jcohort.cohort_index_map(jdata, cohort, 3, steps,
                                              np.random.RandomState(seed))
        t_idx, t_w = tcohort.cohort_index_map(tdata, cohort, 3, steps,
                                              np.random.RandomState(seed))
        np.testing.assert_array_equal(t_idx, j_idx)
        np.testing.assert_array_equal(t_w, j_w)
    j_stack, _ = jcohort.stack_cohort(jdata, cohort, 3, steps, np.random.RandomState(7))
    t_stack, _ = tcohort.stack_cohort(tdata, cohort, 3, steps, np.random.RandomState(7))
    for k in j_stack:
        np.testing.assert_array_equal(t_stack[k], j_stack[k])
    for k, v in jcohort.batch_array(arrays, 7).items():
        np.testing.assert_array_equal(tcohort.batch_array(arrays, 7)[k], v)
    assert tcohort.steps_per_epoch(10, 3) == jcohort.steps_per_epoch(10, 3)


def test_device_gather_matches_host_stack(rng):
    arrays, part = _lm_data(rng)
    data = tcohort.FederatedArrays(arrays, part)
    idx, _ = tcohort.cohort_index_map(data, np.array([1, 3, 2]), 4, rng=np.random.RandomState(2))
    host = tcohort.gather_index_stack(arrays, idx)
    dev = FedSim._gather_batches({k: torch.tensor(v) for k, v in arrays.items()},
                                 torch.tensor(idx))
    for k in host:
        np.testing.assert_array_equal(dev[k].numpy(), host[k])


# -- tree ops and the optimizer ----------------------------------------------


def test_tree_ops_match_jax(rng):
    shapes = {"a": (3, 4), "b": (5,)}
    trees = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    weights = np.array([3.0, 0.0, 5.0], np.float32)
    stacked = {k: np.stack([t[k] for t in trees]) for k in shapes}
    j_mean = jtree.tree_weighted_mean(stacked, jnp.asarray(weights))
    tt = [{k: torch.tensor(v) for k, v in t.items()} for t in trees]
    t_mean = ttree.weighted_mean(iter(tt), torch.tensor(weights))
    for k in shapes:
        np.testing.assert_allclose(t_mean[k].numpy(), np.asarray(j_mean[k]), atol=1e-6)
    a, b = tt[0], tt[2]
    ja, jb = trees[0], trees[2]
    np.testing.assert_allclose(float(ttree.dot(a, b)), float(jtree.tree_dot(ja, jb)), atol=1e-5)
    np.testing.assert_allclose(float(ttree.norm(a)), float(jtree.tree_norm(ja)), atol=1e-6)
    for tfn, jfn in ((ttree.add, jtree.tree_add), (ttree.sub, jtree.tree_sub)):
        out, ref = tfn(a, b), jfn(ja, jb)
        for k in shapes:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-6)
    np.testing.assert_allclose(ttree.scale(a, 0.5)["a"].numpy(), ja["a"] * 0.5, atol=1e-6)
    with pytest.raises(ValueError, match="3 weights"):
        ttree.weighted_mean(iter(tt[:2]), torch.tensor(weights))


def test_torch_sgd_momentum_matches_optax(rng):
    """torch SGD(momentum=0.9, dampening=0) equals optax.sgd(lr, 0.9)
    (trace + scale_by_learning_rate) step for step."""
    p0 = rng.randn(6, 3).astype(np.float32)
    grads = [rng.randn(6, 3).astype(np.float32) for _ in range(5)]
    opt = optax.sgd(0.05, momentum=0.9)
    p_j, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    p_t = torch.nn.Parameter(torch.tensor(p0))
    topt = sgd(0.05, 0.9)([p_t])
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        p_t.grad = torch.tensor(g)
        topt.step()
        np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j), atol=1e-6)


# -- one client's local training ---------------------------------------------


def test_one_client_local_train_matches_jax(rng):
    """Two epochs over three batches, one of them all padding (a no-op step),
    under a budget of 4 steps that masks the second epoch's later steps; then
    the summed eval metrics of the trained model on the same batches."""
    arrays, _ = _lm_data(rng)
    S, B = 3, 4
    idx = np.arange(S * B).reshape(S, B).astype(np.int32)
    idx[2] = -1  # all-padding step
    data = tcohort.gather_index_stack(arrays, idx)
    jmodel, tmodel = _models()
    jtrainer = JaxTrainer(module=jmodel, task="nwp", optimizer=optax.sgd(0.1, momentum=0.9),
                          epochs=2)
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.key(1), jnp.asarray(data["x"][0])))
    num_steps = 4  # of the second epoch's steps 3, 4, 5 only step 3 runs
    j_vars, j_m = jax.jit(jax_local_train(jtrainer))(
        variables, {k: jnp.asarray(v) for k, v in data.items()}, jax.random.key(0),
        num_steps)
    ttrainer = ClientTrainer(module=tmodel, task="nwp", optimizer=sgd(0.1, 0.9), epochs=2)
    t_vars, t_m = make_local_train(ttrainer)(
        convert.from_flax(variables), {k: torch.tensor(v) for k, v in data.items()},
        num_steps)
    _close_to_jax(j_vars, t_vars, ATOL)
    np.testing.assert_allclose(float(t_m["train_loss"]), float(j_m["train_loss"]), atol=ATOL)
    j_eval = jax.jit(jax_local_eval(jtrainer))(j_vars, {k: jnp.asarray(v) for k, v in data.items()})
    t_eval = make_local_eval(ttrainer)(t_vars, {k: torch.tensor(v) for k, v in data.items()})
    assert set(t_eval) == set(j_eval)
    for k in j_eval:
        # sums over every token of three batches: relative f32 rounding
        np.testing.assert_allclose(float(t_eval[k]), float(j_eval[k]), rtol=1e-6, err_msg=k)


# -- FedSim ------------------------------------------------------------------


def test_fedsim_two_rounds_match_jax(rng):
    arrays, part = _lm_data(rng)
    test = {k: v[:12] for k, v in arrays.items()}
    kw = dict(client_num_in_total=6, client_num_per_round=4, batch_size=4, comm_round=2,
              epochs=2, frequency_of_the_test=1, eval_batch_size=5, seed=3,
              train_eval_samples=30, cohort_execution="scan")
    jmodel, tmodel = _models()
    jsim = JaxSim(JaxTrainer(module=jmodel, task="nwp", optimizer=optax.sgd(0.1, momentum=0.9),
                             epochs=2),
                  jcohort.FederatedArrays(arrays, part), test, JaxConfig(**kw))
    tsim = FedSim(ClientTrainer(module=tmodel, task="nwp", optimizer=sgd(0.1, 0.9), epochs=2),
                  tcohort.FederatedArrays(arrays, part), test, SimConfig(**kw), device="cpu")
    j_vars = jsim.init_round_variables()
    j_state = jsim.aggregator.init_state(j_vars)
    t_vars = convert.from_flax(jax.tree.map(np.asarray, j_vars))
    root = jrng.root_key(kw["seed"])
    for r in range(2):
        j_vars, j_state, j_m = jsim.run_round(r, j_vars, j_state, root)
        t_vars, _, t_m = tsim.run_round(r, t_vars)
        _close_to_jax(j_vars, t_vars, ATOL)
        np.testing.assert_allclose(float(t_m["Train/Loss"]), float(j_m["Train/Loss"]), atol=ATOL)
        j_eval, t_eval = jsim.evaluate(j_vars), tsim.evaluate(t_vars)
        assert set(t_eval) == set(j_eval) == {"Train/Acc", "Train/Loss", "Test/Acc", "Test/Loss"}
        for k in j_eval:
            np.testing.assert_allclose(t_eval[k], j_eval[k], atol=ATOL, err_msg=k)


def test_fedsim_run_history(rng):
    arrays, part = _lm_data(rng)
    _, tmodel = _models()
    sim = FedSim(ClientTrainer(module=tmodel, task="nwp", optimizer=sgd(0.1), epochs=1),
                 tcohort.FederatedArrays(arrays, part), {k: v[:8] for k, v in arrays.items()},
                 SimConfig(client_num_in_total=6, client_num_per_round=3, batch_size=4,
                           comm_round=3, frequency_of_the_test=2, eval_batch_size=8),
                 device="cpu")
    _, history = sim.run()
    assert [h["round"] for h in history] == [0, 1, 2]
    assert "Test/Acc" not in history[0] and "Test/Acc" in history[1] and "Test/Acc" in history[2]
    assert all(np.isfinite(h["Train/Loss"]) and h["round_time"] > 0 for h in history)


def test_simconfig_rejects_unported_fields():
    SimConfig(block_dispatch=True)
    SimConfig(population="speed=const:1", pack_lanes=2, pack_capacity_factor=2.0)
    SimConfig(compressor="q8", error_feedback=False)
    with pytest.raises(NotImplementedError, match="mesh_shape"):
        SimConfig(mesh_shape=(2, 4))
    with pytest.raises(NotImplementedError, match="shard_rules"):
        SimConfig(shard_rules="cnn_tp")
    with pytest.raises(ValueError, match="downlink delta coding is a wire-path plane"):
        SimConfig(downlink_compressor="q8")
    SimConfig(robust_rule="median", norm_bound=1.0, dp_stddev=0.1)
    SimConfig(stage_on_device=True, block_dispatch=False, pipeline_depth=0,
              eval_on_clients=True, straggler_frac=0.2, profile_dir="prof")
