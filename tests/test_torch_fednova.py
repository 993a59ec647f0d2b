"""FedNova in the port (``fedml_tpu_torch/algorithms/fednova.py``) against the
JAX package's, on the same numpy-made inputs.

Tolerances:

- ``normalizing_vector`` (momentum 0 and 0.9, etamu 0 and 0.01): rtol 1e-6
  (the same f32 recurrence, which XLA may fuse);
- the aggregator on a stacked cohort with heterogeneous tau: atol 1e-6;
- the client optimizer (``fednova_optimizer``), eight steps with momentum,
  the proximal term, weight decay and Nesterov: atol 1e-6;
- FedSim rounds of LogisticRegression with stragglers (E=2, half of each
  cohort on one epoch, so tau differs between clients) against the JAX
  engine from the same converted initial variables, scan and vmap: atol
  1e-5 on parameters, the round loss, ``tau_eff`` and the evals.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms import fednova as jfednova
from fedml_tpu.core import rng as jrng
from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.sim import cohort as jcohort
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fednova
from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import FedSim, SimConfig

ATOL = 1e-5


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("etamu", [0.0, 0.01])
def test_normalizing_vector_matches_jax(momentum, etamu):
    tau = np.array([0, 1, 3, 7, 12, 12, 5], np.float32)
    want = jfednova.normalizing_vector(jnp.asarray(tau), momentum, etamu, 12)
    got = fednova.normalizing_vector(torch.tensor(tau), momentum, etamu, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    if momentum == 0.0 and etamu == 0.0:
        np.testing.assert_array_equal(got.numpy(), tau)


def _flax_tree(rng, lead=()):
    def r(*shape):
        return rng.randn(*lead, *shape).astype(np.float32)

    return {"params": {"Dense_0": {"kernel": r(6, 4), "bias": r(4)},
                       "BatchNorm_0": {"scale": r(4), "bias": r(4)}},
            "batch_stats": {"BatchNorm_0": {"mean": r(4), "var": np.abs(r(4))}}}


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_aggregator_heterogeneous_tau_matches_jax(rng, momentum):
    c = 5
    g = _flax_tree(rng)
    stacked = _flax_tree(rng, lead=(c,))
    weights = np.array([12, 3, 0, 7, 9], np.float32)
    tau = np.array([6, 2, 1, 4, 3], np.float32)
    kw = dict(client_lr=0.1, momentum=momentum, batch_size=4, epochs=2, max_client_samples=12)
    want, _, jm = jfednova.fednova_aggregator(**kw).aggregate(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, stacked), jnp.asarray(weights),
        (), None, {"tau": jnp.asarray(tau), "max_tau": 6})
    tstack = {k: torch.stack([convert.from_flax(jax.tree.map(lambda a: a[i], stacked))[k]
                              for i in range(c)]) for k in convert.from_flax(g)}
    agg = fednova.fednova_aggregator(**kw)
    assert agg.stacked
    got, _, tm = agg.aggregate(convert.from_flax(g), tstack, torch.tensor(weights), (), None,
                               {"tau": torch.tensor(tau), "max_tau": 6})
    back = convert.to_flax(got)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=1e-6, err_msg=str(path))
    np.testing.assert_allclose(float(tm["tau_eff"]), float(jm["tau_eff"]), rtol=1e-6)


def test_fednova_optimizer_steps_match_jax(rng):
    kw = dict(lr=0.05, momentum=0.9, mu=0.1, weight_decay=0.01, nesterov=True)
    jopt = jfednova.fednova_optimizer(**kw)
    topt = fednova.fednova_optimizer(**kw)
    params = {"w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(8):
        grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        upd, js = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = topt.update({k: torch.tensor(v) for k, v in grads.items()}, ts, tp)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6)
    # the torch.optim form steps the module's parameters the same way
    w = torch.nn.Parameter(torch.tensor(params["w"]))
    opt = topt([w])
    ref, st = {"w": torch.tensor(params["w"])}, topt.init({"w": torch.tensor(params["w"])})
    for _ in range(3):
        g = torch.tensor(rng.randn(5, 3).astype(np.float32))
        w.grad = g.clone()
        opt.step()
        ref, st = topt.update({"w": g}, st, ref)
        assert torch.equal(w.detach(), ref["w"])


def _data(rng):
    sizes = [13, 4, 9, 11, 6, 8]
    n = sum(sizes)
    x = rng.rand(n + 12, 20).astype(np.float32)
    y = rng.randint(0, 10, n + 12).astype(np.int32)
    starts = np.cumsum([0] + sizes)
    part = {c: np.arange(starts[c], starts[c + 1]) for c in range(len(sizes))}
    return {"x": x[:n], "y": y[:n]}, part, {"x": x[n:], "y": y[n:]}


def _close(j_vars, t_vars, atol=ATOL):
    back = convert.to_flax(t_vars)
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(j_vars))[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=atol, err_msg=str(path))


@pytest.mark.parametrize("mode", ["scan", "vmap"])
def test_fedsim_stragglers_match_jax_engine(rng, mode):
    arrays, part, test = _data(rng)
    kw = dict(client_num_in_total=6, client_num_per_round=4, batch_size=4, comm_round=3,
              epochs=2, frequency_of_the_test=1, eval_batch_size=8, seed=5,
              straggler_frac=0.5, cohort_execution=mode)
    agg_kw = dict(client_lr=0.1, batch_size=4, epochs=2, max_client_samples=13)
    jsim = JaxSim(JaxTrainer(module=JaxLR(num_classes=10), optimizer=optax.sgd(0.1), epochs=2),
                  jcohort.FederatedArrays(arrays, part), test, JaxConfig(**kw),
                  aggregator=jfednova.fednova_aggregator(**agg_kw))
    module = create_model("lr", 10, "mnist", device="cpu", input_shape=(20,))
    tsim = FedSim(ClientTrainer(module=module, optimizer=sgd(0.1), epochs=2),
                  FederatedArrays(arrays, part), test, SimConfig(**kw),
                  aggregator=fednova.fednova_aggregator(**agg_kw), device="cpu")
    j_vars = jsim.init_round_variables()
    t_vars = convert.from_flax(jax.tree.map(np.asarray, dict(j_vars)))
    root = jrng.root_key(kw["seed"])
    taus = []
    for r in range(kw["comm_round"]):
        j_vars, _, j_m = jsim.run_round(r, j_vars, (), root)
        t_vars, _, t_m = tsim.run_round(r, t_vars, ())
        _close(j_vars, t_vars)
        for k in ("Train/Loss", "tau_eff"):
            np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), atol=ATOL, err_msg=k)
        taus.append(float(t_m["tau_eff"]))
    assert len(set(taus)) > 1  # tau differs between clients and rounds
    j_eval, t_eval = jsim.evaluate(j_vars), tsim.evaluate(t_vars)
    for k in j_eval:
        np.testing.assert_allclose(t_eval[k], j_eval[k], atol=ATOL, err_msg=k)
