"""FedProx with stragglers, Adam and weight decay in the port
(fedml_tpu_torch: ClientTrainer.prox_mu, the straggler budgets of FedSim,
the Adam optimizer's two forms, SGD's weight decay) against the JAX engine
on the same numpy-made inputs, from the same converted initial variables.

Tolerance: atol 1e-5 on parameters, round losses and eval metrics, f32 in
both, in scan and in vmap (a few SGD or Adam steps of f32 arithmetic
through a LogisticRegression or LeNet, with sums, the proximal term and the
weighted fold taken in other orders). The functional Adam against
``optax.chain(add_decayed_weights, adam)`` step for step: atol 1e-6.

LeNet's FedProx rounds run at lr 0.02, LogisticRegression's at 0.1. The
reported loss holds the proximal term, a sum of ~430k squares, and the JAX
package reduces it with ``jnp.vdot``, whose f32 sum on the CPU is off by
~1e-4 relative on a 400k-element vector (measured: -1.1e-4 against float64;
``torch.sum`` -4e-9). At lr 0.1 LeNet's parameters move far enough from
the global model that this puts the JAX round loss 1.0e-4 from the port's
while the parameters agree to 3e-8; at lr 0.02 both stay inside 1e-5."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.core import rng as jrng
from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.models.cnn import LeNet as JaxLeNet
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.sim import cohort as jcohort
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms.fedprox import fedprox_aggregator, fedprox_trainer
from fedml_tpu_torch.core.trainer import ClientTrainer, adam, sgd
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import FedSim, SimConfig

ATOL = 1e-5


def _data(rng, image):
    sizes = [13, 4, 9, 11, 6, 8]
    n = sum(sizes)
    shape = (28, 28) if image else (20,)
    x = rng.rand(n + 12, *shape).astype(np.float32)
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


def _rounds_against_jax(rng, model, mode, jax_opt, port_opt, rounds, prox_mu=0.0,
                        straggler_frac=0.0, epochs=2):
    arrays, part, test = _data(rng, image=model == "lenet")
    kw = dict(client_num_in_total=6, client_num_per_round=4, batch_size=4, comm_round=rounds,
              epochs=epochs, frequency_of_the_test=1, eval_batch_size=8, seed=5,
              straggler_frac=straggler_frac, cohort_execution=mode)
    jmodule = JaxLeNet(num_classes=10) if model == "lenet" else JaxLR(num_classes=10)
    jsim = JaxSim(JaxTrainer(module=jmodule, optimizer=jax_opt, epochs=epochs, prox_mu=prox_mu),
                  jcohort.FederatedArrays(arrays, part), test, JaxConfig(**kw))
    tmodule = create_model(model, 10, "mnist", device="cpu",
                           input_shape=arrays["x"].shape[1:])
    trainer = ClientTrainer(module=tmodule, optimizer=port_opt, epochs=epochs)
    tsim = FedSim(fedprox_trainer(trainer, prox_mu), FederatedArrays(arrays, part), test,
                  SimConfig(**kw), aggregator=fedprox_aggregator(), device="cpu")
    j_vars = jsim.init_round_variables()
    j_state = jsim.aggregator.init_state(j_vars)
    t_vars = convert.from_flax(jax.tree.map(np.asarray, dict(j_vars)))
    root = jrng.root_key(kw["seed"])
    for r in range(rounds):
        j_vars, j_state, j_m = jsim.run_round(r, j_vars, j_state, root)
        t_vars, _, t_m = tsim.run_round(r, t_vars)
        _close(j_vars, t_vars)
        np.testing.assert_allclose(float(t_m["Train/Loss"]), float(j_m["Train/Loss"]),
                                   atol=ATOL)
    j_eval, t_eval = jsim.evaluate(j_vars), tsim.evaluate(t_vars)
    assert set(j_eval) == set(t_eval)
    for k in j_eval:
        np.testing.assert_allclose(t_eval[k], j_eval[k], atol=ATOL, err_msg=k)
    return tsim


@pytest.mark.parametrize("model,lr", [("lr", 0.1), ("lenet", 0.02)])
@pytest.mark.parametrize("mode", ["scan", "vmap"])
def test_fedprox_stragglers_two_rounds_match_jax(rng, model, lr, mode):
    sim = _rounds_against_jax(rng, model, mode, optax.sgd(lr), sgd(lr), rounds=2,
                              prox_mu=0.1, straggler_frac=0.5)
    # the straggler draw of these rounds holds both budgets (1 and 2 epochs)
    budgets = np.concatenate([sim._host_cohort_indices(
        np.arange(4), r)[2] for r in range(2)])
    assert set(budgets.tolist()) == {sim._steps, 2 * sim._steps}


@pytest.mark.parametrize("mode", ["scan", "vmap"])
@pytest.mark.parametrize("kind", ["adam", "adam_wd", "sgd_wd"])
def test_adam_and_weight_decay_round_matches_jax(rng, mode, kind):
    wd = 0.0 if kind == "adam" else 0.01
    if kind.startswith("adam"):
        jax_opt, port_opt = optax.chain(optax.add_decayed_weights(wd), optax.adam(0.01)), \
            adam(0.01, weight_decay=wd)
    else:
        jax_opt, port_opt = optax.chain(optax.add_decayed_weights(wd), optax.sgd(0.1)), \
            sgd(0.1, weight_decay=wd)
    _rounds_against_jax(rng, "lr", mode, jax_opt, port_opt, rounds=1, epochs=1)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_forms_match_optax(rng, wd):
    p0 = rng.randn(3, 6, 4).astype(np.float32)
    grads = [rng.randn(3, 6, 4).astype(np.float32) for _ in range(5)]
    opt = optax.chain(optax.add_decayed_weights(wd), optax.adam(0.05))
    p_j, state_j = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tadam = adam(0.05, weight_decay=wd)
    p_f = {"w": torch.tensor(p0)}
    state_f = tadam.init(p_f, (3,))
    assert state_f["count"].shape == (3,)
    p_t = torch.nn.Parameter(torch.tensor(p0))
    topt = tadam([p_t])
    for g in grads:
        updates, state_j = opt.update(jnp.asarray(g), state_j, p_j)
        p_j = optax.apply_updates(p_j, updates)
        p_f, state_f = torch.func.vmap(tadam.update)({"w": torch.tensor(g)}, state_f, p_f)
        p_t.grad = torch.tensor(g)
        topt.step()
        np.testing.assert_allclose(p_f["w"].numpy(), np.asarray(p_j), atol=1e-6)
        np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j), atol=1e-6)
