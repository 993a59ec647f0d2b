"""FedOpt in the port (``fedml_tpu_torch/algorithms/fedopt.py``) against the
JAX package's optax server optimizers, and FedAvg's and FedProx's histories
held to the ones the port gave before the server rules' contract grew.

Tolerances:

- the six server optimizers through ``fedopt_aggregator``, five chained
  aggregations of a tree that has BatchNorm statistics, the same numpy-made
  client stacks given to both packages: atol 1e-6 (f32 arithmetic written
  out in the port, fused by XLA in the JAX package);
- ``sgd`` at lr 1 with momentum 0 against FedAvg: atol 1e-6 (``old - (old -
  avg)`` rounds where ``avg`` does not);
- FedAvg and FedProx (scan, vmap, packed lanes) CPU histories: bitwise
  equal to the values recorded from the port before ``Aggregator`` passed
  the round's noise and ``extras`` and could ask for the stacked cohort.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.base import fedavg_aggregator as jax_fedavg
from fedml_tpu.algorithms.fedopt import fedopt_aggregator as jax_fedopt
from fedml_tpu.algorithms.fedopt import server_optimizer as jax_server_optimizer
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms.base import fedavg_aggregator
from fedml_tpu_torch.algorithms.fedopt import fedopt_aggregator, server_optimizer
from fedml_tpu_torch.algorithms.fedprox import fedprox_aggregator, fedprox_trainer
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import FedSim, SimConfig

ATOL = 1e-6
OPTIMIZERS = ["sgd", "adam", "yogi", "adagrad", "rmsprop", "adamw"]


def _flax_tree(rng, lead=()):
    """A small flax-layout tree with ``params`` and ``batch_stats``."""
    def r(*shape):
        return rng.randn(*lead, *shape).astype(np.float32)

    return {"params": {"Dense_0": {"kernel": r(5, 3), "bias": r(3)},
                       "BatchNorm_0": {"scale": r(3), "bias": r(3)}},
            "batch_stats": {"BatchNorm_0": {"mean": r(3), "var": np.abs(r(3))}}}


def _port(tree):
    return convert.from_flax(tree)


def _port_stack(stacked, c):
    return [_port(jax.tree.map(lambda a: a[i], stacked)) for i in range(c)]


def _close(j_tree, t_sd, atol=ATOL):
    back = convert.to_flax(t_sd)
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(j_tree))[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=atol, err_msg=str(path))


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_server_optimizers_match_optax(rng, name):
    c = 4
    j_global = _flax_tree(rng)
    t_global = _port(j_global)
    jagg = jax_fedopt(jax_server_optimizer(name, 0.1, 0.9))
    tagg = fedopt_aggregator(server_optimizer(name, 0.1, 0.9))
    j_state = jagg.init_state(jax.tree.map(jnp.asarray, j_global))
    t_state = tagg.init_state(t_global)
    j_global = jax.tree.map(jnp.asarray, j_global)
    for step in range(5):
        stacked = _flax_tree(rng, lead=(c,))
        weights = rng.randint(1, 20, c).astype(np.float32)
        j_global, j_state, _ = jagg.aggregate(j_global, jax.tree.map(jnp.asarray, stacked),
                                              jnp.asarray(weights), j_state, None)
        t_global, t_state, _ = tagg.aggregate(t_global, iter(_port_stack(stacked, c)),
                                              torch.tensor(weights), t_state)
        _close(j_global, t_global)
    if "count" in t_state:
        # the step count is a tensor (a CUDA graph of the round carries it)
        assert isinstance(t_state["count"], torch.Tensor) and int(t_state["count"]) == 5


def test_sgd_lr1_momentum0_is_fedavg(rng):
    c = 5
    t_global = _port(_flax_tree(rng))
    stack = _port_stack(_flax_tree(rng, lead=(c,)), c)
    weights = torch.tensor(rng.randint(1, 20, c).astype(np.float32))
    agg = fedopt_aggregator(server_optimizer("sgd", 1.0, 0.0))
    got, _, _ = agg.aggregate(t_global, iter(stack), weights, agg.init_state(t_global))
    want, _, _ = fedavg_aggregator().aggregate(t_global, iter(stack), weights, ())
    assert list(got) == list(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=ATOL)


def test_fedopt_state_is_params_only_and_bn_averaged(rng):
    c = 3
    j_global = _flax_tree(rng)
    t_global = _port(j_global)
    agg = fedopt_aggregator(server_optimizer("adam", 0.1, 0.9))
    state = agg.init_state(t_global)
    assert set(state["mu"]) == set(treelib.params_of(t_global))
    assert not any(treelib.is_model_state(k) for k in state["mu"])
    stack = _port_stack(_flax_tree(rng, lead=(c,)), c)
    weights = torch.ones(c)
    new, _, _ = agg.aggregate(t_global, iter(stack), weights, state)
    mean = treelib.weighted_mean(iter(stack), weights)
    for k in ("bn_0.running_mean", "bn_0.running_var"):
        assert torch.equal(new[k], mean[k])
    with pytest.raises(ValueError, match="unknown server optimizer"):
        server_optimizer("lamb")


def test_jax_fedavg_and_port_fedavg_agree(rng):
    c = 4
    stacked = _flax_tree(rng, lead=(c,))
    weights = rng.randint(1, 20, c).astype(np.float32)
    want, _, _ = jax_fedavg().aggregate(None, jax.tree.map(jnp.asarray, stacked),
                                        jnp.asarray(weights), (), None)
    got, _, _ = fedavg_aggregator().aggregate(None, iter(_port_stack(stacked, c)),
                                              torch.tensor(weights), ())
    _close(want, got)


# the port's histories (float.hex) of the runs below, recorded before the
# aggregator contract passed noise and extras
GOLDEN = {
'fedavg-scan-0': [
    {'Train/Loss': '0x1.35dfd00000000p+1', 'Train/Acc': '0x1.e1e1e20000000p-4', 'Test/Acc': '0x1.5555560000000p-4', 'Test/Loss': '0x1.3b59da0000000p+1'},
    {'Train/Loss': '0x1.331b900000000p+1', 'Train/Acc': '0x1.4141420000000p-3', 'Test/Acc': '0x1.5555560000000p-4', 'Test/Loss': '0x1.37b72a0000000p+1'},
    {'Train/Loss': '0x1.2ffab00000000p+1', 'Train/Acc': '0x1.9191920000000p-3', 'Test/Acc': '0x1.5555560000000p-3', 'Test/Loss': '0x1.2e855a0000000p+1'},
],
'fedavg-vmap-0': [
    {'Train/Loss': '0x1.35dfd00000000p+1', 'Train/Acc': '0x1.e1e1e20000000p-4', 'Test/Acc': '0x1.5555560000000p-4', 'Test/Loss': '0x1.3b59da0000000p+1'},
    {'Train/Loss': '0x1.331b900000000p+1', 'Train/Acc': '0x1.4141420000000p-3', 'Test/Acc': '0x1.5555560000000p-4', 'Test/Loss': '0x1.37b72a0000000p+1'},
    {'Train/Loss': '0x1.2ffab00000000p+1', 'Train/Acc': '0x1.9191920000000p-3', 'Test/Acc': '0x1.5555560000000p-3', 'Test/Loss': '0x1.2e855a0000000p+1'},
],
'fedavg-vmap-2': [
    {'Train/Loss': '0x1.35dfd00000000p+1', 'Train/Acc': '0x1.e1e1e20000000p-4', 'Test/Acc': '0x1.5555560000000p-4', 'Test/Loss': '0x1.3b59da0000000p+1'},
    {'Train/Loss': '0x1.331b900000000p+1', 'Train/Acc': '0x1.4141420000000p-3', 'Test/Acc': '0x1.5555560000000p-4', 'Test/Loss': '0x1.37b72a0000000p+1'},
    {'Train/Loss': '0x1.2ffab00000000p+1', 'Train/Acc': '0x1.9191920000000p-3', 'Test/Acc': '0x1.5555560000000p-3', 'Test/Loss': '0x1.2e855a0000000p+1'},
],
'fedprox-scan-0': [
    {'Train/Loss': '0x1.3711f00000000p+1', 'Train/Acc': '0x1.e1e1e20000000p-4', 'Test/Acc': '0x1.5555560000000p-4', 'Test/Loss': '0x1.3d8fa20000000p+1'},
    {'Train/Loss': '0x1.359aec0000000p+1', 'Train/Acc': '0x1.4141420000000p-3', 'Test/Acc': '0x1.5555560000000p-4', 'Test/Loss': '0x1.3b78fe0000000p+1'},
    {'Train/Loss': '0x1.325f1c0000000p+1', 'Train/Acc': '0x1.69696a0000000p-3', 'Test/Acc': '0x1.5555560000000p-3', 'Test/Loss': '0x1.32b0f20000000p+1'},
],
'fedprox-vmap-0': [
    {'Train/Loss': '0x1.3711f00000000p+1', 'Train/Acc': '0x1.e1e1e20000000p-4', 'Test/Acc': '0x1.5555560000000p-4', 'Test/Loss': '0x1.3d8fa40000000p+1'},
    {'Train/Loss': '0x1.359aec0000000p+1', 'Train/Acc': '0x1.4141420000000p-3', 'Test/Acc': '0x1.5555560000000p-4', 'Test/Loss': '0x1.3b78fe0000000p+1'},
    {'Train/Loss': '0x1.325f1c0000000p+1', 'Train/Acc': '0x1.69696a0000000p-3', 'Test/Acc': '0x1.5555560000000p-3', 'Test/Loss': '0x1.32b0f20000000p+1'},
],
'fedprox-vmap-2': [
    {'Train/Loss': '0x1.3711f00000000p+1', 'Train/Acc': '0x1.e1e1e20000000p-4', 'Test/Acc': '0x1.5555560000000p-4', 'Test/Loss': '0x1.3d8fa40000000p+1'},
    {'Train/Loss': '0x1.359aec0000000p+1', 'Train/Acc': '0x1.4141420000000p-3', 'Test/Acc': '0x1.5555560000000p-4', 'Test/Loss': '0x1.3b78fe0000000p+1'},
    {'Train/Loss': '0x1.325f1c0000000p+1', 'Train/Acc': '0x1.69696a0000000p-3', 'Test/Acc': '0x1.5555560000000p-3', 'Test/Loss': '0x1.32b0f20000000p+1'},
],
}


def _golden_data():
    rng = np.random.RandomState(3)
    sizes = [13, 4, 9, 11, 6, 8]
    n = sum(sizes)
    x = rng.rand(n + 12, 20).astype(np.float32)
    y = rng.randint(0, 10, n + 12).astype(np.int32)
    starts = np.cumsum([0] + sizes)
    part = {c: np.arange(starts[c], starts[c + 1]) for c in range(len(sizes))}
    return FederatedArrays({"x": x[:n], "y": y[:n]}, part), {"x": x[n:], "y": y[n:]}


@pytest.mark.parametrize("key", sorted(GOLDEN))
def test_fedavg_fedprox_histories_bitwise_unchanged(key):
    algo, mode, pack = key.split("-")
    train, test = _golden_data()
    module = create_model("lr", 10, "mnist", device="cpu", input_shape=(20,))
    trainer = ClientTrainer(module=module, optimizer=sgd(0.1), epochs=2)
    agg = fedavg_aggregator()
    if algo == "fedprox":
        trainer, agg = fedprox_trainer(trainer, 0.1), fedprox_aggregator()
    cfg = SimConfig(client_num_in_total=6, client_num_per_round=4, batch_size=4,
                    comm_round=3, epochs=2, frequency_of_the_test=1, eval_batch_size=8,
                    seed=5, straggler_frac=0.5 if algo == "fedprox" else 0.0,
                    cohort_execution=mode, pack_lanes=int(pack), pipeline_depth=0)
    _, hist = FedSim(trainer, train, test, cfg, aggregator=agg, device="cpu").run()
    got = [{k: v.hex() for k, v in rec.items() if k not in ("round", "round_time")}
           for rec in hist]
    assert got == GOLDEN[key]
