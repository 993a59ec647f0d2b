"""Hierarchical FedAvg in the port (``fedml_tpu_torch/algorithms/hierarchical.py``)
against the JAX package's.

Tolerances: the group draw bitwise (the same seeded numpy permutation); a
LogisticRegression run of 3 global rounds x 2 groups x 2 group rounds from
the same converted initial variables against the JAX run: atol 1e-5 on the
final parameters and on every global round's eval record.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import numpy as np
import optax
import pytest

from fedml_tpu.algorithms import hierarchical as jhier
from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.sim import cohort as jcohort
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import hierarchical
from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import FedSim, SimConfig


@pytest.mark.parametrize("n,g,seed", [(10, 2, 0), (1000, 2, 0), (37, 5, 3), (7, 7, 11)])
def test_group_assignment_bitwise(n, g, seed):
    want = jhier.random_group_assignment(n, g, seed)
    got = hierarchical.random_group_assignment(n, g, seed)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_hierarchical_lr_matches_jax(monkeypatch, rng, mode):
    sizes = [13, 4, 9, 11, 6, 8, 10, 5, 7, 12, 3, 9]
    n = sum(sizes)
    x = rng.rand(n + 20, 20).astype(np.float32)
    y = rng.randint(0, 10, n + 20).astype(np.int32)
    starts = np.cumsum([0, *sizes])
    part = {c: np.arange(starts[c], starts[c + 1]) for c in range(len(sizes))}
    arrays, test = {"x": x[:n], "y": y[:n]}, {"x": x[n:], "y": y[n:]}
    kw = dict(client_num_in_total=len(sizes), client_num_per_round=4, batch_size=4,
              comm_round=3, epochs=1, frequency_of_the_test=1, eval_batch_size=8, seed=2,
              cohort_execution=mode)
    hier = dict(group_num=2, global_comm_round=3, group_comm_round=2)
    jsim = JaxSim(JaxTrainer(module=JaxLR(num_classes=10), optimizer=optax.sgd(0.1)),
                  jcohort.FederatedArrays(arrays, part), test, JaxConfig(**kw))
    init = convert.from_flax(jax.tree.map(np.asarray, dict(jsim.init_variables())))
    j_vars, j_hist = jhier.HierarchicalFedAvg(jsim, jhier.HierConfig(**hier)).run()
    module = create_model("lr", 10, "mnist", device="cpu", input_shape=(20,))
    tsim = FedSim(ClientTrainer(module=module, optimizer=sgd(0.1)),
                  FederatedArrays(arrays, part), test, SimConfig(**kw), device="cpu")
    monkeypatch.setattr(tsim, "init_variables", lambda: {k: v.clone() for k, v in init.items()})
    seen = []
    t_vars, t_hist = hierarchical.HierarchicalFedAvg(
        tsim, hierarchical.HierConfig(**hier)).run(callback=seen.append)
    assert seen == t_hist and len(t_hist) == len(j_hist) == 3
    for got, want in zip(t_hist, j_hist):
        assert set(got) == set(want) and got["round"] == want["round"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    back = convert.to_flax(t_vars)
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(j_vars))[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=1e-5, err_msg=str(path))
