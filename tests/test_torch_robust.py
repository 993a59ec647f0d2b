"""The robust defenses in the port (``fedml_tpu_torch/algorithms/robust.py``)
against the JAX package's, on the same numpy-made stacks.

Tolerances:

- clipping, the coordinate median (odd and even C: both take the midpoint
  of the sorted column, so they agree bitwise), the trimmed mean and the
  ``Robust/*`` metrics: atol 1e-6 (f32 sums in other orders);
- Krum: the index against a float64 numpy oracle of the Krum rule, and the
  output bitwise the selected client. The JAX ``krum_select`` adds
  ``eye(C) * inf`` to exclude each client's distance to itself, which is NaN
  off the diagonal, so it returns client 0 whatever the stack:
  ``test_krum_reference_fault`` shows it, the one place where the port
  departs from the JAX package;
- the weak-DP noise: a pure function of (seed, round) (a draw repeated is
  bitwise the same; the next round's differs), its standard deviation
  within 5% of the configured one over 10^5 draws;
- FedSim rounds with each rule and stddev 0 against the JAX engine from the
  same converted initial variables, 8 clients a round (the JAX engine pads
  a cohort to a multiple of its 8-device CPU mesh with zero-weight copies
  of the global model, which the port has no mesh to need): atol 1e-5 for LogisticRegression, 1e-4
  for LeNet (two SGD steps a client through two convolutions). For Krum the
  JAX engine runs with its ``krum_select`` replaced by the Krum rule;
- packed lanes against the padded round for FedNova and the median: bitwise
  on the CPU.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms import fednova as jfednova
from fedml_tpu.algorithms import robust as jrobust
from fedml_tpu.core import rng as jrng
from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.models.cnn import LeNet as JaxLeNet
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.sim import cohort as jcohort
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fednova, robust
from fedml_tpu_torch.core.rng import RoundNoise
from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.obs import metrics as metricslib
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import FedSim, SimConfig


def _flax_tree(rng, lead=()):
    def r(*shape):
        return rng.randn(*lead, *shape).astype(np.float32)

    return {"params": {"Dense_0": {"kernel": r(6, 4), "bias": r(4)},
                       "BatchNorm_0": {"scale": r(4), "bias": r(4)}},
            "batch_stats": {"BatchNorm_0": {"mean": r(4), "var": np.abs(r(4))}}}


def _port_stack(stacked, c):
    per = [convert.from_flax(jax.tree.map(lambda a: a[i], stacked)) for i in range(c)]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


def _close(want, got_sd, atol=1e-6, exact=False):
    back = convert.to_flax(got_sd)
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(want))[0]:
        node = back
        for p in path:
            node = node[p.key]
        if exact:
            np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=str(path))
        else:
            np.testing.assert_allclose(node, np.asarray(leaf), atol=atol, err_msg=str(path))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_clip_matches_jax(rng):
    c = 5
    g, stacked = _flax_tree(rng), _flax_tree(rng, lead=(c,))
    want = jrobust.clip_deltas(_jnp(g), _jnp(stacked), 1.5)
    got = robust.clip_deltas(convert.from_flax(g), _port_stack(stacked, c), 1.5)
    for i in range(c):
        _close(jax.tree.map(lambda a: a[i], want), {k: v[i] for k, v in got.items()})
    _, jn = jrobust.delta_norms(_jnp(g), _jnp(stacked))
    _, tn = robust.delta_norms(convert.from_flax(g), _port_stack(stacked, c))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)


@pytest.mark.parametrize("c", [5, 6])
def test_median_matches_jax_bitwise(rng, c):
    stacked = _flax_tree(rng, lead=(c,))
    _close(jrobust.coordinate_median(_jnp(stacked)),
           robust.coordinate_median(_port_stack(stacked, c)), exact=True)


@pytest.mark.parametrize("c,ratio", [(10, 0.1), (7, 0.3)])
def test_trimmed_mean_matches_jax(rng, c, ratio):
    stacked = _flax_tree(rng, lead=(c,))
    _close(jrobust.trimmed_mean(_jnp(stacked), ratio),
           robust.trimmed_mean(_port_stack(stacked, c), ratio))


def test_error_cases_match_jax(rng):
    stacked = _flax_tree(rng, lead=(4,))
    for fn in (lambda m: m.trimmed_ratio_k(4, 0.5), lambda m: m.trimmed_ratio_k(2, 0.5)):
        with pytest.raises(ValueError) as theirs:
            fn(jrobust)
        with pytest.raises(ValueError) as ours:
            fn(robust)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError) as theirs:
        jrobust.krum_select(_jnp(stacked), num_byzantine=2)
    with pytest.raises(ValueError) as ours:
        robust.krum_select(_port_stack(stacked, 4), num_byzantine=2)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError) as theirs:
        jrobust.RobustConfig(rule="mode")
    with pytest.raises(ValueError) as ours:
        robust.RobustConfig(rule="mode")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("rule", ["mean", "median", "trimmed_mean", "krum"])
def test_robust_aggregator_and_metrics_match_jax(monkeypatch, rng, rule):
    if rule == "krum":
        monkeypatch.setattr(jrobust, "krum_select", _correct_jax_krum)
    c = 10
    g, stacked = _flax_tree(rng), _flax_tree(rng, lead=(c,))
    stacked["params"]["Dense_0"]["kernel"][4] += 50.0
    weights = rng.randint(1, 20, c).astype(np.float32)
    weights[7] = 0.0  # a dropped client: out of the metrics, in the stack
    cfg = dict(norm_bound=2.0, rule=rule)
    want, _, jm = jrobust.robust_aggregator(jrobust.RobustConfig(**cfg)).aggregate(
        _jnp(g), _jnp(stacked), jnp.asarray(weights), (), None)
    agg = robust.robust_aggregator(robust.RobustConfig(**cfg))
    got, _, tm = agg.aggregate(convert.from_flax(g), _port_stack(stacked, c),
                               torch.tensor(weights), ())
    _close(want, got)
    assert set(tm) == set(jm) == {metricslib.ROBUST_UPDATE_NORM, metricslib.ROBUST_FILTERED,
                                  metricslib.ROBUST_CLIP_FRACTION}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6, err_msg=k)


def _krum_oracle(mat: np.ndarray, f: int) -> int:
    mat = mat.astype(np.float64)
    c = len(mat)
    d2 = ((mat[:, None, :] - mat[None, :, :]) ** 2).sum(-1)
    scores = [np.sort(np.delete(d2[i], i))[: c - f - 2].sum() for i in range(c)]
    return int(np.argmin(scores))


def _params_matrix(stacked_sd):
    return np.concatenate([v.reshape(v.shape[0], -1).numpy() for k, v in stacked_sd.items()
                           if not k.endswith(("running_mean", "running_var"))], axis=1)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("f", [1, 2])
def test_krum_matches_numpy_oracle(seed, f):
    rng = np.random.RandomState(seed)
    c = 8
    stacked = _flax_tree(rng, lead=(c,))
    stacked["params"]["Dense_0"]["kernel"][rng.randint(c)] += 30.0
    sd = _port_stack(stacked, c)
    idx = int(robust.krum_select(sd, f))
    assert idx == _krum_oracle(_params_matrix(sd), f)
    out, _, _ = robust.robust_aggregator(robust.RobustConfig(rule="krum", num_byzantine=f)
                                         ).aggregate(convert.from_flax(_flax_tree(rng)), sd,
                                                     torch.ones(c), ())
    for k, v in sd.items():
        assert torch.equal(out[k], v[idx])


def test_krum_reference_fault(rng):
    """The JAX ``krum_select`` scores every client NaN (``0 * inf`` off the
    diagonal of ``eye(C) * inf``) and returns client 0, even when client 0 is
    the outlier; the port returns an inlier."""
    c = 6
    stacked = _flax_tree(rng, lead=(c,))
    for leaf in jax.tree_util.tree_leaves(stacked["params"]):
        leaf[0] += 100.0
    assert int(jrobust.krum_select(_jnp(stacked))) == 0
    sd = _port_stack(stacked, c)
    idx = int(robust.krum_select(sd))
    assert idx != 0
    assert idx == _krum_oracle(_params_matrix(sd), 1)


def test_dp_noise_is_a_pure_function_of_seed_and_round():
    a = RoundNoise(7, 3).normal((100_000,))
    b = RoundNoise(7, 3).normal((100_000,))
    assert torch.equal(a, b)
    assert not torch.equal(a, RoundNoise(7, 4).normal((100_000,)))
    assert not torch.equal(a, RoundNoise(8, 3).normal((100_000,)))
    noise = RoundNoise(7, 3)
    first, second = noise.normal((4,)), noise.normal((4,))
    assert not torch.equal(first, second)  # each draw of a round its own
    # through the aggregator: the aggregate of identical clients plus noise
    g = {"w": torch.zeros(100_000), "b": torch.zeros(3)}
    stacked = {k: torch.zeros((4,) + v.shape) for k, v in g.items()}
    agg = robust.robust_aggregator(robust.RobustConfig(stddev=0.05))
    out, _, _ = agg.aggregate(g, stacked, torch.ones(4), (), RoundNoise(7, 3))
    assert abs(float(out["w"].std()) - 0.05) < 0.05 * 0.05
    assert torch.equal(out["w"], RoundNoise(7, 3).normal((100_000,)) * 0.05)
    again, _, _ = agg.aggregate(g, stacked, torch.ones(4), (), RoundNoise(7, 3))
    assert torch.equal(out["w"], again["w"])
    later, _, _ = agg.aggregate(g, stacked, torch.ones(4), (), RoundNoise(7, 4))
    assert not torch.equal(out["w"], later["w"])


def _correct_jax_krum(stacked, num_byzantine=1):
    """The JAX krum_select with self excluded by a mask instead of ``0 *
    inf``: the JAX pipeline around a correct Krum, what the port is held
    to."""
    from fedml_tpu.core import tree as jtree

    c = jax.tree_util.tree_leaves(stacked)[0].shape[0]
    mat = jax.vmap(lambda i: jtree.tree_vectorize(
        jax.tree.map(lambda s: s[i], stacked), exclude=jrobust._is_norm_stat))(jnp.arange(c))
    d2 = jnp.sum((mat[:, None, :] - mat[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(jnp.eye(c, dtype=bool), jnp.inf, d2)
    return jnp.argmin(jnp.sum(jnp.sort(d2, axis=1)[:, : c - num_byzantine - 2], axis=1))


def _data(rng, image, sizes=(13, 4, 9, 11, 6, 8)):
    n = sum(sizes)
    shape = (28, 28) if image else (20,)
    x = rng.rand(n + 12, *shape).astype(np.float32)
    y = rng.randint(0, 10, n + 12).astype(np.int32)
    starts = np.cumsum([0, *sizes])
    part = {c: np.arange(starts[c], starts[c + 1]) for c in range(len(sizes))}
    return {"x": x[:n], "y": y[:n]}, part, {"x": x[n:], "y": y[n:]}


RULES = {"mean": dict(rule="mean", norm_bound=0.3),
         "median": dict(rule="median", norm_bound=0.3),
         "trimmed_mean": dict(rule="trimmed_mean", trim_ratio=0.25),
         "krum": dict(rule="krum")}


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("model,lr,atol", [("lr", 0.1, 1e-5), ("lenet", 0.05, 1e-4)])
def test_fedsim_rule_matches_jax_engine(monkeypatch, rng, rule, model, lr, atol):
    if rule == "krum":
        monkeypatch.setattr(jrobust, "krum_select", _correct_jax_krum)
    # 8 a round: the JAX engine pads a cohort to a multiple of its 8-device
    # CPU mesh with zero-weight copies of the global model, which an order
    # statistic would read
    arrays, part, test = _data(rng, image=model == "lenet",
                               sizes=(13, 4, 9, 11, 6, 8, 7, 10, 5, 12))
    kw = dict(client_num_in_total=10, client_num_per_round=8, batch_size=8, comm_round=2,
              epochs=1, frequency_of_the_test=1, eval_batch_size=8, seed=5,
              cohort_execution="vmap")
    jmodule = JaxLeNet(num_classes=10) if model == "lenet" else JaxLR(num_classes=10)
    jsim = JaxSim(JaxTrainer(module=jmodule, optimizer=optax.sgd(lr), epochs=1),
                  jcohort.FederatedArrays(arrays, part), test, JaxConfig(**kw),
                  aggregator=jrobust.robust_aggregator(jrobust.RobustConfig(**RULES[rule])))
    tmodule = create_model(model, 10, "mnist", device="cpu", input_shape=arrays["x"].shape[1:])
    tsim = FedSim(ClientTrainer(module=tmodule, optimizer=sgd(lr), epochs=1),
                  FederatedArrays(arrays, part), test, SimConfig(**kw),
                  aggregator=robust.robust_aggregator(robust.RobustConfig(**RULES[rule])),
                  device="cpu")
    j_vars = jsim.init_round_variables()
    t_vars = convert.from_flax(jax.tree.map(np.asarray, dict(j_vars)))
    root = jrng.root_key(kw["seed"])
    for r in range(kw["comm_round"]):
        j_vars, _, j_m = jsim.run_round(r, j_vars, (), root)
        t_vars, _, t_m = tsim.run_round(r, t_vars, ())
        _close(j_vars, t_vars, atol=atol)
        assert set(t_m) == set(j_m)
        for k in j_m:
            np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), atol=atol, err_msg=k)


def test_simconfig_robust_fields_build_the_rule_and_conflict(rng):
    arrays, part, test = _data(rng, image=False)
    module = create_model("lr", 10, "mnist", device="cpu", input_shape=(20,))
    trainer = ClientTrainer(module=module, optimizer=sgd(0.1))
    cfg = SimConfig(client_num_in_total=6, client_num_per_round=4, batch_size=8,
                    robust_rule="median", norm_bound=1.0, dp_stddev=0.01)
    sim = FedSim(trainer, FederatedArrays(arrays, part), test, cfg, device="cpu")
    assert sim.aggregator.name == "robust-median" and sim.aggregator.stacked
    _, _, m = sim.run_round(0, sim.init_round_variables(), ())
    assert metricslib.ROBUST_CLIP_FRACTION in m
    with pytest.raises(ValueError) as theirs:
        JaxSim(JaxTrainer(module=JaxLR(num_classes=10), optimizer=optax.sgd(0.1)),
               jcohort.FederatedArrays(arrays, part), test,
               JaxConfig(client_num_in_total=6, client_num_per_round=4, robust_rule="median"),
               aggregator=jfednova.fednova_aggregator(0.1))
    with pytest.raises(ValueError) as ours:
        FedSim(trainer, FederatedArrays(arrays, part), test, dataclass_replace(cfg),
               aggregator=fednova.fednova_aggregator(0.1), device="cpu")
    assert str(ours.value) == str(theirs.value)


def dataclass_replace(cfg):
    import dataclasses

    return dataclasses.replace(cfg, norm_bound=0.0, dp_stddev=0.0)


@pytest.mark.parametrize("rule", ["fednova", "median"])
def test_packed_equals_padded_bitwise(rng, rule):
    arrays, part, test = _data(rng, image=False)
    hists = []
    for pack in (0, 2):
        module = create_model("lr", 10, "mnist", device="cpu", input_shape=(20,))
        agg = (fednova.fednova_aggregator(0.1, batch_size=4, epochs=2, max_client_samples=13)
               if rule == "fednova" else
               robust.robust_aggregator(robust.RobustConfig(rule="median", norm_bound=0.3)))
        cfg = SimConfig(client_num_in_total=6, client_num_per_round=4, batch_size=4,
                        comm_round=3, epochs=2, frequency_of_the_test=3, eval_batch_size=8,
                        seed=5, straggler_frac=0.5, pack_lanes=pack, pipeline_depth=0)
        variables, hist = FedSim(ClientTrainer(module=module, optimizer=sgd(0.1), epochs=2),
                                 FederatedArrays(arrays, part), test, cfg, aggregator=agg,
                                 device="cpu").run()
        hists.append(([{k: v for k, v in r.items() if k != "round_time"} for r in hist],
                      variables))
    (h0, v0), (h1, v1) = hists
    assert h0 == h1
    assert all(torch.equal(v0[k], v1[k]) for k in v0)


def test_cli_flags_match_jax():
    import argparse

    ours = robust.add_cli_flags(argparse.ArgumentParser())
    theirs = jrobust.add_cli_flags(argparse.ArgumentParser())

    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         tuple(a.choices) if a.choices else None)
                for a in parser._actions if a.dest != "help"}

    assert table(ours) == table(theirs)
    argv = ["--robust_rule", "krum", "--norm_bound", "2.0", "--dp_stddev", "0.1"]
    assert robust.sim_config_fields(ours.parse_args(argv)) == jrobust.sim_config_fields(
        theirs.parse_args(argv))
    SimConfig(**robust.sim_config_fields(ours.parse_args(argv)))
