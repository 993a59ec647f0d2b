"""The port's heterogeneous population (fedml_tpu_torch.population and the
FedSim hooks it drives) against the JAX package's, on the same inputs.

Tolerances:
- the population copies (``prng.spawn``, ``Dist`` draws, ``parse_dist``,
  ``parse_population_spec`` and their errors, ``Population.round_view``
  across availability blocks, ``step_budgets``, ``describe``) are numpy
  copies of the reference: bitwise equal, error messages equal;
- traces cross between the packages: a trace saved by either loads in the
  other, with views equal array for array;
- runs of the port against the port: a population-off run against one with
  the identity population (full speed, always available, never dropping),
  and a trace's replay against its generative run, bitwise (the same
  arithmetic on the same staged values); a dropped client's weight is
  exactly 0;
- the port's population run against the JAX engine's, from the same
  converted variables: atol 1e-5 on parameters, losses and eval metrics,
  the FedSim parity tolerance (``tests/test_torch_engine.py``);
- the constructor's conflict errors: the JAX engine's messages, equal.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import numpy as np
import optax
import pytest
import torch

from fedml_tpu import population as jpop
from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.population import prng as jprng
from fedml_tpu.sim import cohort as jcohort
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch import population as tpop
from fedml_tpu_torch.algorithms.base import EmptyRoundError
from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
from fedml_tpu_torch.data.synthetic import gaussian_blobs
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.population import prng as tprng
from fedml_tpu_torch.sim.engine import FedSim, SimConfig

ATOL = 1e-5
CHURN = "speed=lognormal:0,0.5;avail=0.8;avail_block=4;dropout=0.05"
SPECS = [
    CHURN,
    "speed=uniform:0.2,1.5;avail=0.5;avail_block=3;dropout=0.3;drop_frac=uniform:0.1,0.9",
    "speed=zipf:1.7;avail=0.9",
    "speed=const:0.5;dropout=1.0",
    "avail=0.0",
]


def _views_equal(a, b):
    assert a.round_idx == b.round_idx and a.eligible_count == b.eligible_count
    for f in ("cohort", "speed", "dropped", "drop_frac", "jitter_s"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


# -- numpy copies: bitwise ---------------------------------------------------


@pytest.mark.parametrize("seed,stream,index", [(0, 1, 0), (7, 3, 12), (2**40, 5, 999)])
def test_spawn_bitwise(seed, stream, index):
    np.testing.assert_array_equal(tprng.spawn(seed, stream, index).random_sample(16),
                                  jprng.spawn(seed, stream, index).random_sample(16))


@pytest.mark.parametrize("spec", ["const:0.7", "uniform:0.2,1.5", "lognormal:0,0.5",
                                  "zipf:1.7"])
def test_dist_draws_bitwise(spec):
    t, j = tpop.parse_dist(spec), jpop.parse_dist(spec)
    assert (t.name, t.params, t.to_string()) == (j.name, j.params, j.to_string())
    np.testing.assert_array_equal(t.draw(tprng.spawn(3, 1), 64), j.draw(jprng.spawn(3, 1), 64))


def _error(fn, *args):
    with pytest.raises(Exception) as info:
        fn(*args)
    return type(info.value), str(info.value)


@pytest.mark.parametrize("spec", ["gauss:1", "uniform", "uniform:1", "uniform:2,1",
                                  "lognormal:0,-1", "zipf:1", "const:x"])
def test_parse_dist_errors_match(spec):
    assert _error(tpop.parse_dist, spec) == _error(jpop.parse_dist, spec)


@pytest.mark.parametrize("spec", SPECS + ["jitter=lognormal:0,1;avail_block=2"])
def test_parse_population_spec_matches(spec):
    t, j = tpop.parse_population_spec(spec), jpop.parse_population_spec(spec)
    assert t.to_string() == j.to_string()
    assert (t.jitter_active, t.avail, t.avail_block, t.dropout) == (
        j.jitter_active, j.avail, j.avail_block, j.dropout)


@pytest.mark.parametrize("spec", ["", "speed", "speed=", "speed=const:1;speed=const:2",
                                  "colour=red", "avail=1.5", "avail_block=0",
                                  "dropout=-0.1", "avail=abc"])
def test_parse_population_spec_errors_match(spec):
    assert (_error(tpop.parse_population_spec, spec)
            == _error(jpop.parse_population_spec, spec))


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 11])
def test_round_views_and_budgets_bitwise(spec, seed):
    """Rounds 0-9 cross availability blocks of 3 and 4 rounds."""
    t, j = tpop.Population(spec, 40, seed), jpop.Population(spec, 40, seed)
    np.testing.assert_array_equal(t.speed, j.speed)
    assert t.describe() == j.describe()
    for r in range(10):
        np.testing.assert_array_equal(t.availability_mask(r), j.availability_mask(r))
        tv, jv = t.round_view(r, 7), j.round_view(r, 7)
        _views_equal(tv, jv)
        for nominal in (1, 6, 318):
            for a, b in zip(tpop.step_budgets(tv, nominal), jpop.step_budgets(jv, nominal)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_population_errors_match():
    for args in ((CHURN, 0), ("speed=wobbly:1", 4)):
        assert _error(tpop.Population, *args) == _error(jpop.Population, *args)


# -- traces cross between the packages ---------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trace_crosses_packages(tmp_path, writer):
    save = (jpop if writer == "jax" else tpop).save_trace
    load = (tpop if writer == "jax" else jpop).load_trace
    pop = (jpop if writer == "jax" else tpop).Population(CHURN, 30, 5)
    path = save(tmp_path / "trace.jsonl", pop, rounds=9, cohort_size=6)
    replay = load(path)
    assert replay.rounds == list(range(9)) and replay.num_clients == 30
    assert not replay.jitter_active
    for r in range(9):
        _views_equal(replay.round_view(r, 6), pop.round_view(r, 6))
    t, j = tpop.load_trace(path), jpop.load_trace(path)
    assert t.describe() == j.describe()
    assert _error(t.round_view, 9, 6) == _error(j.round_view, 9, 6)
    assert _error(t.round_view, 0, 5) == _error(j.round_view, 0, 5)


def test_trace_load_errors_match(tmp_path):
    path = tpop.save_trace(tmp_path / "t.jsonl", tpop.Population(CHURN, 10, 0), 3, 4)
    lines = path.read_text().splitlines()
    cases = {
        "empty.jsonl": "",
        "kind.jsonl": lines[0].replace("fedml_tpu_population_trace", "other") + "\n",
        "truncated.jsonl": "\n".join(lines[:-1]) + "\n",
        "duplicate.jsonl": "\n".join(lines + lines[-1:]) + "\n",
    }
    for name, text in cases.items():
        bad = tmp_path / name
        bad.write_text(text)
        assert _error(tpop.load_trace, bad) == _error(jpop.load_trace, bad), name


# -- FedSim under a population -----------------------------------------------


def _blobs():
    return gaussian_blobs(n_clients=12, samples_per_client=20, num_classes=4, dim=16,
                          partition_method="hetero", partition_alpha=0.5, seed=0)


def _cfg(**kw):
    base = dict(client_num_in_total=12, client_num_per_round=5, batch_size=6, comm_round=6,
                epochs=2, frequency_of_the_test=3, eval_batch_size=16, seed=0)
    base.update(kw)
    return base


def _sim(train=None, test=None, **kw):
    if train is None:
        train, test = _blobs()
    trainer = ClientTrainer(module=create_model("lr", 4, device="cpu", input_shape=(16,)),
                            optimizer=sgd(0.2), epochs=2)
    return FedSim(trainer, train, test, SimConfig(**_cfg(**kw)), device="cpu")


def _strip(history):
    return [{k: v for k, v in rec.items() if k != "round_time"} for rec in history]


def _run(sim, init):
    return sim.run(variables={k: t.clone() for k, t in init.items()})


def test_population_off_equals_identity_population():
    """The identity population (full speed, always available, no dropout)
    samples the reference's cohorts and budgets, so its run is bitwise the
    population-off run, which goes through none of the population hooks."""
    off = _sim()
    assert off._population is None and off.population_summary() == {}
    init = off.init_variables()
    v_off, h_off = _run(off, init)
    v_id, h_id = _run(_sim(population="speed=const:1"), init)
    assert _strip(h_off) == _strip(h_id)
    for k in v_off:
        assert torch.equal(v_off[k], v_id[k]), k


@pytest.mark.parametrize("pack_lanes", [0, 2])
def test_trace_replay_equals_generative_run(tmp_path, pack_lanes):
    gen = _sim(population=CHURN, pack_lanes=pack_lanes)
    init = gen.init_variables()
    v_gen, h_gen = _run(gen, init)
    path = tpop.save_trace(tmp_path / "churn.jsonl", tpop.Population(CHURN, 12, 0), 6, 5)
    replay = _sim(population_trace=str(path), pack_lanes=pack_lanes)
    assert replay.population_summary()["kind"] == "trace"
    v_rep, h_rep = _run(replay, init)
    assert _strip(h_gen) == _strip(h_rep)
    for k in v_gen:
        assert torch.equal(v_gen[k], v_rep[k]), k


def test_population_seed_draws_another_realization():
    a = _sim(population=CHURN)
    b = _sim(population=CHURN, population_seed=3)
    c = _sim(population=CHURN, population_seed=0)
    assert a.population_summary() == c.population_summary() != b.population_summary()


def test_dropped_clients_get_weight_zero():
    spec = "dropout=0.5;drop_frac=uniform:0.2,0.8"
    sim = _sim(population=spec)
    pop = tpop.Population(spec, 12, 0)
    dropped_somewhere = False
    for r in range(6):
        view = pop.round_view(r, 5)
        cohort = sim._sample_cohort(r)
        np.testing.assert_array_equal(cohort, view.cohort)
        _, weights, budgets = sim._host_cohort_indices(cohort, r)
        actual, _ = tpop.step_budgets(view, 2 * sim._steps)
        np.testing.assert_array_equal(budgets, actual)
        assert (weights[view.dropped] == 0.0).all() and (weights[~view.dropped] > 0).all()
        dropped_somewhere |= bool(view.dropped.any())
    assert dropped_somewhere


def test_churned_cohort_pads_empty_slots():
    """Fewer eligible clients than the cohort wants: the tail slots are
    empty (-1), train nothing and weigh 0."""
    sim = _sim(population="avail=0.25", client_num_per_round=8)
    for r in range(4):
        cohort = sim._sample_cohort(r)
        if (cohort < 0).any():
            _, weights, budgets = sim._host_cohort_indices(cohort, r)
            assert (weights[cohort < 0] == 0).all() and (budgets[cohort < 0] == 0).all()
            break
    else:
        pytest.fail("no round with an empty slot")
    _, history = sim.run()
    assert all(np.isfinite(rec["Train/Loss"]) for rec in history)


@pytest.mark.parametrize("spec,what", [("avail=0.0", "no eligible clients"),
                                       ("dropout=1.0", "dropped mid-round")])
def test_empty_round_raises(spec, what):
    sim = _sim(population=spec)
    with pytest.raises(EmptyRoundError, match=what):
        sim.stage_round(0)
    with pytest.raises(EmptyRoundError, match="round 0"):
        sim.run()


@pytest.mark.parametrize("pack_lanes", [0, 2])
def test_population_run_matches_jax_engine(pack_lanes):
    """The port's population run (padded, and packed) against the JAX
    engine's padded one, from the same converted variables."""
    train, test = _blobs()
    kw = _cfg(population=CHURN, train_eval_samples=100)
    jsim = JaxSim(JaxTrainer(module=JaxLR(num_classes=4), optimizer=optax.sgd(0.2), epochs=2),
                  jcohort.FederatedArrays(train.arrays, train.partition), test, JaxConfig(**kw))
    tsim = _sim(train, test, population=CHURN, train_eval_samples=100, pack_lanes=pack_lanes)
    j_vars = jsim.init_round_variables()
    t_vars = convert.from_flax(jax.tree.map(np.asarray, dict(j_vars)))
    j_out, j_hist = jsim.run(variables=j_vars)
    t_out, t_hist = tsim.run(variables=t_vars)
    back = convert.to_flax(t_out)
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(j_out))[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=ATOL, err_msg=str(path))
    assert [r["round"] for r in t_hist] == [r["round"] for r in j_hist]
    for t_rec, j_rec in zip(t_hist, j_hist):
        for k in set(j_rec) - {"round", "round_time"}:
            assert abs(t_rec[k] - j_rec[k]) <= ATOL, (k, t_rec, j_rec)
    assert tsim.population_summary() == jsim.population_summary()


# -- the constructor's conflicts: the JAX engine's errors ---------------------


def _jax_error(**kw):
    train, test = _blobs()
    return _error(lambda: JaxSim(JaxTrainer(module=JaxLR(num_classes=4),
                                            optimizer=optax.sgd(0.2)),
                                 jcohort.FederatedArrays(train.arrays, train.partition), test,
                                 JaxConfig(**_cfg(**kw))))


def _port_error(**kw):
    return _error(lambda: _sim(**kw))


def test_constructor_errors_match_jax(tmp_path):
    plain = tpop.save_trace(tmp_path / "plain.jsonl", tpop.Population(CHURN, 12, 0), 2, 5)
    other = tpop.save_trace(tmp_path / "other.jsonl", tpop.Population(CHURN, 9, 0), 2, 5)
    jitter = tpop.save_trace(tmp_path / "jitter.jsonl",
                             tpop.Population("jitter=uniform:0.1,0.5", 12, 0), 2, 5)
    cases = [
        dict(population=CHURN, population_trace=str(plain)),
        dict(population=CHURN, straggler_frac=0.5),
        dict(population="jitter=lognormal:0,1"),
        dict(population_trace=str(other)),
        dict(population_trace=str(jitter)),
        dict(population="speed=fast:1"),
    ]
    for kw in cases:
        port, jax_ = _port_error(**kw), _jax_error(**kw)
        assert port == jax_, kw
