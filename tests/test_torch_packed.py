"""The port's packed-lane execution (``SimConfig.pack_lanes``): the planners
(``sim/cohort.py``), the lane step (``core/trainer.py``) and FedSim's packed
rounds, against the JAX package's planners, the port's padded rounds and the
JAX engine's packed rounds. On the CPU a packed round runs its passes
eagerly; on the card each pass is a CUDA graph replay, which
``chip_smoke.py`` holds to the padded rounds (``[packed femnist]``,
``[packed overflow]``, ``[population]``).

Tolerances:
- ``executed_steps``, ``pack_cohort`` (with and without predicted steps, 1
  and 2 shards, forced overflow) and ``pack_index_map`` are numpy copies of
  the reference: bitwise equal, errors equal;
- port packed against port padded (LR on the JAX test's uniform and
  power-law sizes with stragglers, host staging, a capacity factor of 0.01,
  a CNNDropOut with its dropout masks, a population with churn):
  variables and every eval metric bitwise equal, ``Train/Loss`` within
  rtol 1e-6 (the JAX contract, ``tests/test_packed_lanes.py``; measured
  bitwise here). The CNN's convs run grouped over 2 lanes instead of the
  cohort's 4 clients; on the CPU that changes no bit;
- port packed against the JAX engine's packed rounds on one mesh device,
  from the same converted variables: atol 1e-5 on parameters, losses and
  eval metrics (the FedSim parity tolerance, ``tests/test_torch_engine.py``);
- the lane step's reset against a fresh start: bitwise;
- the constructor's and the CLI's conflict errors: the JAX package's
  messages, equal.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse

import jax
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.parallel import mesh as meshlib
from fedml_tpu.sim import cohort as jcohort
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms.base import Aggregator
from fedml_tpu_torch.core.trainer import ClientTrainer, _functional_step, make_lane_step, sgd
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.sim import cohort as tcohort
from fedml_tpu_torch.sim.engine import FedSim, PackedStaged, SimConfig, resolve_dispatch

ATOL = 1e-5
UNIFORM = [33] * 6
POWERLAW = [97, 41, 24, 12, 9, 6]  # tests/test_packed_lanes.py:41-42
CHURN = "speed=lognormal:0,0.5;avail=0.8;avail_block=4;dropout=0.05"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CNN rounds on one torch thread (beside the suite's other workers
    a thread per core oversubscribes the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fixture(sizes, num_classes=4, dim=12, seed=3, image=None):
    """Blobs with explicit per-client sizes (the JAX test's fixture); with
    ``image``, random ``image x image`` pictures instead."""
    rng = np.random.RandomState(seed)
    n = int(sum(sizes))
    centers = rng.normal(0.0, 2.0, (num_classes, dim))
    y = rng.randint(0, num_classes, n).astype(np.int32)
    x = (centers[y] + rng.normal(0.0, 0.6, (n, dim))).astype(np.float32)
    if image:
        x = rng.rand(n, image, image).astype(np.float32)
    bounds = np.cumsum([0] + list(sizes))
    part = {i: np.arange(bounds[i], bounds[i + 1]) for i in range(len(sizes))}
    return {"x": x, "y": y}, part, {"x": x[: 4 * num_classes], "y": y[: 4 * num_classes]}


# -- the planners: bitwise copies --------------------------------------------


def _plans_equal(a, b):
    assert (a.lanes, a.s_lane, a.total_steps, a.capacity, a.padding_frac) == (
        b.lanes, b.s_lane, b.total_steps, b.capacity, b.padding_frac)
    assert len(a.passes) == len(b.passes)
    for pa, pb in zip(a.passes, b.passes):
        for f in ("slot", "gidx", "sidx", "boundary"):
            x, y = getattr(pa, f), getattr(pb, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=f)


def _error(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


_PLANS = [
    # (C, S, E, lanes, s_lane, shards, predicted, seed)
    (8, 5, 2, 2, 10, 1, False, 0),
    (8, 5, 2, 2, 10, 2, False, 1),
    (8, 5, 2, 3, 10, 2, True, 2),
    (10, 7, 1, 2, 7, 1, True, 3),
    (6, 4, 3, 1, 12, 1, False, 4),    # forced overflow: one lane of 12
    (12, 6, 2, 1, 12, 2, True, 5),    # overflow with dropped clients re-packed
    (4, 3, 1, 2, 3, 1, False, 6),
]


@pytest.mark.parametrize("C,S,E,lanes,s_lane,shards,predicted,seed", _PLANS)
def test_pack_cohort_and_index_map_bitwise(C, S, E, lanes, s_lane, shards, predicted, seed):
    rng = np.random.RandomState(seed)
    num_steps = rng.randint(0, E * S + 1, C).astype(np.int32)
    data_steps = rng.randint(0, S + 1, C)
    pred = None
    if predicted:
        pred = np.minimum(num_steps + rng.randint(0, 3, C) * (rng.rand(C) < 0.4),
                          E * S).astype(np.int32)
    np.testing.assert_array_equal(tcohort.executed_steps(num_steps, data_steps, S, E),
                                  jcohort.executed_steps(num_steps, data_steps, S, E))
    t = tcohort.pack_cohort(num_steps, data_steps, S, E, lanes, s_lane, shards,
                            predicted_steps=pred)
    j = jcohort.pack_cohort(num_steps, data_steps, S, E, lanes, s_lane, shards,
                            predicted_steps=pred)
    _plans_equal(t, j)
    idx = rng.randint(-1, 50, (C, S, 4)).astype(np.int32)
    for pt, pj in zip(t.passes, j.passes):
        np.testing.assert_array_equal(tcohort.pack_index_map(idx, pt),
                                      jcohort.pack_index_map(idx, pj))
    # every client's executed stream is placed exactly once
    totals = tcohort.executed_steps(num_steps, data_steps, S, E).sum(1)
    placed = np.bincount(np.concatenate([p.slot[p.slot >= 0] for p in t.passes] + [[]]
                                        ).astype(int), minlength=C)
    np.testing.assert_array_equal(placed, totals)


def test_pack_cohort_forced_overflow_spills_passes():
    plan = tcohort.pack_cohort(np.full(6, 8), np.full(6, 4), 4, 2, 1, 8)
    assert len(plan.passes) == 6 and plan.capacity == 48 and plan.total_steps == 48


@pytest.mark.parametrize("args,kw", [
    ((np.full(5, 4), np.full(5, 4), 4, 1, 2, 8, 2), {}),
    ((np.full(4, 9), np.full(4, 9), 9, 1, 2, 8, 1), {}),
    ((np.full(4, 4), np.full(4, 4), 4, 1, 2, 8, 1), {"predicted_steps": np.full(4, 3)}),
])
def test_pack_cohort_errors_match(args, kw):
    assert _error(tcohort.pack_cohort, *args, **kw) == _error(jcohort.pack_cohort, *args, **kw)


# -- the lane step ------------------------------------------------------------


def test_lane_step_reset_equals_fresh_start():
    """A lane at ``is_first`` forgets its carry: bitwise the padded step
    from the global model and a fresh optimizer state; elsewhere it steps
    its carry."""
    torch.manual_seed(0)
    module = create_model("lr", 4, device="cpu", input_shape=(6,))
    trainer = ClientTrainer(module=module, optimizer=sgd(0.1, momentum=0.9))
    g = {k: v.detach().clone() for k, v in module.state_dict().items()}
    opt0 = trainer.optimizer.init(g)
    batch = {"x": torch.randn(3, 5, 6), "y": torch.randint(0, 4, (3, 5)),
             "mask": torch.ones(3, 5)}
    carry = {k: torch.randn((3,) + v.shape) for k, v in g.items()}
    carry_opt = {k: torch.randn((3,) + v.shape) for k, v in g.items()}
    is_first = torch.tensor([True, False, True])
    lane = torch.func.vmap(make_lane_step(trainer), in_dims=(0, 0, 0, None, None, 0, 0, None))
    out = lane(carry, {}, carry_opt, g, opt0, batch, is_first, {})
    step = torch.func.vmap(_functional_step(trainer), in_dims=(0, 0, 0, 0, None))
    fresh = step({k: v.expand((3,) + v.shape) for k, v in g.items()}, {},
                 {k: v.expand((3,) + v.shape) for k, v in opt0.items()}, batch, {})
    carried = step(carry, {}, carry_opt, batch, {})
    for i, ref in ((0, fresh), (1, carried), (2, fresh)):
        for a, b in zip(out[:3], ref[:3]):
            for k in a:
                assert torch.equal(a[k][i], b[k][i]), (i, k)
        assert torch.equal(out[3][i], ref[3][i]) and torch.equal(out[4][i], ref[4][i])


# -- packed against padded, the port ------------------------------------------


def _trainer(model, image=None):
    shape = (image, image) if image else (12,)
    module = create_model(model, 4, "femnist", device="cpu", input_shape=shape)
    return ClientTrainer(module=module, optimizer=sgd(0.2), epochs=2)


def _pair(sizes, pack_kw, model="lr", image=None, **cfg_kw):
    arrays, part, test = _fixture(sizes, image=image)
    train = tcohort.FederatedArrays(arrays, part)
    kw = dict(client_num_in_total=len(sizes), client_num_per_round=4, batch_size=8,
              comm_round=4, epochs=2, frequency_of_the_test=2, seed=0)
    kw.update(cfg_kw)
    padded = FedSim(_trainer(model, image), train, test, SimConfig(**kw), device="cpu")
    init = padded.init_variables()
    v_pad, h_pad = padded.run(variables={k: t.clone() for k, t in init.items()})
    packed = FedSim(_trainer(model, image), train, test, SimConfig(**kw, **pack_kw),
                    device="cpu")
    v_pack, h_pack = packed.run(variables={k: t.clone() for k, t in init.items()})
    for k in v_pad:
        assert torch.equal(v_pad[k], v_pack[k]), k
    assert len(h_pad) == len(h_pack) == kw["comm_round"]
    for rec_d, rec_k in zip(h_pad, h_pack):
        assert set(rec_d) == set(rec_k)
        for key, val in rec_d.items():
            if key == "round_time":
                continue
            if key == "Train/Loss":
                np.testing.assert_allclose(rec_k[key], val, rtol=1e-6, atol=1e-9)
                continue
            assert rec_k[key] == val, (key, rec_d, rec_k)
    return packed


@pytest.mark.parametrize("sizes", [UNIFORM, POWERLAW], ids=["uniform", "powerlaw"])
def test_packed_equals_padded(sizes):
    sim = _pair(sizes, {"pack_lanes": 2}, straggler_frac=0.5)
    steps = 2 * -(-np.asarray(sizes) // 8)  # E x a client's batches
    assert sim._s_lane == max(steps.max(), int(np.ceil(1.25 * steps.mean() * 4 / 2)))
    assert not sim._block_dispatch


def test_packed_host_staged_equals_padded():
    sim = _pair(POWERLAW, {"pack_lanes": 2}, stage_on_device=False)
    staged = sim.stage_round(0)
    assert sim._dataset is None and isinstance(staged.passes[0].data, dict)


def test_packed_overflow_passes_equal_padded():
    sim = _pair(POWERLAW, {"pack_lanes": 1, "pack_capacity_factor": 0.01})
    staged = sim._stage_packed_round(np.asarray([0, 1, 2, 3]), 0)
    assert isinstance(staged, PackedStaged)
    assert staged.stats["n_passes"] > 1 and len(staged.passes) == staged.stats["n_passes"]
    assert sim.pack_round_stats(0) == sim.stage_round(0).stats


def test_packed_dropout_cnn_equals_padded():
    """CNNDropOut: each lane step reads its client's slice of the padded
    round's draw at the client's chain step."""
    sim = _pair(POWERLAW, {"pack_lanes": 2}, model="cnn", image=12, comm_round=2,
                frequency_of_the_test=2)
    assert sim.trainer.dropout_sites


def test_packed_population_churn_equals_padded():
    sim = _pair(POWERLAW, {"pack_lanes": 2}, population=CHURN, comm_round=6,
                frequency_of_the_test=3)
    assert sim.population_summary()["kind"] == "generative"
    assert sim.pack_summary() == {"pack_lanes": 2, "s_lane": sim._s_lane,
                                  "lane_capacity_per_pass": 2 * sim._s_lane,
                                  "padded_scan_steps": 4 * 2 * sim._steps}


def test_packed_pipelined_equals_serial():
    arrays, part, test = _fixture(POWERLAW)
    train = tcohort.FederatedArrays(arrays, part)
    runs = []
    for depth in (0, 2):
        cfg = SimConfig(client_num_in_total=6, client_num_per_round=4, batch_size=8,
                        comm_round=4, epochs=2, frequency_of_the_test=2, seed=0,
                        pack_lanes=2, pipeline_depth=depth)
        runs.append(FedSim(_trainer("lr"), train, test, cfg, device="cpu").run())
    assert ([{k: v for k, v in r.items() if k != "round_time"} for r in runs[0][1]]
            == [{k: v for k, v in r.items() if k != "round_time"} for r in runs[1][1]])


# -- port packed against JAX packed ------------------------------------------


@pytest.mark.parametrize("sizes,cfg_kw", [
    (UNIFORM, dict(straggler_frac=0.5)),
    (POWERLAW, dict(straggler_frac=0.5)),
    (POWERLAW, dict(pack_lanes=1, pack_capacity_factor=0.01)),
], ids=["uniform", "powerlaw", "overflow"])
def test_packed_matches_jax_packed(sizes, cfg_kw):
    arrays, part, test = _fixture(sizes)
    kw = dict(client_num_in_total=len(sizes), client_num_per_round=4, batch_size=8,
              comm_round=4, epochs=2, frequency_of_the_test=2, seed=0, pack_lanes=2)
    kw.update(cfg_kw)
    jsim = JaxSim(JaxTrainer(module=JaxLR(num_classes=4), optimizer=optax.sgd(0.2), epochs=2),
                  jcohort.FederatedArrays(arrays, part), test, JaxConfig(**kw),
                  mesh=meshlib.client_mesh(jax.devices()[:1]))
    tsim = FedSim(_trainer("lr"), tcohort.FederatedArrays(arrays, part), test,
                  SimConfig(**kw), device="cpu")
    assert tsim.pack_summary() == jsim.pack_summary()
    for r in range(kw["comm_round"]):
        assert tsim.pack_round_stats(r) == jsim.pack_round_stats(r)
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
    for t_rec, j_rec in zip(t_hist, j_hist):
        assert set(t_rec) == set(j_rec)
        for k in set(j_rec) - {"round", "round_time"}:
            assert abs(t_rec[k] - j_rec[k]) <= ATOL, (k, t_rec, j_rec)


# -- config and CLI checks ----------------------------------------------------


def _engines_error(port_extra=None, jax_extra=None, **kw):
    arrays, part, test = _fixture(POWERLAW)
    base = dict(client_num_in_total=6, client_num_per_round=4, batch_size=8, comm_round=1)
    base.update(kw)
    port = _error(lambda: FedSim(_trainer("lr"), tcohort.FederatedArrays(arrays, part), test,
                                 SimConfig(**base), device="cpu", **(port_extra or {})))
    jax_ = _error(lambda: JaxSim(JaxTrainer(module=JaxLR(num_classes=4),
                                            optimizer=optax.sgd(0.2)),
                                 jcohort.FederatedArrays(arrays, part), test,
                                 JaxConfig(**base), **(jax_extra or {})))
    return port, jax_


def _custom_round(*args):
    raise AssertionError("never called")


@pytest.mark.parametrize("case", ["negative", "scan", "blocks", "local_train_fn"])
def test_pack_conflicts_raise_the_jax_errors(case):
    kw, port_extra, jax_extra = {"pack_lanes": 2}, None, None
    if case == "negative":
        kw["pack_lanes"] = -1
    elif case == "scan":
        kw["cohort_execution"] = "scan"
    elif case == "blocks":
        kw["block_dispatch"] = True
    else:
        port_extra = jax_extra = {"local_train_fn": _custom_round}
    port, jax_ = _engines_error(port_extra, jax_extra, **kw)
    assert port == jax_


def test_pack_refuses_a_per_client_aggregator():
    from fedml_tpu.algorithms.decentralized import gossip_aggregator

    arrays, part, test = _fixture(POWERLAW)
    agg = Aggregator(lambda v: (), lambda *a: None, name="gossip")
    object.__setattr__(agg, "per_client", True)  # the JAX Aggregator's field
    cfg = dict(client_num_in_total=6, client_num_per_round=6, batch_size=8, comm_round=1)
    port = _error(lambda: FedSim(_trainer("lr"), tcohort.FederatedArrays(arrays, part), test,
                                 SimConfig(**cfg, pack_lanes=2), aggregator=agg,
                                 device="cpu"))
    jax_ = _error(lambda: JaxSim(
        JaxTrainer(module=JaxLR(num_classes=4), optimizer=optax.sgd(0.2)),
        jcohort.FederatedArrays(arrays, part), test, JaxConfig(**cfg, pack_lanes=2),
        aggregator=gossip_aggregator(np.full((6, 6), 1 / 6))))
    assert port == jax_
    port = _error(lambda: FedSim(_trainer("lr"), tcohort.FederatedArrays(arrays, part), test,
                                 SimConfig(**cfg, population=CHURN), aggregator=agg,
                                 device="cpu"))
    assert port[0] is ValueError and "per-client aggregators" in port[1]


def test_custom_round_program_is_not_ported():
    """A custom round program (ROADMAP §A13's fedgan, ported since) is what
    a scan round runs; the vmap mode runs its cohort form, ``.vmap``, and
    refuses a program without one (no fallback to scan)."""
    arrays, part, test = _fixture(POWERLAW)
    data = tcohort.FederatedArrays(arrays, part)
    cfg = dict(client_num_in_total=6, client_num_per_round=4)
    sim = FedSim(_trainer("lr"), data, test, SimConfig(**cfg, cohort_execution="scan"),
                 device="cpu", local_train_fn=_custom_round)
    with pytest.raises(AssertionError, match="never called"):
        sim.run_round(0, sim.init_variables())
    with pytest.raises(TypeError, match="local_train_fn.vmap"):
        FedSim(_trainer("lr"), data, test, SimConfig(**cfg), device="cpu",
               local_train_fn=_custom_round)


@pytest.mark.parametrize("pack_lanes", [0, 2])
@pytest.mark.parametrize("block_dispatch", [None, False])
def test_dispatch_rule_turns_blocks_off_under_packing(pack_lanes, block_dispatch):
    cfg = SimConfig(pack_lanes=pack_lanes, block_dispatch=block_dispatch)
    assert resolve_dispatch(cfg, 1 << 20, "cuda") == (True, block_dispatch is None
                                                      and pack_lanes == 0)


def _cli_args(*argv):
    from fedml_tpu_torch.exp import main_fedavg as cli

    return cli, cli.parse_with_config(cli.add_args(argparse.ArgumentParser()), [
        "--dataset", "synthetic", "--client_num_in_total", "6", "--client_num_per_round",
        "3", "--comm_round", "4", "--frequency_of_the_test", "2", "--epochs", "2",
        "--device", "cpu", *argv])


def test_cli_flags_are_ported(tmp_path):
    """``--pack_lanes``, ``--pack_capacity_factor`` and the population flags
    run on the sim backend; packed histories equal padded ones, a trace's
    replay equals its generative run."""
    from fedml_tpu_torch import population as tpop

    cli, _ = _cli_args()
    for flag in ("pack_lanes", "pack_capacity_factor", "population", "population_trace",
                 "population_seed"):
        assert flag not in cli._UNPORTED_FLAGS
    def strip(history):
        return [{k: v for k, v in r.items() if k != "round_time"} for r in history]

    padded = strip(cli.run(_cli_args()[1]))
    packed = strip(cli.run(_cli_args("--pack_lanes", "2", "--pack_capacity_factor", "0.5")[1]))
    assert packed == padded and "Test/Acc" in packed[-1]
    spec = ["--population", CHURN, "--population_seed", "4"]
    gen = strip(cli.run(_cli_args("--pack_lanes", "1", *spec)[1]))
    trace = tpop.save_trace(tmp_path / "t.jsonl", tpop.Population(CHURN, 6, 4), 4, 3)
    replay = strip(cli.run(_cli_args("--pack_lanes", "1", "--population_trace",
                                     str(trace))[1]))
    assert gen == replay != padded


@pytest.mark.parametrize("argv", [
    ["--population_trace", "t.jsonl", "--backend", "grpc"],
    ["--population", CHURN, "--fault_spec", "drop=0.1"],
    ["--population", CHURN, "--straggler_frac", "0.5"],
])
def test_cli_conflicts_raise_the_jax_errors(argv):
    from fedml_tpu.exp import main_fedavg as jcli

    cli, args = _cli_args(*argv)
    jargs = jcli.parse_with_config(jcli.add_args(argparse.ArgumentParser()), [
        "--dataset", "synthetic", "--client_num_in_total", "6", "--client_num_per_round",
        "3", "--comm_round", "1", *argv])
    assert _error(cli.run, args) == _error(jcli.run, jargs)
