"""The port's round driver (fedml_tpu_torch.sim.engine.FedSim.run and
sim/prefetch.py): pipelined against serial, the per-client server eval
against the JAX engine's, the prefetcher and the metrics drain, resuming,
and the profiler hook.

Tolerances:
- pipelined (``pipeline_depth`` None or 2) against serial (0): bitwise on
  every history value but ``round_time`` and on the final variables;
  staging is a pure function of (seed, round), dropout masks of (seed,
  round, step);
- ``evaluate_per_client`` against the JAX engine's on the same converted
  variables: ``test_total`` exact, the summed ``test_correct`` and
  ``test_loss`` at rtol 1e-6 / atol 1e-5 (sums of f32 cross-entropies in
  other orders); chunked against unchunked: rtol 1e-6, as the JAX package's
  own test (``tests/test_perclient_eval.py``) holds its chunks;
- the per-client summary against the pooled train eval: 1e-5.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import threading

import jax
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.sim import cohort as jcohort
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
from fedml_tpu_torch.data.synthetic import gaussian_blobs
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import FedSim, SimConfig
from fedml_tpu_torch.sim.prefetch import THREAD_NAME, MetricsDrain, Prefetcher


def _no_prefetch_threads():
    return not any(t.name == THREAD_NAME for t in threading.enumerate())


def _blob_sim(model="lr", **cfg_kw):
    train, test = gaussian_blobs(n_clients=6, samples_per_client=24, num_classes=4, dim=16,
                                 partition_method="hetero", partition_alpha=0.5, seed=0)
    if model == "cnn":
        rng = np.random.RandomState(1)
        train = FederatedArrays({"x": rng.rand(train.num_samples, 28, 28).astype(np.float32),
                                 "y": train.arrays["y"]}, train.partition)
        test = {"x": rng.rand(len(test["y"]), 28, 28).astype(np.float32), "y": test["y"]}
    module = create_model(model, 4, "femnist", device="cpu",
                          input_shape=train.arrays["x"].shape[1:])
    trainer = ClientTrainer(module=module, optimizer=sgd(0.2), epochs=2)
    cfg = dict(client_num_in_total=6, client_num_per_round=4, batch_size=8, comm_round=5,
               epochs=2, frequency_of_the_test=3, eval_batch_size=16, seed=0)
    cfg.update(cfg_kw)
    return FedSim(trainer, train, test, SimConfig(**cfg), device="cpu"), train, test


@pytest.mark.parametrize("model,mode,depths", [("lr", "vmap", (None, 2)), ("lr", "scan", (None,)),
                                               ("cnn", "vmap", (None,)), ("cnn", "scan", (None,))])
def test_pipelined_matches_serial_bitwise(model, mode, depths):
    """The CNN is CNNDropOut: its dropout masks too are drawn alike."""
    runs = {}
    for depth in (0,) + depths:
        sim, _, _ = _blob_sim(model, cohort_execution=mode, pipeline_depth=depth,
                              straggler_frac=0.5, eval_on_clients=True)
        seen = []
        variables, history = sim.run(callback=seen.append)
        assert seen == history and [h["round"] for h in history] == list(range(5))
        runs[depth] = (variables, history)
        assert _no_prefetch_threads()
    (v0, h0) = runs[0]
    for depth in depths:
        v, h = runs[depth]
        assert all(torch.equal(v[k], v0[k]) for k in v0)
        for rec, rec0 in zip(h, h0):
            assert set(rec) == set(rec0)
            assert {k: x for k, x in rec.items() if k != "round_time"} == \
                {k: x for k, x in rec0.items() if k != "round_time"}
    # eval rounds (2 and the last) carry the eval block, the others do not
    assert ["Test/Acc" in r for r in h0] == [False, False, True, False, True]
    assert "Train/AccOnClients" in h0[2] and all(r["round_time"] > 0 for r in h0)


def test_run_resumes_from_start_round():
    sim, _, _ = _blob_sim()
    whole_v, whole = sim.run()
    sim2, _, _ = _blob_sim(comm_round=2)
    v2, first = sim2.run()
    sim3, _, _ = _blob_sim()
    v3, rest = sim3.run(variables=v2, server_state=(), start_round=2)
    assert [r["round"] for r in rest] == [2, 3, 4]
    assert all(torch.equal(v3[k], whole_v[k]) for k in v3)
    assert rest[-1]["Test/Acc"] == whole[-1]["Test/Acc"]


def test_evaluate_per_client_matches_jax():
    train, test = gaussian_blobs(n_clients=6, samples_per_client=24, num_classes=4, dim=16,
                                 partition_method="hetero", partition_alpha=0.5, seed=0)
    kw = dict(client_num_in_total=6, client_num_per_round=6, batch_size=8, comm_round=1,
              eval_batch_size=16, seed=0)
    jsim = JaxSim(JaxTrainer(module=JaxLR(num_classes=4), optimizer=optax.sgd(0.2)),
                  jcohort.FederatedArrays(train.arrays, train.partition), test, JaxConfig(**kw))
    j_vars = jsim.init_round_variables()
    tsim = FedSim(ClientTrainer(module=create_model("lr", 4, device="cpu", input_shape=(16,))),
                  train, test, SimConfig(**kw), device="cpu")
    t_vars = convert.from_flax(jax.tree.map(np.asarray, dict(j_vars)))
    want = jsim.evaluate_per_client(j_vars)
    got = tsim.evaluate_per_client(t_vars)
    assert set(got) == set(want) == {"test_correct", "test_loss", "test_total"}
    np.testing.assert_array_equal(got["test_total"], want["test_total"])
    np.testing.assert_array_equal(got["test_total"], train.client_sizes())
    for k in ("test_correct", "test_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-5, err_msg=k)
    # an explicit client subset and an external data set
    sub = tsim.evaluate_per_client(t_vars, client_ids=[4, 1], data=train, batch_size=5)
    np.testing.assert_allclose(sub["test_loss"], got["test_loss"][[4, 1]], rtol=1e-6)


def test_per_client_eval_matches_pooled():
    sim, train, _ = _blob_sim()
    variables, _ = sim.run()
    m = sim.evaluate_per_client(variables)
    assert m["test_total"].shape == (6,)
    np.testing.assert_allclose(m["test_total"], train.client_sizes())
    pooled_acc = m["test_correct"].sum() / m["test_total"].sum()
    assert abs(pooled_acc - sim.evaluate(variables)["Train/Acc"]) < 1e-5


@pytest.mark.parametrize("model", ["lr", "cnn"])
def test_per_client_eval_chunked_identical(model):
    sim, _, _ = _blob_sim(model)
    variables = sim.init_round_variables()
    full = sim.evaluate_per_client(variables, chunk=64)
    chunked = sim.evaluate_per_client(variables, chunk=4)  # forces 2 chunks + pad
    for k in full:
        np.testing.assert_allclose(full[k], chunked[k], rtol=1e-6)


def test_eval_on_clients_in_history():
    sim, _, _ = _blob_sim(eval_on_clients=True)
    _, history = sim.run()
    assert "Train/AccOnClients" in history[-1] and "Train/LossOnClients" in history[-1]
    assert abs(history[-1]["Train/AccOnClients"] - history[-1]["Train/Acc"]) < 1e-5


def test_profile_dir_produces_trace(tmp_path):
    prof = tmp_path / "prof"
    sim, _, _ = _blob_sim(profile_dir=str(prof), comm_round=2)
    sim.run()
    produced = [p for p in prof.rglob("*") if p.is_file()]
    assert produced and all(p.stat().st_size > 0 for p in produced)


def test_init_round_variables_overrides_and_consensus():
    sim, _, _ = _blob_sim()
    fresh = sim.init_round_variables()
    w = torch.full_like(fresh["dense_0.weight"], 0.5)
    v = sim.init_round_variables({"dense_0.weight": w})
    assert torch.equal(v["dense_0.weight"], w) and torch.equal(v["dense_0.bias"],
                                                               fresh["dense_0.bias"])
    assert sim.consensus(v) is v
    with pytest.raises(ValueError, match="no variable"):
        sim.init_round_variables({"nope": w})


def test_prefetcher_orders_and_propagates_errors():
    staged = []

    def stage(t):
        if t == 3:
            raise RuntimeError("boom")
        staged.append(t)
        return t * 10

    p = Prefetcher(range(5), stage, depth=2)
    try:
        assert [p.get(i) for i in range(3)] == [0, 10, 20]
        with pytest.raises(RuntimeError, match="boom"):
            p.get(3)
    finally:
        p.close()
    assert staged == [0, 1, 2]  # nothing staged past the failure
    assert _no_prefetch_threads()


def test_prefetcher_delivers_final_payload_after_worker_exit():
    p = Prefetcher([0], lambda t: t * 10, depth=2)
    p._thread.join(timeout=10)  # worker stages its only task and exits
    assert not p._thread.is_alive()
    assert p.get(0) == 0
    p.close()
    assert _no_prefetch_threads()


def test_prefetcher_close_with_producer_blocked_and_order_check():
    p = Prefetcher(range(100), lambda t: t, depth=1)
    assert p.get(0) == 0
    with pytest.raises(RuntimeError, match="order violated"):
        p.get(5)
    p.close()
    assert _no_prefetch_threads()


def test_metrics_drain_depth_and_flush_order():
    d = MetricsDrain(2)
    assert d.push("a", {"x": 1}) == []
    assert d.push("b", {"x": 2}) == []
    assert d.push("c", {"x": 3}) == [("a", {"x": 1})]
    assert d.flush() == [("b", {"x": 2}), ("c", {"x": 3})]
    assert d.flush() == []
    # depth 0 degrades to fetch-every-push (the serial driver)
    d0 = MetricsDrain(0)
    assert d0.push("a", {"x": 1}) == [("a", {"x": 1})]
    t = MetricsDrain(1)
    t.push("r0", {"Train/Loss": torch.tensor(0.5)})
    (tag, host), = t.push("r1", {"Train/Loss": torch.tensor(0.25)})
    assert tag == "r0" and float(host["Train/Loss"]) == 0.5
