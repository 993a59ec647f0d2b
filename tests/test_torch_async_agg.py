"""The port's buffered-async server (``fedml_tpu_torch/async_agg/server.py``),
staleness families, async oracle and tier aggregator against the JAX
package's, on the CPU, case by case with ``tests/test_async_agg.py``.

- **Copies, held exactly.** Every staleness family at every lag, the spec
  errors (same messages), and the oracle's replay (models bitwise, records
  equal).
- **Fold arithmetic, bitwise.** The same uploads (bytes, n, version) into
  the JAX and the port ``AsyncFedAggregator`` (and the robust async tally
  at DP stddev 0), and the ``TierAggregator`` partials, negative zero kept.
- **Protocol.** Park / dispatch / emit, the version echo, re-park on a
  failed dispatch, duplicate and replay guards, snapshot/resume and the CLI
  guards, each driven on the handlers with no client thread; the JAX
  server driven with the same messages emits the bitwise-same models.
- **Mixed federations.** JAX clients under a port async server, and port
  clients under a JAX async server, over one ``OrderedUplinkFabric``
  (uploads released in sender order, so the schedule is deterministic even
  at a buffer below the worker count): the port server with JAX clients
  bitwise the all-JAX run; port clients atol 1e-5 of it (the bound of
  ``tests/test_torch_transports.py``: torch and XLA round the local steps
  otherwise).
- **The JAX bit-identity contracts on the port alone.** Async at
  ``buffer_goal == worker_num`` with the constant weight bitwise the sync
  server, round by round.

Every wire run has a deadline of its own (60 s); no test waits on a timer
for more than 2 s (the delay fault sleeps 0.4 s a leg).
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse
import logging
import shutil
import tempfile

import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedavg_distributed as jfd
from fedml_tpu.algorithms import robust_distributed as jrd
from fedml_tpu.async_agg import server as jasrv
from fedml_tpu.async_agg import staleness as jstale
from fedml_tpu.async_agg import tree as jtree
from fedml_tpu.comm import loopback as jloopback
from fedml_tpu.sim import async_oracle as joracle
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
from fedml_tpu_torch.algorithms import robust_distributed as trd
from fedml_tpu_torch.algorithms.base import EmptyRoundError
from fedml_tpu_torch.async_agg import server as tasrv
from fedml_tpu_torch.async_agg import staleness as tstale
from fedml_tpu_torch.async_agg import tree as ttree
from fedml_tpu_torch.comm import loopback as tloopback
from fedml_tpu_torch.comm.message import Message, pack_pytree
from fedml_tpu_torch.exp import main_fedavg as tmain
from fedml_tpu_torch.obs import metrics as metricslib
from fedml_tpu_torch.sim import async_oracle as toracle
from tests.test_torch_fedavg_dist import (
    UPLOAD,
    _assert_close_to_jax,
    _blobs,
    _jax_clients,
    _lr_pair,
    _within_deadline,
)
from tests.test_torch_robust import _correct_jax_krum

W, B = 4, 8
SPECS = ["const", "poly:0.5", "poly:1.0", "hinge:0.5,1", "hinge:0.25,2"]


def _port_lr():
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    return ttr, tdata


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- staleness families and the oracle (copies) ---------------------------------


@pytest.mark.parametrize("spec", SPECS)
def test_staleness_families_match_jax(spec):
    t, j = tstale.make_staleness_fn(spec), jstale.make_staleness_fn(spec)
    assert [t(d) for d in range(12)] == [j(d) for d in range(12)]
    mt, mj = tstale.memoize_staleness(t), jstale.memoize_staleness(j)
    assert [mt(d) for d in (3, 0, 3, 9)] == [mj(d) for d in (3, 0, 3, 9)]
    assert sorted(tstale.STALENESS_FAMILIES) == sorted(jstale.STALENESS_FAMILIES)


def test_staleness_families_match_hand_oracle():
    s = tstale.make_staleness_fn("const")
    assert [s(d) for d in (0, 1, 7)] == [1.0, 1.0, 1.0]
    s = tstale.make_staleness_fn("poly:0.5")
    for d in (0, 1, 3, 8):
        assert s(d) == (1.0 + d) ** -0.5
    s = tstale.make_staleness_fn("hinge:0.25,2")
    assert s(0) == 1.0 and s(2) == 1.0
    assert s(4) == 1.0 / (0.25 * (4 - 2) + 1.0)
    assert s(10) == 1.0 / (0.25 * 8 + 1.0)


@pytest.mark.parametrize("spec", ["exp:1", "poly:abc", "poly:1,2", "poly:-1", "hinge:1",
                                  "hinge:-1,2"])
def test_staleness_spec_errors_match_jax(spec):
    with pytest.raises(ValueError) as jerr:
        jstale.make_staleness_fn(spec)
    with pytest.raises(ValueError) as terr:
        tstale.make_staleness_fn(spec)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("spec", ["const", "poly:0.5", "hinge:0.5,1"])
def test_oracle_replay_matches_jax(spec):
    rng = np.random.RandomState(7)
    raw = [(rng.randn(24).astype(np.float32), float(1 + i % 5), max(0, i // 3 - i % 2))
           for i in range(12)]
    t = toracle.replay_async_schedule([toracle.AsyncUpload(*r) for r in raw], 3, spec)
    j = joracle.replay_async_schedule([joracle.AsyncUpload(*r) for r in raw], 3, spec)
    assert len(t[0]) == len(j[0]) == 4
    for a, b in zip(t[0], j[0]):
        np.testing.assert_array_equal(a, b)
    assert t[1] == j[1]
    with pytest.raises(ValueError, match="ahead of the model"):
        toracle.replay_async_schedule([toracle.AsyncUpload(raw[0][0], 1.0, 5)], 1)
    with pytest.raises(ValueError, match="buffer_goal"):
        toracle.replay_async_schedule([], 0)


# -- the async tally -----------------------------------------------------------


@pytest.mark.parametrize("spec", ["const", "poly:1.0", "hinge:0.5,1"])
def test_async_fold_weight_matches_oracle_and_jax(spec):
    """Versions 0,0,1,1,2,2 against a server at version 2: the port tally,
    the JAX tally and the port's replay agree bitwise."""
    rng = np.random.RandomState(3)
    s = tstale.make_staleness_fn(spec)
    ups = [toracle.AsyncUpload(rng.randn(32).astype(np.float32), 2.0 + i, i // 2)
           for i in range(6)]
    tagg, jagg = tasrv.AsyncFedAggregator(6), jasrv.AsyncFedAggregator(6)
    for i, up in enumerate(ups):
        w = float(s(2 - up.version)) * up.n
        assert tagg.fold_async(i, up.x.view(np.uint8), w, up.version)
        assert jagg.fold_async(i, up.x.view(np.uint8), w, up.version)
    got = tagg.emit()
    np.testing.assert_array_equal(got, jagg.emit())
    models, records = toracle.replay_async_schedule(ups, buffer_goal=6, staleness=s,
                                                    start_version=2)
    np.testing.assert_array_equal(got.view(np.float32), models[0])
    assert records[0]["stale_folds"] == 4
    for w, up in zip(records[0]["fold_weights"], ups):
        assert w == float(s(2 - up.version)) * up.n


def test_fold_async_duplicate_version_is_idempotent():
    agg = tasrv.AsyncFedAggregator(2)
    x = np.ones(8, np.float32)
    assert agg.fold_async(0, x.view(np.uint8), 1.0, 0)
    assert agg.arrivals == 1
    assert not agg.fold_async(0, x.view(np.uint8), 1.0, 0)
    assert agg.arrivals == 1
    assert agg.fold_async(0, (2 * x).view(np.uint8), 1.0, 3)
    assert not agg.fold_async(0, x.view(np.uint8), 1.0, 1)
    assert agg.arrivals == 2


@pytest.mark.parametrize("rule", ["mean", "krum"])
def test_async_robust_tally_matches_jax(rule, monkeypatch):
    """The robust async tally (mean rule: clip at arrival, DP stddev 0)
    bitwise the JAX one on the same uploads; an order-statistic rule is
    refused by both with the same message (the JAX ``krum_select`` patched
    to the Krum rule, ROADMAP §C)."""
    monkeypatch.setattr(jrd, "krum_select", _correct_jax_krum)
    flat, desc = pack_pytree({"w": np.zeros(16, np.float32)})
    if rule == "krum":
        with pytest.raises(NotImplementedError) as jerr:
            jasrv.AsyncRobustFedAggregator(3, jrd.RobustDistConfig(rule="krum"), desc)
        with pytest.raises(NotImplementedError) as terr:
            tasrv.AsyncRobustFedAggregator(3, trd.RobustDistConfig(rule="krum"), desc)
        assert str(terr.value) == str(jerr.value)
        return
    rng = np.random.RandomState(4)
    xs = [rng.randn(16).astype(np.float32) * (10.0 if i == 1 else 0.1) for i in range(3)]
    xs[2][3] = np.nan
    out = []
    for mod, srv in ((trd, tasrv), (jrd, jasrv)):
        agg = srv.AsyncRobustFedAggregator(3, mod.RobustDistConfig(norm_bound=1.0), desc)
        agg.get_global = lambda: flat
        for i, x in enumerate(xs):
            agg.fold_async(i, x.view(np.uint8), 2.0 + i, 0)
        out.append((agg.emit(), agg.pop_round_stats()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]


# -- the protocol, driven on the handlers ----------------------------------------


def _make_async_server(srv=tasrv, loop=tloopback, workers=3, rounds=4, buffer_goal=2, **kw):
    flat, desc = pack_pytree({"w": np.zeros(8, np.float32)})
    fabric = tloopback.LoopbackFabric(workers + 1)
    emitted, stats = [], {}
    server = srv.AsyncFedAvgServerManager(
        loop.LoopbackCommManager(fabric, 0), workers, rounds, flat, desc,
        on_round_done=lambda r, f: emitted.append((r, np.asarray(f).view(np.float32).copy())),
        buffer_goal=buffer_goal, async_stats=stats, **kw)
    return server, fabric, emitted, stats


def _upload(sender, version, x, n=2.0, echo=None):
    msg = Message(tfd.MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, sender, 0)
    msg.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS, np.asarray(x, np.float32).view(np.uint8))
    msg.add_params(Message.MSG_ARG_KEY_NUM_SAMPLES, float(n))
    msg.add_params(Message.MSG_ARG_KEY_ROUND_IDX, int(version))
    if echo is not None:
        msg.add_params(Message.MSG_ARG_KEY_MODEL_VERSION, int(echo))
    return msg


def _decode(item):
    """A loopback queue item (a frame, or a broadcast's head and shared
    payload) as a message and its bytes."""
    if isinstance(item, tuple):
        msg = Message.from_buffers(*item)
    else:
        msg = Message.from_bytes(item)
    return msg, msg.to_bytes()


def _jax_msg(msg):
    from fedml_tpu.comm.message import Message as JMessage

    return JMessage.from_bytes(msg.to_bytes())


def test_async_protocol_park_dispatch_emit():
    """Fresh uploads park, the Kth arrival emits and broadcasts to the
    parked set, stale uploads fold weighted and get the current model at
    once; the JAX server driven with the same messages emits the same
    models, bitwise, and the sync frames stamp the version."""
    runs = []
    for srv, loop in ((tasrv, tloopback), (jasrv, jloopback)):
        server, fabric, emitted, stats = _make_async_server(
            srv, loop, workers=3, rounds=4, buffer_goal=2, staleness_weight="poly:1.0")
        xs = [np.full(8, float(i + 1), np.float32) for i in range(6)]
        wrap = (lambda m: m) if srv is tasrv else _jax_msg
        server._on_model_from_client(wrap(_upload(1, 0, xs[0])))
        assert fabric.queues[1].qsize() == 0 and server._parked == {0}
        server._on_model_from_client(wrap(_upload(2, 0, xs[1])))
        assert server.round_idx == 1
        assert fabric.queues[1].qsize() == 1 and fabric.queues[2].qsize() == 1
        assert fabric.queues[3].qsize() == 0 and server._parked == set()
        server._on_model_from_client(wrap(_upload(3, 0, xs[2])))
        assert fabric.queues[3].qsize() == 1 and server._parked == set()
        server._on_model_from_client(wrap(_upload(1, 1, xs[3])))
        assert server.round_idx == 2
        rec0, rec1 = stats["rounds"]
        assert rec0[metricslib.ASYNC_STALE_FOLDS] == 0
        assert rec1[metricslib.ASYNC_STALE_FOLDS] == 1
        assert rec1[metricslib.ASYNC_MEAN_STALENESS] == 0.5
        sync, frame = _decode(fabric.queues[3].get_nowait())
        assert sync.get(Message.MSG_ARG_KEY_MODEL_VERSION) == 1
        runs.append((emitted, stats, frame))
    ups = [toracle.AsyncUpload(np.full(8, float(i + 1), np.float32), 2.0, v)
           for i, v in enumerate((0, 0, 0, 1))]
    models, _ = toracle.replay_async_schedule(ups, buffer_goal=2, staleness="poly:1.0")
    (temitted, tstats, tframe), (jemitted, jstats, jframe) = runs
    assert len(temitted) == len(jemitted) == 2
    for (_, got), (_, jgot), want in zip(temitted, jemitted, models):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jgot)
    assert tstats["rounds"] == jstats["rounds"]
    assert tframe == jframe


def test_async_upload_version_echo_takes_precedence():
    server, fabric, emitted, stats = _make_async_server(workers=2, rounds=3, buffer_goal=1,
                                                        staleness_weight="poly:1.0")
    server.round_idx = 2
    server._on_model_from_client(_upload(1, 2, np.ones(8, np.float32), echo=0))
    assert stats["rounds"][0][metricslib.ASYNC_STALE_FOLDS] == 1
    assert stats["rounds"][0][metricslib.ASYNC_MEAN_STALENESS] == 2.0


def test_async_failed_dispatch_reparks_worker():
    server, fabric, emitted, stats = _make_async_server(workers=3, rounds=4, buffer_goal=2)
    server._downlink_failed({3: RuntimeError("transient leg")})
    assert server._parked == {2}
    x = np.ones(8, np.float32)
    server._on_model_from_client(_upload(1, 0, x))
    server._on_model_from_client(_upload(2, 0, x))
    assert server._parked == set()
    assert fabric.queues[3].qsize() == 1
    boom = RuntimeError("crash")
    boom.unretryable = True
    with pytest.raises(RuntimeError, match="crash"):
        server._downlink_failed({1: boom})


def test_async_duplicate_upload_absorbed_and_counted():
    server, fabric, emitted, stats = _make_async_server()
    x = np.ones(8, np.float32)
    server._on_model_from_client(_upload(1, 0, x))
    server._on_model_from_client(_upload(1, 0, x))
    assert server.aggregator.arrivals == 1 and server._totals["dup"] == 1
    server._on_model_from_client(_upload(2, 0, x))
    assert emitted and stats["rounds"][0][metricslib.ASYNC_DUP_UPLOADS] == 1
    assert server.async_totals()[metricslib.ASYNC_DUP_UPLOADS] == 1


def test_async_fleet_liveness_sweep_by_heartbeat_age():
    """The emission-time sweep classifies heartbeat age into the fleet view
    (explicit ``now=``, no timer): SLOW past the timeout, OFFLINE past 3x,
    READMITTED then ONLINE on fresh contact; the status tracker untouched."""
    from fedml_tpu_torch.comm.status import ClientStatus
    from fedml_tpu_torch.obs.registry import STATE_READMITTED, FleetHealth

    server, *_ = _make_async_server(workers=2, fleet=FleetHealth(), heartbeat_timeout=1.0)
    t0 = server._fleet_t0
    server.status.update(1, ClientStatus.ONLINE)
    seen = server.status.last_seen(1)
    server._fleet_liveness_sweep(now=seen + 0.5)
    assert server.fleet.state(1) == ClientStatus.ONLINE
    server._fleet_liveness_sweep(now=t0 + 1.5)
    assert server.fleet.state(2) == ClientStatus.SLOW
    server._fleet_liveness_sweep(now=max(seen, t0) + 4.0)
    assert server.fleet.state(1) == server.fleet.state(2) == ClientStatus.OFFLINE
    server.status.update(2, ClientStatus.ONLINE)
    server._fleet_liveness_sweep(now=server.status.last_seen(2) + 0.1)
    states = [s for _, s in server.fleet.timeline(2)]
    assert states[-2:] == [STATE_READMITTED, ClientStatus.ONLINE]


def test_async_server_validation():
    flat, desc = pack_pytree({"w": np.zeros(4, np.float32)})
    fabric = tloopback.LoopbackFabric(3)

    def make(**kw):
        return tasrv.AsyncFedAvgServerManager(tloopback.LoopbackCommManager(fabric, 0), 2, 3,
                                              flat, desc, **kw)

    with pytest.raises(ValueError, match="deadlock"):
        make(buffer_goal=3)
    with pytest.raises(ValueError, match="round_timeout"):
        make(round_timeout=1.0)
    with pytest.raises(ValueError, match="buffered"):
        make(buffered_aggregation=True)
    with pytest.raises(ValueError, match="unknown staleness"):
        make(staleness_weight="nope")


def test_run_distributed_rejects_bad_async_combinations():
    ttr, tdata = _port_lr()
    run = tfd.run_distributed_fedavg_loopback
    with pytest.raises(ValueError, match="unknown server_mode"):
        run(ttr, tdata, worker_num=2, round_num=1, batch_size=B, server_mode="tree")
    with pytest.raises(ValueError, match="round_timeout"):
        run(ttr, tdata, worker_num=2, round_num=1, batch_size=B, server_mode="async",
            round_timeout=5.0)
    with pytest.raises(NotImplementedError, match="mean"):
        run(ttr, tdata, worker_num=2, round_num=1, batch_size=B, server_mode="async",
            robust_config=trd.RobustDistConfig(rule="median"))
    with pytest.raises(NotImplementedError, match="codec OR a robust"):
        run(ttr, tdata, worker_num=2, round_num=1, batch_size=B, server_mode="async",
            robust_config=trd.RobustDistConfig(norm_bound=1.0),
            codec=__import__("fedml_tpu_torch.compress", fromlist=["make_codec"]).make_codec(
                "topk"))
    with pytest.raises(NotImplementedError, match=r"§A11\.4"):
        run(ttr, tdata, worker_num=2, round_num=1, batch_size=B, downlink_codec="q8")


# -- fault kinds end to end -------------------------------------------------------


def test_async_dup_fault_end_to_end():
    ttr, tdata = _port_lr()
    stats: dict = {}
    fabric = tloopback.LoopbackFabric(W + 1)
    final = _within_deadline(lambda: tfd.run_distributed_fedavg_loopback(
        ttr, tdata, W, 2, B, fabric=fabric, server_mode="async", fault_specs="2:dup=1.0",
        async_stats=stats), [fabric])
    assert stats["totals"][metricslib.ASYNC_MODELS_EMITTED] == 2
    assert stats["totals"][metricslib.ASYNC_DUP_UPLOADS] >= 1
    assert all(torch.isfinite(v).all() for v in final.values())


def test_async_delay_fault_still_fills_every_window():
    ttr, tdata = _port_lr()
    stats: dict = {}
    fabric = tloopback.LoopbackFabric(W + 1)
    _within_deadline(lambda: tfd.run_distributed_fedavg_loopback(
        ttr, tdata, W, 4, B, fabric=fabric, server_mode="async", buffer_goal=2,
        staleness_weight="poly:0.5", fault_specs="2:delay=0.4@1.0", async_stats=stats),
        [fabric])
    assert stats["totals"][metricslib.ASYNC_MODELS_EMITTED] == 4
    assert all(r[metricslib.ASYNC_ARRIVALS] == 2 for r in stats["rounds"])


def test_sync_stale_upload_counted_not_silent(caplog):
    flat, desc = pack_pytree({"w": np.zeros(8, np.float32)})
    server = tfd.FedAvgServerManager(
        tloopback.LoopbackCommManager(tloopback.LoopbackFabric(3), 0), 2, 3, flat, desc)
    server.round_idx = 4
    with caplog.at_level(logging.INFO):
        server._on_model_from_client(_upload(2, 3, np.ones(8, np.float32)))
    assert server.stale_uploads == 1
    assert server.aggregator.received_workers() == []
    joined = " ".join(r.getMessage() for r in caplog.records)
    assert "worker 2" in joined and "upload_round=3" in joined and "current=4" in joined


def test_sync_stale_uploads_land_in_comm_stats():
    ttr, tdata = _port_lr()
    comm_stats: dict = {}
    fabric = tloopback.LoopbackFabric(3)
    _within_deadline(lambda: tfd.run_distributed_fedavg_loopback(
        ttr, tdata, 2, 1, B, fabric=fabric, comm_stats=comm_stats), [fabric])
    assert comm_stats["totals"][metricslib.COMM_STALE_UPLOADS] == 0


def test_sync_frames_stamp_no_version_and_clients_echo_only_a_stamp():
    """The sync server's sync frame stays the JAX sync server's byte for
    byte (no version stamped); a client echoes a version only when the sync
    carried one."""
    flat, desc = pack_pytree({"w": np.arange(8, dtype=np.float32)})
    frames = []
    for fd, loop in ((tfd, tloopback), (jfd, jloopback)):
        fabric = tloopback.LoopbackFabric(3)
        server = fd.FedAvgServerManager(loop.LoopbackCommManager(fabric, 0), 2, 3, flat, desc)
        server.send_init_msg()
        frames.append([_decode(fabric.queues[r].get_nowait()) for r in (1, 2)])
    assert [f for _, f in frames[0]] == [f for _, f in frames[1]]
    assert frames[0][0][0].get(Message.MSG_ARG_KEY_MODEL_VERSION) is None


# -- crash-resume ---------------------------------------------------------------


def test_async_snapshot_restores_arrival_counter_and_guard(tmp_path):
    from fedml_tpu_torch.obs.checkpoint import RoundCheckpointer

    rng = np.random.RandomState(0)
    xs = [rng.randn(16).astype(np.float32) for _ in range(5)]
    ref, live = tasrv.AsyncFedAggregator(5), tasrv.AsyncFedAggregator(5)
    for i in range(3):
        ref.fold_async(i, xs[i].view(np.uint8), 2.0 + i, i % 2)
        live.fold_async(i, xs[i].view(np.uint8), 2.0 + i, i % 2)
    ckptr = RoundCheckpointer(tmp_path)
    ckptr.save_server(7, {"aggregator": live.snapshot_state()})
    restored = tasrv.AsyncFedAggregator(5)
    restored.restore_state(ckptr.restore_server(7)["aggregator"])
    assert restored.arrivals == 3
    assert restored.last_folded == {0: 0, 1: 1, 2: 0}
    for i in (3, 4):
        ref.fold_async(i, xs[i].view(np.uint8), 1.5, 2)
        restored.fold_async(i, xs[i].view(np.uint8), 1.5, 2)
    np.testing.assert_array_equal(ref.emit(), restored.emit())
    assert restored.arrivals == 0


def test_async_checkpoint_resume_completed_run():
    ttr, tdata = _port_lr()
    ckpt_dir = tempfile.mkdtemp(prefix="async_resume_")
    try:
        fabrics = [tloopback.LoopbackFabric(W + 1) for _ in range(2)]
        final = _within_deadline(lambda: tfd.run_distributed_fedavg_loopback(
            ttr, tdata, W, 2, B, fabric=fabrics[0], server_mode="async",
            checkpoint_dir=ckpt_dir, checkpoint_every=1), fabrics[:1])
        resumed = _within_deadline(lambda: tfd.run_distributed_fedavg_loopback(
            ttr, tdata, W, 2, B, fabric=fabrics[1], server_mode="async",
            checkpoint_dir=ckpt_dir, resume=True), fabrics[1:])
        _assert_bitwise(final, resumed)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


# -- the JAX bit-identity contract on the port alone -----------------------------


def test_async_full_buffer_const_is_the_sync_server_bitwise():
    """Async at ``buffer_goal == worker_num`` with the constant weight
    (every worker parks, the emission is the sync round close): bitwise the
    sync streaming server, round by round, over ordered fabrics."""
    ttr, tdata = _port_lr()
    runs = []
    for kw in ({}, {"server_mode": "async", "buffer_goal": W, "staleness_weight": "const"}):
        rounds = []
        fabric = tloopback.OrderedUplinkFabric(W + 1, W, UPLOAD)
        final = _within_deadline(lambda: tfd.run_distributed_fedavg_loopback(
            ttr, tdata, W, 3, B, fabric=fabric,
            on_round_done=lambda r, v: rounds.append((r, {k: t.clone() for k, t in v.items()})),
            **kw), [fabric])
        runs.append((final, rounds))
    (sf, sr), (af, ar) = runs
    assert [r for r, _ in sr] == [r for r, _ in ar] == [0, 1, 2]
    for (_, a), (_, b) in zip(sr, ar):
        _assert_bitwise(a, b)
    _assert_bitwise(sf, af)


# -- mixed federations --------------------------------------------------------------

_REF: dict = {}


def _async_federation(server_pkg, client_pkg, buffer_goal, staleness, versions=4):
    """One async federation over an OrderedUplinkFabric: the server of
    ``server_pkg`` and the clients of ``client_pkg`` ('jax' | 'port');
    returns the final flat bytes."""
    (jtr, ttr), (jdata, tdata) = _lr_pair(), _blobs()
    template, flat, desc = jfd.init_template(jtr, jdata.arrays, B, 0)
    fabric = tloopback.OrderedUplinkFabric(W + 1, W, UPLOAD)
    done = {}
    srv, loop = (jasrv, jloopback) if server_pkg == "jax" else (tasrv, tloopback)
    server = srv.AsyncFedAvgServerManager(
        loop.LoopbackCommManager(fabric, 0), W, versions, flat, desc, client_num_in_total=W,
        on_round_done=lambda r, f: done.update(final=np.array(f)), buffer_goal=buffer_goal,
        staleness_weight=staleness)
    if client_pkg == "jax":
        make = _jax_clients(jtr)(1)
        clients = [make(jloopback.LoopbackCommManager(fabric, r), r, W + 1, jtr, jdata, B,
                        template) for r in range(1, W + 1)]
    else:
        clients = [tfd.FedAvgClientManager(tloopback.LoopbackCommManager(fabric, r), r, W + 1,
                                           ttr, tdata, B, convert.from_flax(template))
                   for r in range(1, W + 1)]
    _within_deadline(lambda: tfd.run_manager_protocol(server, clients), [fabric])
    return done["final"], desc


@pytest.mark.parametrize("buffer_goal,staleness", [(W, "const"), (2, "poly:0.5")])
@pytest.mark.parametrize("server", ["jax", "port"])
def test_mixed_async_federation_reaches_the_all_jax_result(server, buffer_goal, staleness):
    """A port async server with JAX clients: bitwise the all-JAX run (the
    same upload bytes, echoed versions and fold order). A JAX async server
    with port clients: atol 1e-5 of it."""
    key = (buffer_goal, staleness)
    if key not in _REF:
        _REF[key] = _async_federation("jax", "jax", buffer_goal, staleness)
    ref, desc = _REF[key]
    got, _ = _async_federation(server, "jax" if server == "port" else "port", buffer_goal,
                               staleness)
    if server == "port":
        np.testing.assert_array_equal(got, ref)
    else:
        _assert_close_to_jax(jfd.unpack_pytree(ref, desc), tfd.unpack_state(got, desc),
                             atol=1e-5)


# -- the tier aggregator --------------------------------------------------------------


def test_tree_topology_validation():
    with pytest.raises(ValueError, match="edge tier"):
        ttree.TreeTopology((4,))
    with pytest.raises(ValueError, match=">= 1"):
        ttree.TreeTopology((2, 0))
    topo = ttree.TreeTopology((2, 3, 4))
    assert topo.leaf_count == 24 and topo.tier_count == 2


def test_tier_aggregator_partial_roundtrip_matches_jax():
    """Two leaf tiers fold models and export raw tallies, the parent folds
    both and closes to the flat weighted mean; the JAX tiers on the same
    uploads give the same partial bytes and global, bitwise."""
    rng = np.random.RandomState(1)
    xs = [rng.randn(8).astype(np.float32) for _ in range(4)]
    ns = [2.0, 3.0, 4.0, 5.0]
    outs = []
    for mod in (ttree, jtree):
        edges = [mod.TierAggregator(2), mod.TierAggregator(2)]
        for (e, child), x, n in zip([(0, 0), (0, 1), (1, 0), (1, 1)], xs, ns):
            edges[e].add_local_trained_result(child, x.view(np.uint8), n)
        root = mod.TierAggregator(2)
        parts = []
        for i, e in enumerate(edges):
            part, wsum, count = e.partial()
            assert count == 2
            parts.append((np.array(part), wsum))
            assert not root.add_partial_result(i, part, wsum) or i == 1
        outs.append((parts, root.aggregate()))
    (tparts, tglob), (jparts, jglob) = outs
    for (a, wa), (b, wb) in zip(tparts, jparts):
        np.testing.assert_array_equal(a, b)
        assert wa == wb
    np.testing.assert_array_equal(tglob, jglob)
    acc = np.zeros(8, np.float64)
    for x, n in zip(xs, ns):
        acc += np.multiply(x, n, dtype=np.float64)
    np.testing.assert_array_equal(tglob.view(np.float32), (acc / sum(ns)).astype(np.float32))
    with pytest.raises(EmptyRoundError):
        ttree.TierAggregator(2).partial()


def test_tier_partial_preserves_negative_zero():
    edge = ttree.TierAggregator(1)
    x = np.array([-0.0, 1.0], np.float32)
    edge.add_local_trained_result(0, x.view(np.uint8), 1.0)
    part, wsum, _ = edge.partial()
    root = ttree.TierAggregator(1)
    root.add_partial_result(0, part, wsum)
    got = root.aggregate()
    flat = tfd.FedAvgDistAggregator(1)
    flat.add_local_trained_result(0, x.view(np.uint8), 1.0)
    np.testing.assert_array_equal(got, flat.aggregate())


def test_async_tier_windows_match_jax():
    """An async tier's weighted partial folds (fresh and stale-scaled) and
    its exported window: the port's bytes the JAX tier's, negative zero
    kept through the first copy."""
    rng = np.random.RandomState(9)
    parts = [rng.randn(12) for _ in range(3)]
    parts[0][0] = -0.0
    outs = []
    for mod in (ttree, jtree):
        agg = mod.TierAggregator(3)
        agg.fold_partial_weighted(parts[0], 3.0)
        agg.fold_partial_weighted(parts[1], 2.0, scale=0.5)
        agg.fold_async(2, rng.randn(12).astype(np.float32).view(np.uint8), 1.5, 0)
        acc, wsum = agg.export_partial()
        outs.append((np.array(acc), wsum, agg.arrivals))
        rng = np.random.RandomState(9)
        parts = [rng.randn(12) for _ in range(3)]
        parts[0][0] = -0.0
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:]


def test_two_tier_tree_matches_flat_closely():
    ttr, tdata = _port_lr()
    tree_final = _within_deadline(lambda: ttree.run_tree_fedavg_loopback(
        ttr, tdata, (2, 2), 2, B), [])
    fabric = tloopback.LoopbackFabric(W + 1)
    flat_final = _within_deadline(lambda: tfd.run_distributed_fedavg_loopback(
        ttr, tdata, W, 2, B, fabric=fabric), [fabric])
    for k in tree_final:
        np.testing.assert_allclose(tree_final[k].numpy(), flat_final[k].numpy(), rtol=1e-5,
                                   atol=1e-7)


def _edge(child_num=2):
    up_fabric, down_fabric = tloopback.LoopbackFabric(2), tloopback.LoopbackFabric(child_num + 1)
    edge = ttree.EdgeAggregatorManager(
        up_comm=tloopback.LoopbackCommManager(up_fabric, 1), up_rank=1,
        down_comm=tloopback.LoopbackCommManager(down_fabric, 0), child_num=child_num,
        leaf_base=0, leaf_total=child_num, client_num_in_total=child_num,
        children_are_leaves=True)
    edge.register_message_receive_handlers()
    return edge, up_fabric, down_fabric


def _sync(round_idx, x):
    sync = Message(tfd.MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, 1)
    sync.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS, x.view(np.uint8))
    sync.add_params(Message.MSG_ARG_KEY_ROUND_IDX, round_idx)
    return sync


def test_edge_absorbs_duplicate_after_partial_forward():
    edge, up_fabric, _ = _edge()
    x = np.ones(8, np.float32)
    edge._on_child_model(_upload(1, 0, x, n=2.0))
    edge._on_child_model(_upload(2, 0, x, n=3.0))
    assert up_fabric.queues[0].qsize() == 1
    edge._on_child_model(_upload(1, 0, x, n=2.0))
    assert edge.duplicate_uploads == 1 and up_fabric.queues[0].qsize() == 1
    assert edge.aggregator.received_workers() == []
    edge._on_sync_from_parent(_sync(1, x))
    edge._on_child_model(_upload(1, 1, x, n=2.0))
    edge._on_child_model(_upload(2, 1, x, n=3.0))
    assert up_fabric.queues[0].qsize() == 2
    assert edge.duplicate_uploads == 1 and edge.stale_uploads == 0


def test_edge_forwards_partial_outside_edge_lock():
    edge, up_fabric, _ = _edge()
    free_at_send = []
    inner_send = edge.up_comm.send_message

    def probed_send(msg):
        free = edge._edge_lock.acquire(blocking=False)
        if free:
            edge._edge_lock.release()
        free_at_send.append(free)
        return inner_send(msg)

    edge.up_comm.send_message = probed_send
    x = np.ones(8, np.float32)
    edge._on_child_model(_upload(1, 0, x, n=2.0))
    edge._on_child_model(_upload(2, 0, x, n=3.0))
    assert up_fabric.queues[0].qsize() == 1 and free_at_send == [True]
    part, _ = _decode(up_fabric.queues[0].get_nowait())
    assert part.get(Message.MSG_ARG_KEY_WEIGHT_SUM) == 5.0
    assert part.get(Message.MSG_ARG_KEY_ROUND_IDX) == 0


def test_edge_discards_stale_window_when_parent_advances():
    edge, up_fabric, down_fabric = _edge()
    x = np.ones(8, np.float32)
    edge._on_child_model(_upload(1, 0, x, n=7.0))
    assert up_fabric.queues[0].qsize() == 0
    edge._on_sync_from_parent(_sync(1, x))
    assert edge.discarded_folds == 1 and edge.aggregator.received_workers() == []
    edge._on_child_model(_upload(2, 0, x, n=5.0))
    assert edge.stale_uploads == 1
    edge._on_child_model(_upload(1, 1, x, n=2.0))
    downstream = down_fabric.queues[1].qsize()
    edge._on_sync_from_parent(_sync(0, x))
    assert edge.stale_syncs == 1 and edge._round == 1
    assert edge.aggregator.received_workers() == [0]
    assert down_fabric.queues[1].qsize() == downstream
    edge._on_child_model(_upload(2, 1, x, n=3.0))
    part, _ = _decode(up_fabric.queues[0].get_nowait())
    assert part.get(Message.MSG_ARG_KEY_ROUND_IDX) == 1
    assert part.get(Message.MSG_ARG_KEY_WEIGHT_SUM) == 5.0


def test_excluded_tier_requeues_readmission_via_partial():
    flat, desc = pack_pytree({"w": np.zeros(8, np.float32)})
    for readmission in (True, False):
        root = ttree.TreeFedAvgServerManager(
            tloopback.LoopbackCommManager(tloopback.LoopbackFabric(3), 0), 2, 2, flat, desc,
            readmission=readmission)
        root.aggregator.exclude_worker(1)
        part = Message(ttree.TreeMessage.MSG_TYPE_T2S_SEND_PARTIAL, 2, 0)
        acc = np.multiply(flat.view(np.float32), 3.0, dtype=np.float64)
        part.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS, acc.view(np.uint8))
        part.add_params(ttree.TreeMessage.MSG_ARG_KEY_WEIGHT_SUM, 3.0)
        part.add_params(ttree.TreeMessage.MSG_ARG_KEY_FOLD_COUNT, 2)
        part.add_params(Message.MSG_ARG_KEY_ROUND_IDX, 0)
        root._on_partial_from_tier(part)
        assert root.aggregator.received_workers() == []
        assert root._pending_readmit == ({1} if readmission else set())


def test_tree_rejects_oversized_topology_and_unported_planes():
    ttr, tdata = _port_lr()
    with pytest.raises(ValueError, match="leaves"):
        ttree.run_tree_fedavg_loopback(ttr, tdata, (4, 4), 1, B)
    with pytest.raises(NotImplementedError, match=r"§A11\.4"):
        ttree.run_tree_fedavg_loopback(ttr, tdata, (2, 2), 1, B, downlink_codec="q8")
    with pytest.raises(NotImplementedError, match=r"§A11\.5"):
        ttree.run_tree_fedavg_loopback(ttr, tdata, (2, 2), 1, B, trace_wire=True)


@pytest.mark.parametrize("kwarg", [("downlink_keyframe_every", 4), ("downlink_retention", 2)])
def test_tree_runner_refuses_downlink_codec_tuning(kwarg):
    """The downlink codec's own knobs are not taken in silence while the
    codec is unported (ROADMAP §A11.4): the runner has no such parameter."""
    ttr, tdata = _port_lr()
    with pytest.raises(TypeError, match=kwarg[0]):
        ttree.run_tree_fedavg_loopback(ttr, tdata, (2, 2), 1, B, **{kwarg[0]: kwarg[1]})


def test_shm_group_comm_default_prefix_is_fresh_per_group():
    """Two tree shm groups in one process (or in two processes that share
    /dev/shm, whatever their pids) name their rings apart; an explicit
    prefix is kept."""
    import os

    a, b = ttree.ShmGroupComm(), ttree.ShmGroupComm()
    assert a.prefix != b.prefix
    assert str(os.getpid()) not in a.prefix and a.prefix.startswith("tree_")
    assert ttree.ShmGroupComm(prefix="cell7").prefix == "cell7"


# -- the CLI guards -----------------------------------------------------------------


def test_main_fedavg_server_mode_guards():
    def args_for(*argv):
        return tmain.parse_with_config(tmain.add_args(argparse.ArgumentParser()),
                                       list(argv) + ["--device", "cpu"])

    cases = [
        (("--server_mode", "async", "--backend", "sim"), "server_mode"),
        (("--server_mode", "tree", "--backend", "grpc"), "tree_transport"),
        (("--server_mode", "tree", "--backend", "loopback", "--algorithm", "fedavg_robust"),
         "fedavg_robust"),
        (("--server_mode", "tree", "--backend", "loopback", "--checkpoint_dir", "/tmp/nope"),
         "--checkpoint_dir"),
        (("--server_mode", "tree", "--backend", "loopback", "--fault_spec", "2:dup=1.0"),
         "--fault_spec"),
        (("--server_mode", "sync", "--backend", "loopback", "--staleness_weight", "poly:0.5"),
         "--staleness_weight"),
        (("--server_mode", "sync", "--backend", "loopback", "--buffer_goal", "4"),
         "--buffer_goal"),
        (("--server_mode", "async", "--backend", "loopback", "--tree_fan_ins", "2,2"),
         "--tree_fan_ins"),
        (("--server_mode", "async", "--backend", "loopback", "--tier_timeout", "0.5"),
         "--tier_timeout"),
        (("--server_mode", "sync", "--backend", "loopback", "--tier_compressor", "q8"),
         "--tier_compressor"),
        (("--server_mode", "sync", "--backend", "loopback", "--tree_transport", "shm"),
         "--tree_transport"),
    ]
    for argv, match in cases:
        with pytest.raises(NotImplementedError, match=match):
            tmain.run(args_for(*argv))
