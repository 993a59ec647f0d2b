"""The port's edge-aggregator tree (``fedml_tpu_torch/async_agg/tree.py``),
tier codecs (``compress/aggregate.py`` ``encode_partial``/``decode_partial``)
and cascade harness (``async_agg/cascade.py``) against the JAX package's,
on the CPU, case by case with ``tests/test_tree_async.py``.

- **The per-tier ladder on the port alone.** On ``(2, 2)`` every cell has
  two uploaders and an f64 two-term fold commutes, so the sync tree, async
  edges at ``buffer_goal == fan_in`` and the none-coded tier uplink are
  bitwise alike per round; a 1-tier tree over a rank-ordered leaf fabric is
  bitwise the flat server; shm is bitwise loopback.
- **Window discipline, against JAX.** One root and one edge over inline
  transports, driven with the same uploads in both packages: the partials'
  payloads, weights, folds and ``(round, seq, complete)`` flags are equal,
  bytes bitwise (seq/complete flags, stale folds under a staleness family,
  the elastic flush naming its missing children, the zero marker, the
  duplicate and replay guards, the clip defense at DP stddev 0).
- **Tier codecs.** ``encode_partial``/``decode_partial`` bitwise JAX's at
  the JAX key's injected uniforms (the port draws its own, ROADMAP §C); an
  edge's q8 uplink bitwise the JAX edge's at the same uniforms; the tier DP
  noise is the port's ``RoundNoise`` seeded with the JAX key's integers.
- **Mixed federations.** A port root and edge over JAX leaf clients,
  bitwise the all-JAX tree; a JAX root and edge over port clients, atol
  1e-5 of it (``tests/test_torch_transports.py``'s bound).
- **The slow soaks.** The JAX 10^6-upload cascade soak has no tier-1
  counterpart; a small churned, defended, q8-coded cascade stands in.

Every threaded run has a deadline of its own (60 s); the elastic flush is
driven by calling it, not by a timer.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse
import logging

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedavg_distributed as jfd
from fedml_tpu.algorithms import robust_distributed as jrd
from fedml_tpu.async_agg import cascade as jcascade
from fedml_tpu.async_agg import tree as jtree
from fedml_tpu.comm import loopback as jloopback
from fedml_tpu.comm import message as jmsg
from fedml_tpu.compress import aggregate as jagg
from fedml_tpu.compress import codec as jcodec
from fedml_tpu.exp import main_fedavg as jmain
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
from fedml_tpu_torch.algorithms import robust_distributed as trd
from fedml_tpu_torch.algorithms.base import EmptyRoundError
from fedml_tpu_torch.async_agg import cascade as tcascade
from fedml_tpu_torch.async_agg import tree as ttree
from fedml_tpu_torch.comm import loopback as tloopback
from fedml_tpu_torch.comm import message as tmsg
from fedml_tpu_torch.compress import aggregate as tagg
from fedml_tpu_torch.compress import codec as tcodec
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.exp import main_fedavg as tmain
from tests.test_torch_compress import JaxUniforms, jax_draws
from tests.test_torch_fedavg_dist import (
    UPLOAD,
    _assert_close_to_jax,
    _blobs,
    _jax_clients,
    _lr_pair,
    _within_deadline,
)
from tests.test_torch_wire_families import BASE, init_file  # noqa: F401  (a fixture)

W, B = 4, 8
PARTIAL = ttree.TreeMessage.MSG_TYPE_T2S_SEND_PARTIAL
PKGS = {"port": (ttree, tcascade, tmsg, trd, tcodec), "jax": (jtree, jcascade, jmsg, jrd, jcodec)}


def _port_lr():
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    return ttr, tdata


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _snap(v):
    return {k: t.clone() for k, t in v.items()}


# -- the per-tier ladder, on the port ------------------------------------------------


def _tree_rounds(ttr, tdata, fan_ins, runner=None, **kw):
    rounds = []
    final = _within_deadline(lambda: (runner or ttree.run_tree_fedavg_loopback)(
        ttr, tdata, fan_ins, 2, B, on_round_done=lambda r, v: rounds.append((r, _snap(v))),
        **kw), [])
    return final, rounds


def test_async_edge_ladder_bit_identical_two_tier():
    ttr, tdata = _port_lr()
    sync_final, sync_rounds = _tree_rounds(ttr, tdata, (2, 2))
    for kw in ({"buffer_goal": 2, "tier_staleness": "const"},
               {"buffer_goal": 2, "tier_uplink_codec": "none"}):
        final, rounds = _tree_rounds(ttr, tdata, (2, 2), **kw)
        assert [r for r, _ in rounds] == [r for r, _ in sync_rounds] == [0, 1]
        for (_, a), (_, b) in zip(rounds, sync_rounds):
            _assert_bitwise(a, b)
        _assert_bitwise(final, sync_final)


def test_async_edge_matches_flat_server_ordered():
    ttr, tdata = _port_lr()
    fabric = tloopback.OrderedUplinkFabric(W + 1, W, UPLOAD)
    flat_rounds = []
    flat_final = _within_deadline(lambda: tfd.run_distributed_fedavg_loopback(
        ttr, tdata, W, 2, B, fabric=fabric,
        on_round_done=lambda r, v: flat_rounds.append((r, _snap(v)))), [fabric])

    def make_group(path, world):
        f = (tloopback.LoopbackFabric(world) if path == ()
             else tloopback.OrderedUplinkFabric(world, W, UPLOAD))
        return lambda r: tloopback.LoopbackCommManager(f, r)

    tree_final, tree_rounds = _tree_rounds(ttr, tdata, (1, W), make_group_comm=make_group,
                                           buffer_goal=W, tier_staleness="const")
    assert [r for r, _ in tree_rounds] == [r for r, _ in flat_rounds]
    for (_, a), (_, b) in zip(tree_rounds, flat_rounds):
        _assert_bitwise(a, b)
    _assert_bitwise(tree_final, flat_final)


def test_shm_tree_matches_loopback_bitwise():
    ttr, tdata = _port_lr()
    kw = {"buffer_goal": 2, "tier_uplink_codec": "none"}
    loop_final, _ = _tree_rounds(ttr, tdata, (2, 2), **kw)
    shm_final, _ = _tree_rounds(ttr, tdata, (2, 2), runner=ttree.run_tree_fedavg_shm, **kw)
    _assert_bitwise(loop_final, shm_final)


def test_grpc_group_comm_allocates_disjoint_cell_ports():
    pytest.importorskip("grpc")
    from tests.test_comm import _free_port_run

    base = _free_port_run(6)
    group = ttree.GrpcGroupComm(base_port=base)
    f1 = group((), 3)
    f2 = group((0,), 3)
    c = f1(0)
    try:
        assert c is not None
    finally:
        c.stop_receive_message()
    assert group._next_port == base + 6 and f2 is not None


# -- window discipline: one edge cell over inline transports, both packages ----------


class _Tap:
    def __init__(self):
        self.partials = []

    def receive_message(self, msg_type, msg):
        if msg_type == PARTIAL:
            self.partials.append(msg)


def _edge_cell(pkg="port", child_num=3, model_size=16, rounds=4, **cfg_kwargs):
    tree, cascade, msg, _, codec = PKGS[pkg]
    if isinstance(cfg_kwargs.get("uplink_codec"), str):
        cfg_kwargs["uplink_codec"] = codec.make_codec(cfg_kwargs["uplink_codec"])
    flat, desc = msg.pack_pytree({"w": np.zeros(model_size, np.float32)})
    rounds_done = []
    server = tree.TreeFedAvgServerManager(
        cascade.InlineCommManager(cascade.InlineFabric(2), 0), 1, rounds, flat, desc,
        client_num_in_total=child_num, on_round_done=lambda r, f: rounds_done.append(r),
        tier_uplink_codec=cfg_kwargs.get("uplink_codec"))
    tap = _Tap()
    edge = tree.EdgeAggregatorManager(
        up_comm=cascade.InlineCommManager(server.comm.fabric, 1), up_rank=1,
        down_comm=cascade.InlineCommManager(cascade.InlineFabric(child_num + 1), 0),
        child_num=child_num, leaf_base=0, leaf_total=child_num, client_num_in_total=child_num,
        children_are_leaves=True, async_config=tree.EdgeAsyncConfig(**cfg_kwargs),
        model_desc=desc)
    edge.register_message_receive_handlers()
    server.register_message_receive_handlers()
    server.comm.add_observer(tap)
    server.send_init_msg()
    return server, edge, tap, rounds_done


def _upload(pkg, child, round_idx, x, n=4.0):
    m = PKGS[pkg][2].Message(tfd.MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, child, 0)
    m.add_params(tmsg.Message.MSG_ARG_KEY_MODEL_PARAMS,
                 np.ascontiguousarray(x.astype(np.float32)).view(np.uint8))
    m.add_params(tmsg.Message.MSG_ARG_KEY_NUM_SAMPLES, float(n))
    m.add_params(tmsg.Message.MSG_ARG_KEY_ROUND_IDX, round_idx)
    return m


def _partial_record(p):
    """A partial message as comparable values: its raw or encoded payload
    bytes, weight sum, folds and flags."""
    K = tmsg.Message
    payload = p.get(K.MSG_ARG_KEY_MODEL_PARAMS)
    if payload is None:
        payload = p.get(K.MSG_ARG_KEY_ENCODED_UPDATE)
    return (np.asarray(payload).tobytes(), p.get(K.MSG_ARG_KEY_ENCODED_DESC),
            float(p.get(K.MSG_ARG_KEY_WEIGHT_SUM)), p.get(K.MSG_ARG_KEY_FOLD_COUNT),
            p.get(K.MSG_ARG_KEY_ROUND_IDX), p.get(K.MSG_ARG_KEY_PARTIAL_SEQ),
            p.get(K.MSG_ARG_KEY_WINDOW_COMPLETE))


def _both(drive, **cell_kwargs):
    """Run ``drive(pkg, cell)`` on a port cell and a JAX cell; assert their
    partials equal and return the port cell's (server, edge, tap, done)."""
    cells = {}
    for pkg in ("port", "jax"):
        cells[pkg] = _edge_cell(pkg, **cell_kwargs)
        drive(pkg, cells[pkg])
    tp, jp = cells["port"][2].partials, cells["jax"][2].partials
    assert [_partial_record(p) for p in tp] == [_partial_record(p) for p in jp]
    assert cells["port"][3] == cells["jax"][3]
    assert cells["port"][1].tier_counters() == cells["jax"][1].tier_counters()
    return cells["port"]


def test_buffer_emissions_carry_seq_and_complete_flags():
    x = np.full(16, 0.5, np.float32)

    def drive(pkg, cell):
        _, edge, tap, done = cell
        edge.comm.notify(_upload(pkg, 1, 0, x))
        assert tap.partials == [] and done == []
        edge.comm.notify(_upload(pkg, 2, 0, x))
        assert len(tap.partials) == 1 and done == []
        edge.comm.notify(_upload(pkg, 3, 0, x))

    _, _, tap, done = _both(drive, child_num=3, buffer_goal=2)
    first, second = tap.partials
    K = ttree.TreeMessage
    assert (first.get(K.MSG_ARG_KEY_PARTIAL_SEQ), first.get(K.MSG_ARG_KEY_WINDOW_COMPLETE),
            first.get(K.MSG_ARG_KEY_FOLD_COUNT)) == (0, 0, 2)
    assert (second.get(K.MSG_ARG_KEY_PARTIAL_SEQ),
            second.get(K.MSG_ARG_KEY_WINDOW_COMPLETE)) == (1, 1)
    assert done == [0]
    assert sum(float(p.get(K.MSG_ARG_KEY_WEIGHT_SUM)) for p in tap.partials) == 12.0


def test_stale_upload_folds_downweighted_when_family_armed():
    x = np.full(16, 1.0, np.float32)

    def drive(pkg, cell):
        _, edge, _, _ = cell
        edge.comm.notify(_upload(pkg, 2, 0, x))
        edge.flush_window()
        edge.comm.notify(_upload(pkg, 1, 0, x, n=4.0))

    _, edge, tap, done = _both(drive, child_num=2, buffer_goal=1, staleness_weight="poly:0.5")
    assert done == [0]
    stale = tap.partials[-1]
    assert float(stale.get(ttree.TreeMessage.MSG_ARG_KEY_WEIGHT_SUM)) == pytest.approx(
        2.0 ** -0.5 * 4.0)
    assert stale.get(ttree.TreeMessage.MSG_ARG_KEY_WINDOW_COMPLETE) == 0
    assert edge.tier_counters()["stale_folds"] == 1

    def drive_plain(pkg, cell):
        _, edge, tap, _ = cell
        edge.comm.notify(_upload(pkg, 2, 0, x))
        edge.flush_window()
        n = len(tap.partials)
        edge.comm.notify(_upload(pkg, 1, 0, x))
        assert len(tap.partials) == n

    _, edge2, _, done2 = _both(drive_plain, child_num=2, buffer_goal=1)
    assert done2 == [0] and edge2.tier_counters()["stale_uploads"] == 1


def test_elastic_flush_emits_and_names_missing_children(caplog):
    x = np.full(16, 0.25, np.float32)

    def drive(pkg, cell):
        _, edge, tap, _ = cell
        edge.comm.notify(_upload(pkg, 1, 0, x))
        assert tap.partials == []
        with caplog.at_level(logging.WARNING):
            edge.flush_window()
        edge.flush_window()  # nothing pending and no prior emission: silent

    caplog.clear()
    _, edge, tap, done = _both(drive, child_num=3, buffer_goal=3, tier_timeout=30.0)
    assert len(tap.partials) == 1
    out = tap.partials[0]
    assert out.get(ttree.TreeMessage.MSG_ARG_KEY_WINDOW_COMPLETE) == 1
    assert float(out.get(ttree.TreeMessage.MSG_ARG_KEY_WEIGHT_SUM)) == 4.0
    assert edge.tier_counters()["elastic_emissions"] == 1
    port_logs = [r.getMessage() for r in caplog.records if r.name == "root"
                 and "elastic tier timeout" in r.getMessage()]
    assert len(port_logs) == 2 and all("[2, 3]" in m for m in port_logs)
    assert port_logs[0] == port_logs[1]
    assert done == [0] and edge.tier_counters()["emissions"] == 0
    edge._async_reset_window_locked()  # the armed 30 s timer, cancelled


def test_elastic_flush_zero_marker_after_mid_window_emissions():
    x = np.full(16, 0.25, np.float32)

    def drive(pkg, cell):
        _, edge, tap, done = cell
        edge.comm.notify(_upload(pkg, 1, 0, x))
        edge.comm.notify(_upload(pkg, 2, 0, x))
        assert len(tap.partials) == 2 and done == []
        edge.flush_window()

    _, _, tap, done = _both(drive, child_num=3, buffer_goal=1)
    marker = tap.partials[-1]
    assert len(tap.partials) == 3
    assert float(marker.get(ttree.TreeMessage.MSG_ARG_KEY_WEIGHT_SUM)) == 0.0
    assert marker.get(ttree.TreeMessage.MSG_ARG_KEY_WINDOW_COMPLETE) == 1
    assert done == [0]


def test_duplicate_and_replay_guards():
    x = np.full(16, 1.0, np.float32)

    def drive(pkg, cell):
        _, edge, _, _ = cell
        edge.comm.notify(_upload(pkg, 1, 0, x))
        edge.comm.notify(_upload(pkg, 1, 0, x))
        edge.comm.notify(_upload(pkg, 2, 0, x))

    _, edge, tap, done = _both(drive, child_num=2, buffer_goal=2)
    assert edge.tier_counters()["duplicate_uploads"] == 1 and done == [0]
    assert float(tap.partials[-1].get(ttree.TreeMessage.MSG_ARG_KEY_WEIGHT_SUM)) == 8.0

    flat, desc = tmsg.pack_pytree({"w": np.zeros(16, np.float32)})
    mid = ttree.EdgeAggregatorManager(
        up_comm=tcascade.InlineCommManager(tcascade.InlineFabric(2), 1), up_rank=1,
        down_comm=tcascade.InlineCommManager(tcascade.InlineFabric(2), 0), child_num=1,
        leaf_base=0, leaf_total=1, client_num_in_total=1, children_are_leaves=False,
        async_config=ttree.EdgeAsyncConfig(buffer_goal=1), model_desc=desc)
    mid.register_message_receive_handlers()
    part = tmsg.Message(PARTIAL, 1, 0)
    K = ttree.TreeMessage
    part.add_params(tmsg.Message.MSG_ARG_KEY_MODEL_PARAMS, np.ones(16, np.float64).view(np.uint8))
    part.add_params(K.MSG_ARG_KEY_WEIGHT_SUM, 2.0)
    part.add_params(K.MSG_ARG_KEY_FOLD_COUNT, 1)
    part.add_params(tmsg.Message.MSG_ARG_KEY_ROUND_IDX, 0)
    part.add_params(K.MSG_ARG_KEY_PARTIAL_SEQ, 0)
    part.add_params(K.MSG_ARG_KEY_WINDOW_COMPLETE, 1)
    mid.comm.notify(part)
    mid.comm.notify(part)
    assert mid.tier_counters()["duplicate_uploads"] == 1


def test_defense_rejects_nonfinite_and_clips_overbound():
    """The tier's clip defense at DP stddev 0: the port edge's partial
    bitwise the JAX edge's."""
    bad = np.full(16, np.nan, np.float32)
    huge = np.full(16, 100.0, np.float32)
    ok = np.full(16, 0.01, np.float32)

    def drive(pkg, cell):
        _, edge, _, _ = cell
        edge.comm.notify(_upload(pkg, 1, 0, bad))
        assert edge.tier_counters()["rejected_uploads"] == 1
        assert edge.tier_counters()["folds_total"] == 0
        edge.comm.notify(_upload(pkg, 2, 0, huge))
        assert edge.tier_counters()["clipped_uploads"] == 1
        edge.comm.notify(_upload(pkg, 3, 0, ok))
        edge.flush_window()

    cells = {}
    for pkg in ("port", "jax"):
        cells[pkg] = _edge_cell(pkg, child_num=3, buffer_goal=3,
                                defense=PKGS[pkg][3].RobustDistConfig(rule="mean",
                                                                       norm_bound=1.0))
        drive(pkg, cells[pkg])
    tp, jp = cells["port"][2].partials, cells["jax"][2].partials
    assert [_partial_record(p) for p in tp] == [_partial_record(p) for p in jp]
    assert cells["port"][3] == [0]
    out = tp[-1]
    acc = np.ascontiguousarray(np.asarray(out.get(tmsg.Message.MSG_ARG_KEY_MODEL_PARAMS))
                               ).view(np.float64)
    assert np.isfinite(acc).all()
    assert float(np.linalg.norm(acc)) <= 4.0 + 4.0 * np.linalg.norm(ok.astype(np.float64)) + 1e-9


def test_tier_dp_noise_is_the_ports_roundnoise():
    """With DP stddev > 0 the leaf tier adds ``RoundNoise(dp_seed +
    leaf_base * 1_000_003, emission).normal * stddev * wsum`` to the
    partial (the JAX key's integers, the port's draws: ROADMAP §C)."""
    x = np.full(16, 0.5, np.float32)
    outs = []
    for stddev in (0.0, 0.1):
        _, edge, tap, _ = _edge_cell(child_num=2, buffer_goal=2, defense=trd.RobustDistConfig(
            rule="mean", dp_stddev=stddev, dp_seed=3))
        edge.comm.notify(_upload("port", 1, 0, x))
        edge.comm.notify(_upload("port", 2, 0, x))
        outs.append(np.array(np.ascontiguousarray(np.asarray(tap.partials[0].get(
            tmsg.Message.MSG_ARG_KEY_MODEL_PARAMS))).view(np.float64)))
    noise = rnglib.RoundNoise(3, 0, "cpu").normal((16,), torch.float32).numpy().astype(np.float64)
    np.testing.assert_array_equal(outs[1], outs[0] + noise * (0.1 * 8.0))


def test_empty_round_error_names_tier_and_missing_children():
    agg = ttree.TierAggregator(3, tier_label="rank=2 leaf_base=64")
    agg.add_partial_result(0, np.zeros(4, np.float64), 1.0)
    err = agg._empty_round_error()
    jerr = jtree.TierAggregator(3, tier_label="rank=2 leaf_base=64")
    jerr.add_partial_result(0, np.zeros(4, np.float64), 1.0)
    assert isinstance(err, EmptyRoundError)
    assert str(err) == str(jerr._empty_round_error())
    assert "rank=2 leaf_base=64" in str(err) and "[2, 3]" in str(err)
    with pytest.raises(EmptyRoundError, match="rank=1 leaf_base=0"):
        ttree.TierAggregator(2, tier_label="rank=1 leaf_base=0").export_partial()


# -- tier codecs ----------------------------------------------------------------------


class _LazyJaxUniforms:
    """Serves the uniforms JAX's q8 draws from ``key`` for whatever leaf
    size the port's codec asks for."""

    def __init__(self, key):
        self.key = key

    def uniform(self, shape, dtype=torch.float32):
        return JaxUniforms(jax_draws("q8", self.key, {"acc": np.zeros(shape, np.float32)})
                           ).uniform(shape, dtype)


def _tier_key(leaf_base, round_idx, seq):
    return jax.random.fold_in(jax.random.fold_in(jax.random.key(0x7EE4 ^ leaf_base),
                                                 round_idx), seq)


@pytest.mark.parametrize("spec", ["none", "q8", "q4", "bf16"])
def test_encoded_partial_matches_jax_and_roundtrips(spec):
    """``encode_partial``/``decode_partial`` bitwise JAX's, the quantizers
    fed the uniforms JAX draws from the same key; the none codec passes the
    f64 accumulator through bit for bit, q8 reconstructs to a few
    delta-domain steps and cuts the bytes 4x."""
    rng = np.random.RandomState(3)
    d = 1000
    base = rng.randn(d)
    acc = 3.0 * base + rng.randn(d) * 0.05
    key = jax.random.key(0)
    tc, jc = tcodec.make_codec(spec), jcodec.make_codec(spec)
    b = None if spec == "none" else base
    tenc = tagg.encode_partial(acc, 3.0, b, tc, _LazyJaxUniforms(key))
    jenc = jagg.encode_partial(acc, 3.0, b, jc, key)
    tblob, tdesc = tmsg.pack_encoded_update(tenc)
    jblob, jdesc = jmsg.pack_encoded_update(jenc)
    np.testing.assert_array_equal(tblob, jblob)
    if spec == "none":
        # JAX's meta records the f64 accumulator's dtype as jnp.result_type
        # gives it with x64 off, float32; the none codec decodes from the
        # planes (f64 in both), never from the meta
        jdesc = jdesc.replace('\\"float32\\"', '\\"float64\\"')
    assert tdesc == jdesc
    out = tagg.decode_partial(tmsg.unpack_encoded_update(tblob, tdesc), 3.0, b, tc)
    np.testing.assert_array_equal(out, jagg.decode_partial(jenc, 3.0, b, jc))
    if spec == "none":
        np.testing.assert_array_equal(out, acc)
    if spec == "q8":
        assert acc.nbytes / (tblob.nbytes + len(tdesc)) >= 4.0
        delta = acc - 3.0 * base
        assert np.max(np.abs(out - acc)) <= 4 * (delta.max() - delta.min()) / 255
    with pytest.raises(ValueError, match="needs the round"):
        tagg.encode_partial(acc, 3.0, None, tcodec.make_codec("q8"), None)


def test_edge_q8_uplink_matches_jax_at_injected_uniforms(monkeypatch):
    """An edge's q8-coded partials: the port's frames bitwise the JAX
    edge's when the port's tier noise is replaced by the uniforms of the
    JAX key ``fold_in(fold_in(key(0x7EE4 ^ leaf_base), round), seq)``; the
    root decodes them to the same global."""
    monkeypatch.setattr(ttree.EdgeAggregatorManager, "partial_noise",
                        lambda self, r, seq: _LazyJaxUniforms(_tier_key(self.leaf_base, r, seq)))
    rng = np.random.RandomState(5)
    xs = [rng.randn(16).astype(np.float32) for _ in range(3)]

    def drive(pkg, cell):
        _, edge, _, _ = cell
        for c, x in enumerate(xs):
            edge.comm.notify(_upload(pkg, c + 1, 0, x))

    server, _, tap, done = _both(drive, child_num=3, buffer_goal=2, uplink_codec="q8")
    assert done == [0] and len(tap.partials) == 2
    assert tap.partials[0].get(tmsg.Message.MSG_ARG_KEY_ENCODED_UPDATE) is not None


def test_tier_noise_seeds_with_the_jax_integers():
    """Without injection the port's tier quantizer draws from
    ``TierNoise(0x7EE4 ^ leaf_base, round, seq)``: reproducible, one stream
    per emission."""
    a, b = ttree.TierNoise(0x7EE4 ^ 4, 1, 0), ttree.TierNoise(0x7EE4 ^ 4, 1, 0)
    assert torch.equal(a.uniform((32,)), b.uniform((32,)))
    assert not torch.equal(ttree.TierNoise(0x7EE4 ^ 4, 1, 1).uniform((32,)),
                           ttree.TierNoise(0x7EE4 ^ 4, 1, 0).uniform((32,)))


def test_stale_delta_encoded_partial_always_discarded():
    flat, desc = tmsg.pack_pytree({"w": np.zeros(16, np.float32)})
    mid = ttree.EdgeAggregatorManager(
        up_comm=tcascade.InlineCommManager(tcascade.InlineFabric(2), 1), up_rank=1,
        down_comm=tcascade.InlineCommManager(tcascade.InlineFabric(2), 0), child_num=1,
        leaf_base=0, leaf_total=1, client_num_in_total=1, children_are_leaves=False,
        async_config=ttree.EdgeAsyncConfig(buffer_goal=1, staleness_weight="poly:0.5",
                                           uplink_codec=tcodec.make_codec("q8")),
        model_desc=desc)
    mid.register_message_receive_handlers()
    mid._round = 2
    part = tmsg.Message(PARTIAL, 1, 0)
    K = ttree.TreeMessage
    part.add_params(tmsg.Message.MSG_ARG_KEY_ENCODED_UPDATE, np.zeros(4, np.uint8))
    part.add_params(tmsg.Message.MSG_ARG_KEY_ENCODED_DESC, "{}")
    part.add_params(K.MSG_ARG_KEY_WEIGHT_SUM, 1.0)
    part.add_params(K.MSG_ARG_KEY_FOLD_COUNT, 1)
    part.add_params(tmsg.Message.MSG_ARG_KEY_ROUND_IDX, 1)
    part.add_params(K.MSG_ARG_KEY_PARTIAL_SEQ, 0)
    mid.comm.notify(part)
    assert mid.tier_counters()["stale_uploads"] == 1
    assert mid.tier_counters()["folds_total"] == 0


# -- mixed federations -------------------------------------------------------------------

_REF: dict = {}


def _tree_federation(tier_pkg, client_pkg, rounds=2):
    """Root over one edge over ``W`` leaves, by hand: the root and edge of
    ``tier_pkg``, the clients of ``client_pkg``; the leaf fabric releases
    uploads in rank order. Returns the final flat bytes and descriptor."""
    (jtr, ttr), (jdata, tdata) = _lr_pair(), _blobs()
    template, flat, desc = jfd.init_template(jtr, jdata.arrays, B, 0)
    tree, loop = (jtree, jloopback) if tier_pkg == "jax" else (ttree, tloopback)
    root_fabric = tloopback.LoopbackFabric(2)
    leaf_fabric = tloopback.OrderedUplinkFabric(W + 1, W, UPLOAD)
    done = {}
    server = tree.TreeFedAvgServerManager(
        loop.LoopbackCommManager(root_fabric, 0), 1, rounds, flat, desc,
        client_num_in_total=W, on_round_done=lambda r, f: done.update(final=np.array(f)))
    edge = tree.EdgeAggregatorManager(
        up_comm=loop.LoopbackCommManager(root_fabric, 1), up_rank=1,
        down_comm=loop.LoopbackCommManager(leaf_fabric, 0), child_num=W, leaf_base=0,
        leaf_total=W, client_num_in_total=W, children_are_leaves=True,
        async_config=tree.EdgeAsyncConfig(buffer_goal=2, staleness_weight="const"),
        model_desc=desc)
    if client_pkg == "jax":
        make = _jax_clients(jtr)(1)
        clients = [make(jloopback.LoopbackCommManager(leaf_fabric, r), r, W + 1, jtr, jdata, B,
                        template) for r in range(1, W + 1)]
    else:
        clients = [tfd.FedAvgClientManager(tloopback.LoopbackCommManager(leaf_fabric, r), r,
                                           W + 1, ttr, tdata, B, convert.from_flax(template))
                   for r in range(1, W + 1)]
    _within_deadline(lambda: tfd.run_manager_protocol(server, [edge, *clients]),
                     [root_fabric, leaf_fabric])
    return done["final"], desc


@pytest.mark.parametrize("tiers", ["jax", "port"])
def test_mixed_tree_federation_reaches_the_all_jax_result(tiers):
    """A port root and async edge (buffer 2 of 4) over JAX clients: bitwise
    the all-JAX tree; a JAX root and edge over port clients: atol 1e-5."""
    if "ref" not in _REF:
        _REF["ref"] = _tree_federation("jax", "jax")
    ref, desc = _REF["ref"]
    got, _ = _tree_federation(tiers, "jax" if tiers == "port" else "port")
    if tiers == "port":
        np.testing.assert_array_equal(got, ref)
    else:
        _assert_close_to_jax(jfd.unpack_pytree(ref, desc), tfd.unpack_state(got, desc), 1e-5)


# -- the cascade (the slow soaks' stand-in) --------------------------------------------


def test_cascade_small_churned_hierarchy():
    rep = tcascade.run_cascade(
        (2, 2, 2), rounds=3, model_size=64, buffer_goal=2, tier_staleness="poly:0.5",
        tier_uplink_codec="q8",
        tier_defense=trd.RobustDistConfig(rule="mean", norm_bound=10.0, dp_stddev=1e-3,
                                          dp_seed=7),
        population="speed=lognormal:0,0.5;dropout=0.2;jitter=uniform:0,0.1")
    assert rep.tier_count == 6
    assert rep.uploads + rep.dropped_uploads == 3 * 8
    assert rep.interior_uplink_bytes > 0
    assert rep.max_tier_state_bytes <= 64 * (8 + 4 + 8) + 256
    assert np.isfinite(rep.uploads_per_s) and np.isfinite(rep.elapsed_s)


def test_cascade_matches_jax_without_noise():
    """The same churn, staleness and clip (no DP, raw f64 uplinks) through
    both packages' cascades: the same upload fates, counters and bytes."""
    kw = dict(rounds=3, model_size=48, seed=2, buffer_goal=2, tier_staleness="poly:0.5",
              population="dropout=0.25;jitter=uniform:0,0.15")
    t = tcascade.run_cascade((2, 3), tier_defense=trd.RobustDistConfig(norm_bound=2.0), **kw)
    j = jcascade.run_cascade((2, 3), tier_defense=jrd.RobustDistConfig(norm_bound=2.0), **kw)
    for field in ("uploads", "dropped_uploads", "delayed_uploads", "interior_uplink_bytes",
                  "interior_dense_bytes", "elastic_emissions", "stale_folds",
                  "clipped_uploads", "max_tier_state_bytes", "tiers"):
        assert getattr(t, field) == getattr(j, field), field


def test_cascade_rejects_churn_without_async_tiers():
    with pytest.raises(ValueError, match="barrier-free"):
        tcascade.run_cascade((2, 2), rounds=1, model_size=16, population="dropout=0.5")


def test_cascade_sync_matches_async_full_buffer():
    sync = tcascade.run_cascade((2, 2), rounds=2, model_size=32, seed=5)
    full = tcascade.run_cascade((2, 2), rounds=2, model_size=32, seed=5, buffer_goal=2,
                                tier_staleness="const")
    assert sync.uploads == full.uploads == 8
    assert full.interior_dense_bytes == sync.interior_dense_bytes


# -- the CLI tree plane -------------------------------------------------------------------


def test_cli_tree_async_knobs_end_to_end():
    args = tmain.parse_with_config(tmain.add_args(argparse.ArgumentParser()), [
        "--model", "lr", "--dataset", "synthetic_0.5_0.5", "--backend", "loopback",
        "--client_num_in_total", "8", "--client_num_per_round", "4", "--batch_size", "8",
        "--comm_round", "2", "--frequency_of_the_test", "2", "--lr", "0.05",
        "--server_mode", "tree", "--tree_fan_ins", "2,2", "--buffer_goal", "2",
        "--staleness_weight", "poly:0.5", "--tier_timeout", "1.5", "--tier_compressor", "q8",
        "--population", "speed=lognormal:0,0.5;jitter=uniform:0,0.05",
        "--send_retries", "1", "--heartbeat_interval", "0.2", "--device", "cpu"])
    history = tmain.run(args)
    assert len(history) == 2 and np.isfinite(history[-1]["Test/Loss"])


@pytest.mark.parametrize("extra", [
    ["--server_mode", "tree", "--tree_fan_ins", "2,2"],
    ["--server_mode", "tree", "--tree_fan_ins", "2,2", "--buffer_goal", "2",
     "--tier_compressor", "none"],
    ["--server_mode", "async", "--buffer_goal", "4"],
], ids=["tree", "tree-async-none", "async"])
def test_main_fedavg_server_modes_match_the_jax_cli(tmp_path, init_file, extra):  # noqa: F811
    """``main_fedavg --server_mode tree|async`` from the same initial
    variables: the port CLI's history and saved model atol 1e-5 of the JAX
    CLI's (the folds' arrival order is the threads')."""
    from fedml_tpu.obs.checkpoint import load_params as jax_load_params
    from fedml_tpu_torch.obs import checkpoint

    argv = BASE + ["--init_from", init_file] + extra
    jhist = jmain.main(argv + ["--save_params_to", str(tmp_path / "jax.npz")])
    thist = tmain.main(argv + ["--device", "cpu", "--save_params_to", str(tmp_path / "port.npz")])
    assert jhist.keys() == thist.keys()
    for k, v in jhist.items():
        assert thist[k] == pytest.approx(v, abs=1e-5), k
    _assert_close_to_jax(jax_load_params(tmp_path / "jax.npz"),
                         checkpoint.load_params(tmp_path / "port.npz"), atol=1e-5)
