"""The port's downlink delta coding (``fedml_tpu_torch/compress/downlink.py``
and its branches in the wire servers, clients and runners) against the JAX
package's, on the CPU, case by case with ``tests/test_downlink.py``.

- **The codec state, driven in step with JAX's.** The same flats through
  the port's and the JAX ``DownlinkCodecState`` and ``DownlinkDecoder``:
  every ``advance`` returns the JAX state's decoded bytes, and every chain
  blob and descriptor ``serve`` hands out is JAX's, byte for byte. bf16 and
  top-k draw nothing; q8 and q4 are fed the uniforms JAX draws from
  ``fold_in(key(0xD0DEC), version)`` (the port draws from ``RoundNoise(
  0xD0DEC, version)``, ROADMAP §C). Keyframe cadence, one blob per gap,
  retention, the staleness floor, the decoder's guards: equal outcomes.
- **Mixed federations over loopback.** A JAX server with port clients and
  a port server with JAX clients, q8 and top-k downlinks: every client's
  held model is bitwise the server's decoded model at its version, every
  version it held. With top-k the final global is within atol 1e-5 of the
  all-JAX run (torch and XLA round the local steps otherwise).
- **The JAX bit-identity contracts on the port alone.** A resolved-``none``
  run and a q8 run at ``keyframe_every=1`` are bitwise the dense run; a
  checkpoint-resumed q8 run is bitwise the uninterrupted one and re-anchors
  on a keyframe; a ``buffer_goal=1`` async run serves cumulative chains and
  a (2, 2) tree delivers chains to its leaves, every held model bitwise the
  decoded one at its version.
- **The CLI.** ``--downlink_compressor`` on ``--jobs``: the same records,
  and the same ``Comm/*`` byte counts, as the JAX CLI.

Every wire run has a deadline of its own (60 s).
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse
import json

import jax
import numpy as np
import pytest

from fedml_tpu.algorithms import fedavg_distributed as jfd
from fedml_tpu.comm import loopback as jloopback
from fedml_tpu.comm import message as jmsg
from fedml_tpu.compress import codec as jcodec
from fedml_tpu.compress import downlink as jdl
from fedml_tpu.exp import main_fedavg as jmain
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
from fedml_tpu_torch.async_agg import server as tasrv
from fedml_tpu_torch.async_agg import tree as ttree
from fedml_tpu_torch.comm import loopback as tloopback
from fedml_tpu_torch.comm import message as tmsg
from fedml_tpu_torch.compress import codec as tcodec
from fedml_tpu_torch.compress import downlink as tdl
from fedml_tpu_torch.exp import main_fedavg as tmain
from fedml_tpu_torch.obs import metrics as metricslib
from fedml_tpu_torch.sim.engine import SimConfig
from tests.test_torch_compress import JaxUniforms, jax_draws
from tests.test_torch_fedavg_dist import (
    B,
    W,
    _assert_bitwise,
    _assert_close_to_jax,
    _blobs,
    _fabric,
    _jax_clients,
    _lr_pair,
    _run_jax,
    _run_port,
    _within_deadline,
)

TOPK = 0.1


def _fixture(dim=24, seed=3):
    rng = np.random.RandomState(seed)
    tree = {"w": rng.randn(dim, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    flat, desc = tmsg.pack_pytree(tree)
    assert np.array_equal(flat, jmsg.pack_pytree(tree)[0])
    return flat, desc, rng


def _f32(u8):
    return np.array(np.ascontiguousarray(np.asarray(u8)).view(np.float32))


def _shapes(desc):
    return {d["path"]: np.zeros(d["shape"], np.float32) for d in json.loads(desc)}


def jax_downlink_noise(spec, desc):
    """``DownlinkCodecState.noise`` serving the uniforms JAX's state draws
    for ``version`` (``fold_in(key(0xD0DEC), version)``)."""
    shapes = _shapes(desc)

    def noise(version):
        key = jax.random.fold_in(jax.random.key(0xD0DEC), version)
        return JaxUniforms(jax_draws(spec, key, shapes, topk_frac=TOPK))

    return noise


def _states(spec, desc, **kw):
    """The JAX and the port state for ``spec`` on one model descriptor, the
    port's quantizer fed JAX's uniforms."""
    js = jdl.DownlinkCodecState(jcodec.make_codec(spec, topk_frac=TOPK), desc, **kw)
    ts = tdl.DownlinkCodecState(tcodec.make_codec(spec, topk_frac=TOPK), desc, **kw)
    ts.noise = jax_downlink_noise(spec, desc)
    return js, ts


def _both(js, ts, method, *args):
    """Call ``method`` on both states and hold the results equal: arrays and
    blobs bitwise, descriptors and reasons as strings."""
    a, b = getattr(js, method)(*args), getattr(ts, method)(*args)
    if isinstance(a, tuple):
        assert a[0] == b[0] and a[2] == b[2], (a, b)
        if a[0] == "delta":
            np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
        else:
            assert a[1] == b[1]
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b
    return b


# -- resolution ------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [None, "none", "  none ", "q8", "topk+q4", "bf16"])
def test_resolve_matches_jax(spec):
    j = jdl.resolve_downlink_codec(spec, topk_frac=TOPK)
    t = tdl.resolve_downlink_codec(spec, topk_frac=TOPK)
    assert (j is None) == (t is None)
    if t is not None:
        assert t.name == j.name
    assert tdl.resolve_downlink_codec(tcodec.make_codec("none")) is None
    codec = tcodec.make_codec("bf16")
    assert tdl.resolve_downlink_codec(codec) is codec


def test_state_rejects_none_codec():
    _, desc, _ = _fixture()
    with pytest.raises(ValueError, match="delta-domain"):
        tdl.DownlinkCodecState(tcodec.make_codec("none"), desc)


# -- server state: keyframes, chains, retention -------------------------------------


@pytest.mark.parametrize("spec", ["bf16", "topk", "topk+bf16", "q8", "q4", "topk+q8"])
def test_advance_and_chains_match_jax(spec):
    """Every advance returns JAX's decoded bytes, every served chain is JAX's
    blob and descriptor, and the port's decoder reconstructs it bitwise, one
    step at a time and as a cumulative chain."""
    flat, desc, rng = _fixture()
    js, ts = _states(spec, desc, keyframe_every=100, retention=8)
    fresh, straggler = (tdl.DownlinkDecoder(ts.codec) for _ in range(2))
    init = _both(js, ts, "reset", flat, 0)
    fresh.apply_keyframe(init, 0)
    straggler.apply_keyframe(init, 0)
    prev = _f32(flat)
    for v in range(1, 5):
        new = prev + rng.randn(prev.size).astype(np.float32)
        out = _f32(_both(js, ts, "advance", new.view(np.uint8), v))
        assert not np.array_equal(out, new)  # lossy, against the decoded base
        kind, blob, cdesc = _both(js, ts, "serve", fresh.version)
        assert kind == "delta"
        fresh.apply_chain(blob, cdesc, fresh.version, v)
        np.testing.assert_array_equal(fresh.held, out)
        prev = out
    kind, blob, cdesc = _both(js, ts, "serve", 0)
    assert [s["version"] for s in json.loads(cdesc)["steps"]] == [1, 2, 3, 4]
    straggler.apply_chain(blob, cdesc, 0, 4)
    np.testing.assert_array_equal(straggler.held, prev)
    assert ts.stats_snapshot() == js.stats_snapshot()


def test_keyframe_cadence_resets_chain_and_is_exact():
    flat, desc, _ = _fixture()
    js, ts = _states("q8", desc, keyframe_every=3, retention=8)
    _both(js, ts, "reset", flat, 0)
    base = _f32(flat)
    _both(js, ts, "advance", (base + 1).view(np.uint8), 1)
    _both(js, ts, "advance", (base + 2).view(np.uint8), 2)
    out = _f32(_both(js, ts, "advance", (base + 3).view(np.uint8), 3))
    np.testing.assert_array_equal(out, base + 3)  # a keyframe is the exact aggregate
    kind, _, retired = _both(js, ts, "serve", 2)
    assert kind == "keyframe" and not retired  # the designed cadence, not retired
    s = ts.stats_snapshot()
    assert s == js.stats_snapshot() and s["keyframes"] == 2 and s["deltas"] == 2


def test_cumulative_chain_shares_one_blob_per_gap():
    flat, desc, _ = _fixture()
    js, ts = _states("q8", desc, keyframe_every=100, retention=8)
    _both(js, ts, "reset", flat, 0)
    base = _f32(flat)
    for v in range(1, 4):
        _both(js, ts, "advance", (base + v).view(np.uint8), v)
    k1, blob1, d1 = _both(js, ts, "serve", 1)
    k2, blob2, d2 = ts.serve(1)
    assert k1 == k2 == "delta"
    assert blob1 is blob2 and d1 is d2  # cached: one blob per distinct gap
    assert [s["version"] for s in json.loads(d1)["steps"]] == [2, 3]


def test_retention_trims_and_flags_retired():
    flat, desc, _ = _fixture()
    js, ts = _states("q8", desc, keyframe_every=100, retention=2)
    _both(js, ts, "reset", flat, 0)
    base = _f32(flat)
    for v in range(1, 5):
        _both(js, ts, "advance", (base + v).view(np.uint8), v)
    kind, reason, retired = _both(js, ts, "serve", 0)
    assert kind == "keyframe" and retired and "retired" in reason
    assert _both(js, ts, "serve", 2)[0] == "delta"
    assert ts.stats_snapshot()["retired_fallbacks"] == 1


def test_staleness_p99_raises_retention_floor():
    flat, desc, _ = _fixture()
    js, ts = _states("q8", desc, keyframe_every=1000, retention=1)
    _both(js, ts, "reset", flat, 0)
    base = _f32(flat)
    assert _both(js, ts, "retention_effective") == 1
    for _ in range(50):
        _both(js, ts, "observe_staleness", 3)
    assert _both(js, ts, "retention_effective") == 4
    for v in range(1, 7):
        _both(js, ts, "advance", (base + v).view(np.uint8), v)
    assert _both(js, ts, "serve", 2)[0] == "delta"
    for _ in range(5000):
        ts.observe_staleness(1)
    ts.advance((base + 7).view(np.uint8), 7)
    assert ts.retention_effective() == 4  # the floor never shrinks


def test_serve_current_or_unknown_base_is_keyframe():
    flat, desc, _ = _fixture()
    js, ts = _states("q8", desc)
    _both(js, ts, "reset", flat, 0)
    assert _both(js, ts, "serve", None)[::2] == ("keyframe", False)
    assert _both(js, ts, "serve", 0)[::2] == ("keyframe", False)


# -- client decoder -----------------------------------------------------------------


def test_decoder_guards_match_jax():
    """Each guard raises the JAX decoder's error, in its words."""
    flat, desc, _ = _fixture()
    js, ts = _states("q8", desc, keyframe_every=100, retention=8)
    _both(js, ts, "reset", flat, 0)
    base = _f32(flat)
    _both(js, ts, "advance", (base + 1).view(np.uint8), 1)
    _both(js, ts, "advance", (base + 2).view(np.uint8), 2)
    _, blob, cdesc = _both(js, ts, "serve", 1)  # step 2 only
    mangled = json.dumps({**json.loads(cdesc), "kind": "nonsense"})
    cases = [  # (codec spec, held version or None, chain desc, base)
        ("q8", None, cdesc, 1),
        ("q8", 0, cdesc, None),
        ("q8", 0, cdesc, 1),
        ("q4", 1, cdesc, 1),
        ("q8", 1, mangled, 1),
    ]
    for spec, held, d, b in cases:
        errs = []
        for pkg, make in ((jdl, jcodec.make_codec), (tdl, tcodec.make_codec)):
            dec = pkg.DownlinkDecoder(make(spec))
            if held is not None:
                dec.apply_keyframe(flat, held)
            with pytest.raises(RuntimeError) as e:
                dec.apply_chain(blob, d, b, 2)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_decoder_skips_already_held_steps():
    flat, desc, _ = _fixture()
    js, ts = _states("q8", desc, keyframe_every=100, retention=8)
    client = tdl.DownlinkDecoder(ts.codec)
    client.apply_keyframe(_both(js, ts, "reset", flat, 0), 0)
    base = _f32(flat)
    _both(js, ts, "advance", (base + 1).view(np.uint8), 1)
    _, blob, cdesc = _both(js, ts, "serve", 0)
    client.apply_chain(blob, cdesc, 0, 1)
    out = _f32(_both(js, ts, "advance", (base + 2).view(np.uint8), 2))
    _, blob, cdesc = _both(js, ts, "serve", 0)  # the server still thinks base 0
    client.apply_chain(blob, cdesc, 0, 2)
    np.testing.assert_array_equal(client.held, out)
    assert client.version == 2


def test_sim_engine_refuses_in_the_jax_words():
    with pytest.raises(ValueError) as ours:
        SimConfig(downlink_compressor="q8")
    from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
    from fedml_tpu.data.synthetic import gaussian_blobs
    from fedml_tpu.models.linear import LogisticRegression as JaxLR
    from fedml_tpu.sim.engine import FedSim as JaxSim
    from fedml_tpu.sim.engine import SimConfig as JaxConfig
    import optax

    train, test = gaussian_blobs(n_clients=4, samples_per_client=16, seed=0)
    with pytest.raises(ValueError) as theirs:
        JaxSim(JaxTrainer(module=JaxLR(num_classes=4), optimizer=optax.sgd(0.1), epochs=1),
               train, test, JaxConfig(client_num_in_total=4, client_num_per_round=4,
                                      comm_round=1, downlink_compressor="q8"))
    assert str(ours.value) == str(theirs.value)
    assert SimConfig(downlink_compressor="none") == SimConfig()


def test_runner_refuses_downlink_with_custom_managers():
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    with pytest.raises(ValueError, match="custom manager classes"):
        tfd.run_distributed_fedavg_loopback(ttr, tdata, 2, 1, 4, downlink_codec="q8",
                                            server_cls=tfd.FedAvgServerManager)


# -- federations ----------------------------------------------------------------------


@pytest.fixture
def record(monkeypatch):
    """Every decoded model a server of either package made (by version) and
    every model a client of either package held after a sync (version,
    bytes)."""
    rec = {"decoded": {}, "held": []}
    for pkg in (jdl, tdl):
        state, dec = pkg.DownlinkCodecState, pkg.DownlinkDecoder

        def wrap_state(orig):
            def f(self, flat, version):
                out = orig(self, flat, version)
                rec["decoded"][int(version)] = _f32(out)
                return out
            return f

        def wrap_decoder(orig):
            def f(self, *args):
                held = orig(self, *args)
                rec["held"].append((self.version, _f32(held)))
                return held
            return f

        for name in ("reset", "advance"):
            monkeypatch.setattr(state, name, wrap_state(getattr(state, name)))
        for name in ("apply_keyframe", "apply_chain"):
            monkeypatch.setattr(dec, name, wrap_decoder(getattr(dec, name)))
    return rec


def _assert_held_is_decoded(rec, min_held):
    assert len(rec["held"]) >= min_held
    for version, held in rec["held"]:
        np.testing.assert_array_equal(held, rec["decoded"][version],
                                      err_msg=f"held model at version {version}")


@pytest.mark.parametrize("spec", ["q8", "topk"])
@pytest.mark.parametrize("server", ["jax", "port"])
def test_mixed_federation_reconstructs_bitwise(record, server, spec):
    """A JAX server with port clients, or a port server with JAX clients,
    one OrderedUplinkFabric, 3 rounds of delta syncs: every held model is
    the server's decoded one at its version; with top-k the final global is
    the all-JAX run's within atol 1e-5."""
    rounds = 3
    (jtr, ttr), (jdata, tdata) = _lr_pair(), _blobs()
    jcod, tcod = jcodec.make_codec(spec, topk_frac=TOPK), tcodec.make_codec(spec, topk_frac=TOPK)
    down = {"downlink_keyframe_every": 64, "downlink_retention": 4}
    template, flat, desc = jfd.init_template(jtr, jdata.arrays, B, 0)
    fabric = _fabric()
    done = {}
    port_tmpl = convert.from_flax(template)
    if server == "jax":
        srv = jfd.FedAvgServerManager(
            jloopback.LoopbackCommManager(fabric, 0), W, rounds, flat, desc,
            client_num_in_total=W, on_round_done=lambda r, f: done.update(final=f),
            downlink_codec=jcod, **down)
        clients = [tfd.FedAvgClientManager(tloopback.LoopbackCommManager(fabric, r), r, W + 1,
                                           ttr, tdata, B, port_tmpl) for r in range(1, W + 1)]
        for c in clients:
            c.downlink_codec = tcod
    else:
        srv = tfd.FedAvgServerManager(
            tloopback.LoopbackCommManager(fabric, 0), W, rounds, tfd.pack_state(port_tmpl),
            desc, client_num_in_total=W, on_round_done=lambda r, f: done.update(final=f),
            downlink_codec=tcod, **down)
        make = _jax_clients(jtr)(1)
        clients = [make(jloopback.LoopbackCommManager(fabric, r), r, W + 1, jtr, jdata, B,
                        template) for r in range(1, W + 1)]
        for c in clients:
            c.downlink_codec = jcod
    _within_deadline(lambda: tfd.run_manager_protocol(srv, clients), [fabric])
    # the init keyframe and two delta syncs per client
    _assert_held_is_decoded(record, W * rounds)
    assert srv.downlink.stats_snapshot()["chains_served"] == W * (rounds - 1)
    if spec == "topk":
        jfinal, _ = _run_jax(jtr, jdata, rounds=rounds, client_cls_for_rank=None,
                             downlink_codec=jcod, **down)
        _assert_close_to_jax(jfinal, tfd.unpack_state(done["final"], desc), atol=1e-5)


@pytest.mark.parametrize("arm", ["none", "q8_keyframe_every_1"])
def test_none_and_all_keyframe_runs_are_the_dense_run(arm):
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    template = convert.to_flax(tfd.init_template(ttr, tdata.arrays, B)[0])
    dense = _run_port(ttr, tdata, template, rounds=3)
    kw = ({"downlink_codec": "none"} if arm == "none"
          else {"downlink_codec": tcodec.make_codec("q8"), "downlink_keyframe_every": 1})
    _assert_bitwise(dense, _run_port(ttr, tdata, template, rounds=3, **kw))


def test_resumed_run_reanchors_on_a_keyframe(tmp_path, record):
    """A q8 run checkpointed after 2 rounds and resumed to 3: bitwise the
    uninterrupted run, and every client's first sync after the resume is the
    dense keyframe of the checkpointed (decoded) global."""
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    template = convert.to_flax(tfd.init_template(ttr, tdata.arrays, B)[0])
    kw = {"downlink_codec": "q8", "downlink_keyframe_every": 64}
    whole = _run_port(ttr, tdata, template, rounds=3, **kw)
    ckpt = str(tmp_path / "ckpt")
    _run_port(ttr, tdata, template, rounds=2, checkpoint_dir=ckpt, **kw)
    stats: dict = {}
    resumed = _run_port(ttr, tdata, template, rounds=3, checkpoint_dir=ckpt, resume=True,
                        comm_stats=stats, **kw)
    _assert_bitwise(whole, resumed)
    assert stats["rounds"][0]["round"] == 2
    assert stats["rounds"][0][metricslib.COMM_DOWNLINK_KEYFRAMES] == W
    _assert_held_is_decoded(record, 3 * W)


def test_async_buffer_goal_one_serves_cumulative_chains(record):
    """buffer_goal=1 over a rank-ordered uplink: later ranks of each upload
    wave train against an older version, so the server serves cumulative
    chains; every held model is bitwise the decoded one at its version."""
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    codec = tcodec.make_codec("q8")
    template, flat, desc = tfd.init_template(ttr, tdata.arrays, 8, 0)
    fabric = _fabric()
    server = tasrv.AsyncFedAvgServerManager(
        tloopback.LoopbackCommManager(fabric, 0), W, 3 * W, flat, desc,
        client_num_in_total=tdata.num_clients, buffer_goal=1,
        downlink_codec=codec, downlink_keyframe_every=5, downlink_retention=8)
    clients = [tfd.FedAvgClientManager(tloopback.LoopbackCommManager(fabric, r), r, W + 1,
                                       ttr, tdata, 8, template) for r in range(1, W + 1)]
    for c in clients:
        c.downlink_codec = codec
    _within_deadline(lambda: tfd.run_manager_protocol(server, clients), [fabric])
    assert server.async_totals()[metricslib.ASYNC_STALE_FOLDS] > 0
    stats = server.downlink.stats_snapshot()
    cumulative = stats["chain_steps_served"] - stats["chains_served"]
    assert stats["chains_served"] > 0 and cumulative > 0, stats
    _assert_held_is_decoded(record, 3 * W)
    assert all(c._downlink.version in record["decoded"] for c in clients)


def test_tree_delivers_chains_to_the_leaves(record):
    """q8 deltas through a (2, 2) tree: the edges re-serve the chain
    verbatim, the leaves reconstruct it bitwise, and the root's records
    show rounds served by chains alone."""
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    comm: dict = {}
    ttree.run_tree_fedavg_loopback(ttr, tdata, (2, 2), 3, 8, downlink_codec="q8",
                                   downlink_keyframe_every=64, comm_stats=comm)
    assert comm["totals"][metricslib.COMM_DOWNLINK_BYTES] > 0
    assert [r for r in comm["rounds"] if metricslib.COMM_DOWNLINK_KEYFRAMES not in r]
    _assert_held_is_decoded(record, 3 * W)


def test_tree_all_keyframes_is_the_dense_tree_bitwise():
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    dense = ttree.run_tree_fedavg_loopback(ttr, tdata, (2, 2), 2, 8)
    kf = ttree.run_tree_fedavg_loopback(ttr, tdata, (2, 2), 2, 8,
                                        downlink_codec=tcodec.make_codec("q8"),
                                        downlink_keyframe_every=1)
    _assert_bitwise(dense, kf)


JOBS = ["--dataset", "synthetic", "--backend", "loopback", "--comm_round", "3",
        "--client_num_in_total", "4", "--client_num_per_round", "4",
        "--frequency_of_the_test", "1", "--batch_size", "16"]


def test_main_fedavg_jobs_with_a_q8_downlink_job_match_the_jax_cli(tmp_path):
    """``--jobs`` with a dense job and a q8-downlink job: the port's
    records have the JAX CLI's jobs, rounds and keys, and the q8 job's
    ``Comm/*`` byte counts (encoded chains, keyframes, dense equivalent)
    are the JAX job's."""
    path = tmp_path / "jobs.json"
    path.write_text(json.dumps([{"job_id": "dense"},
                                {"job_id": "q8", "downlink_compressor": "q8",
                                 "downlink_keyframe_every": 64}]))

    def run(cli, extra):
        args = cli.parse_with_config(cli.add_args(argparse.ArgumentParser()),
                                     JOBS + ["--jobs", str(path)] + extra)
        return cli.run(args)

    theirs, ours = run(jmain, []), run(tmain, ["--device", "cpu"])
    assert [(r["job"], r["round"]) for r in ours] == [(r["job"], r["round"]) for r in theirs]
    for a, b in zip(ours, theirs):
        assert set(a) == set(b) - {"_ts"}
        assert np.isfinite(a["Test/Loss"])
        for k in a:
            if k.startswith("Comm/"):
                assert a[k] == b[k], (a["job"], a["round"], k)
    q8 = [r for r in ours if r["job"] == "q8"]
    assert q8[-1][metricslib.COMM_DOWNLINK_BYTES] < q8[-1][metricslib.COMM_DOWNLINK_DENSE_BYTES]
    assert not any(k.startswith("Comm/") for r in ours if r["job"] == "dense" for k in r)
