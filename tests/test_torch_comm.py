"""The port's wire layer (``fedml_tpu_torch/comm``, the copies it rests on,
the server tallies and the mobile transfer format) against the JAX
package's, on the same numpy-made inputs.

Tolerances: none. Frames, pack descriptors and payload bytes are
byte-equal across the packages, and each package decodes the other's
frames (a broadcast's ``(head, shared_tail)`` pair included); the copies
(``send_pool``, ``retry``, ``registry``, ``fold_plane``) give the JAX
module's results on the same calls; the server tallies fold the same
upload bytes into a bitwise-equal global. The port's codec planes are
bitwise JAX's given JAX's uniforms (the ``JaxUniforms`` stub of the
compression tests).
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedavg_distributed as jfd
from fedml_tpu.algorithms import fold_plane as jfold
from fedml_tpu.comm import message as jmsg
from fedml_tpu.comm import retry as jretry
from fedml_tpu.comm import send_pool as jpool
from fedml_tpu.compress import codec as jcodec
from fedml_tpu.models import cnn as jcnn
from fedml_tpu.models import export as jexport
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.models.resnet import CifarResNet as JaxResNet
from fedml_tpu.obs import registry as jregistry
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
from fedml_tpu_torch.algorithms import fold_plane as tfold
from fedml_tpu_torch.comm import loopback as tloopback
from fedml_tpu_torch.comm import message as tmsg
from fedml_tpu_torch.comm import retry as tretry
from fedml_tpu_torch.comm import send_pool as tpool
from fedml_tpu_torch.compress import codec as tcodec
from fedml_tpu_torch.models import export as texport
from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.obs import registry as tregistry
from tests.test_torch_compress import JaxUniforms, jax_draws


def _arrays():
    rng = np.random.RandomState(0)
    return {"flat": rng.randint(0, 255, 37).astype(np.uint8),
            "w": rng.randn(3, 5).astype(np.float32),
            "count": np.array(16_777_217, np.int64),
            "f64": rng.randn(4).astype(np.float64)}


def _message(mod):
    m = mod.Message(3, 2, 0)
    for k, v in _arrays().items():
        m.add_params(k, v)
    m.add_params("num_samples", 17.0)
    m.add_params("round_idx", 4)
    m.add_params("model_desc", json.dumps([{"path": "a/b", "shape": [2], "dtype": "float32"}]))
    m.add_params("telemetry", {"step_ms": 1.5, "retries": 0})
    return m


def _assert_same_message(a, b):
    assert a.get_params().keys() == b.get_params().keys()
    for k, v in a.get_params().items():
        w = b.get(k)
        if isinstance(v, np.ndarray):
            assert not w.flags.writeable and w.dtype == v.dtype
            np.testing.assert_array_equal(w, v)
        else:
            assert w == v


def test_message_bytes_equal_and_each_package_decodes_the_other():
    jb, tb = _message(jmsg).to_bytes(), _message(tmsg).to_bytes()
    assert jb == tb
    _assert_same_message(jmsg.Message.from_bytes(tb), tmsg.Message.from_bytes(jb))
    _assert_same_message(_message(tmsg), tmsg.Message.from_bytes(jb))


@pytest.mark.parametrize("overrides", [None, {"client_idx": 7}])
def test_broadcast_pairs_equal_and_cross_decode(overrides):
    jf, tf = _message(jmsg).frame(), _message(tmsg).frame()
    assert jf.tail_bytes() == tf.tail_bytes()
    for dst in (1, 12, 4096):
        jhead, thead = jf.head_for(dst, overrides), tf.head_for(dst, overrides)
        assert jhead == thead
        assert jf.bytes_for(dst, overrides) == tf.bytes_for(dst, overrides)
        got = tmsg.Message.from_buffers(jhead, jf.tail_bytes())
        back = jmsg.Message.from_buffers(thead, tf.tail_bytes())
        _assert_same_message(back, got)
        assert got.get_receiver_id() == dst
        if overrides:
            assert got.get("client_idx") == 7


def test_frame_encodes_once_and_refuses_array_overrides():
    m = tmsg.Message(2, 0, 1)
    m.add_params("model_params", np.arange(64, dtype=np.float32))
    tmsg.reset_wire_stats()
    frame = m.frame()
    for dst in range(1, 6):
        frame.bytes_for(dst)
    assert tmsg.wire_stats()["payload_serializations"] == 1
    with pytest.raises(ValueError, match="header-only"):
        frame.head_for(2, {"x": np.zeros(2)})
    with pytest.raises(ValueError, match="payload segment"):
        frame.head_for(2, {"model_params": 1})


def test_loopback_fabric_carries_jax_and_port_frames():
    """One port fabric: a JAX manager and a port manager exchange a unary
    send and a broadcast; the ordered fabric releases held uplinks in
    sender order."""
    from fedml_tpu.comm.loopback import LoopbackCommManager as JaxComm

    fabric = tloopback.OrderedUplinkFabric(3, expected=2, msg_type=5)
    port0, jax1 = tloopback.LoopbackCommManager(fabric, 0), JaxComm(fabric, 1)
    got = []

    class Obs:
        def receive_message(self, msg_type, msg):
            got.append(msg)
            if len(got) == 3:
                port0.stop_receive_message()

    port0.add_observer(Obs())
    jax1.send_message(_message(jmsg))
    for sender in (2, 1):  # held until both posted, released in sender order
        up = jmsg.Message(5, sender, 0)
        up.add_params("x", np.full(3, sender, np.float32))
        jax1.send_message(up)
    port0.handle_receive_message()
    assert [m.get_sender_id() for m in got] == [2, 1, 2]
    _assert_same_message(_message(tmsg), got[0])
    got.clear()

    class Obs1:
        def receive_message(self, msg_type, msg):
            got.append(msg)
            jax1.stop_receive_message()

    jax1.add_observer(Obs1())
    port0.broadcast_message(_message(tmsg), [1], {1: {"client_idx": 3}})
    jax1.handle_receive_message()
    assert got[0].get("client_idx") == 3 and got[0].get_receiver_id() == 1


# -- pack_pytree over the JAX layout -------------------------------------------


def _jax_variables(name, rng):
    if name == "lr":
        model, x = JaxLR(num_classes=10), rng.rand(2, 784)
    elif name == "cnn":
        model, x = jcnn.CNNOriginalFedAvg(num_classes=62), rng.rand(2, 28, 28)
    else:
        model, x = JaxResNet(depth=8, num_classes=10), rng.randn(2, 8, 8, 3)
    variables = model.init(jax.random.key(int(rng.randint(1 << 30))),
                           jnp.asarray(x, jnp.float32))
    return jax.tree.map(np.asarray, dict(variables))


def _port_model(name):
    if name == "lr":
        return LogisticRegression(num_classes=10, device="cpu")
    if name == "cnn":
        return CNNOriginalFedAvg(num_classes=62, device="cpu")
    return CifarResNet(depth=8, num_classes=10, device="cpu")


@pytest.mark.parametrize("name", ["lr", "cnn", "resnet8"])
def test_pack_pytree_of_the_port_model_matches_jax(name):
    """The port module's own state dict (loaded from the JAX variables),
    through ``to_flax``, packs to JAX's bytes and descriptor; BatchNorm's
    statistics travel as ``batch_stats`` in the same order; the port reads
    JAX's bytes back to the same state dict."""
    jv = _jax_variables(name, np.random.RandomState(1))
    model = _port_model(name)
    model.load_state_dict(convert.from_flax(jv))
    flat, desc = tmsg.pack_pytree(convert.to_flax(model.state_dict()))
    jflat, jdesc = jmsg.pack_pytree(jv)
    assert desc == jdesc
    np.testing.assert_array_equal(flat, jflat)
    assert ("batch_stats" in jdesc) == (name == "resnet8")
    back = tfd.unpack_state(jflat, jdesc)
    assert back.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v)
    # the device-side JAX layout is the same leaves in the wire order
    lay = tfd.jax_layout(model.state_dict())
    assert list(lay) == [d["path"] for d in json.loads(jdesc)]


def test_unpack_pytree_views_are_readonly_and_bf16_round_trips():
    tree = {"b": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "a": torch.arange(5, dtype=torch.float32).to(torch.bfloat16),
            "c": np.array(3, np.int64)}
    flat, desc = tmsg.pack_pytree(tree)
    jflat, jdesc = jmsg.pack_pytree({"b": tree["b"], "c": tree["c"],
                                     "a": jnp.arange(5, dtype=jnp.bfloat16)})
    assert desc == jdesc
    np.testing.assert_array_equal(flat, jflat)
    back = tmsg.unpack_pytree(flat, desc)
    assert not back["b"]["w"].flags.writeable
    assert back["a"].dtype == torch.bfloat16 and torch.equal(back["a"], tree["a"])


# a JAX-layout tree with a conv kernel, BatchNorm statistics and odd sizes
# (q4's padding nibble), its leaves in an order the flat dict does not have
_BN_TREE = {"params": {"Dense_0": {"kernel": (12, 5), "bias": (5,)},
                       "Conv_0": {"kernel": (3, 3, 2, 3)}},
            "batch_stats": {"BatchNorm_0": {"var": (3,), "mean": (3,)}}}


def _delta(name, seed):
    rng = np.random.RandomState(seed)
    jv = (_jax_variables(name, rng) if name == "lr"
          else jax.tree.map(np.zeros, _BN_TREE, is_leaf=lambda s: isinstance(s, tuple)))
    return jax.tree.map(lambda v: (rng.randn(*v.shape) * 0.01).astype(np.float32), jv)


@pytest.mark.parametrize("spec", ["topk", "q4", "topk+q4"])
@pytest.mark.parametrize("name", ["lr", "bn_tree"])
def test_pack_encoded_update_matches_jax(spec, name):
    """An update encoded in the JAX layout packs to JAX's bytes and
    descriptor (top-k's flat indices and q4's nibble pairs included), and
    each package decodes the other's payload to the same dense update."""
    delta = _delta(name, 3)
    key = jax.random.key(11)
    jc = jcodec.make_codec(spec, topk_frac=0.05)
    tc = tcodec.make_codec(spec, topk_frac=0.05)
    jenc = jc.encode(delta, key)
    flat_delta = {p: torch.from_numpy(np.array(v))
                  for p, v in tmsg.tree_leaves_with_paths(delta)}
    tenc = tc.encode(flat_delta, JaxUniforms(jax_draws(spec, key, flat_delta, topk_frac=0.05)))
    jflat, jdesc = jmsg.pack_encoded_update(jenc)
    flat, desc = tmsg.pack_encoded_update(tenc)
    assert desc == jdesc
    np.testing.assert_array_equal(flat, jflat)
    dense = tc.decode(tmsg.unpack_encoded_update(jflat, jdesc))
    jdense = jc.decode(jmsg.unpack_encoded_update(flat, desc))
    for (path, jleaf) in jax.tree_util.tree_leaves_with_path(jdense):
        p = "/".join(k.key for k in path)
        np.testing.assert_array_equal(dense[p].numpy(), np.asarray(jleaf))


# -- the server tallies ---------------------------------------------------------


def _payloads(n, size=33, seed=0):
    rng = np.random.RandomState(seed)
    flats = [rng.randn(size).astype(np.float32).view(np.uint8) for _ in range(n)]
    weights = [float(w) for w in rng.randint(1, 50, n)]
    return flats, weights


@pytest.mark.parametrize("order", [[0, 1, 2, 3], [3, 1, 0, 2]])
@pytest.mark.parametrize("cls", ["FedAvgDistAggregator", "BufferedFedAvgDistAggregator"])
def test_dense_tally_bitwise_jax(order, cls):
    flats, weights = _payloads(4)
    jagg, tagg = getattr(jfd, cls)(4), getattr(tfd, cls)(4)
    for i in order:
        assert (jagg.add_local_trained_result(i, flats[i], weights[i])
                == tagg.add_local_trained_result(i, flats[i], weights[i]))
    np.testing.assert_array_equal(tagg.aggregate(), jagg.aggregate())


@pytest.mark.parametrize("spec", ["none", "topk", "q8", "q4"])
@pytest.mark.parametrize("buffered", [False, True])
def test_compressed_tally_bitwise_jax(spec, buffered):
    """The same encoded upload bytes folded by each package's server give
    the bitwise-same global (JAX decodes its own planes, the port its
    copy of them); the streaming and buffered tallies agree bitwise."""
    rng = np.random.RandomState(5)
    shapes = {"params": {"Dense_0": {"bias": (7,), "kernel": (9, 7)}}}
    base = {"params": {"Dense_0": {k: rng.randn(*s).astype(np.float32)
                                   for k, s in shapes["params"]["Dense_0"].items()}}}
    base_flat, _ = jmsg.pack_pytree(base)
    jc, tc = jcodec.make_codec(spec, topk_frac=0.2), tcodec.make_codec(spec, topk_frac=0.2)
    names = ("CompressedBufferedDistAggregator" if buffered else "CompressedDistAggregator",)
    outs = []
    for mod, codec, unpack in ((jfd, jc, jmsg.unpack_encoded_update),
                               (tfd, tc, tmsg.unpack_encoded_update)):
        agg = getattr(mod, names[0])(3, codec)
        agg.get_global = lambda: base_flat
        for i in (2, 0, 1):
            d = jax.tree.map(lambda v: (np.random.RandomState(i).randn(*v.shape) * 0.1)
                             .astype(np.float32), base)
            payload = d if spec != "none" else jax.tree.map(np.add, base, d)
            enc = jc.encode(payload, jax.random.key(i))
            flat, desc = jmsg.pack_encoded_update(enc)
            agg.add_local_trained_result(i, unpack(flat, desc), float(10 + i))
        outs.append(agg.aggregate())
    np.testing.assert_array_equal(outs[1], outs[0])


# -- the copies -----------------------------------------------------------------


@pytest.mark.parametrize("mod", [jpool, tpool], ids=["jax", "port"])
def test_send_pool_orders_per_destination_and_collects_errors(mod):
    pool = mod.SendWorkerPool(3, name="t")
    seen: dict[int, list[int]] = {}
    lock = threading.Lock()

    def send(dst, i):
        with lock:
            seen.setdefault(dst, []).append(i)
        if dst == 2 and i == 1:
            raise OSError("down")

    jobs = [(d, (lambda d=d, i=i: send(d, i))) for i in range(4) for d in (1, 2, 3)]
    with pytest.raises(mod.BroadcastSendError) as e:
        pool.run_all(jobs)
    assert sorted(e.value.errors) == [2]
    assert seen == {d: [0, 1, 2, 3] for d in (1, 2, 3)}
    pool.close()


def test_retry_policy_matches_jax():
    for mod in (jretry, tretry):
        policy = mod.RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0)
        assert [policy.delay_for(k) for k in (1, 2, 3)] == [0.0, 0.0, 0.0]
    j = jretry.RetryPolicy(base_delay=0.01, backoff=3.0, max_delay=0.05, jitter=0.0)
    t = tretry.RetryPolicy(base_delay=0.01, backoff=3.0, max_delay=0.05, jitter=0.0)
    assert [j.delay_for(k) for k in range(1, 5)] == [t.delay_for(k) for k in range(1, 5)]
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("transient")
        return "ok"

    before = tretry.retry_stats()["retries"]
    retried = []
    assert tretry.RetryPolicy(max_attempts=3, base_delay=0.0).run(
        flaky, on_retry=lambda: retried.append(1)) == "ok"
    assert len(calls) == 3 and len(retried) == 2
    assert tretry.retry_stats()["retries"] - before == 2
    with pytest.raises(ConnectionError):
        tretry.RetryPolicy(max_attempts=2, base_delay=0.0).run(
            lambda: (_ for _ in ()).throw(ConnectionError("down")))
    with pytest.raises(ValueError, match="max_attempts"):
        tretry.RetryPolicy(max_attempts=0)


def _strip_times(snap):
    for rank in snap["ranks"].values():
        rank["timeline"] = [s for _, s in rank["timeline"]]
    return snap


def test_registry_and_fleet_health_match_jax():
    out = []
    for mod in (jregistry, tregistry):
        reg = mod.MetricRegistry()
        reg.counter("a", 2.0)
        reg.gauge("g", 3.5)
        for v in (0.0, 1.0, 2.5, 50.0, 1e6):
            reg.observe("h", v)
        fleet = mod.FleetHealth()
        for r in (1, 2):
            fleet.record_state(r, "ONLINE")
            fleet.counter(r, "uploads")
            fleet.observe(r, "staleness", r - 1)
            fleet.merge_report(r, {"step_ms": 3.5 * r, "retries": r})
        fleet.record_state(2, mod.STATE_READMITTED)
        out.append((reg.snapshot(), _strip_times(fleet.round_record(0)),
                    _strip_times(fleet.snapshot())))
    assert out[0] == out[1]


@pytest.mark.parametrize("order", [[0, 1, 2, 3, 4], [4, 2, 0, 3, 1]])
def test_fold_plane_dense_and_encoded_bitwise_jax(order):
    """The plane's chunked folds equal the serial fold and the JAX plane's,
    bitwise, for dense and top-k uploads."""
    flats, weights = _payloads(5, size=1000, seed=7)
    outs = []
    for fd in (jfd, tfd):
        for workers in (0, 3):
            agg = fd.FedAvgDistAggregator(5)
            if workers:
                agg.attach_fold_plane((jfold if fd is jfd else tfold).FoldPlane(
                    workers, chunk_elems=96))
            for i in order:
                agg.add_local_trained_result(i, flats[i], weights[i])
            outs.append(agg.aggregate())
            agg.close_fold_plane()
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    base = {"w": np.zeros(1000, np.float32)}
    jc, tc = jcodec.make_codec("topk", topk_frac=0.1), tcodec.make_codec("topk", topk_frac=0.1)
    outs = []
    for fd, codec, unpack, fold in ((jfd, jc, jmsg.unpack_encoded_update, jfold),
                                    (tfd, tc, tmsg.unpack_encoded_update, tfold)):
        for workers in (0, 2):
            agg = fd.CompressedDistAggregator(5, codec)
            agg.get_global = lambda: jmsg.pack_pytree(base)[0]
            if workers:
                agg.attach_fold_plane(fold.FoldPlane(workers, chunk_elems=128))
            for i in order:
                enc = jc.encode({"w": flats[i].view(np.float32)[:1000]}, None)
                agg.add_local_trained_result(i, unpack(*jmsg.pack_encoded_update(enc)),
                                             weights[i])
            outs.append(agg.aggregate())
            agg.close_fold_plane()
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


# -- the mobile transfer format -------------------------------------------------


def test_mobile_transfer_format_matches_jax():
    jv = _jax_variables("resnet8", np.random.RandomState(2))
    assert texport.params_to_nested_lists(jv) == jexport.params_to_nested_lists(jv)
    assert json.dumps(texport.params_to_nested_lists(jv)) == json.dumps(
        jexport.params_to_nested_lists(jv))
    tlist, jlist = texport.params_to_flat_list(jv), jexport.params_to_flat_list(jv)
    assert len(tlist) == len(jlist)
    for a, b in zip(tlist, jlist):
        np.testing.assert_array_equal(a, b)
    back = texport.nested_lists_to_params(jexport.params_to_nested_lists(jv), jv)
    flat = texport.flat_list_to_params(jlist, jv)
    for tree in (back, flat):
        np.testing.assert_array_equal(tmsg.pack_pytree(tree)[0], jmsg.pack_pytree(jv)[0])
    with pytest.raises(ValueError, match="missing parameter"):
        texport.nested_lists_to_params({}, jv)


def test_create_backend_builds_loopback_and_refuses_the_rest(tmp_path):
    from fedml_tpu_torch.comm.managers import create_backend

    from fedml_tpu_torch.comm.object_store import OffloadCommManager

    fabric = tloopback.LoopbackFabric(2)
    assert isinstance(create_backend("loopback", 1, 2, fabric=fabric),
                      tloopback.LoopbackCommManager)
    # the other arms are ported (tests/test_torch_transports.py builds each);
    # an object store composes with any of them
    offload = create_backend("loopback", 0, 2, fabric=fabric, store_dir=str(tmp_path))
    assert isinstance(offload, OffloadCommManager)
    assert isinstance(offload.inner, tloopback.LoopbackCommManager)
    with pytest.raises(ImportError, match="requires paho-mqtt"):
        create_backend("mqtt", 0, 2)
    with pytest.raises(ValueError, match="unknown backend"):
        create_backend("carrier-pigeon", 0, 2)
