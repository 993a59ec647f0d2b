"""The port's distributed FedAvg (``fedml_tpu_torch/algorithms/
fedavg_distributed.py``, ``fedavg_mobile.py``) over the loopback fabric,
against the JAX package's, on the CPU.

Every run goes over an ``OrderedUplinkFabric`` (the server folds the
uploads in sender order: f64 addition is not associative) and in a daemon
thread under a deadline of its own (:func:`_within_deadline`, 60 s): a
protocol bug fails the test instead of hanging the suite. The port starts
from the JAX run's initial variables (``init_overrides``).

Tolerances:

- the all-port run against the all-JAX run (LogisticRegression, and a
  depth-8 BatchNorm ResNet without dropout): atol 1e-5 (torch and XLA
  round the local steps otherwise);
- a JAX server with port clients: atol 1e-5 of the all-JAX run; a port
  server with JAX clients: bitwise the all-JAX run (the same upload bytes
  fold into the same global);
- top-k with error feedback, and q4 fed the JAX client's uniforms: atol
  1e-5 of the JAX runs, their ``Comm/*`` bytes equal;
- the mobile JSON format against the native one, the streaming tally
  against the buffered one, a checkpointed and resumed run against an
  uninterrupted one, telemetry and retries on against off: bitwise;
- the wire against the port's ``FedSim`` at full participation, full batch,
  E=1, no shuffle: rtol 2e-4, atol 2e-5 (the JAX package's own bound,
  ``tests/test_comm.py``).
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import json
import threading

import jax
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms import fedavg_distributed as jfd
from fedml_tpu.comm import loopback as jloopback
from fedml_tpu.compress import codec as jcodec
from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.core.trainer import make_local_train as jax_local_train
from fedml_tpu.data.synthetic import gaussian_blobs
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.models.resnet import CifarResNet as JaxResNet
from fedml_tpu.sim.cohort import FederatedArrays as JaxArrays
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
from fedml_tpu_torch.algorithms.fedavg_mobile import run_distributed_fedavg_mobile
from fedml_tpu_torch.comm import loopback as tloopback
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.retry import RetryPolicy
from fedml_tpu_torch.compress import codec as tcodec
from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import FedSim, SimConfig
from tests.test_torch_compress import JaxUniforms, jax_draws

UPLOAD = tfd.MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER
W, B, R = 4, 10, 2


def _within_deadline(fn, fabrics, timeout=60.0):
    """Run ``fn`` in a daemon thread; past ``timeout`` seconds stop every
    manager on ``fabrics`` (each package's stop sentinel in every queue)
    and fail."""
    out: dict = {}

    def target():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised on the test thread
            out["error"] = e

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.join(timeout)
    if thread.is_alive():
        for fabric in fabrics:
            for q in fabric.queues.values():
                q.put(tloopback.LoopbackCommManager._STOP)
                q.put(jloopback.LoopbackCommManager._STOP)
        thread.join(5.0)
        pytest.fail(f"the wire run did not finish within {timeout} s")
    if "error" in out:
        raise out["error"]
    return out["value"]


def _fabric(workers=W):
    return tloopback.OrderedUplinkFabric(workers + 1, workers, UPLOAD)


def _blobs():
    train, _ = gaussian_blobs(n_clients=W, samples_per_client=20, seed=5)
    return train, FederatedArrays(train.arrays, train.partition)


def _images():
    rng = np.random.RandomState(3)
    n = 2 * 8
    arrays = {"x": rng.randn(n, 8, 8, 3).astype(np.float32),
              "y": rng.randint(0, 4, n).astype(np.int32)}
    part = {0: np.arange(0, 8), 1: np.arange(8, 16)}
    return JaxArrays(arrays, part), FederatedArrays(arrays, part)


def _lr_pair(lr=0.2):
    return (JaxTrainer(module=JaxLR(num_classes=4), optimizer=optax.sgd(lr), epochs=1),
            ClientTrainer(module=LogisticRegression(num_classes=4, in_features=16, device="cpu"),
                          optimizer=sgd(lr), epochs=1))


def _resnet_pair():
    return (JaxTrainer(module=JaxResNet(depth=8, num_classes=4), optimizer=optax.sgd(0.05),
                       epochs=1),
            ClientTrainer(module=CifarResNet(depth=8, num_classes=4, device="cpu"),
                          optimizer=sgd(0.05), epochs=1))


def _jax_clients(trainer, **kw):
    """JAX client managers sharing one jitted local round (one compile)."""
    shared = jax.jit(jax_local_train(trainer))

    def cls_for(rank):
        def make(comm, r, size, tr, data, bs, tmpl):
            return jfd.FedAvgClientManager(comm, r, size, tr, data, bs, tmpl,
                                           local_train_fn=shared, **kw)
        return make

    return cls_for


def _run_jax(trainer, data, workers=W, batch=B, rounds=R, **kw):
    fabric = _fabric(workers)
    kw.setdefault("client_cls_for_rank", None if "codec" in kw else _jax_clients(trainer))
    final = _within_deadline(lambda: jfd.run_distributed_fedavg(
        trainer, data, workers, rounds, batch, lambda r: jloopback.LoopbackCommManager(fabric, r),
        **kw), [fabric])
    template, _, _ = jfd.init_template(trainer, data.arrays, batch, 0)
    return jax.tree.map(np.asarray, final), template


def _run_port(trainer, data, template, workers=W, batch=B, rounds=R, **kw):
    fabric = _fabric(workers)
    return _within_deadline(lambda: tfd.run_distributed_fedavg_loopback(
        trainer, data, workers, rounds, batch, fabric=fabric,
        init_overrides=convert.from_flax(template), **kw), [fabric])


def _assert_close_to_jax(jax_vars, state_dict, atol):
    flax = convert.to_flax(state_dict)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax_vars):
        node = flax
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=0, atol=atol)


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("model", ["lr", "resnet8"])
def test_all_port_run_matches_all_jax(model):
    if model == "lr":
        (jtr, ttr), (jdata, tdata), workers, batch = _lr_pair(), _blobs(), W, B
    else:
        (jtr, ttr), (jdata, tdata), workers, batch = _resnet_pair(), _images(), 2, 4
    jfinal, template = _run_jax(jtr, jdata, workers, batch)
    tfinal = _run_port(ttr, tdata, template, workers, batch)
    _assert_close_to_jax(jfinal, tfinal, atol=1e-5)


@pytest.mark.parametrize("server", ["jax", "port"])
def test_mixed_federation_reaches_the_all_jax_result(server):
    """One OrderedUplinkFabric: a JAX server with port clients, or a port
    server with JAX clients."""
    (jtr, ttr), (jdata, tdata) = _lr_pair(), _blobs()
    jfinal, template = _run_jax(jtr, jdata)
    _, flat, desc = jfd.init_template(jtr, jdata.arrays, B, 0)
    fabric = _fabric()
    done = {}
    port_tmpl = convert.from_flax(template)
    if server == "jax":
        srv = jfd.FedAvgServerManager(
            jloopback.LoopbackCommManager(fabric, 0), W, R, flat, desc,
            client_num_in_total=W, on_round_done=lambda r, f: done.update(final=f))
        clients = [tfd.FedAvgClientManager(tloopback.LoopbackCommManager(fabric, r), r, W + 1,
                                           ttr, tdata, B, port_tmpl) for r in range(1, W + 1)]
    else:
        srv = tfd.FedAvgServerManager(
            tloopback.LoopbackCommManager(fabric, 0), W, R, tfd.pack_state(port_tmpl),
            desc, client_num_in_total=W, on_round_done=lambda r, f: done.update(final=f))
        make = _jax_clients(jtr)(1)
        clients = [make(jloopback.LoopbackCommManager(fabric, r), r, W + 1, jtr, jdata, B,
                        template) for r in range(1, W + 1)]
    _within_deadline(lambda: tfd.run_manager_protocol(srv, clients), [fabric])
    got = tfd.unpack_state(done["final"], desc)
    if server == "jax":
        _assert_close_to_jax(jfinal, got, atol=1e-5)
    else:
        ref = jfd.pack_pytree(jfinal)[0]
        np.testing.assert_array_equal(tfd.pack_state(got), ref)


def test_wire_matches_the_port_fedsim():
    _, ttr = _lr_pair(0.1)
    train, test = gaussian_blobs(n_clients=4, samples_per_client=24, seed=6)
    tdata = FederatedArrays(train.arrays, train.partition)
    max_n = tdata.max_client_size()
    fabric = tloopback.LoopbackFabric(5)
    final = _within_deadline(lambda: tfd.run_distributed_fedavg_loopback(
        ttr, tdata, 4, 3, max_n, fabric=fabric), [fabric])
    cfg = SimConfig(client_num_in_total=4, client_num_per_round=4, batch_size=max_n,
                    comm_round=3, frequency_of_the_test=100, shuffle_each_round=False)
    sim_vars, _ = FedSim(ttr, tdata, test, cfg, device="cpu").run()
    for k, v in sim_vars.items():
        np.testing.assert_allclose(final[k].numpy(), v.cpu().numpy(), rtol=2e-4, atol=2e-5)


def test_mobile_json_matches_native_bitwise():
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    template = convert.to_flax(tfd.init_template(ttr, tdata.arrays, B)[0])
    native = _run_port(ttr, tdata, template)
    payloads = []

    class Spy(tloopback.LoopbackCommManager):
        def send_message(self, msg):
            if msg.get_sender_id() == 3 and msg.get(Message.MSG_ARG_KEY_MODEL_PARAMS) is not None:
                payloads.append(msg.get(Message.MSG_ARG_KEY_MODEL_PARAMS))
            super().send_message(msg)

    fabric = _fabric()
    mixed = _within_deadline(lambda: run_distributed_fedavg_mobile(
        ttr, tdata, W, R, B,
        make_comm=lambda r: (Spy if r == 3 else tloopback.LoopbackCommManager)(fabric, r),
        init_overrides=convert.from_flax(template), mobile_ranks={1, 3}), [fabric])
    _assert_bitwise(native, mixed)
    assert payloads and all(isinstance(json.loads(p), dict) for p in payloads)


@pytest.mark.parametrize("spec", [None, "topk"])
def test_streaming_tally_matches_buffered_bitwise(spec):
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    template = convert.to_flax(tfd.init_template(ttr, tdata.arrays, B)[0])
    kw = {} if spec is None else {"codec": tcodec.make_codec(spec, topk_frac=0.1)}
    runs = [_run_port(ttr, tdata, template, server_kwargs={"buffered_aggregation": b}, **kw)
            for b in (False, True)]
    _assert_bitwise(*runs)


def test_compressed_topk_with_error_feedback_matches_jax():
    (jtr, ttr), (jdata, tdata) = _lr_pair(), _blobs()
    jstats, tstats = {}, {}
    jfinal, template = _run_jax(jtr, jdata, rounds=3,
                                codec=jcodec.make_codec("topk", topk_frac=0.1),
                                error_feedback=True, comm_stats=jstats)
    tfinal = _run_port(ttr, tdata, template, rounds=3,
                       codec=tcodec.make_codec("topk", topk_frac=0.1), error_feedback=True,
                       comm_stats=tstats)
    _assert_close_to_jax(jfinal, tfinal, atol=1e-5)
    assert jstats["totals"] == tstats["totals"]


def test_compressed_q4_matches_jax_given_its_uniforms(monkeypatch):
    """The port client's quantizer fed the uniforms the JAX client draws
    from ``fold_in(key(0xC0DEC ^ rank), round)``."""
    (jtr, ttr), (jdata, tdata) = _lr_pair(), _blobs()
    jfinal, template = _run_jax(jtr, jdata, codec=jcodec.make_codec("q4"),
                                error_feedback=True)
    shapes = {k: v.numpy() for k, v in tfd.jax_layout(convert.from_flax(template)).items()}

    def upload_noise(self, round_idx):
        key = jax.random.fold_in(jax.random.key(0xC0DEC ^ self.rank), round_idx)
        return JaxUniforms(jax_draws("q4", key, shapes))

    monkeypatch.setattr(tfd.CompressedFedAvgClientManager, "upload_noise", upload_noise)
    tfinal = _run_port(ttr, tdata, template, codec=tcodec.make_codec("q4"), error_feedback=True)
    _assert_close_to_jax(jfinal, tfinal, atol=1e-5)


def test_checkpointed_and_resumed_run_matches_an_uninterrupted_one(tmp_path):
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    template = convert.to_flax(tfd.init_template(ttr, tdata.arrays, B)[0])
    whole = _run_port(ttr, tdata, template, rounds=3)
    ckpt = str(tmp_path / "ckpt")
    _run_port(ttr, tdata, template, rounds=2, checkpoint_dir=ckpt)
    resumed = _run_port(ttr, tdata, template, rounds=3, checkpoint_dir=ckpt, resume=True)
    _assert_bitwise(whole, resumed)
    # every round already closed: the checkpointed global is the result
    again = _run_port(ttr, tdata, template, rounds=3, checkpoint_dir=ckpt, resume=True)
    _assert_bitwise(whole, again)


def test_telemetry_and_retries_leave_the_result_unchanged():
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    template = convert.to_flax(tfd.init_template(ttr, tdata.arrays, B)[0])
    plain = _run_port(ttr, tdata, template)
    fleet, stats = {}, {}
    armed = _run_port(ttr, tdata, template, fleet_stats=fleet, comm_stats=stats,
                      retry_policy=RetryPolicy(max_attempts=2, base_delay=0.0),
                      fold_workers=2, fold_chunk=16)
    _assert_bitwise(plain, armed)
    unicast = _run_port(ttr, tdata, template, server_kwargs={"use_broadcast": False})
    _assert_bitwise(plain, unicast)
    assert len(fleet["rounds"]) == R and set(fleet["totals"]["ranks"]) == {"1", "2", "3", "4"}
    assert stats["totals"]["Comm/RetryCount"] == 0
    assert stats["totals"]["Comm/StaleUploads"] == 0


@pytest.mark.parametrize("kwarg, value", [
    ("trace_wire", True), ("downlink_codec", "q8"),
])
def test_unported_kwargs_raise_naming_their_roadmap_item(kwarg, value):
    """The downlink delta codec (ROADMAP §A11.4) and the cross-rank trace
    lanes (§A11.5) raise; ``server_mode="async"`` is ported
    (``tests/test_torch_async_agg.py``)."""
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    with pytest.raises(NotImplementedError, match="ROADMAP §A11"):
        tfd.run_distributed_fedavg_loopback(ttr, tdata, W, R, B, **{kwarg: value})


def _upload(mod, sender, flat, n, round_idx):
    m = mod.Message(UPLOAD, sender, 0)
    m.add_params("model_params", flat)
    m.add_params("num_samples", float(n))
    m.add_params("round_idx", round_idx)
    return m


def test_server_timeout_exclusion_readmission_and_stale_uploads_match_jax():
    """Each package's server driven through its handlers with the same
    messages: round 0 times out without worker 3, which is excluded; its
    status contact queues it for readmission at round 1's close; round 2
    folds all three; a stale upload is counted, not folded. The globals
    are bitwise equal round by round, and so are the live sets and the
    status tables."""
    from fedml_tpu.comm import message as jmsg
    from fedml_tpu.comm.status import ClientStatus as JaxStatus
    from fedml_tpu_torch.comm import message as tmsg
    from fedml_tpu_torch.comm.status import ClientStatus

    rng = np.random.RandomState(4)
    flats = {(r, w): rng.randn(33).astype(np.float32).view(np.uint8)
             for r in range(3) for w in (1, 2, 3)}
    desc = json.dumps([{"path": "w", "shape": [33], "dtype": "float32"}])
    init = np.zeros(33, np.float32).view(np.uint8)
    seen = []
    for fd, loop, mod, status in ((jfd, jloopback, jmsg, JaxStatus),
                                  (tfd, tloopback, tmsg, ClientStatus)):
        fabric = loop.LoopbackFabric(4)
        globals_ = []
        server = fd.FedAvgServerManager(
            loop.LoopbackCommManager(fabric, 0), 3, 4, init, desc, round_timeout=60.0,
            exclude_after=1, readmission=True,
            on_round_done=lambda r, f, g=globals_: g.append(np.array(f)))
        for w in (1, 2):
            server._on_model_from_client(_upload(mod, w, flats[0, w], 10 * w, 0))
        server._round_timed_out(0)
        excluded = server.aggregator.live_workers()
        contact = mod.Message(status.MSG_TYPE_CLIENT_STATUS, 3, 0)
        contact.add_params(status.KEY_STATUS, status.ONLINE)
        server._on_client_status(contact)
        for w in (1, 2):
            server._on_model_from_client(_upload(mod, w, flats[1, w], 10 * w, 1))
        readmitted = server.aggregator.live_workers()
        server._on_model_from_client(_upload(mod, 1, flats[0, 1], 10, 0))  # stale
        for w in (3, 1, 2):
            server._on_model_from_client(_upload(mod, w, flats[2, w], 10 * w, 2))
        seen.append((globals_, excluded, readmitted, server.stale_uploads,
                     server.status.snapshot(), server.round_idx))
    (jg, *jrest), (tg, *trest) = seen
    assert trest == jrest and trest[:2] == [[0, 1], [0, 1, 2]] and trest[2] == 1
    assert len(tg) == len(jg) == 3
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a, b)
