"""The port's transports against the JAX package's, on the CPU: the native
shm ring (built from the port's own copy of ``shm_ring.cpp``) and
``ShmCommManager``, ``GRPCCommManager``, the in-process MQTT broker with
``MqttCommManager``, ``OffloadCommManager`` over a ``FileSystemStore``, the
``create_backend`` arms, federations that mix JAX and port ranks over each
transport, and ``main_fedavg --backend shm|grpc|mqtt_s3``.

Every protocol run is in a daemon thread under a deadline of its own
(:func:`_within`, 60 s, which stops every manager and fails). gRPC ranks
take ports the OS found free (bound to port 0, then released); shm rings
carry a uuid job name and are unlinked at the end.

Tolerances: frames, blobs and payloads bitwise; a mixed federation (a JAX
server with port clients, or a port server with JAX clients) atol 1e-5 of
the all-JAX run over loopback, ``tests/test_torch_fedavg_dist.py``'s bound
(over real transports the server folds the uploads in arrival order, f64
addition is not associative, and port clients round their local steps
otherwise); the CLIs' histories and saved models atol 1e-5 of the JAX
CLI's.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import functools
import os
import socket
import threading
import uuid
from pathlib import Path

import numpy as np
import pytest

from fedml_tpu.algorithms import fedavg_distributed as jfd
from fedml_tpu.comm import grpc_backend as jgrpc
from fedml_tpu.comm import message as jmsg
from fedml_tpu.comm import mqtt_backend as jmqtt
from fedml_tpu.comm import object_store as jobj
from fedml_tpu.comm import shm as jshm
from fedml_tpu.exp import main_fedavg as jmain
from fedml_tpu.obs.checkpoint import load_params as jax_load_params
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
from fedml_tpu_torch.comm import grpc_backend as tgrpc
from fedml_tpu_torch.comm import inproc_broker as tbroker
from fedml_tpu_torch.comm import loopback as tloopback
from fedml_tpu_torch.comm import message as tmsg
from fedml_tpu_torch.comm import mqtt_backend as tmqtt
from fedml_tpu_torch.comm import object_store as tobj
from fedml_tpu_torch.comm import shm as tshm
from fedml_tpu_torch.comm.managers import create_backend
from fedml_tpu_torch.exp import main_fedavg as tmain
from fedml_tpu_torch.obs import checkpoint
from tests.test_comm import _free_port_run, _libc_shm_open
from tests.test_torch_fedavg_dist import (
    _assert_close_to_jax,
    _blobs,
    _jax_clients,
    _lr_pair,
    _run_jax,
)
from tests.test_torch_wire_families import BASE, init_file  # noqa: F401  (a fixture)

ROOT = Path(__file__).resolve().parent.parent
W, B, R = 4, 10, 2


def _within(fn, managers, timeout=60.0):
    """Run ``fn`` in a daemon thread; past ``timeout`` seconds stop every
    manager in ``managers`` and fail."""
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
        for m in managers:
            try:
                m.stop_receive_message()
            except Exception:  # noqa: BLE001 — best-effort unblock
                pass
        thread.join(5.0)
        pytest.fail(f"the run did not finish within {timeout} s")
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _free_ports(n: int) -> list[int]:
    """``n`` distinct free ports, each bound to port 0 by the OS."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


# -- the native ring ------------------------------------------------------------

def test_ring_builds_from_the_ports_own_copy():
    lib = tshm._load_lib()
    built = Path(lib._name).resolve()
    assert built.is_relative_to(ROOT / "fedml_tpu_torch" / "ops" / "_build")
    assert built == tshm.library_path().resolve() and built.name.startswith("libshmring-")
    assert tshm._SRC.resolve() == ROOT / "fedml_tpu_torch" / "comm" / "native" / "shm_ring.cpp"
    # the port's copy is the JAX package's source, so the segment layouts agree
    jax_src = (ROOT / "fedml_tpu" / "ops" / "native" / "shm_ring.cpp").read_text()
    assert tshm._SRC.read_text() == jax_src.replace("see fedml_tpu/comm/shm.py",
                                                   "see fedml_tpu_torch/comm/shm.py")


def test_ring_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "shm_ring.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tshm, "_SRC", bad)
    monkeypatch.setattr(tshm, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tshm.build()


def test_ring_round_trip_wraps_and_times_out():
    name = f"/fedml_torch_{uuid.uuid4().hex[:10]}"
    ring = tshm.ShmRing(name, capacity=1 << 16, create=True)
    try:
        ring.send(b"hello")
        assert ring.recv(timeout_ms=500) == b"hello"
        blob = bytes(range(256)) * 16  # 4 KB: 40 of them wrap the 64 KB ring
        for _ in range(40):
            ring.send(blob)
            assert ring.recv(timeout_ms=500) == blob
        assert ring.recv(timeout_ms=50) is None
    finally:
        ring.close()
        ring.unlink()


@pytest.mark.parametrize("creator", ["jax", "port"])
def test_jax_and_port_rings_open_each_other(creator):
    """The two packages' libraries, built from one source into two files,
    share a segment: one creates it, the other opens it by name."""
    name = f"/fedml_mix_{uuid.uuid4().hex[:10]}"
    mods = (jshm, tshm) if creator == "jax" else (tshm, jshm)
    owner = mods[0].ShmRing(name, capacity=1 << 16, create=True)
    other = mods[1].ShmRing(name, create=False)
    try:
        other.send(b"from the other package")
        assert owner.recv(timeout_ms=500) == b"from the other package"
        owner.send(b"and back")
        assert other.recv(timeout_ms=500) == b"and back"
    finally:
        other.close()
        owner.close()
        owner.unlink()


def test_a_closed_ring_raises_where_the_jax_ring_crashes():
    """A send on a closed ring (a delayed fault's timer firing after the
    runner unlinked the rings) raises in the port; the JAX ring passes the
    NULL handle to C and the process dies of SIGSEGV (ROADMAP §C)."""
    import subprocess
    import sys

    code = ("import uuid\nfrom {mod} import ShmRing\n"
            "r = ShmRing('/c' + uuid.uuid4().hex[:10], 1 << 16, create=True)\n"
            "r.close(); r.unlink()\n"
            "try:\n    r.send(b'late')\nexcept OSError as e:\n    print('raised', e)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = {pkg: subprocess.run([sys.executable, "-c", code.format(mod=mod)], cwd=ROOT, env=env,
                               capture_output=True, text=True, timeout=120)
           for pkg, mod in (("jax", "fedml_tpu.comm.shm"), ("port", "fedml_tpu_torch.comm.shm"))}
    assert run["port"].returncode == 0 and "is closed" in run["port"].stdout
    assert run["jax"].returncode == -11  # SIGSEGV


@pytest.mark.skipif(_libc_shm_open() is None,
                    reason="shm_open not exported by this container's libc or librt "
                           "(ctypes cannot forge the stale segment this test needs)")
def test_ring_recovers_a_stale_segment(monkeypatch):
    """A creator that died between O_EXCL and publishing the magic word
    leaves a half-initialized segment, and a dead recoverer its lock
    segment; ``shmring_create`` unlinks and rebuilds (the JAX package's
    ``test_shm_ring_stale_segment_recovery`` on the port's library)."""
    import ctypes

    tshm._load_lib()
    name = f"/fedml_stale_{uuid.uuid4().hex[:10]}"
    monkeypatch.setenv("FEDML_SHMRING_WAIT_MS", "50")
    libc = ctypes.CDLL(None, use_errno=True)
    shm_open = _libc_shm_open()
    for seg, size in ((name, 1 << 16), (f"{name}.rec", 0)):
        fd = shm_open(seg.encode(), 0o102, 0o600)  # O_CREAT|O_RDWR
        assert fd >= 0
        if size:
            libc.ftruncate(fd, size)
        libc.close(fd)
    ring = tshm.ShmRing(name, capacity=1 << 12, create=True)
    try:
        ring.send(b"recovered")
        assert ring.recv(timeout_ms=500) == b"recovered"
    finally:
        ring.close()
        ring.unlink()
    assert shm_open(f"{name}.rec".encode(), 2, 0o600) < 0  # the lock segment went too


# -- the managers ---------------------------------------------------------------

JAX = {"shm": jshm, "grpc": jgrpc, "mqtt": jmqtt, "obj": jobj, "msg": jmsg}
PORT = {"shm": tshm, "grpc": tgrpc, "mqtt": tmqtt, "obj": tobj, "msg": tmsg}


def _mqtt_ranks(mods, tmp_path, offload):
    topic = f"t{uuid.uuid4().hex[:8]}"
    factory = tbroker.InProcessBroker().client_factory()
    mgrs = [m["mqtt"].MqttCommManager("inproc", 1883, topic=topic, client_id=r, client_num=2,
                                      client_factory=factory) for r, m in enumerate(mods)]
    if not offload:
        return mgrs
    return [m["obj"].OffloadCommManager(inner, m["obj"].FileSystemStore(tmp_path / "store"),
                                        threshold_bytes=256) for inner, m in zip(mgrs, mods)]


def _ranks(transport, tmp_path, mods):
    if transport == "shm":
        job = f"t{uuid.uuid4().hex[:10]}"
        return [m["shm"].ShmCommManager(job, r, 3, capacity=1 << 20) for r, m in enumerate(mods)]
    if transport == "grpc":
        table = dict(enumerate(("127.0.0.1", p) for p in _free_ports(3)))
        return [m["grpc"].GRPCCommManager(r, table, send_workers=2) for r, m in enumerate(mods)]
    return _mqtt_ranks(mods, tmp_path, offload=transport == "mqtt_s3")


def _close(transport, mgrs):
    for m in mgrs:
        if transport == "shm":
            m.cleanup()
        else:
            m.stop_receive_message()


@pytest.mark.parametrize("mix", ["port", "mixed"])
@pytest.mark.parametrize("transport", ["shm", "grpc", "mqtt", "mqtt_s3"])
def test_manager_round_trip_and_encode_once_broadcast(transport, mix, tmp_path):
    """Rank 0 sends rank 1 a model, then broadcasts one to ranks 1 and 2
    with a per-receiver client index (framed once); with ``mixed`` rank 1
    is the JAX package's manager."""
    mods = [PORT, JAX if mix == "mixed" else PORT, PORT]
    mgrs = _ranks(transport, tmp_path, mods)
    got = {1: [], 2: []}
    done = threading.Event()

    def observer(rank):
        class Obs:
            def receive_message(self, t, m):
                got[rank].append((t, m.get("client_index"), np.asarray(m.get("model_params"))))
                if len(got[1]) == 2 and len(got[2]) == 1:
                    done.set()
        return Obs()

    threads = []
    for r in (1, 2):
        mgrs[r].add_observer(observer(r))
        threads.append(threading.Thread(target=mgrs[r].handle_receive_message, daemon=True))
        threads[-1].start()
    model = np.random.RandomState(1).randn(300).astype(np.float32)  # 1200 B: offloaded
    try:
        one = tmsg.Message(2, 0, 1)
        one.add_params("model_params", model)
        one.add_params("client_index", 7)
        mgrs[0].send_message(one)
        bc = tmsg.Message(2, 0, 1)
        bc.add_params("model_params", model * 2)
        mgrs[0].broadcast_message(bc, [1, 2], {1: {"client_index": 10}, 2: {"client_index": 20}})
        assert done.wait(20.0), got
    finally:
        for r in (1, 2):
            mgrs[r].stop_receive_message()
        for t in threads:
            t.join(5.0)
        _close(transport, mgrs)
    assert [(t, i) for t, i, _ in got[1]] == [(2, 7), (2, 10)] and got[2][0][:2] == (2, 20)
    np.testing.assert_array_equal(got[1][0][2], model)
    for a in (got[1][1][2], got[2][0][2]):
        np.testing.assert_array_equal(a, model * 2)


@pytest.mark.parametrize("holder", ["jax", "port"])
def test_grpc_manager_refuses_a_port_another_server_holds(holder):
    """The port's server turns grpcio's SO_REUSEPORT off: a second server on
    a port that a live one holds fails to bind instead of sharing it."""
    port = _free_ports(1)[0]
    table = {0: ("127.0.0.1", port)}
    first = (jgrpc if holder == "jax" else tgrpc).GRPCCommManager(0, table)
    try:
        with pytest.raises((OSError, RuntimeError)):
            tgrpc.GRPCCommManager(0, table).stop_receive_message()
    finally:
        first.stop_receive_message()


def test_offload_blobs_are_the_jax_format_and_retire_by_generation(tmp_path):
    a = np.random.RandomState(2).randn(5, 7).astype(np.float32)
    assert tobj._array_bytes(a) == jobj._array_bytes(a)
    np.testing.assert_array_equal(jobj._bytes_array(tobj._array_bytes(a)), a)
    np.testing.assert_array_equal(tobj._bytes_array(jobj._array_bytes(a)), a)
    store = tobj.FileSystemStore(tmp_path / "s")
    sent = []

    class Sink(tloopback.LoopbackCommManager):
        def broadcast_message(self, msg, receiver_ids, per_receiver=None):
            sent.append(msg)

    mgr = tobj.OffloadCommManager(Sink(tloopback.LoopbackFabric(3), 0), store,
                                  threshold_bytes=64, broadcast_generations=2)
    for g in range(4):
        m = tmsg.Message(2, 0, 1)
        m.add_params("model_params", a + g)
        mgr.broadcast_message(m, [1, 2])
    keys = [next(iter(m.get("__offloaded__").values())) for m in sent]
    assert all(m.get("__offload_shared__") == 1 for m in sent)
    on_disk = {p.name for p in (tmp_path / "s").iterdir()}
    assert on_disk == set(keys[2:])  # the two older generations were retired
    # a JAX receiver resolves the port's shared blob, and leaves it (shared)
    jres = jobj.OffloadCommManager(jloopback_like(), jobj.FileSystemStore(tmp_path / "s"))
    msg = jmsg.Message.from_bytes(sent[-1].to_bytes())
    np.testing.assert_array_equal(jres._resolve(msg).get("model_params"), a + 3)
    assert {p.name for p in (tmp_path / "s").iterdir()} == set(keys[2:])
    mgr.retire_broadcast_blobs()
    assert not any((tmp_path / "s").iterdir())


def jloopback_like():
    from fedml_tpu.comm.loopback import LoopbackCommManager, LoopbackFabric

    return LoopbackCommManager(LoopbackFabric(2), 1)


def test_create_backend_arms(tmp_path):
    job = f"cb{uuid.uuid4().hex[:8]}"
    shm = [create_backend("shm", r, 2, job=job) for r in range(2)]
    try:
        assert all(isinstance(m, tshm.ShmCommManager) for m in shm)
        assert {m.my_ring.name for m in shm} == {f"/{job}_r0".encode(), f"/{job}_r1".encode()}
    finally:
        for m in shm:
            m.cleanup()
    table = dict(enumerate(("127.0.0.1", p) for p in _free_ports(2)))
    g = create_backend("grpc", 0, 2, ip_config=table, grpc_send_timeout=5.0,
                       grpc_send_workers=0)
    try:
        assert isinstance(g, tgrpc.GRPCCommManager) and g.send_timeout == 5.0
        assert g._send_pool is None
    finally:
        g.stop_receive_message()
    csv = tmp_path / "ips.csv"
    csv.write_text("receiver_id,ip,port\n0,127.0.0.1,0\n1,10.0.0.2\n")
    assert tgrpc.read_ip_config(csv) == jgrpc.read_ip_config(csv) == {
        0: ("127.0.0.1", 0), 1: ("10.0.0.2", 50001)}
    factory = tbroker.InProcessBroker().client_factory()
    mq = create_backend("mqtt", 0, 3, job="cbjob", client_factory=factory,
                        store_dir=str(tmp_path / "store"), store_threshold=128)
    try:
        assert isinstance(mq, tobj.OffloadCommManager) and mq.threshold == 128
        assert isinstance(mq.inner, tmqtt.MqttCommManager) and mq.inner.topic == "cbjob"
    finally:
        mq.stop_receive_message()
    with pytest.raises(ImportError, match="requires paho-mqtt"):
        create_backend("mqtt", 0, 2)
    with pytest.raises(ImportError, match="requires boto3"):
        tobj.S3Store("bucket")


# -- federations ----------------------------------------------------------------

def _federation_ranks(transport, tmp_path, server_pkg):
    """``W + 1`` managers of ``transport``: rank 0 from ``server_pkg``, the
    clients from the other package."""
    srv, cli = (JAX, PORT) if server_pkg == "jax" else (PORT, JAX)
    mods = [srv] + [cli] * W
    if transport == "shm":
        job = f"f{uuid.uuid4().hex[:10]}"
        return [m["shm"].ShmCommManager(job, r, W + 1) for r, m in enumerate(mods)]
    if transport == "grpc":
        table = dict(enumerate(("127.0.0.1", p) for p in _free_ports(W + 1)))
        return [m["grpc"].GRPCCommManager(r, table) for r, m in enumerate(mods)]
    topic = f"f{uuid.uuid4().hex[:8]}"
    factory = tbroker.InProcessBroker().client_factory()
    return [m["obj"].OffloadCommManager(
        m["mqtt"].MqttCommManager("inproc", 1883, topic=topic, client_id=r, client_num=W,
                                  client_factory=factory),
        m["obj"].FileSystemStore(tmp_path / "store"), threshold_bytes=256)
        for r, m in enumerate(mods)]


@pytest.mark.parametrize("server", ["jax", "port"])
@pytest.mark.parametrize("transport", ["shm", "grpc", "mqtt_s3"])
def test_mixed_federation_reaches_the_all_jax_result(transport, server, tmp_path):
    (jtr, ttr), (jdata, tdata) = _lr_pair(), _blobs()
    jfinal, template = _run_jax(jtr, jdata)
    _, flat, desc = jfd.init_template(jtr, jdata.arrays, B, 0)
    port_tmpl = convert.from_flax(template)
    mgrs = _federation_ranks(transport, tmp_path, server)
    done = {}
    if server == "jax":
        srv = jfd.FedAvgServerManager(mgrs[0], W, R, flat, desc, client_num_in_total=W,
                                      on_round_done=lambda r, f: done.update(final=f))
        clients = [tfd.FedAvgClientManager(mgrs[r], r, W + 1, ttr, tdata, B, port_tmpl)
                   for r in range(1, W + 1)]
    else:
        srv = tfd.FedAvgServerManager(mgrs[0], W, R, tfd.pack_state(port_tmpl), desc,
                                      client_num_in_total=W,
                                      on_round_done=lambda r, f: done.update(final=f))
        make = _jax_clients(jtr)(1)
        clients = [make(mgrs[r], r, W + 1, jtr, jdata, B, template) for r in range(1, W + 1)]
    try:
        _within(lambda: tfd.run_manager_protocol(srv, clients), mgrs)
    finally:
        _close(transport, mgrs)
    _assert_close_to_jax(jfinal, tfd.unpack_state(done["final"], desc), atol=1e-5)


@pytest.mark.parametrize("backend", ["shm", "grpc", "mqtt_s3"])
def test_main_fedavg_transport_matches_the_jax_cli(tmp_path, init_file, backend,  # noqa: F811
                                                   monkeypatch):
    if backend == "grpc":
        monkeypatch.setattr(jfd, "run_distributed_fedavg_grpc", functools.partial(
            jfd.run_distributed_fedavg_grpc, base_port=_free_port_run(5)))
        monkeypatch.setattr(tfd, "run_distributed_fedavg_grpc", functools.partial(
            tfd.run_distributed_fedavg_grpc, base_port=_free_port_run(5)))
    argv = [a if a != "loopback" else backend for a in BASE] + ["--init_from", init_file]
    if backend == "mqtt_s3":
        argv += ["--offload_threshold_bytes", "256"]
    jfinal = jmain.main(argv + ["--object_store_dir", str(tmp_path / "js")] * (
        backend == "mqtt_s3") + ["--save_params_to", str(tmp_path / "jax.npz")])
    tfinal = tmain.main(argv + ["--object_store_dir", str(tmp_path / "ts")] * (
        backend == "mqtt_s3") + ["--device", "cpu", "--save_params_to",
                                 str(tmp_path / "port.npz")])
    assert jfinal.keys() == tfinal.keys()
    for k, v in jfinal.items():
        assert tfinal[k] == pytest.approx(v, abs=1e-5), k
    _assert_close_to_jax(jax_load_params(tmp_path / "jax.npz"),
                         checkpoint.load_params(tmp_path / "port.npz"), atol=1e-5)
    if backend == "mqtt_s3":
        # the last broadcast generations outlive the run in the store, as in JAX
        assert len(os.listdir(tmp_path / "ts")) == len(os.listdir(tmp_path / "js")) > 0
