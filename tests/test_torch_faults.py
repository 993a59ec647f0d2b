"""The port's wire fault injection (``fedml_tpu_torch/comm/faults.py``), its
heartbeat plane (``comm/status.py``), the server's SLOW-versus-OFFLINE
judgement and the population wire adapter (``population/wire.py``), against
the JAX package's, on the CPU.

Tolerances: none. The fault spec parser gives the same specs or the same
error text; the fault wrapper's ``applied`` ledger, what it delivers and
the corrupted bytes are equal to the JAX wrapper's for the same seed, rank
and message order (send and receive side); the tracker's transitions, the
server's status judgements and the population adapter's specs and profiles
are equal; a heartbeating run and a population run with the identity spec
are bitwise a plain one.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import dataclasses
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedavg_distributed as jfd
from fedml_tpu.comm import base as jbase
from fedml_tpu.comm import faults as jfaults
from fedml_tpu.comm import loopback as jloopback
from fedml_tpu.comm import message as jmsg
from fedml_tpu.comm import status as jstatus
from fedml_tpu.population import wire as jwire
from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
from fedml_tpu_torch.comm import base as tbase
from fedml_tpu_torch.comm import faults as tfaults
from fedml_tpu_torch.comm import loopback as tloopback
from fedml_tpu_torch.comm import message as tmsg
from fedml_tpu_torch.comm import status as tstatus
from fedml_tpu_torch.population import wire as twire
from tests.test_torch_fedavg_dist import _blobs, _fabric, _lr_pair, _within_deadline

PKG = {"jax": (jfaults, jbase, jmsg, jstatus), "port": (tfaults, tbase, tmsg, tstatus)}
UPLOAD = tfd.MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER
SYNC = tfd.MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT


# -- the spec parser ----------------------------------------------------------

VALID = ["2:drop=1.0", "2:drop=1.0;3:delay=0.2@0.5,dup=0.3;*:corrupt=0.05",
         "1:fail=0.5,corrupt=0.2,corrupt_frac=0.1", "*:recv_drop=0.2,recv_delay=0.1@0.3",
         "0:crash=3", " 4 : dup=0.5 ; "]
INVALID = ["", ";", "2", "2:", "2:drop", "2:drop=1.5", "x:drop=0.1", "2:explode=1",
           "2:drop=0.1;2:dup=0.2", "1:delay=-1", "1:crash=a", "1:recv_delay=0.1@2"]


@pytest.mark.parametrize("spec", VALID + INVALID)
def test_parse_fault_spec_gives_jax_specs_or_jax_errors(spec):
    def parse(pkg):
        try:
            return {k: dataclasses.asdict(v) for k, v in PKG[pkg][0].parse_fault_spec(spec).items()}
        except Exception as e:  # noqa: BLE001 — the error itself is compared
            return (type(e).__name__, str(e))

    theirs, ours = parse("jax"), parse("port")
    assert ours == theirs
    assert isinstance(ours, tuple) == (spec in INVALID)


# -- the wrapper's ledger and bytes -------------------------------------------

def _recorder(pkg):
    base = PKG[pkg][1]

    class Recorder(base.BaseCommunicationManager):
        def __init__(self):
            super().__init__()
            self.sent = []
            self.lock = threading.Lock()

        def send_message(self, msg):
            with self.lock:
                self.sent.append(("send", msg.get_receiver_id(), bytes(msg.to_bytes())))

        def _send_framed(self, frame, dst, overrides=None):
            with self.lock:
                self.sent.append(("framed", dst, bytes(frame.bytes_for(dst, overrides))))

        def handle_receive_message(self):
            pass

        def stop_receive_message(self):
            pass

    return Recorder()


def _drive_sends(pkg, spec: str, seed: int):
    """A fixed message sequence through rank 2's wrapper: uploads with a
    model payload, broadcasts with per-receiver overrides, a status message
    and a protected ``finished`` message."""
    faults, _, msg_mod, status = PKG[pkg]
    rec = _recorder(pkg)
    w = faults.FaultyCommManager(rec, faults.parse_fault_spec(spec)[2], rank=2, seed=seed)
    rng = np.random.RandomState(0)
    failures = []
    for i in range(16):
        payload = rng.randn(48).astype(np.float32)
        if i % 4 == 3:
            m = msg_mod.Message(SYNC, 2, 0)
            m.add_params(msg_mod.Message.MSG_ARG_KEY_MODEL_PARAMS, payload)
            m.add_params(msg_mod.Message.MSG_ARG_KEY_ROUND_IDX, i // 4)
            try:
                w.broadcast_message(m, [1, 3, 4], {r: {"client_idx": r + i} for r in (1, 3, 4)})
            except Exception as e:  # noqa: BLE001 — failed legs are compared
                failures.append((i, type(e).__name__))
            continue
        m = msg_mod.Message(UPLOAD, 2, 0)
        m.add_params(msg_mod.Message.MSG_ARG_KEY_MODEL_PARAMS, payload)
        m.add_params(msg_mod.Message.MSG_ARG_KEY_NUM_SAMPLES, float(i))
        m.add_params(msg_mod.Message.MSG_ARG_KEY_ROUND_IDX, i // 4)
        try:
            w.send_message(m)
        except faults.TransientSendError:
            failures.append((i, "TransientSendError"))
    try:
        status.send_client_status(w, 2, status.ClientStatus.ONLINE)
    except faults.TransientSendError:
        failures.append(("status", "TransientSendError"))
    fin = msg_mod.Message(SYNC, 2, 1)
    fin.add_params(msg_mod.Message.MSG_ARG_KEY_FINISHED, True)
    w.send_message(fin)
    time.sleep(0.3 if "delay" in spec else 0.0)  # delayed legs land on timers
    return w.applied, w.applied_counts(), sorted(rec.sent), failures


@pytest.mark.parametrize("spec", [
    "2:drop=0.2,dup=0.3,corrupt=0.4,corrupt_frac=0.05,fail=0.2",
    "2:delay=0.02@0.5,dup=0.5,corrupt=0.3",
    "2:corrupt=1.0,corrupt_frac=0.5",
])
@pytest.mark.parametrize("seed", [0, 7])
def test_send_faults_equal_jax_ledger_and_bytes(spec, seed):
    theirs, ours = _drive_sends("jax", spec, seed), _drive_sends("port", spec, seed)
    assert ours[0] == theirs[0] and ours[1] == theirs[1] and ours[3] == theirs[3]
    assert ours[2] == theirs[2]
    assert ours[0], "the spec applied no fault"
    if "corrupt=1.0" in spec:
        clean = _drive_sends("port", "2:dup=0.0001", seed)[2]
        assert {b for *_, b in ours[2]} != {b for *_, b in clean}


def _drive_receives(pkg, spec: str, seed: int):
    faults, _, msg_mod, _ = PKG[pkg]
    rec = _recorder(pkg)
    w = faults.FaultyCommManager(rec, faults.parse_fault_spec(spec)[3], rank=3, seed=seed)
    got, lock = [], threading.Lock()

    class Obs:
        def receive_message(self, msg_type, msg):
            with lock:
                got.append((msg_type, msg.get_sender_id(), msg.get("k")))

    w.add_observer(Obs())
    for i in range(24):
        m = msg_mod.Message(SYNC if i % 2 else UPLOAD, i % 5, 3)
        m.add_params("k", i)
        if i == 23:
            m.add_params(msg_mod.Message.MSG_ARG_KEY_FINISHED, True)
        rec.notify(m)
    time.sleep(0.3)
    return w.applied, sorted(got)


@pytest.mark.parametrize("seed", [0, 3])
def test_receive_faults_equal_jax(seed):
    spec = "3:recv_drop=0.3,recv_delay=0.02@0.5"
    theirs, ours = _drive_receives("jax", spec, seed), _drive_receives("port", spec, seed)
    assert ours == theirs
    assert any(k == "recv_drop" for k, *_ in ours[0]) and (SYNC, 3, 23) in ours[1]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_crash_kills_every_later_send(pkg):
    faults, _, msg_mod, status = PKG[pkg]
    rec = _recorder(pkg)
    w = faults.FaultyCommManager(rec, faults.parse_fault_spec("1:crash=1")[1], rank=1)

    def upload(r):
        m = msg_mod.Message(UPLOAD, 1, 0)
        m.add_params(msg_mod.Message.MSG_ARG_KEY_ROUND_IDX, r)
        return m

    w.send_message(upload(0))
    with pytest.raises(faults.InjectedCrash, match="crashed at round 1"):
        w.send_message(upload(1))
    with pytest.raises(faults.InjectedCrash, match="is crashed"):
        status.send_client_status(w, 1, status.ClientStatus.ONLINE)
    with pytest.raises(faults.InjectedCrash):
        w.broadcast_message(upload(0), [0])
    assert faults.InjectedCrash.unretryable
    assert w.applied == [("crash", -1, -1)] and w.applied_counts() == {"crash": 1}
    assert len(rec.sent) == 1


def test_wrap_make_comm_wraps_only_active_ranks():
    made = []
    for faults in (jfaults, tfaults):
        reg: list = []
        make = faults.wrap_make_comm(lambda r: f"inner{r}", "1:drop=0.5;*:dup=0.0", seed=3,
                                     registry=reg)
        made.append(([type(make(r)).__name__ for r in range(3)], len(reg)))
    assert made[0] == made[1] == (["str", "FaultyCommManager", "str"], 1)


# -- the heartbeat plane --------------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_heartbeat_sender_sends_online_and_survives_send_errors(pkg):
    _, _, _, status = PKG[pkg]
    rec = _recorder(pkg)
    flaky = {"n": 0}
    send = rec.send_message

    def send_or_fail(msg):
        flaky["n"] += 1
        if flaky["n"] == 2:
            raise ConnectionError("transport flapped")
        send(msg)

    rec.send_message = send_or_fail
    hb = status.HeartbeatSender(rec, 3, 0.02).start()
    time.sleep(0.2)
    hb.stop()
    n = len(rec.sent)
    time.sleep(0.06)
    assert len(rec.sent) == n >= 3
    with pytest.raises(ValueError, match="heartbeat interval must be > 0"):
        status.HeartbeatSender(rec, 3, 0.0)


def test_tracker_transitions_equal_jax():
    def drive(status):
        cs = status.ClientStatus
        t = status.ClientStatusTracker(2)
        seen = []
        t.on_transition = lambda c, s: seen.append((c, s))
        t.update(1, cs.ONLINE)
        before = t.wait_all_online(0.0)
        t.update(2, cs.ONLINE)
        t.update(2, cs.ONLINE)  # a heartbeat: no transition
        after = t.wait_all_online(0.0)
        t.update(1, cs.SLOW, touch=False)
        t.update(2, cs.OFFLINE, touch=False)
        fresh = (t.seen_within(1, 5.0), t.seen_within(9, 5.0))
        time.sleep(0.05)
        stale = t.stale(0.01)
        t.update(1, cs.FINISHED)
        m = status.Message(cs.MSG_TYPE_CLIENT_STATUS, 2, 0)
        m.add_params(cs.KEY_STATUS, cs.ONLINE)
        t.handle_message(m)
        return (seen, before, after, fresh, stale, t.snapshot(), t.finished_count(),
                t.last_seen(9))

    assert drive(tstatus) == drive(jstatus)
    assert drive(tstatus)[4] == [1]


def _judging_server(base):
    """A FedAvg server class that logs every status transition and the miss
    counts after each round timeout."""
    class Judging(base):
        log = None

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            Judging.log = {"transitions": [], "misses": [], "excluded": None}
            self.status.on_transition = lambda c, s: Judging.log["transitions"].append((c, s))

        def _round_timed_out(self, expected_round):
            super()._round_timed_out(expected_round)
            Judging.log["misses"].append(dict(self._miss_counts))
            Judging.log["excluded"] = self.aggregator.excluded_workers()

    return Judging


def test_server_judges_slow_with_fresh_heartbeats_and_offline_when_silent():
    """Rank 2 drops every send (its uploads and heartbeats): it misses two
    rounds and is excluded as OFFLINE. Rank 3 gets each sync 2 s late
    (``recv_delay``), past the 0.3 s round timeout, while its heartbeats stay
    fresh: SLOW, and no miss. The JAX server judges the same run alike."""
    jtr, ttr = _lr_pair()
    jdata, tdata = _blobs()
    workers, rounds = 3, 3
    kw = dict(round_timeout=0.3, heartbeat_interval=0.03, heartbeat_timeout=2.0,
              fault_specs="2:drop=1.0;3:recv_delay=2.0", fault_seed=1)
    logs = {}
    for name, mod, loop, tr, data in (("jax", jfd, jloopback, jtr, jdata),
                                      ("port", tfd, tloopback, ttr, tdata)):
        fabric = loop.LoopbackFabric(workers + 1)
        cls = _judging_server(mod.FedAvgServerManager)
        _within_deadline(lambda: mod.run_distributed_fedavg(
            tr, data, workers, rounds, 10, lambda r: loop.LoopbackCommManager(fabric, r),
            server_cls=cls, **kw), [fabric])
        logs[name] = cls.log
    for log in logs.values():
        assert log["misses"] == [{1: 1}, {1: 2}, {1: 2}]
        assert log["excluded"] == [1]
        assert (2, "OFFLINE") in log["transitions"] and (3, "SLOW") in log["transitions"]
        assert (2, "SLOW") not in log["transitions"]
    assert {k: sorted(set(v["transitions"])) for k, v in logs.items()}["port"] == \
        sorted(set(logs["jax"]["transitions"]))
    time.sleep(2.0)  # the last delayed syncs land before the fabrics go


def test_heartbeating_run_is_bitwise_a_silent_one():
    """Two workers (two f64 addends fold alike in either arrival order) over
    the shm rings, with and without 10 ms heartbeats."""
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    runs = [_within_deadline(lambda: tfd.run_distributed_fedavg_shm(
        ttr, tdata, 2, 3, 10, job=f"hb_{uuid.uuid4().hex[:8]}", **kw), [])
        for kw in ({}, {"heartbeat_interval": 0.01}, {})]
    for a in runs[1:]:
        assert all(torch.equal(runs[0][k], a[k]) for k in a)


# -- the population wire adapter -----------------------------------------------

@pytest.mark.parametrize("spec,workers,seed", [
    ("speed=lognormal:0,0.5;dropout=0.1;jitter=uniform:0,0.2", 5, 0),
    ("speed=uniform:0.2,1.5;jitter=const:0.05", 3, 11),
    ("speed=zipf:2.0;dropout=0.3", 4, 2),
    ("speed=const:1", 4, 0),
])
def test_population_fault_specs_equal_jax(spec, workers, seed):
    theirs = jwire.population_fault_specs(spec, workers, seed=seed)
    ours = twire.population_fault_specs(spec, workers, seed=seed)
    assert {r: dataclasses.asdict(s) for r, s in ours.fault_specs.items()} == \
        {r: dataclasses.asdict(s) for r, s in theirs.fault_specs.items()}
    assert ours.profiles == theirs.profiles and ours.describe() == theirs.describe()
    assert (ours.active, ours.drops_uploads, ours.max_delay_s) == \
        (theirs.active, theirs.drops_uploads, theirs.max_delay_s)
    if spec == "speed=const:1":
        assert not ours.active and ours.fault_specs == {}


def test_identity_population_wraps_nothing_and_runs_bitwise_plain(monkeypatch):
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    wrapped = []
    monkeypatch.setattr(tfaults, "FaultyCommManager",
                        lambda *a, **k: wrapped.append(a) or pytest.fail("wrapped"))
    template = tfd.init_template(ttr, tdata.arrays, 10)[0]
    runs = [_within_deadline(lambda: tfd.run_distributed_fedavg_loopback(
        ttr, tdata, 4, 2, 10, fabric=_fabric(), init_overrides=template, **kw), [])
        for kw in ({}, {"population": "speed=const:1;jitter=const:0"})]
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0]) and not wrapped
    with pytest.raises(ValueError, match="round_timeout"):
        tfd.run_distributed_fedavg_loopback(ttr, tdata, 4, 2, 10, population="dropout=0.5")
    with pytest.raises(ValueError, match="both drive the wire fault"):
        tfd.run_distributed_fedavg_loopback(ttr, tdata, 4, 2, 10, population="jitter=const:0.1",
                                            fault_specs="1:drop=0.1")
