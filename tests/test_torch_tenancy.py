"""The port's multi-tenant job plane (``fedml_tpu_torch/tenancy/``) against
the JAX package's, on the CPU, case by case with ``tests/test_tenancy.py``.

- **Scheduler and router.** The deficit-round-robin dispatch order of the
  port's ``FairFanoutScheduler`` equals the JAX one's on the same legs;
  per-job FIFO, error isolation, the router's demux and drop count.
- **The wire.** A named job's sync frames (job-id header, global rank) are
  the JAX job plane's byte for byte from the same initial variables; the
  default job stamps no header and is bitwise the single-job harness.
- **The JAX bit-identity contracts on the port alone.** Eight heterogeneous
  jobs (models, codecs, defenses, an async server) co-scheduled on one
  fabric each reproduce their solo runs bitwise, round by round, with each
  job's fold order pinned by ordered uplink fabrics; two ``FedSim`` engines
  interleaved by ``run_multi_job_sim`` reproduce their solo runs bitwise.
- **Isolation.** A crashing job and a mid-run ``EmptyRoundError`` leave
  their neighbors advancing.
- **The CLI.** ``--jobs`` runs on the port; its flag guards raise the JAX
  CLI's errors (the package path in the message aside); a job's downlink
  delta coding raises, naming ROADMAP §A11.4.

Every threaded run has a deadline of its own (``join_timeout``, 60 s).
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse
import collections
import json
import threading

import numpy as np
import pytest
import torch

from fedml_tpu import tenancy as jten
from fedml_tpu.comm import loopback as jloopback
from fedml_tpu.comm.send_pool import SendWorkerPool as JaxPool
from fedml_tpu.exp import main_fedavg as jmain
from fedml_tpu.tenancy import scheduler as jsched
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
from fedml_tpu_torch.algorithms.base import EmptyRoundError
from fedml_tpu_torch.algorithms.robust_distributed import RobustDistConfig
from fedml_tpu_torch.comm import loopback as tloopback
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.send_pool import BroadcastSendError, SendWorkerPool
from fedml_tpu_torch.compress import make_codec
from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
from fedml_tpu_torch.data.synthetic import gaussian_blobs
from fedml_tpu_torch.exp import main_fedavg as tmain
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.obs import jobscope, registry, trace
from fedml_tpu_torch.obs import metrics as metricslib
from fedml_tpu_torch.sim.engine import FedSim, SimConfig
from fedml_tpu_torch.tenancy import (
    DEFAULT_JOB,
    FairFanoutScheduler,
    JobRouter,
    JobSpec,
    MultiJobOrderedUplinkFabric,
    plan_rank_bases,
    run_multi_job,
    run_multi_job_sim,
)
from fedml_tpu_torch.tenancy import scheduler as tsched
from tests.test_torch_fedavg_dist import _lr_pair

UPLOAD = tfd.MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER


def _snap(v):
    return {k: t.clone() for k, t in v.items()}


def _blob_job(seed, num_classes=4, workers=2, samples=16):
    train, _ = gaussian_blobs(n_clients=workers, samples_per_client=samples,
                              num_classes=num_classes, seed=seed)
    trainer = ClientTrainer(module=LogisticRegression(num_classes=num_classes, in_features=16,
                                                      device="cpu"),
                            optimizer=sgd(0.2), epochs=1)
    return trainer, train


# -- the fair fan-out scheduler --------------------------------------------------------


def _drr_order(sched_mod, pool_cls):
    """The dispatch order of two jobs' four legs each (300 KB and 10 KB),
    both queued before the dispatcher starts; one pool worker runs them in
    order."""
    pool = pool_cls(1, name="drr-test")
    sched = sched_mod.FairFanoutScheduler(pool, quantum_bytes=256 * 1024)
    order, lock = [], threading.Lock()

    def leg(job, i):
        def fn():
            with lock:
                order.append((job, i))
        return fn

    batches = {}
    with sched._wake:
        for name, nbytes in (("big", 300 * 1024), ("small", 10 * 1024)):
            batch = batches[name] = sched_mod._Batch(4)
            q = sched._queues[name] = collections.deque()
            sched._deficit[name] = 0
            sched._stats[name] = {"bytes": 0, "legs": 0, "turns": 0}
            for i in range(4):
                q.append(sched_mod._Leg(0, i, leg(name, i), nbytes, batch))
            sched._ring.append(name)
        sched._thread = threading.Thread(target=sched._dispatch_loop, daemon=True)
        sched._thread.start()
        sched._wake.notify()
    assert batches["big"].done.wait(10) and batches["small"].done.wait(10)
    stats = sched.stats()
    sched.close()
    pool.close()
    return order, stats


def test_scheduler_drr_interleaves_small_job_past_big_legs():
    order, stats = _drr_order(tsched, SendWorkerPool)
    small = [i for i, (j, _) in enumerate(order) if j == "small"]
    big = [i for i, (j, _) in enumerate(order) if j == "big"]
    assert max(small) < big[1], order
    assert [i for j, i in order if j == "big"] == [0, 1, 2, 3]
    assert [i for j, i in order if j == "small"] == [0, 1, 2, 3]
    assert stats["big"][metricslib.JOB_SEND_LEGS] == 4
    assert stats["small"][metricslib.JOB_SEND_BYTES] == 4 * 10 * 1024
    assert stats["big"][metricslib.JOB_SCHED_TURNS] >= 2
    jorder, jstats = _drr_order(jsched, JaxPool)
    assert order == jorder and stats == jstats


def test_scheduler_per_job_error_isolation():
    sched = FairFanoutScheduler(SendWorkerPool(2, name="err-test"))
    boom = RuntimeError("dead receiver")
    errs, ok_done = {}, []

    def run_bad():
        try:
            sched.run_job_legs("bad", [(1, 1, lambda: (_ for _ in ()).throw(boom), 10),
                                       (2, 2, lambda: None, 10)], timeout=10)
        except BaseException as e:  # noqa: BLE001
            errs["bad"] = e

    def run_ok():
        sched.run_job_legs("ok", [(3, 3, lambda: ok_done.append(1), 10)], timeout=10)

    threads = [threading.Thread(target=run_bad), threading.Thread(target=run_ok)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    sched.close()
    sched.pool.close()
    assert ok_done == [1]
    assert isinstance(errs["bad"], BroadcastSendError) and list(errs["bad"].errors) == [1]


def test_scheduler_rejects_bad_quantum_and_closed_submit():
    with pytest.raises(ValueError, match="quantum_bytes"):
        FairFanoutScheduler(SendWorkerPool(1), quantum_bytes=0)
    sched = FairFanoutScheduler(SendWorkerPool(1))
    sched.close()
    with pytest.raises(RuntimeError, match="closed"):
        sched.run_job_legs("j", [(0, 0, lambda: None, 1)])


# -- the router ----------------------------------------------------------------------


def test_router_routes_by_job_header_and_drops_unknown():
    fabric = tloopback.LoopbackFabric(1)
    router = JobRouter(tloopback.LoopbackCommManager(fabric, 0)).start()
    try:
        default_inbox, j1_inbox = router.register(None), router.register("j1")

        def post(job_id):
            msg = Message(42, 1, 0)
            if job_id is not None:
                msg.add_params(Message.MSG_ARG_KEY_JOB_ID, job_id)
            fabric.post(msg)

        for job in (None, "j1", "ghost", "j1"):
            post(job)
        assert default_inbox.get(timeout=5).get_type() == 42
        assert j1_inbox.get(timeout=5).get(Message.MSG_ARG_KEY_JOB_ID) == "j1"
        assert j1_inbox.get(timeout=5) is not None
        assert router.dropped == 1 and default_inbox.empty() and j1_inbox.empty()
    finally:
        router.close()


# -- job-scoped observability ---------------------------------------------------------


def test_job_scoped_registry_and_merge_view():
    assert registry.get() is None
    proc = registry.install()
    ra, rb = registry.install_job("a"), registry.install_job("b")
    try:
        registry.counter("Comm/X", 1)
        with jobscope.bound("a"):
            registry.counter("Comm/X", 10)
            assert registry.get() is ra
        t = threading.Thread(target=jobscope.wrap_target(
            lambda: registry.counter("Comm/X", 100), job="b"))
        t.start()
        t.join()
        assert proc.snapshot()["counters"]["Comm/X"] == 1
        assert ra.snapshot()["counters"]["Comm/X"] == 10
        assert rb.snapshot()["counters"]["Comm/X"] == 100
        assert registry.merged_snapshot()["counters"]["Comm/X"] == 111
    finally:
        registry.uninstall_job("a")
        registry.uninstall_job("b")
        registry.uninstall()
    assert registry.merged_snapshot()["counters"] == {}


def test_job_scoped_tracer_captures_only_its_jobs_spans():
    ta = trace.install_job("a", trace.Tracer())
    try:
        with jobscope.bound("a"):
            with trace.span("tenancy/dispatch", job="a"):
                pass
        with trace.span("comm/send"):
            pass
        assert [e["name"] for e in ta.events()] == ["tenancy/dispatch"]
        assert trace.get() is None
    finally:
        trace.uninstall_job("a")


def test_jobscope_bound_restores_previous_binding():
    assert jobscope.current_job() is None
    with jobscope.bound("outer"):
        with jobscope.bound(None):
            assert jobscope.current_job() == "outer"
        with jobscope.bound("inner"):
            assert jobscope.current_job() == "inner"
        assert jobscope.current_job() == "outer"
    assert jobscope.current_job() is None


# -- specs and the rank layout ------------------------------------------------------------


def test_jobspec_validation_rejects_reserved_kwargs_and_dupes():
    trainer, train = _blob_job(seed=0)
    with pytest.raises(ValueError, match="collide"):
        JobSpec(trainer=trainer, train_data=train, worker_num=2, round_num=1, batch_size=4,
                run_kwargs={"make_comm": None})
    with pytest.raises(ValueError, match="worker_num"):
        JobSpec(trainer=trainer, train_data=train, worker_num=0, round_num=1, batch_size=4)
    spec = JobSpec(trainer=trainer, train_data=train, worker_num=2, round_num=1, batch_size=4)
    with pytest.raises(ValueError, match="duplicate job name"):
        run_multi_job([spec, spec])
    with pytest.raises(ValueError, match="world_size"):
        run_multi_job([spec], fabric=tloopback.LoopbackFabric(2))
    with pytest.raises(NotImplementedError, match=r"§A11\.5"):
        run_multi_job([spec], trace_dir="traces")


def test_plan_rank_bases_accumulates_workers():
    trainer, train = _blob_job(seed=0)

    def spec(job_id, w):
        return JobSpec(trainer=trainer, train_data=train, worker_num=w, round_num=1,
                       batch_size=4, job_id=job_id)

    assert plan_rank_bases([spec("a", 3), spec("b", 2), spec(None, 4)]) == {
        "a": 0, "b": 3, DEFAULT_JOB: 5}


# -- failure isolation ---------------------------------------------------------------------


def _two_jobs_one_raising(exc_factory, crash_round):
    t1, d1 = _blob_job(seed=3)
    t2, d2 = _blob_job(seed=7, num_classes=3)

    def poison(r, _v):
        if r == crash_round:
            raise exc_factory()

    return run_multi_job([
        JobSpec(trainer=t1, train_data=d1, worker_num=2, round_num=3, batch_size=4,
                job_id="healthy"),
        JobSpec(trainer=t2, train_data=d2, worker_num=2, round_num=3, batch_size=4,
                job_id="doomed", on_round=poison),
    ], join_timeout=60)


def test_crashing_job_does_not_take_down_neighbors():
    res = _two_jobs_one_raising(lambda: RuntimeError("job imploded"), 0)
    assert isinstance(res["doomed"].error, RuntimeError)
    assert res["doomed"].totals[metricslib.JOB_ERRORS] == 1
    assert res["healthy"].ok and res["healthy"].rounds == [0, 1, 2]
    assert res["healthy"].totals[metricslib.JOB_ROUNDS] == 3
    assert res["healthy"].totals[metricslib.JOB_ERRORS] == 0


def test_empty_round_error_mid_run_leaves_others_advancing():
    res = _two_jobs_one_raising(lambda: EmptyRoundError("no uploads"), 1)
    assert isinstance(res["doomed"].error, EmptyRoundError)
    assert res["doomed"].rounds == [0, 1] and res["doomed"].final is None
    assert res["healthy"].ok and res["healthy"].rounds == [0, 1, 2]
    assert res["healthy"].final is not None


# -- eight heterogeneous jobs == their solo runs ----------------------------------------


def _hetero_job_matrix():
    """(job_id, workers, classes, seed, run_kwargs factory): models, codecs,
    defenses and an async server on one wire (the JAX matrix's downlink job
    is an async one here: downlink coding is ROADMAP §A11.4)."""
    return [
        ("plain-a", 2, 4, 1, dict),
        ("plain-b", 3, 3, 2, dict),
        ("bf16", 2, 4, 3, lambda: {"codec": make_codec("bf16")}),
        ("topk", 2, 4, 4, lambda: {"codec": make_codec("topk", topk_frac=0.5)}),
        ("robust", 2, 4, 5, lambda: {"robust_config": RobustDistConfig(rule="median")}),
        ("robust-dp", 2, 3, 6, lambda: {"robust_config": RobustDistConfig(
            rule="mean", norm_bound=0.5, dp_stddev=0.01, dp_seed=2)}),
        ("async", 2, 4, 7, lambda: {"server_mode": "async", "buffer_goal": 2}),
        ("lr-tiny", 2, 2, 8, dict),
    ]


def test_eight_heterogeneous_jobs_bit_identical_to_solo():
    matrix, rounds = _hetero_job_matrix(), 2
    data = {jid: _blob_job(seed=seed, num_classes=nc, workers=w)
            for jid, w, nc, seed, _ in matrix}
    solo = {}
    for jid, w, _, seed, kw in matrix:
        trainer, train = data[jid]
        fabric = tloopback.OrderedUplinkFabric(w + 1, w, UPLOAD)
        per_round = []
        final = tfd.run_distributed_fedavg(
            trainer, train, w, rounds, 4, lambda r, f=fabric: tloopback.LoopbackCommManager(f, r),
            seed=seed, on_round_done=lambda r, v, acc=per_round: acc.append((r, _snap(v))),
            **kw())
        solo[jid] = (final, per_round)
    multi = {jid: [] for jid, *_ in matrix}
    jobs = [JobSpec(trainer=data[jid][0], train_data=data[jid][1], worker_num=w,
                    round_num=rounds, batch_size=4, job_id=jid, seed=seed,
                    on_round=lambda r, v, acc=multi[jid]: acc.append((r, _snap(v))),
                    run_kwargs=kw())
            for jid, w, _, seed, kw in matrix]
    fabric = MultiJobOrderedUplinkFabric(1 + sum(j.worker_num for j in jobs),
                                         {j.name: j.worker_num for j in jobs}, UPLOAD)
    results = run_multi_job(jobs, fabric=fabric, join_timeout=60)
    for jid, *_ in matrix:
        res = results[jid]
        assert res.ok, f"{jid}: {res.error!r}"
        solo_final, solo_rounds = solo[jid]
        assert [r for r, _ in multi[jid]] == [r for r, _ in solo_rounds] == [0, 1]
        for (_, a), (_, b) in zip(solo_rounds, multi[jid]):
            assert all(torch.equal(a[k], b[k]) for k in a), jid
        assert all(torch.equal(solo_final[k], res.final[k]) for k in solo_final), jid
        assert res.totals[metricslib.JOB_ROUNDS] == rounds
        assert res.totals[metricslib.JOB_SEND_LEGS] > 0


def test_default_job_is_the_single_job_harness_bitwise():
    """One default job (no job id) through the whole job plane: no header
    on the wire, every round bitwise the plain harness."""
    trainer, train = _blob_job(seed=11, workers=4, samples=24)
    solo_rounds, multi_rounds = [], []
    solo_fabric = tloopback.OrderedUplinkFabric(5, 4, UPLOAD)
    solo_final = tfd.run_distributed_fedavg_loopback(
        trainer, train, 4, 3, 8, fabric=solo_fabric,
        on_round_done=lambda r, v: solo_rounds.append((r, _snap(v))))

    class HeaderAudit(MultiJobOrderedUplinkFabric):
        stamped = 0

        def post(self, msg):
            HeaderAudit.stamped += msg.get(Message.MSG_ARG_KEY_JOB_ID) is not None
            super().post(msg)

    fabric = HeaderAudit(5, {DEFAULT_JOB: 4}, UPLOAD)
    res = run_multi_job([JobSpec(trainer=trainer, train_data=train, worker_num=4, round_num=3,
                                 batch_size=8, on_round=lambda r, v: multi_rounds.append(
                                     (r, _snap(v))))], fabric=fabric, join_timeout=60)
    assert res[DEFAULT_JOB].ok and HeaderAudit.stamped == 0
    assert len(multi_rounds) == len(solo_rounds) == 3
    for (_, a), (_, b) in zip(solo_rounds, multi_rounds):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(solo_final[k], res[DEFAULT_JOB].final[k]) for k in solo_final)


def test_named_job_sync_frames_match_the_jax_job_plane():
    """From the same initial variables, the first syncs a named job's
    server sends through the shared plane (job-id header, global ranks) are
    the JAX job plane's frames byte for byte."""
    from fedml_tpu.algorithms import fedavg_distributed as jfd
    from tests.test_torch_fedavg_dist import _blobs

    (jtr, ttr), (jdata, tdata) = _lr_pair(), _blobs()
    template, _, _ = jfd.init_template(jtr, jdata.arrays, 8, 0)
    frames = {}
    for pkg, mod, loop, tr, data, init in (
            ("port", None, tloopback, ttr, tdata, convert.from_flax(template)),
            ("jax", jten, jloopback, jtr, jdata, template)):
        sent = []

        class Spy(loop.LoopbackFabric):
            def post_raw(self, receiver, data):
                if receiver != 0:
                    sent.append((receiver, data if not isinstance(data, tuple)
                                 else b"".join(bytes(p) for p in data)))
                super().post_raw(receiver, data)

        spec_cls, runner = ((JobSpec, run_multi_job) if pkg == "port"
                            else (jten.JobSpec, jten.run_multi_job))
        pad = spec_cls(trainer=tr, train_data=data, worker_num=1, round_num=1, batch_size=8,
                       job_id="first", run_kwargs={"init_overrides": init})
        job = spec_cls(trainer=tr, train_data=data, worker_num=4, round_num=1, batch_size=8,
                       job_id="second", run_kwargs={"init_overrides": init})
        res = runner([pad, job], fabric=Spy(6), join_timeout=60)
        assert res["second"].ok
        frames[pkg] = sorted(f for f in sent if f[0] >= 2 and Message.from_bytes(f[1]).get_type()
                             == tfd.MyMessage.MSG_TYPE_S2C_INIT_CONFIG)
    assert [r for r, _ in frames["port"]] == [2, 3, 4, 5]
    assert frames["port"] == frames["jax"]
    head = Message.from_bytes(frames["port"][0][1])
    assert head.get(Message.MSG_ARG_KEY_JOB_ID) == "second" and head.get_receiver_id() == 2


# -- the sim plane ---------------------------------------------------------------------


def _sim_engine(seed, comm_round=3):
    train, test = gaussian_blobs(n_clients=4, samples_per_client=16, num_classes=4, seed=seed)
    trainer = ClientTrainer(module=LogisticRegression(num_classes=4, in_features=16,
                                                      device="cpu"),
                            optimizer=sgd(0.2), epochs=1)
    cfg = SimConfig(client_num_in_total=4, client_num_per_round=4, batch_size=8,
                    comm_round=comm_round, frequency_of_the_test=comm_round, seed=seed)
    return FedSim(trainer, train, test, cfg, device="cpu")


def test_sim_coscheduled_jobs_match_solo_runs():
    solo = {name: _sim_engine(seed).run() for name, seed in (("a", 5), ("b", 9))}
    results = run_multi_job_sim({"a": _sim_engine(5), "b": _sim_engine(9)})
    for name in ("a", "b"):
        res = results[name]
        assert res.ok, res.error
        solo_vars, solo_hist = solo[name]
        assert [{k: v for k, v in r.items() if k != "round_time"} for r in solo_hist] \
            == res.rounds
        assert all(torch.equal(solo_vars[k], res.final[k]) for k in solo_vars)


def test_sim_job_failure_drops_out_of_rotation():
    good, bad = _sim_engine(5, comm_round=2), _sim_engine(9, comm_round=2)

    def explode(*a, **k):
        raise RuntimeError("dispatch died")

    bad.run_staged_round = explode
    results = run_multi_job_sim({"good": good, "bad": bad})
    assert isinstance(results["bad"].error, RuntimeError) and results["bad"].final is None
    assert results["good"].ok and [r["round"] for r in results["good"].rounds] == [0, 1]
    with pytest.raises(ValueError, match="at least one engine"):
        run_multi_job_sim({})


# -- the CLI ---------------------------------------------------------------------------

JOBS_BASE = ["--dataset", "synthetic", "--backend", "loopback", "--comm_round", "2",
             "--client_num_in_total", "4", "--client_num_per_round", "4",
             "--frequency_of_the_test", "1", "--batch_size", "16"]


def _jobs_file(tmp_path, entries):
    path = tmp_path / "jobs.json"
    path.write_text(json.dumps(entries))
    return str(path)


def test_main_fedavg_jobs_runs_like_the_jax_cli(tmp_path):
    """``--jobs`` with two jobs (one overriding its model's widths and
    rate, one a top-k codec): the port's per-job records have the JAX CLI's
    shape (jobs, rounds, keys), finite evals, and per-job telemetry files
    under ``--fleet_stats``."""
    path = _jobs_file(tmp_path, [{"job_id": "a"},
                                 {"job_id": "b", "lr": 0.1, "client_num_per_round": 2,
                                  "compressor": "topk", "topk_frac": 0.5}])

    def run(cli, extra):
        args = cli.parse_with_config(cli.add_args(argparse.ArgumentParser()),
                                     JOBS_BASE + ["--jobs", path] + extra)
        return cli.run(args)

    theirs = run(jmain, ["--fleet_stats", str(tmp_path / "jf")])
    ours = run(tmain, ["--device", "cpu", "--fleet_stats", str(tmp_path / "tf")])
    assert [(r["job"], r["round"]) for r in ours] == [(r["job"], r["round"]) for r in theirs]
    for a, b in zip(ours, theirs):
        assert set(a) == set(b) - {"_ts"}
        assert np.isfinite(a["Test/Loss"])
    jobs = json.loads((tmp_path / "tf" / "jobs.json").read_text())
    assert sorted(jobs) == ["a", "b"] and jobs["b"]["totals"][metricslib.JOB_ROUNDS] == 2
    assert (tmp_path / "tf" / "a" / "fleet.jsonl").exists()


@pytest.mark.parametrize("extra", [
    ["--backend", "mqtt_s3"], ["--server_mode", "async"], ["--is_mobile", "1"],
    ["--fault_spec", "2:dup=1.0"], ["--checkpoint_dir", "ck"], ["--send_retries", "1"],
], ids=["backend", "server_mode", "mobile", "fault_spec", "checkpoint", "retries"])
def test_main_fedavg_jobs_guards_match_the_jax_cli(tmp_path, extra):
    path = _jobs_file(tmp_path, [{"job_id": "a"}])
    argv = [a for a in JOBS_BASE] + ["--jobs", path] + extra
    if "--backend" in extra:
        argv = argv[:2] + argv[4:]
    with pytest.raises(NotImplementedError) as theirs:
        jmain.main(argv)
    with pytest.raises(NotImplementedError) as ours:
        tmain.main(argv + ["--device", "cpu"])
    assert str(ours.value) == str(theirs.value).replace("fedml_tpu/", "fedml_tpu_torch/")


def test_main_fedavg_job_downlink_raises_naming_its_item(tmp_path):
    path = _jobs_file(tmp_path, [{"job_id": "a", "downlink_compressor": "q8"}])
    with pytest.raises(NotImplementedError, match=r"§A11\.4"):
        tmain.main(JOBS_BASE + ["--jobs", path, "--device", "cpu"])
    bad = _jobs_file(tmp_path, [{"job_id": "a", "no_such_key": 1}])
    with pytest.raises(ValueError, match="unknown override"):
        tmain.main(JOBS_BASE + ["--jobs", bad, "--device", "cpu"])
