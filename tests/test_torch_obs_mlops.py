"""The port's observability planes beside the trace (``obs/mlops.py``,
``obs/package.py``, ``obs/metrics.py``'s ``RoundTimer``) and the loopback
attack A-B (``algorithms/robust_distributed.py``'s ``run_attack_simulation``
and ``eval_accuracy``) against the JAX package's, on the CPU.

- **MLOps records.** The same calls on the port's and the JAX
  ``MLOpsLogger``, ``FedEvents`` and ``FedLogs`` over a ``FileMessenger``
  each: the JSONL records equal record for record (topics and payloads),
  the wall-clock fields aside (``ts``, ``started_time``/``ended_time``,
  ``create_time``/``update_time``). ``MqttMessenger`` needs paho, which
  neither package ships: both raise ``ImportError`` on construction.
- **round_callback** streams a port ``FedSim`` run's history.
- **Packages.** ``build_mlops_package`` then ``verify_package``: both zips
  hold the port package (its sim engine included), no ``__pycache__``, and
  entry scripts that import ``fedml_tpu_torch.exp.main_fedavg``.
- **RoundTimer.** Spans, summary and the tracer span as JAX's; an unmatched
  ``tock`` raises JAX's error, in its words.
- **Attack A-B.** A median defense against a backdoor on LR, both packages
  from the same initial variables over rank-ordered uplinks: the same
  compromised clients and poisoned counts, each arm's final variables
  within atol 1e-5 (torch and XLA round the local steps otherwise), ASR and
  clean accuracy equal.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import json
import zipfile
from pathlib import Path

import pytest

from fedml_tpu.algorithms import fedavg_distributed as jfd
from fedml_tpu.algorithms import robust_distributed as jrd
from fedml_tpu.comm import loopback as jloopback
from fedml_tpu.data.synthetic import gaussian_blobs
from fedml_tpu.obs import metrics as jmetrics
from fedml_tpu.obs import mlops as jmlops
from fedml_tpu.obs import trace as jtrace
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
from fedml_tpu_torch.algorithms import robust_distributed as trd
from fedml_tpu_torch.comm import loopback as tloopback
from fedml_tpu_torch.data.poison import Trigger
from fedml_tpu_torch.obs import metrics as tmetrics
from fedml_tpu_torch.obs import mlops as tmlops
from fedml_tpu_torch.obs import package as tpackage
from fedml_tpu_torch.obs import trace as ttrace
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import FedSim, SimConfig
from tests.test_torch_fedavg_dist import UPLOAD, _assert_close_to_jax, _lr_pair, _within_deadline

WALL = {"ts", "started_time", "ended_time", "create_time", "update_time"}
REPO = Path(__file__).resolve().parent.parent


def _drive(mlops, path: Path, log: Path):
    """One scripted run of ``mlops``'s logger, events and log shipper,
    all into the JSONL at ``path``."""
    m = mlops.FileMessenger(path)
    logger = mlops.MLOpsLogger(m, run_id=7, edge_id=3)
    logger.report_client_training_status(3, "TRAINING")
    logger.report_client_id_status(7, 3, "FINISHED")
    logger.report_server_training_status(7, "RUNNING")
    logger.report_server_id_status(7, "FINISHED")
    logger.report_client_training_metric({"round": 1, "Train/Acc": 0.5})
    logger.report_server_training_metric({"round": 1, "Test/Acc": 0.25})
    logger.report_server_training_round_info({"round_index": 1, "total_rounds": 2})
    logger.report_client_model_info({"run_id": 7, "model_url": "s3://m"})
    logger.report_aggregated_model_info({"run_id": 7, "model_url": "s3://g"})
    logger.report_system_metric({"run_id": 7, "cpu_utilization": 1.5})
    logger.round_callback()({"round": 4, "Train/Loss": 0.125})
    events = mlops.FedEvents(m, run_id=7, edge_id=3)
    with events.span("train", event_value="r1"):
        events.log_event_started("wait", event_edge_id=9)
    events.log_event_ended("wait")
    shipper = mlops.FedLogs(log, m, run_id=7, edge_id=3)
    first = shipper.upload_once()
    with open(log, "a") as fh:
        fh.write("tail line\npartial")
    second = shipper.upload_once()
    m.close()
    return [first, second], [json.loads(line) for line in path.read_text().splitlines()]


def _strip(rec):
    if isinstance(rec, dict):
        return {k: _strip(v) for k, v in rec.items() if k not in WALL}
    return rec


def test_mlops_records_equal_jax(tmp_path):
    logs = []
    for name in ("jax", "port"):
        log = tmp_path / f"{name}.log"
        log.write_text("".join(f"line {i}\n" for i in range(150)))
        logs.append(_drive(jmlops if name == "jax" else tmlops, tmp_path / f"{name}.jsonl", log))
    (jcounts, jrecs), (tcounts, trecs) = logs
    assert tcounts == jcounts == [150, 1]
    assert len(trecs) == len(jrecs) > 10
    for a, b in zip(trecs, jrecs):
        assert _strip(a) == _strip(b)
        assert set(a) == set(b) and set(a["payload"]) == set(b["payload"])
    topics = {r["topic"] for r in trecs}
    assert {tmlops.TOPIC_EVENTS, tmlops.TOPIC_LOGS, tmlops.TOPIC_SYSTEM} <= topics
    assert tmlops.TOPIC_CLIENT_ID_STATUS.format(edge_id=3) in topics


def test_system_metric_sample_and_mqtt_needs_paho(tmp_path):
    m = tmlops.FileMessenger(tmp_path / "sys.jsonl")
    tmlops.MLOpsLogger(m, run_id=1, edge_id=2).report_system_metric()
    m.close()
    rec = json.loads((tmp_path / "sys.jsonl").read_text())
    assert rec["topic"] == jmlops.TOPIC_SYSTEM
    assert {"run_id", "edge_id", "uptime_s", "process_memory_in_use"} <= set(rec["payload"])
    for mod in (jmlops, tmlops):
        with pytest.raises(ImportError):
            mod.MqttMessenger()


def test_round_callback_streams_a_port_fedsim_run(tmp_path):
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.models.linear import LogisticRegression

    train, test = gaussian_blobs(n_clients=4, samples_per_client=16, seed=2)
    trainer = ClientTrainer(module=LogisticRegression(num_classes=4, in_features=16,
                                                      device="cpu"),
                            optimizer=sgd(0.2), epochs=1)
    cfg = SimConfig(client_num_in_total=4, client_num_per_round=2, batch_size=8, comm_round=3,
                    frequency_of_the_test=1)
    m = tmlops.FileMessenger(tmp_path / "run.jsonl")
    _, history = FedSim(trainer, FederatedArrays(train.arrays, train.partition), test, cfg,
                        device="cpu").run(
        callback=tmlops.MLOpsLogger(m, run_id=5).round_callback())
    m.close()
    recs = [json.loads(line) for line in (tmp_path / "run.jsonl").read_text().splitlines()]
    metrics = [r["payload"] for r in recs if r["topic"] == tmlops.TOPIC_SERVER_METRICS]
    rounds = [r["payload"] for r in recs if r["topic"] == tmlops.TOPIC_ROUND_INFO]
    assert [p["round"] for p in metrics] == [h["round"] for h in history] == [0, 1, 2]
    assert all(p["run_id"] == 5 and p["Test/Acc"] == h["Test/Acc"]
               for p, h in zip(metrics, history))
    assert rounds == [{"run_id": 5, "round_index": r} for r in (0, 1, 2)]


def test_mlops_package_builds_and_verifies(tmp_path):
    cfg = {"client_args": ["--backend", "loopback"], "server_args": ["--comm_round", "2"]}
    zips = tpackage.build_mlops_package(REPO, tmp_path / "out", run_config=cfg)
    assert sorted(zips) == ["client", "server"]
    for role, path in zips.items():
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
            run_py = z.read("package/run.py").decode()
            manifest = json.loads(z.read("package/manifest.json"))
            config = json.loads(z.read("package/fedml_config.json"))
        assert any(n.startswith("package/fedml_tpu_torch/sim/") for n in names)
        assert "package/fedml_tpu_torch/exp/main_fedavg.py" in names
        assert not any("__pycache__" in n or n.endswith((".pyc", ".so")) for n in names)
        assert not any(n.startswith("package/fedml_tpu/") for n in names)
        assert "from fedml_tpu_torch.exp.main_fedavg import main" in run_py
        assert manifest["framework"] == "fedml_tpu_torch" and manifest["role"] == role
        assert config == {"role": role, **cfg}
        assert tpackage.verify_package(path, tmp_path / f"unzip_{role}")


def test_round_timer_matches_jax():
    for mod, trace in ((jmetrics, jtrace), (tmetrics, ttrace)):
        tracer = trace.Tracer()
        timer = mod.RoundTimer(tracer=tracer)
        timer.tick("comm")
        timer.tick("compute")
        assert timer.tock("compute") >= 0.0
        timer.tock("comm")
        timer.tick("comm")
        timer.tock("comm")
        assert [t for t, _ in timer.spans] == ["compute", "comm", "comm"]
        assert set(timer.summary()) == {"compute", "comm"}
        assert [e["name"] for e in tracer.events() if e.get("ph") == "X"] == [
            "compute", "comm", "comm"]
    errs = []
    for mod in (jmetrics, tmetrics):
        timer = mod.RoundTimer()
        timer.tick("a")
        with pytest.raises(ValueError) as e:
            timer.tock("b")
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "without a matching tick" in errs[1]
    # without an explicit tracer the process tracer gets the span
    tracer = ttrace.install()
    try:
        timer = tmetrics.RoundTimer()
        timer.tick("round")
        timer.tock("round")
        assert [e["name"] for e in tracer.events() if e.get("ph") == "X"] == ["round"]
    finally:
        ttrace.uninstall()


def _ordered_runner(mod, loop, finals, deadline_fabrics, **extra):
    """``mod``'s loopback runner over a rank-ordered uplink (a deterministic
    fold order), recording each final model."""

    def run(trainer, data, worker_num, round_num, batch_size, seed=0, **kw):
        fabric = loop.OrderedUplinkFabric(worker_num + 1, worker_num, UPLOAD)
        deadline_fabrics.append(fabric)
        final = _within_deadline(lambda: mod.run_distributed_fedavg(
            trainer, data, worker_num, round_num, batch_size,
            lambda r: loop.LoopbackCommManager(fabric, r), seed=seed, **kw, **extra), [fabric])
        finals.append(final)
        return final

    return run


def test_attack_simulation_matches_jax(monkeypatch):
    (jtr, ttr) = _lr_pair(lr=0.3)
    train, test = gaussian_blobs(n_clients=4, samples_per_client=24, num_classes=4, seed=5)
    tdata = FederatedArrays(train.arrays, train.partition)
    seed, B = 3, 8
    template = convert.from_flax(jfd.init_template(jtr, train.arrays, B, seed)[0])
    jfinals, tfinals, fabrics = [], [], []
    monkeypatch.setattr(jfd, "run_distributed_fedavg_loopback",
                        _ordered_runner(jfd, jloopback, jfinals, fabrics))
    monkeypatch.setattr(tfd, "run_distributed_fedavg_loopback",
                        _ordered_runner(tfd, tloopback, tfinals, fabrics,
                                        init_overrides=template))
    kw = dict(worker_num=4, round_num=4, batch_size=B, compromised_frac=0.5, sample_frac=1.0,
              target_label=0, poison_seed=2, seed=seed)
    theirs = jrd.run_attack_simulation(
        jtr, train, test, defense=jrd.RobustDistConfig(rule="median", norm_bound=0.5),
        trigger=__import__("fedml_tpu.data.poison", fromlist=["Trigger"]).Trigger(
            size=4, value=3.0), **kw)
    ours = trd.run_attack_simulation(
        ttr, tdata, test, defense=trd.RobustDistConfig(rule="median", norm_bound=0.5),
        trigger=Trigger(size=4, value=3.0), **kw)
    assert ours["compromised_clients"] == theirs["compromised_clients"]
    assert ours["poisoned_counts"] == theirs["poisoned_counts"]
    assert len(jfinals) == len(tfinals) == 2  # the defended arm, then the undefended one
    for j, t in zip(jfinals, tfinals):
        _assert_close_to_jax(j, t, atol=1e-5)
    for k in ("asr_defended", "asr_undefended", "clean_acc_defended", "clean_acc_undefended"):
        assert ours[k] == theirs[k], k
    assert len(ours["robust_rounds"]) == 4
