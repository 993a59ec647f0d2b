"""The port's tracer (``fedml_tpu_torch/obs/trace.py``, a copy of the JAX
package's) and its trace points in the engine, the prefetch thread and the
experiment loops.

- The same sequence of spans, events, counters and gauges recorded by the
  port's tracer and the JAX package's exports the same records in JSONL and
  in Chrome JSON: names, phases, attributes, span ids and parents, thread
  ids (all but the timestamps, the durations, the wall-clock anchor and the
  process track's label);
- spans on several threads each get their own track, nested per thread;
  the threads are held alive together by a ``threading.Barrier`` (a thread
  that ended could hand its ident to the next, which is how the
  reference's ``test_span_nesting_across_threads`` can fail);
- with no tracer installed a span is the shared no-op;
- a traced CLI run's history equals an untraced one's bitwise (round time
  aside), and its trace holds the engine's, the prefetch thread's and the
  loop's spans.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse
import json
import threading

import pytest

from fedml_tpu.obs import trace as jtrace
from fedml_tpu_torch.exp import main_fedavg as port_cli
from fedml_tpu_torch.obs import trace


def _record(mod):
    t = mod.Tracer()
    with t.span("engine/stage", round=0, packed=False):
        t.event("engine/first_dispatch", program="gather")
        with t.span("engine/dispatch", program="block2", round=0, n_rounds=2, first=True):
            t.counter("engine/overflow_passes", 1, round=0)
    t.gauge("prefetch/queue_depth", 2)
    t.add_span("loop/round", 0.0, 0.0, round=1)
    return t


def _strip(rec):
    rec = {k: v for k, v in rec.items() if k not in ("ts", "dur")}
    if rec.get("name") == "trace/meta":
        rec["args"] = {k: v for k, v in rec["args"].items() if k != "wall0"}
    if rec.get("name") == "process_name":
        rec["args"] = {}
    return rec


def test_records_match_the_jax_tracer(tmp_path):
    mine, theirs = _record(trace), _record(jtrace)
    a = [json.loads(line) for line in
         mine.export_jsonl(tmp_path / "a.jsonl").read_text().splitlines()]
    b = [json.loads(line) for line in
         theirs.export_jsonl(tmp_path / "b.jsonl").read_text().splitlines()]
    assert [_strip(r) for r in a] == [_strip(r) for r in b]
    assert {r["ph"] for r in a} == {"M", "X", "i", "C"}
    ca = json.loads(mine.export_chrome(tmp_path / "a.json").read_text())
    cb = json.loads(theirs.export_chrome(tmp_path / "b.json").read_text())
    assert set(ca) == set(cb)
    assert [_strip(r) for r in ca["traceEvents"]] == [_strip(r) for r in cb["traceEvents"]]


def test_span_nesting_across_threads_with_a_barrier():
    t = trace.Tracer()
    barrier = threading.Barrier(4)

    def work(tag):
        with t.span("outer", tag=tag):
            with t.span("inner", tag=tag):
                barrier.wait()  # every thread is alive at once here

    threads = [threading.Thread(target=work, args=(i,), name=f"w{i}") for i in range(3)]
    for th in threads:
        th.start()
    work("main")
    for th in threads:
        th.join()
    spans = [e for e in t.events() if e["ph"] == "X"]
    assert len(spans) == 8
    by_tid = {}
    for e in spans:
        by_tid.setdefault(e["tid"], []).append(e)
    assert len(by_tid) == 4
    assert {"w0", "w1", "w2"} <= set(t.thread_names().values())
    for group in by_tid.values():
        inner = next(e for e in group if e["name"] == "inner")
        outer = next(e for e in group if e["name"] == "outer")
        assert inner["args"]["parent_id"] == outer["args"]["span_id"]
        assert inner["args"]["tag"] == outer["args"]["tag"]
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3


def test_disabled_tracer_is_the_null_span():
    assert trace.get() is None
    assert trace.span("x", a=1) is trace.span("y")
    trace.gauge("g", 1.0)  # no tracer: nothing happens
    tracer = trace.install()
    try:
        with trace.span("x", a=1):
            trace.event("e")
        assert [e["name"] for e in tracer.events()] == ["e", "x"]
    finally:
        trace.uninstall()
    assert trace.get() is None


def _cli(argv):
    args = port_cli.parse_with_config(port_cli.add_args(argparse.ArgumentParser()), argv)
    return port_cli.run(args)


@pytest.mark.parametrize("mode", ["blocks", "per_round"])
def test_traced_cli_run_equals_untraced(tmp_path, mode):
    argv = ["--client_num_in_total", "6", "--client_num_per_round", "4", "--comm_round", "4",
            "--frequency_of_the_test", "2", "--data_dir", str(tmp_path / "none"),
            "--device", "cpu", "--algorithm", "fedopt"]
    if mode == "per_round":
        argv += ["--pipeline_depth", "0"]
    plain = _cli(argv)
    traced = _cli(argv + ["--trace_dir", str(tmp_path / "tr")])
    assert trace.get() is None

    def strip(h):
        return [{k: v for k, v in r.items() if k != "round_time"} for r in h]

    assert strip(traced) == strip(plain)
    recs = [json.loads(line) for line in
            (tmp_path / "tr" / trace.JSONL_TRACE_NAME).read_text().splitlines()]
    names = {r["name"] for r in recs if r["ph"] == "X"}
    assert {"engine/stage", "engine/dispatch", "engine/eval", "engine/sync"} <= names
    if mode == "blocks":
        assert {"prefetch/stage", "prefetch/drain_fetch"} <= names
        assert any(r["name"] == "prefetch/queue_depth" for r in recs if r["ph"] == "C")
    chrome = json.loads((tmp_path / "tr" / trace.CHROME_TRACE_NAME).read_text())
    assert len(chrome["traceEvents"]) > len(recs) - 5


def test_repro_loop_spans(tmp_path):
    import numpy as np

    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.exp._loop import run_rounds
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.sim.cohort import FederatedArrays
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    rng = np.random.RandomState(0)
    x, y = rng.rand(40, 20).astype(np.float32), rng.randint(0, 10, 40).astype(np.int32)
    part = {c: np.arange(c * 8, c * 8 + 8) for c in range(5)}
    cfg = SimConfig(client_num_in_total=5, client_num_per_round=3, batch_size=4, comm_round=3,
                    frequency_of_the_test=3)
    module = create_model("lr", 10, "mnist", device="cpu", input_shape=(20,))
    sim = FedSim(ClientTrainer(module=module, optimizer=sgd(0.1)),
                 FederatedArrays({"x": x, "y": y}, part), {"x": x, "y": y}, cfg, device="cpu")
    with trace.trace_to(tmp_path / "tr") as tracer:
        records, _ = run_rounds(sim, cfg, str(tmp_path / "m.jsonl"))
    assert len(records) == 3
    names = [e["name"] for e in tracer.events() if e["ph"] == "X"]
    assert names.count("loop/round") == 3 and "loop/salvage_flush" in names
    assert {"engine/dispatch", "engine/eval", "prefetch/stage"} <= set(names)
    rounds = [e for e in tracer.events() if e["name"] == "loop/round"]
    assert [e["args"]["round"] for e in rounds] == [0, 1, 2]
