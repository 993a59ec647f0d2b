"""The port's cross-rank trace lanes (``trace_lanes=`` of the flat and the
tree runners, ``run_multi_job(trace_dir=)``) against the JAX package's, on
the CPU, case by case with the runner cases of ``tests/test_trace_ctx.py``.

Each case runs the same federation (LogisticRegression on Gaussian blobs,
2 rounds) through both packages, each into a directory of its own, and
holds:

- the lane files: the same lane names as the JAX run's;
- the span names per lane: every JAX span name is in the port's lane, and
  the port adds only its own per-layer spans (``PORT_SPANS``: the server's
  decode, fold and aggregate, the client's decode and encode, which the
  wire measurements read);
- causality: every receive span that carries a wire context names a lane
  of the run and a ``comm/send`` span in it; on the flat and tree runs that
  lane is another node's (the sender's), and on the flat run it is the lane
  of the rank that sent the message.

Every wire run has a deadline of its own (60 s).
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import json
from pathlib import Path

import pytest

from fedml_tpu import tenancy as jten
from fedml_tpu.algorithms import fedavg_distributed as jfd
from fedml_tpu.async_agg import tree as jtree
from fedml_tpu.obs import trace as jtrace
from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
from fedml_tpu_torch.async_agg import tree as ttree
from fedml_tpu_torch.obs import trace as ttrace
from fedml_tpu_torch.tenancy import JobSpec, run_multi_job
from tests.test_torch_fedavg_dist import _blobs, _lr_pair

PORT_SPANS = {"server/decode", "server/fold", "server/aggregate", "client/decode",
              "client/encode"}


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    jtrace.uninstall()
    ttrace.uninstall()
    yield
    jtrace.uninstall()
    ttrace.uninstall()


def _lanes(root: Path) -> dict[str, list[dict]]:
    """``{lane: records}`` of every ``trace_<lane>.jsonl`` under ``root``."""
    out = {}
    for p in sorted(root.glob("trace_*.jsonl")):
        recs = [json.loads(line) for line in p.read_text().splitlines()]
        meta = next(r for r in recs if r["name"] == "trace/meta")
        out[meta["args"]["lane"]] = recs
    return out


def _span_names(recs):
    return {r["name"] for r in recs if r.get("ph") == "X"}


def _assert_like_jax(ours: dict, theirs: dict):
    assert set(ours) == set(theirs)
    for lane in theirs:
        mine, want = _span_names(ours[lane]), _span_names(theirs[lane])
        assert want <= mine, (lane, want - mine)
        assert mine - want <= PORT_SPANS, (lane, mine - want)


def _recv_links(lanes: dict):
    """``(lane, recv args, sender's send record)`` of every received
    message that carries a wire context."""
    sends = {lane: {r["args"]["span_id"]: r for r in recs
                    if r.get("ph") == "X" and "span_id" in r.get("args", {})}
             for lane, recs in lanes.items()}
    links = []
    for lane, recs in lanes.items():
        for r in recs:
            if r["name"] == "comm/recv" and "ctx_lane" in r["args"]:
                args = r["args"]
                assert args["ctx_lane"] in lanes, args
                src = sends[args["ctx_lane"]].get(args["ctx_span"])
                assert src is not None and src["name"] == "comm/send", args
                links.append((lane, args, src))
    return links


def test_flat_lanes_match_jax(tmp_path):
    (jtr, ttr), (jdata, tdata) = _lr_pair(), _blobs()
    jfd.run_distributed_fedavg_loopback(jtr, jdata, worker_num=2, round_num=2, batch_size=8,
                                        trace_lanes=str(tmp_path / "jax"))
    tfd.run_distributed_fedavg_loopback(ttr, tdata, worker_num=2, round_num=2, batch_size=8,
                                        trace_lanes=str(tmp_path / "port"))
    ours = _lanes(tmp_path / "port")
    assert set(ours) == {"rank0", "rank1", "rank2"}
    _assert_like_jax(ours, _lanes(tmp_path / "jax"))
    links = _recv_links(ours)
    pairs = {(a["ctx_lane"], lane) for lane, a, _ in links}
    # uplink contexts land at the server, downlink contexts at the clients
    assert {("rank1", "rank0"), ("rank2", "rank0"), ("rank0", "rank1")} <= pairs
    for lane, args, src in links:
        assert args["ctx_lane"] != lane
        assert args["ctx_lane"] == f"rank{args['ctx_rank']}" == f"rank{src['args']['sender']}"


def test_tree_lanes_match_jax(tmp_path):
    (jtr, ttr), (jdata, tdata) = _lr_pair(), _blobs()
    jtree.run_tree_fedavg_loopback(jtr, jdata, (2, 2), 2, 8, trace_lanes=str(tmp_path / "jax"))
    ttree.run_tree_fedavg_loopback(ttr, tdata, (2, 2), 2, 8, trace_lanes=str(tmp_path / "port"))
    ours = _lanes(tmp_path / "port")
    assert set(ours) == {"root", "edge0", "edge1", "leaf1", "leaf2", "leaf3", "leaf4"}
    _assert_like_jax(ours, _lanes(tmp_path / "jax"))
    links = _recv_links(ours)
    assert {a["ctx_lane"] for lane, a, _ in links if lane == "root"} == {"edge0", "edge1"}
    assert all(args["ctx_lane"] != lane for lane, args, _ in links)


def test_multi_job_lanes_match_jax(tmp_path):
    """Two federations over one wire, one lane per job: each lane holds its
    job's server and clients, every context names a send in the same job."""
    (jtr, ttr), (jdata, tdata) = _lr_pair(), _blobs()

    def specs(pkg_spec, trainer, data):
        return [pkg_spec(trainer=trainer, train_data=data, worker_num=2, round_num=2,
                         batch_size=8, job_id=f"job{i}", seed=i) for i in range(2)]

    jres = jten.run_multi_job(specs(jten.JobSpec, jtr, jdata), join_timeout=60,
                              trace_dir=str(tmp_path / "jax"))
    tres = run_multi_job(specs(JobSpec, ttr, tdata), join_timeout=60,
                         trace_dir=str(tmp_path / "port"))
    assert all(r.ok for r in jres.values()) and all(r.ok for r in tres.values())
    ours = _lanes(tmp_path / "port")
    assert set(ours) == {"job0", "job1"}
    _assert_like_jax(ours, _lanes(tmp_path / "jax"))
    links = _recv_links(ours)
    assert {lane for lane, _, _ in links} == {"job0", "job1"}
    assert all(args["ctx_lane"] == lane for lane, args, _ in links)
