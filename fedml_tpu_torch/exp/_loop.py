"""Round loop for the reproduction entry points, the port of
``fedml_tpu/exp/_loop.py`` (``run_rounds``).

Drives ``FedSim`` one round-dispatch at a time (the recipes' per-round
dispatch, not the engine's eval-aligned blocks): ``round_sleep`` idles
between rounds, ``stop_when`` may end the run after an eval round, and an
exception stops the loop with the completed rounds kept, so a crash mid-run
still yields a truthful partial report. ``touch <metrics_out>.stop`` ends
the run after the current round with the report written; the sentinel is
consumed when found, and a stale one is cleared at the start.

With a nonzero ``sim.pipeline_depth`` (FedSim's default) the loop is
pipelined (``sim/prefetch.py``): a background thread stages the next rounds
and round metrics drain on the device, fetched at eval rounds (where the
host waits for the device anyway) and at the end. Records are bitwise those
of the serial loop (``pipeline_depth=0``). The completed rounds of a window
go to the metrics file before the eval runs, so an eval that fails loses no
round that trained; a round that completed but was still in the drain when
the loop broke off is salvaged into the records. A hard kill
(SIGKILL/OOM/segfault) can lose the records of the current eval window,
which the serial loop writes round by round.

Each record holds ``round_time``: the serial loop's is the seconds of the
round up to the synchronisation of its metrics, eval excluded; the pipelined
loop's is its window's per-round mean (the window's rounds over its wall
time up to the synchronisation, eval excluded), as ``FedSim.run`` reports it.

At the start the loop logs the sim's packed-lane and population summaries
(``FedSim.pack_summary``, ``population_summary``), as the JAX loop does;
with packed lanes on the card it captures the lane pass's CUDA graph before
the prefetch thread starts. Each round runs in a ``loop/round`` span and the
salvage of drained rounds in ``loop/salvage_flush`` (``obs/trace.py``, the
JAX loop's); its sharded summary comes with that plane (§A12).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time

from fedml_tpu_torch.obs import trace


def run_rounds(sim, cfg, metrics_out: str | None, round_sleep: float = 0.0,
               stop_when=None) -> tuple[list, float]:
    """Returns ``(records, wall_seconds)``. ``metrics_out`` (a JSONL path, or
    None for no file and no sentinel) receives one line per completed round.
    ``stop_when(records) -> bool`` is consulted after every eval round: True
    stops the run early."""
    records: list[dict] = []
    sentinel = metrics_out + ".stop" if metrics_out else None
    if sentinel:
        # a leftover from a run that ended another way must not cut this
        # one to one round
        with contextlib.suppress(FileNotFoundError):
            os.unlink(sentinel)
    variables = sim.init_round_variables()
    server_state = sim.aggregator.init_state(variables)
    pack = getattr(sim, "pack_summary", lambda: {})()
    if pack:
        # packed lanes (SimConfig.pack_lanes): the lane geometry beside the
        # run, so a reader can tell which execution mode made the curve
        logging.info("packed-lane execution: %s", pack)
        if sim.device.type == "cuda" and cfg.comm_round > 0:
            # a capture may not overlap the prefetch thread's pinned copies
            sim.capture_pass_graph(0, variables=variables)
    pop = getattr(sim, "population_summary", lambda: {})()
    if pop:
        # a heterogeneous population (SimConfig.population): the spec or
        # trace up front, so a curve trained under churned cohorts and
        # truncated budgets is never taken for an idealized run
        logging.info("population: %s", pop)
    freq = max(cfg.frequency_of_the_test, 1)
    depth = getattr(sim, "pipeline_depth", 0)
    prefetch = drain = None
    if depth and cfg.comm_round > 0:
        from fedml_tpu_torch.sim.prefetch import MetricsDrain, Prefetcher

        prefetch = Prefetcher(range(cfg.comm_round), sim.stage_round, depth)
        drain = MetricsDrain(depth)
    t0 = time.time()
    try:
        with (open(metrics_out, "w") if metrics_out else contextlib.nullcontext()) as f:

            def write(rr, metrics, round_time, eval_rec=None):
                rec = {"round": rr, **{k: float(v) for k, v in metrics.items()},
                       "round_time": round_time}
                if eval_rec:
                    rec.update(eval_rec)
                records.append(rec)
                if f is not None:
                    f.write(json.dumps(rec) + "\n")
                    f.flush()

            t_mark = time.perf_counter()
            window = 0  # rounds dispatched since the last synchronisation
            pending: list = []  # fetched off the drain's back, readable after a flush
            for r in range(cfg.comm_round):
                evaled = (r + 1) % freq == 0 or r == cfg.comm_round - 1
                try:
                    with trace.span("loop/round", round=r):
                        if prefetch is None:
                            t_mark = time.perf_counter()
                            variables, server_state, m = sim.run_round(r, variables,
                                                                       server_state)
                            ready = [(r, {k: float(v) for k, v in m.items()})]  # synchronises
                        else:
                            variables, server_state, m = sim.run_staged_round(
                                prefetch.get(r), variables, server_state)
                            # queue this round's metrics on the device; an eval
                            # round fetches everything queued
                            pending.extend(drain.push(r, m))
                            if evaled:
                                ready, pending = pending + drain.flush(), []
                            else:
                                ready = []
                    window += 1
                    if ready:
                        per_round = (time.perf_counter() - t_mark) / window
                        # completed rounds go on the record before the eval
                        # runs: an eval failure must not lose rounds that
                        # trained (only this round's record waits for its
                        # eval, as in the serial loop)
                        for rr, mm in ready:
                            if not (evaled and rr == r):
                                write(rr, mm, per_round)
                        if evaled:
                            write(r, ready[-1][1], per_round, sim.eval_record(variables))
                        t_mark, window = time.perf_counter(), 0
                except Exception:
                    logging.exception("round %d failed — reporting the %d completed rounds",
                                      r, len(records))
                    break
                if evaled and stop_when is not None and stop_when(records):
                    logging.info("stop_when fired at round %d — stopping early", r)
                    break
                if sentinel and os.path.exists(sentinel):
                    # a graceful external stop: the run ends after this round
                    # with its report written; consumed, so it cannot stop
                    # the next run at round 0
                    os.unlink(sentinel)
                    logging.info("stop file %s found at round %d — stopping", sentinel, r)
                    break
                if round_sleep:
                    time.sleep(round_sleep)
            # salvage rounds that completed but were still in the drain when
            # an exception or a stop broke the loop off
            if drain is not None:
                try:
                    with trace.span("loop/salvage_flush"):
                        salvaged, pending = pending + drain.flush(), []
                    per_round = (time.perf_counter() - t_mark) / max(len(salvaged), 1)
                    for rr, mm in salvaged:
                        write(rr, mm, per_round)
                except Exception:
                    logging.exception("draining pending round metrics failed")
    finally:
        if prefetch is not None:
            prefetch.close()
    return records, (time.time() - t0) or 1.0
