"""Round loop for the reproduction entry points, the port of
``fedml_tpu/exp/_loop.py`` (``run_rounds``).

Drives ``FedSim`` one round at a time: ``round_sleep`` idles between
rounds, ``stop_when`` may end the run after an eval round, every record goes
to the metrics JSONL as it completes, and an exception stops the loop with
the completed rounds kept, so a crash mid-run still yields a truthful partial
report. Each record holds ``round_time``, the seconds of the round up to the
synchronisation of its metrics, eval excluded.

Not ported: the JAX loop's trace spans (ROADMAP §A13 ``obs/``), its
pipelined rounds (``pipeline_depth``, §A4) and its ``<metrics_out>.stop``
sentinel file.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time


def run_rounds(sim, cfg, metrics_out: str | None, round_sleep: float = 0.0,
               stop_when=None) -> tuple[list, float]:
    """Returns ``(records, wall_seconds)``. ``metrics_out`` (a JSONL path, or
    None for no file) receives one line per completed round.
    ``stop_when(records) -> bool`` is consulted after every eval round: True
    stops the run early."""
    records: list[dict] = []
    variables = sim.init_variables()
    server_state = sim.aggregator.init_state(variables)
    freq = max(cfg.frequency_of_the_test, 1)
    t0 = time.time()
    with (open(metrics_out, "w") if metrics_out else contextlib.nullcontext()) as f:
        for r in range(cfg.comm_round):
            evaled = (r + 1) % freq == 0 or r == cfg.comm_round - 1
            try:
                t_round = time.perf_counter()
                variables, server_state, m = sim.run_round(r, variables, server_state)
                rec = {"round": r, **{k: float(v) for k, v in m.items()}}  # synchronises
                rec["round_time"] = time.perf_counter() - t_round
                if evaled:
                    rec.update(sim.eval_record(variables))
            except Exception:
                logging.exception("round %d failed — reporting the %d completed rounds",
                                  r, len(records))
                break
            records.append(rec)
            if f is not None:
                f.write(json.dumps(rec) + "\n")
                f.flush()
            if evaled and stop_when is not None and stop_when(records):
                logging.info("stop_when fired at round %d — stopping early", r)
                break
            if round_sleep:
                time.sleep(round_sleep)
    return records, (time.time() - t0) or 1.0
