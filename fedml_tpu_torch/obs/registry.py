"""A copy of ``fedml_tpu/obs/registry.py``.

Fleet telemetry plane: metric registry + per-rank health view
(docs/OBSERVABILITY.md "Fleet telemetry").

The tracer (obs/trace.py) answers *where the time went in one process*; it
says nothing about the FLEET — which clients are slow, how stale the async
fold really runs, what upload latency looks like at p99, which worker went
SLOW → OFFLINE → readmitted and when. The reference ships that signal over
a dedicated MLOps telemetry channel (system metrics over MQTT, SURVEY
§5.5); here it rides the planes this repo already has:

- :class:`MetricRegistry` — a process-wide, thread-safe registry of
  counters (monotonic adds), gauges (last value wins), and log-bucketed
  :class:`Histogram` series, with ATOMIC snapshot and snapshot merge. Same
  install/no-op discipline as ``obs.trace``: the module-level helpers
  (:func:`counter` / :func:`gauge` / :func:`observe`) cost one global read
  and do nothing when no registry is installed, so instrumented hot paths
  are free in ordinary runs.
- :class:`FleetHealth` — the server-side fleet view: per-rank (or per tree
  tier) health records combining what the server observes (state
  transitions, stale uploads, dup absorptions, staleness distribution,
  heartbeat freshness) with the compact telemetry dict clients/edge tiers
  piggyback on ordinary uploads (:data:`fedml_tpu.comm.message.Message.
  MSG_ARG_KEY_TELEMETRY`; :meth:`FleetHealth.merge_report` defines the
  field semantics).

Telemetry is READ-ONLY by contract: it never touches rng, aggregation, or
the protocol state machine, so a run with ``--fleet_stats`` is bit-identical
to the same run without it (tools/fleet_smoke.py holds the contract).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any

from fedml_tpu_torch.obs import jobscope

__all__ = [
    "Histogram", "MetricRegistry", "FleetHealth",
    "install", "uninstall", "get", "enabled",
    "install_job", "uninstall_job", "job_registries", "merged_snapshot",
    "counter", "gauge", "observe", "add_cli_flag",
    "STATE_READMITTED", "FLEET_JSONL_NAME",
]

FLEET_JSONL_NAME = "fleet.jsonl"

# fleet-view state recorded at the readmission boundary — not a wire
# ClientStatus (the tracker flips OFFLINE -> ONLINE); the timeline keeps the
# distinct event so an operator can tell a readmitted worker from one that
# was never excluded
STATE_READMITTED = "READMITTED"


class Histogram:
    """Log-bucketed histogram: bucket ``i`` holds values in
    ``(growth**(i-1), growth**i]`` (so with the default growth of 2 the
    bucket upper bounds are ..., 0.5, 1, 2, 4, ...); non-positive values
    land in a dedicated ``zeros`` bucket (staleness 0, a zero-length wait).
    O(observed magnitude range) memory — a multi-hour latency series costs
    a few dozen buckets, never one entry per sample.

    Snapshots are plain JSON-able dicts; :meth:`merge` folds a snapshot (or
    another histogram) back in, which is what makes fleet records
    aggregatable across ranks and rounds."""

    __slots__ = ("growth", "_log_g", "count", "total", "min", "max",
                 "zeros", "buckets")

    def __init__(self, growth: float = 2.0):
        if growth <= 1.0:
            raise ValueError(f"histogram growth must be > 1, got {growth}")
        self.growth = float(growth)
        self._log_g = math.log(self.growth)
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self.zeros = 0
        self.buckets: dict[int, int] = {}

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if v <= 0.0:
            self.zeros += 1
            return
        # ceil with a tiny slack so exact powers land in their own bucket
        # (log2(4)/log2(2) == 2.0 -> bucket 2, upper bound 4)
        idx = math.ceil(math.log(v) / self._log_g - 1e-9)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def bound(self, idx: int) -> float:
        """Upper bound of bucket ``idx``."""
        return self.growth ** idx

    def snapshot(self) -> dict:
        return {
            "count": self.count, "sum": self.total,
            "min": self.min, "max": self.max,
            "growth": self.growth, "zeros": self.zeros,
            "buckets": {str(i): n for i, n in sorted(self.buckets.items())},
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "Histogram":
        h = cls(growth=snap.get("growth", 2.0))
        h.merge(snap)
        return h

    def merge(self, other: "Histogram | dict") -> "Histogram":
        snap = other.snapshot() if isinstance(other, Histogram) else other
        if float(snap.get("growth", self.growth)) != self.growth:
            raise ValueError(
                f"cannot merge histograms with different growth factors: "
                f"{self.growth} vs {snap.get('growth')}"
            )
        self.count += int(snap.get("count", 0))
        self.total += float(snap.get("sum", 0.0))
        for name, v in (("min", snap.get("min")), ("max", snap.get("max"))):
            if v is None:
                continue
            cur = getattr(self, name)
            pick = min if name == "min" else max
            setattr(self, name, v if cur is None else pick(cur, float(v)))
        self.zeros += int(snap.get("zeros", 0))
        for i, n in snap.get("buckets", {}).items():
            i = int(i)
            self.buckets[i] = self.buckets.get(i, 0) + int(n)
        return self

    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def percentile(self, q: float) -> float | None:
        """Approximate q-quantile (q in [0, 1]): the upper bound of the
        bucket where the cumulative count crosses ``q * count``, clamped to
        the observed [min, max] so outliers don't report a bound the data
        never reached."""
        if not self.count:
            return None
        target = q * self.count
        seen = self.zeros
        if seen >= target:
            return 0.0
        bound = self.max
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen >= target:
                bound = self.bound(i)
                break
        return max(min(float(bound), float(self.max)), float(self.min))


class MetricRegistry:
    """Thread-safe registry of counters, gauges, and histograms.

    One lock guards every series, which is what makes :meth:`snapshot`
    ATOMIC — a snapshot taken while other threads record is a consistent
    point-in-time view, never a half-updated mix. :meth:`merge` folds a
    snapshot back in (counters add, gauges last-wins, histograms merge), so
    registries compose across threads, processes, and wire hops."""

    def __init__(self, growth: float = 2.0):
        self._lock = threading.Lock()
        self._growth = float(growth)
        self._counters: dict[str, float] = {}  # guarded-by: _lock
        self._gauges: dict[str, float] = {}  # guarded-by: _lock
        self._hists: dict[str, Histogram] = {}  # guarded-by: _lock

    def counter(self, name: str, inc: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + inc

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(growth=self._growth)
            h.observe(value)

    def histogram(self, name: str) -> Histogram | None:
        """A COPY of the named histogram (None when never observed)."""
        with self._lock:
            h = self._hists.get(name)
            return Histogram.from_snapshot(h.snapshot()) if h else None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.snapshot()
                               for k, h in self._hists.items()},
            }

    def merge(self, snap: dict) -> None:
        with self._lock:
            for k, v in snap.get("counters", {}).items():
                self._counters[k] = self._counters.get(k, 0) + v
            self._gauges.update(snap.get("gauges", {}))
            for k, hs in snap.get("histograms", {}).items():
                h = self._hists.get(k)
                if h is None:
                    h = self._hists[k] = Histogram(
                        growth=hs.get("growth", self._growth))
                h.merge(hs)

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


# ---------------------------------------------------------------------------
# Process-wide registry + zero-overhead module-level helpers (the
# install/no-op discipline of obs.trace: one global read when disabled).
# With the multi-tenant job plane, installs can additionally be job-scoped
# (obs/jobscope.py): a thread bound to a job resolves that job's registry
# first and falls back to the process one, so N co-scheduled federations
# keep separate metric streams while single-job runs are untouched.
# ---------------------------------------------------------------------------

_registry: MetricRegistry | None = None
_job_store = jobscope.JobStore("registry")


def install(registry: MetricRegistry | None = None) -> MetricRegistry:
    """Install ``registry`` (a fresh one by default) process-wide and return
    it. Replaces any previously-installed registry."""
    global _registry
    _registry = registry if registry is not None else MetricRegistry()
    return _registry


def uninstall() -> MetricRegistry | None:
    """Remove and return the process registry (helpers revert to no-ops)."""
    global _registry
    r, _registry = _registry, None
    return r


def install_job(job: str, registry: MetricRegistry | None = None) -> MetricRegistry:
    """Install a registry scoped to ``job``: threads bound to the job
    (jobscope.bound / jobscope.wrap_target) resolve it ahead of the process
    registry. Used by the tenancy runner so each federation's telemetry
    lands in its own registry."""
    return _job_store.install(
        job, registry if registry is not None else MetricRegistry())


def uninstall_job(job: str) -> MetricRegistry | None:
    return _job_store.uninstall(job)


def job_registries() -> dict[str, MetricRegistry]:
    """Snapshot of the installed job-scoped registries (job -> registry)."""
    return _job_store.installed()


def merged_snapshot() -> dict:
    """Process-level merge view: the process registry's snapshot merged with
    every job-scoped registry's, through the :meth:`MetricRegistry.merge`
    composition seam (counters add, gauges last-wins in sorted job order,
    histograms merge)."""
    merged = MetricRegistry()
    if _registry is not None:
        merged.merge(_registry.snapshot())
    for _job, reg in sorted(_job_store.installed().items()):
        merged.merge(reg.snapshot())
    return merged.snapshot()


def get() -> MetricRegistry | None:
    """The calling thread's job-scoped registry when one is installed, else
    the process registry, else None. Call sites whose metric *values* are
    expensive to compute (timers, byte walks) should guard on this before
    computing them."""
    r = _job_store.lookup()
    return r if r is not None else _registry


def enabled() -> bool:
    return get() is not None


def counter(name: str, inc: float = 1.0) -> None:
    r = get()
    if r is not None:
        r.counter(name, inc)


def gauge(name: str, value: float) -> None:
    r = get()
    if r is not None:
        r.gauge(name, value)


def observe(name: str, value: float) -> None:
    r = get()
    if r is not None:
        r.observe(name, value)


def add_cli_flag(parser):
    """Register the canonical ``--fleet_stats`` flag (one help text for
    every entry point that supports fleet telemetry)."""
    parser.add_argument(
        "--fleet_stats", type=str, default=None,
        help="record per-client fleet telemetry (health registry, latency/"
             "staleness histograms, piggybacked client metrics — docs/"
             "OBSERVABILITY.md 'Fleet telemetry') and write per-round "
             "fleet.jsonl snapshots into this dir (render with "
             "tools/fleet_report.py); read-only, results are unchanged; "
             "message-passing backends only",
    )
    return parser


# ---------------------------------------------------------------------------
# Fleet health view
# ---------------------------------------------------------------------------


class FleetHealth:
    """Per-rank health records, keyed by wire rank (flat server: worker
    rank; tree root: edge-tier rank). Owned by a server manager — unlike the
    process registry this is explicitly server-LOCAL state, because rank
    numbering is fabric-local.

    Each record carries the rank's current ``state`` plus a bounded
    transition timeline (``[(t_seconds, state), ...]``, consecutive
    duplicates deduped — heartbeats refresh liveness without growing it),
    counters, gauges, and histograms. :meth:`merge_report` folds the compact
    telemetry dict a client/edge piggybacked on an upload
    (docs/OBSERVABILITY.md "Fleet telemetry" documents the wire fields)."""

    MAX_TIMELINE = 1024  # per-rank transition ring; oldest entries dropped

    def __init__(self, growth: float = 2.0):
        self._lock = threading.Lock()
        self._growth = float(growth)
        self._t0 = time.monotonic()
        self._ranks: dict[int, dict] = {}  # guarded-by: _lock

    def _rec(self, rank: int) -> dict:  # lock-held: _lock
        rec = self._ranks.get(rank)
        if rec is None:
            rec = self._ranks[rank] = {
                "state": None, "timeline": [], "timeline_dropped": 0,
                "counters": {}, "gauges": {}, "hists": {},
            }
        return rec

    def record_state(self, rank: int, state: str) -> None:
        """Record a health-state transition (consecutive duplicates are
        deduped; the timeline is a bounded ring)."""
        t = time.monotonic() - self._t0
        with self._lock:
            rec = self._rec(int(rank))
            if rec["state"] == state:
                return
            rec["state"] = state
            tl = rec["timeline"]
            tl.append((round(t, 4), str(state)))
            if len(tl) > self.MAX_TIMELINE:
                del tl[0]
                rec["timeline_dropped"] += 1

    def state(self, rank: int) -> str | None:
        with self._lock:
            rec = self._ranks.get(int(rank))
            return rec["state"] if rec else None

    def timeline(self, rank: int) -> list[tuple[float, str]]:
        with self._lock:
            rec = self._ranks.get(int(rank))
            return list(rec["timeline"]) if rec else []

    def counter(self, rank: int, name: str, inc: float = 1.0) -> None:
        with self._lock:
            c = self._rec(int(rank))["counters"]
            c[name] = c.get(name, 0) + inc

    def gauge(self, rank: int, name: str, value: float) -> None:
        with self._lock:
            self._rec(int(rank))["gauges"][name] = value

    def observe(self, rank: int, name: str, value: float) -> None:
        with self._lock:
            hists = self._rec(int(rank))["hists"]
            h = hists.get(name)
            if h is None:
                h = hists[name] = Histogram(growth=self._growth)
            h.observe(value)

    def merge_report(self, rank: int, report: dict | None,
                     now: float | None = None) -> None:
        """Fold one piggybacked telemetry dict into the rank's record. Wire
        fields (all optional — absent fields cost nothing):

        - ``sent_at``: sender's ``time.time()`` at send → an ``upload_ms``
          histogram sample (receive minus send; clock-skew-honest only
          within one host, which is where the latency question is asked)
        - ``step_ms``: sender-side local compute wall ms → histogram
        - ``retries``: the sender manager's cumulative retry count → gauge
          (cumulative at source, so last-wins, never summed)
        - ``counts``: ``{name: cumulative_value}`` sender-side totals (edge
          tiers report fold/discard/stale/dup counts here) → gauges
        """
        if not report:
            return
        rank = int(rank)
        sent = report.get("sent_at")
        if sent is not None:
            t = time.time() if now is None else now
            self.observe(rank, "upload_ms",
                         max(t - float(sent), 0.0) * 1e3)
        step = report.get("step_ms")
        if step is not None:
            self.observe(rank, "step_ms", float(step))
        retries = report.get("retries")
        if retries is not None:
            self.gauge(rank, "retries", float(retries))
        for name, v in (report.get("counts") or {}).items():
            self.gauge(rank, str(name), float(v))

    def ranks(self) -> list[int]:
        with self._lock:
            return sorted(self._ranks)

    def snapshot(self) -> dict:
        """Atomic point-in-time view: ``{"ranks": {rank: record}}`` with
        histogram snapshots inlined — plain JSON-able data."""
        with self._lock:
            return {"ranks": {
                str(rank): {
                    "state": rec["state"],
                    "timeline": [list(e) for e in rec["timeline"]],
                    "timeline_dropped": rec["timeline_dropped"],
                    "counters": dict(rec["counters"]),
                    "gauges": dict(rec["gauges"]),
                    "histograms": {k: h.snapshot()
                                   for k, h in rec["hists"].items()},
                }
                for rank, rec in sorted(self._ranks.items())
            }}

    def round_record(self, round_idx: int, extra: dict | None = None) -> dict:
        """One JSONL fleet snapshot line: the cumulative fleet view stamped
        with the round (sync) / emitted-version (async) index."""
        rec: dict[str, Any] = {"round": int(round_idx), **self.snapshot()}
        if extra:
            rec.update(extra)
        return rec

    def merged_histogram(self, name: str) -> Histogram | None:
        """The named histogram merged across every rank (the fleet-wide
        distribution a report renders), or None if no rank observed it."""
        out: Histogram | None = None
        with self._lock:
            for rec in self._ranks.values():
                h = rec["hists"].get(name)
                if h is None:
                    continue
                if out is None:
                    out = Histogram(growth=h.growth)
                out.merge(h.snapshot())
        return out
