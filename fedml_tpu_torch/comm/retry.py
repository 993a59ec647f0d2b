"""Retry/backoff send plane (docs/ROBUSTNESS.md "Failure recovery"), a copy
of ``fedml_tpu/comm/retry.py``.

Until this module, ONE failed send anywhere in the runtime was fatal: a
transient gRPC unavailability, an object-store hiccup, or a faulted
loopback leg killed the whole broadcast (and with it the server's round
protocol). At the north-star scale transient failure is the steady state,
so the send plane gets the standard production treatment: bounded retries
with exponential backoff + jitter, applied OUTSIDE whatever transport (or
fault injector) actually performs the send, so each attempt re-runs the
full send path.

A :class:`RetryPolicy` is attached to a communication manager
(``mgr.retry_policy = policy``); :meth:`BaseCommunicationManager.
broadcast_message` wraps each per-destination leg and
``DistributedManager.send_message`` wraps unary sends. Fault-free runs
with a policy installed are BIT-IDENTICAL to runs without one (the policy
only adds a closure call — tools/ft_smoke.py guards this).

Every retry lands in three places: a ``comm/retry`` span on the tracer
(covering the backoff wait, with the attempt index and error), a
``comm/retry_count`` trace counter, and the process-wide
:func:`retry_stats` ledger (the ``Comm/RetryCount`` metric's source —
mirrors ``comm.message.wire_stats``).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable

from fedml_tpu_torch.obs import trace

__all__ = [
    "RetryPolicy", "SendAttemptTimeout", "retry_stats", "reset_retry_stats",
]


class SendAttemptTimeout(TimeoutError):
    """One send attempt exceeded ``RetryPolicy.attempt_timeout``. The
    attempt's thread is abandoned (daemon — a hung transport call cannot be
    cancelled from Python), and the policy moves on to the next attempt."""


_stats_lock = threading.Lock()
_stats = {"retries": 0, "gave_up": 0}
# jitter only perturbs SLEEP durations, never results; module-level rng is
# deliberately unseeded (determinism of outputs does not depend on it)
_jitter_rng = random.Random()


def retry_stats() -> dict:
    """Process-wide retry ledger: ``retries`` = individual re-attempts after
    a failed send, ``gave_up`` = sends that exhausted every attempt."""
    with _stats_lock:
        return dict(_stats)


def reset_retry_stats() -> None:
    with _stats_lock:
        _stats["retries"] = 0
        _stats["gave_up"] = 0


def _count(key: str) -> int:
    with _stats_lock:
        _stats[key] += 1
        return _stats[key]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for one send leg.

    ``max_attempts`` total tries (1 = no retries); the wait before attempt
    k+1 is ``min(base_delay * backoff**(k-1), max_delay)`` perturbed by
    ``±jitter`` (fractional, decorrelates a thundering herd of failed
    broadcast legs). ``attempt_timeout`` (seconds, optional) bounds each
    attempt by running it on a watchdog thread — a transport call that
    never returns is abandoned (the daemon thread leaks until the call
    dies; Python cannot cancel it) and counted as a failed attempt."""

    max_attempts: int = 3
    base_delay: float = 0.05
    backoff: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.1
    attempt_timeout: float | None = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        for name in ("base_delay", "max_delay"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if self.backoff < 1.0:
            raise ValueError(f"backoff must be >= 1.0, got {self.backoff}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def delay_for(self, attempt: int) -> float:
        """Backoff before re-attempt number ``attempt`` (1-based)."""
        d = min(self.base_delay * self.backoff ** (attempt - 1), self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * _jitter_rng.random() - 1.0)
        return max(d, 0.0)

    def _attempt(self, fn: Callable[[], None]):
        if self.attempt_timeout is None:
            return fn()
        result: list = []
        failure: list[BaseException] = []

        def run():
            try:
                result.append(fn())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                failure.append(e)

        t = threading.Thread(target=run, name="comm-retry-attempt", daemon=True)
        t.start()
        t.join(self.attempt_timeout)
        if t.is_alive():
            raise SendAttemptTimeout(
                f"send attempt still running after {self.attempt_timeout}s"
            )
        if failure:
            raise failure[0]
        return result[0] if result else None

    def run(self, fn: Callable[[], None], on_retry: Callable[[], None] | None = None,
            **attrs):
        """Run ``fn`` with retries. ``attrs`` (e.g. dst/msg_type) annotate
        the ``comm/retry`` telemetry; ``on_retry`` (optional) fires once per
        re-attempt — the per-MANAGER attribution hook the fleet telemetry
        plane uses (the module ledger is process-wide, which cannot tell one
        in-process rank's retries from another's). Raises the LAST error
        once ``max_attempts`` is exhausted."""
        for attempt in range(1, self.max_attempts + 1):
            try:
                return self._attempt(fn)
            except Exception as e:
                if getattr(e, "unretryable", False):
                    # e.g. faults.InjectedCrash: re-sending cannot bring a
                    # dead process back — propagate immediately
                    raise
                if attempt >= self.max_attempts:
                    _count("gave_up")
                    trace.event("comm/retry_gave_up", attempts=attempt,
                                error=type(e).__name__, **attrs)
                    raise
                total = _count("retries")
                if on_retry is not None:
                    on_retry()
                trace.counter("comm/retry_count", total)
                with trace.span("comm/retry", attempt=attempt,
                                error=type(e).__name__, **attrs):
                    time.sleep(self.delay_for(attempt))
