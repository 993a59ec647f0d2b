"""Thread-bound job scoping for the process-wide tracer, a copy of
``fedml_tpu/obs/jobscope.py``.

A process that runs several federations (or lanes of one run) binds each of
its threads to a job; :func:`fedml_tpu_torch.obs.trace.get` consults the
calling thread's binding first and falls back to the process tracer, so:

- single-job runs are untouched (no bindings, one dict-emptiness check on
  the hot path);
- a job's spans land in ITS tracer whichever of its threads emitted them.

Bindings are plain thread-ident dict entries, not contextvars: contextvars
do not cross ``threading.Thread``, and :func:`wrap_target` is the explicit
inheritance point a spawn site uses.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

_lock = threading.Lock()
# thread ident -> job name. Written under _lock; read lock-free on the
# instrumentation hot path (a CPython dict read is atomic, and a stale read
# only mis-scopes the first records of a just-(un)bound thread).
_thread_jobs: dict[int, str] = {}


def current_job() -> str | None:
    """The job the calling thread is bound to, or None (process scope)."""
    return _thread_jobs.get(threading.get_ident())


def bind_thread(job: str) -> None:
    """Bind the calling thread to ``job`` until unbound (prefer :class:`bound`
    or :func:`wrap_target`, which restore the previous binding)."""
    with _lock:
        _thread_jobs[threading.get_ident()] = job


def unbind_thread() -> None:
    with _lock:
        _thread_jobs.pop(threading.get_ident(), None)


class bound:
    """Context manager: bind the calling thread to ``job`` for the block,
    restoring the previous binding (usually none) on exit. ``job=None`` is a
    no-op so call sites can pass an optional job straight through."""

    def __init__(self, job: str | None):
        self._job = job
        self._prev: str | None = None

    def __enter__(self) -> "bound":
        if self._job is not None:
            self._prev = current_job()
            bind_thread(self._job)
        return self

    def __exit__(self, *exc) -> None:
        if self._job is None:
            return
        if self._prev is None:
            unbind_thread()
        else:
            bind_thread(self._prev)


def wrap_target(target: Callable, job: str | None = None) -> Callable:
    """Thread-entry inheritance point: wrap a ``threading.Thread`` /
    ``threading.Timer`` target so the new thread runs bound to ``job``
    (default: the SPAWNING thread's binding at wrap time). Returns ``target``
    unchanged when there is no job to inherit — zero overhead for every
    single-job run."""
    job = current_job() if job is None else job
    if job is None:
        return target

    def run(*args: Any, **kwargs: Any):
        with bound(job):
            return target(*args, **kwargs)

    return run


class JobStore:
    """Per-facility ``job -> installed object`` store (one for the metric
    registries, one for the tracers). Lookup is hot-path: one emptiness
    check when no jobs are installed."""

    def __init__(self, facility: str):
        self.facility = facility
        self._lock = threading.Lock()
        # written under _lock; read lock-free from lookup()
        self._objects: dict[str, Any] = {}

    def install(self, job: str, obj: Any) -> Any:
        with self._lock:
            self._objects[job] = obj
        return obj

    def uninstall(self, job: str) -> Any | None:
        with self._lock:
            return self._objects.pop(job, None)

    def installed(self) -> dict[str, Any]:
        with self._lock:
            return dict(self._objects)

    def lookup(self) -> Any | None:
        """The calling thread's job-scoped object, or None (process scope).
        Fast path first: no jobs installed -> no thread-map read at all."""
        objects = self._objects
        if not objects:
            return None
        job = _thread_jobs.get(threading.get_ident())
        if job is None:
            return None
        return objects.get(job)
