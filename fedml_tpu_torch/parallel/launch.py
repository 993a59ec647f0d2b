"""Local rank launcher: N processes of one world on this host.

:func:`launch` starts ``nprocs`` rank processes with the ``spawn`` method
(a parent with threads, such as a test process, is unsafe to fork), forms
their world over ``localhost`` (``multihost.init_multihost``), runs
``fn(device, *args)`` on every rank and returns the ranks' results in rank
order; with a ``coordinator`` they are ranks ``first_rank ..`` of a world
of ``world_size`` spread over several hosts (one launcher a host). ``fn``
is a module-level function (it is pickled by its import
path); its result must pickle. Every rank runs with one torch thread, so
its CPU arithmetic does not depend on the host's core count.

A rank that raises, exits or outlives ``timeout_s`` fails the launch: the
launcher kills every rank it started and raises with the ranks' errors. The
world's own timeout (the same ``timeout_s``) makes a rank blocked in a
collective with a dead peer fail rather than hang.
"""

from __future__ import annotations

import multiprocessing
import queue
import socket
import time
import traceback

import torch


def free_port() -> int:
    """A TCP port the OS found free on localhost (bound to port 0, then
    released)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(local_rank, world, coordinator, backend, platform, share_device, timeout_s,
               fn, args, results):
    import torch.distributed as dist

    from fedml_tpu_torch.parallel import multihost

    try:
        torch.set_num_threads(1)
        multihost.init_multihost(coordinator, world[1], world[0] + local_rank, backend=backend,
                                 platform=platform, timeout_s=timeout_s)
        device = multihost.rank_device(platform, local_rank, share_device=share_device)
        out = fn(device, *args)
        dist.destroy_process_group()
        results.put((local_rank, True, out))
    except BaseException:  # reported to the launcher, which fails
        results.put((local_rank, False, traceback.format_exc()))
        raise


def launch(fn, nprocs: int, *args, backend: str = "gloo", platform: str = "cpu",
           share_device: bool = False, timeout_s: float = 300.0,
           coordinator: str | None = None, world_size: int | None = None,
           first_rank: int = 0) -> list:
    """``fn(device, *args)`` on each of ``nprocs`` local ranks of a world
    over ``backend`` (``platform`` ``"cpu"`` or ``"cuda"``; ranks share a
    card only with ``share_device``, over gloo); returns their results in
    rank order. Without a ``coordinator`` the world is these ranks, over a
    free localhost port."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    if coordinator is None:
        coordinator, world_size, first_rank = f"localhost:{free_port()}", nprocs, 0
    world = (first_rank, world_size)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, coordinator, backend, platform, share_device,
                               timeout_s, fn, args, results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got: dict[int, tuple] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < nprocs:
            try:
                rank, ok, out = results.get(timeout=1.0)
                got[rank] = (ok, out)
                if not ok:
                    break
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    break
    finally:
        for p in procs:
            p.join(timeout=5.0 if len(got) == nprocs else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    failed = {r: out for r, (ok, out) in got.items() if not ok}
    if failed or len(got) < nprocs:
        missing = [r for r in range(nprocs) if r not in got]
        detail = "".join(f"\n--- rank {r} ---\n{tb}" for r, tb in sorted(failed.items()))
        raise RuntimeError(
            f"launch of {nprocs} ranks ({backend}, {platform}) failed: ranks "
            f"{sorted(failed)} raised, ranks {missing} gave no result within {timeout_s} s "
            f"(exit codes {[p.exitcode for p in procs]}){detail}")
    return [got[r][1] for r in range(nprocs)]
