"""The multi-process runtime, the port of ``fedml_tpu/parallel/multihost.py``.

The JAX package forms one logical device mesh out of every host's chips
with ``jax.distributed`` and runs the engine's round program over it
unchanged. The port runs one process per device (a rank) in a
``torch.distributed`` world: :func:`init_multihost` forms it, with the
backend the caller names (NCCL across cards, gloo on the CPU or for ranks
that share one card), :func:`global_client_mesh` lays the ``clients x silo``
mesh over its ranks, and each rank trains its own slice of the cohort.

Host-side cohort sampling and shuffling are deterministic in (seed, round),
so every rank computes the same index maps without communicating and stages
only its own slots (:func:`stage_global`) — the multi-controller discipline.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from fedml_tpu_torch.parallel import mesh as meshlib

BACKENDS = ("nccl", "gloo")


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    platform: str | None = None,
    timeout_s: float = 300.0,
) -> None:
    """Join (or form) the world: ``coordinator_address`` is rank 0's
    ``host:port``, ``num_processes`` the world size, ``process_id`` this
    process's rank. Left None, the three come from the environment a
    launcher sets (``torchrun``'s ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). ``backend`` is ``"nccl"`` or ``"gloo"``;
    None takes NCCL on ``platform="cuda"`` (the default) and gloo on
    ``"cpu"``. A backend that fails to initialise raises: none is put in
    its place. ``timeout_s`` bounds every collective of the world, so a
    rank that dies fails the others instead of hanging them."""
    platform = platform or "cuda"
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"unknown platform {platform!r} (expected 'cuda' or 'cpu')")
    backend = backend or ("nccl" if platform == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")
    if backend == "nccl" and platform != "cuda":
        raise ValueError("the NCCL backend moves CUDA tensors: it needs platform='cuda'")
    if dist.is_initialized():
        raise RuntimeError("the torch.distributed world is already initialised")
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and process_id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=timeout)


def rank_device(platform: str = "cuda", local_rank: int | None = None,
                share_device: bool = False) -> torch.device:
    """This rank's device: the CPU, or ``cuda:(local_rank % device_count)``
    (``local_rank`` from ``LOCAL_RANK``, else the world rank). More local
    ranks than cards is refused unless ``share_device`` (gloo only: NCCL
    refuses two ranks on one card)."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("platform 'cuda' requested but torch.cuda.is_available() is False")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized()
                                        else 0))
    n = torch.cuda.device_count()
    if local_rank >= n and not share_device:
        raise ValueError(f"local rank {local_rank} has no card of its own ({n} visible); "
                         "ranks share a card only over gloo, when asked (share_device)")
    if local_rank >= n and dist.is_initialized() and dist.get_backend() == "nccl":
        raise ValueError("NCCL refuses two ranks on one card: use the gloo backend")
    device = torch.device("cuda", local_rank % n)
    torch.cuda.set_device(device)
    return device


def global_client_mesh(silo: int = 1) -> meshlib.RankMesh:
    """A mesh over every rank of the world, clients x silo — the multi-host
    version of ``mesh.client_mesh``/``silo_mesh`` (same axis names and
    argument convention: ``silo`` is the silo-group size)."""
    ranks = meshlib.world_ranks()
    if silo > 1:
        if len(ranks) % silo:
            raise ValueError(f"{len(ranks)} devices not divisible by silo={silo}")
        return meshlib.silo_mesh(len(ranks) // silo, ranks)
    return meshlib.client_mesh(ranks)


def stage_global(host_array: np.ndarray, mesh: meshlib.RankMesh,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """This rank's block of a ``[C, S, B, ...]`` cohort array that every rank
    holds identically (``mesh.cohort_batch_slices``: its cohort slots, and
    its batch rows on a silo mesh), on ``device``. On one rank, the whole
    array."""
    host_array = np.asarray(host_array)
    batch = host_array.shape[2] if host_array.ndim > 2 else 1
    rows, cols = meshlib.cohort_batch_slices(mesh, host_array.shape[0], batch)
    block = host_array[rows] if host_array.ndim <= 2 else host_array[rows, :, cols]
    return torch.as_tensor(np.ascontiguousarray(block), device=device)


def flatten_variables(variables) -> np.ndarray:
    """Canonical flat view of a model state dict in the JAX leaf order (the
    flax tree of ``convert.to_flax``, its paths sorted as ``jax.tree.leaves``
    visits them) — the npz exchange format the multihost entry writes, equal
    to the JAX package's for the same model."""
    from fedml_tpu_torch import convert
    from fedml_tpu_torch.comm.message import tree_leaves_with_paths

    return np.concatenate([np.ravel(leaf.detach().cpu().numpy()) for _, leaf in
                           tree_leaves_with_paths(convert.to_flax_tensors(variables))])
