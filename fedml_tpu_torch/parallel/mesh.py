"""Rank meshes, the port of ``fedml_tpu/parallel/mesh.py``.

The JAX package lays a federated simulation over a device mesh: the
``clients`` axis carries cohort parallelism (each device trains a slice of
the cohort), an optional ``silo`` axis carries in-silo data parallelism
(each device holds a slice of every client's batch), and ``model`` carries
tensor or FSDP sharding within one client's model. The port runs one
process per device, so its mesh is over the ranks of a ``torch.distributed``
world: a :class:`RankMesh` names the same axes over a grid of ranks and
holds this rank's process group along each axis, which the collectives
(``parallel/collectives.py``) reduce and gather over.

Every rank builds the same mesh, in the same order: a process group is made
by a call of every rank of the world. Without an initialised world the mesh
is one rank, rank 0, and holds no group: every collective over it is the
identity. Axis names, constructor signatures and their errors are JAX's; a
rank stands where JAX has a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch.distributed as dist

CLIENT_AXIS = "clients"
SILO_AXIS = "silo"
# model-parallel axis: tensor/FSDP sharding WITHIN one client's model,
# orthogonal to the client axis that carries cohort parallelism
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh:
    """Named axes over a grid of ranks. ``ranks`` is the grid (global ranks,
    one axis per name in ``axis_names``); ``groups`` maps each axis to this
    rank's process group along it, None where the axis has one rank or this
    rank is not in the mesh. ``shape`` is JAX's ``Mesh.shape``: axis name to
    size, in axis order."""

    ranks: np.ndarray
    axis_names: tuple[str, ...]
    groups: dict

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def rank(self) -> int:
        """This process's global rank (0 without a world)."""
        return dist.get_rank() if dist.is_initialized() else 0

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        where = np.argwhere(self.ranks == self.rank)
        if len(where) == 0:
            raise ValueError(f"rank {self.rank} is not in this mesh ({self.ranks.tolist()})")
        return int(where[0][self.axis_names.index(axis)])

    def group(self, axis: str):
        """This rank's process group along ``axis`` (None: one rank)."""
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return f"RankMesh({self.shape}, ranks={self.ranks.tolist()})"


def world_ranks() -> list[int]:
    """Every rank of the initialised world, in order; ``[0]`` without one."""
    return list(range(dist.get_world_size())) if dist.is_initialized() else [0]


def _build(grid: np.ndarray, axis_names: tuple[str, ...]) -> RankMesh:
    """The mesh over ``grid``, with a process group per axis line. Every rank
    of the world calls ``new_group`` for every line of more than one rank,
    in the same order (a group is a collective of the world); a line that is
    the whole world in rank order reuses the world's group."""
    grid = np.asarray(grid, dtype=np.int64)
    groups: dict = {}
    if not dist.is_initialized():
        if grid.size != 1 or int(grid.flat[0]) != 0:
            raise ValueError(f"a mesh over ranks {grid.ravel().tolist()} needs an initialised "
                             "torch.distributed world (parallel.multihost.init_multihost)")
        return RankMesh(grid, axis_names, groups)
    me, world = dist.get_rank(), dist.get_world_size()
    for i, axis in enumerate(axis_names):
        if grid.shape[i] == 1:
            continue
        for line in np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i]).tolist():
            group = (dist.group.WORLD if line == list(range(world))
                     else dist.new_group(line))
            if me in line:
                groups[axis] = group
    return RankMesh(grid, axis_names, groups)


def client_mesh(ranks=None) -> RankMesh:
    """1-D mesh: every rank is a client slot (default: every rank of the
    world, or rank 0 alone without one)."""
    ranks = list(ranks if ranks is not None else world_ranks())
    return _build(np.asarray(ranks), (CLIENT_AXIS,))


def silo_mesh(num_silos: int, ranks=None) -> RankMesh:
    """2-D mesh [clients, silo]: cohort parallelism x intra-silo DP."""
    ranks = list(ranks if ranks is not None else world_ranks())
    n = len(ranks)
    if n % num_silos:
        raise ValueError(
            f"silo_mesh(num_silos={num_silos}): {n} available devices do "
            f"not divide evenly into {num_silos} silo groups "
            f"({n} % {num_silos} = {n % num_silos})"
        )
    return _build(np.asarray(ranks).reshape(num_silos, n // num_silos), (CLIENT_AXIS, SILO_AXIS))


def shard_mesh(mesh_shape, ranks=None) -> RankMesh:
    """2-D mesh [clients, model]: cohort parallelism x within-client model
    parallelism. ``mesh_shape`` is ``(n_client_shards, n_model_shards)``;
    the product must divide the rank count evenly, and a proper divisor
    takes the first ``clients * model`` ranks."""
    ranks = list(ranks if ranks is not None else world_ranks())
    try:
        clients, model = (int(x) for x in mesh_shape)
    except (TypeError, ValueError):
        raise ValueError(
            f"mesh_shape must be a (clients, model) pair, got {mesh_shape!r}"
        ) from None
    if clients < 1 or model < 1:
        raise ValueError(
            f"mesh_shape axes must be >= 1, got {(clients, model)}"
        )
    n, want = len(ranks), clients * model
    if want > n or n % want:
        raise ValueError(
            f"mesh_shape {(clients, model)} requires {want} devices "
            f"(clients x model) but {n} are available, and {want} does "
            f"not divide {n} evenly ({n} % {want} = {n % want})"
            if want <= n else
            f"mesh_shape {(clients, model)} requires {want} devices "
            f"(clients x model) but only {n} are available"
        )
    return _build(np.asarray(ranks[:want]).reshape(clients, model), (CLIENT_AXIS, MODEL_AXIS))


def parse_mesh_shape(text: str | None):
    """CLI spelling of a (clients, model) mesh shape: ``'2x4'`` or
    ``'2,4'`` -> ``(2, 4)``; None/empty passes through (no 2-D mesh)."""
    if not text:
        return None
    parts = text.lower().replace("x", ",").split(",")
    try:
        clients, model = (int(p) for p in parts)
    except ValueError:
        raise ValueError(
            f"--mesh_shape expects 'CLIENTSxMODEL' (e.g. 2x4), got {text!r}"
        ) from None
    return (clients, model)


def cohort_batch_slices(mesh: RankMesh, n_slots: int, batch_size: int) -> tuple[slice, slice]:
    """What this rank holds of a ``[C, S, B, ...]`` cohort stack, JAX's
    ``cohort_batch_sharding`` (``P(clients, None, silo)``): its block of
    ``n_slots // clients`` cohort slots and, on a mesh with a ``silo`` axis,
    its block of ``batch_size // silo`` rows of every batch."""
    n_c = mesh.shape[CLIENT_AXIS]
    if n_slots % n_c:
        raise ValueError(f"{n_slots} cohort slots do not shard over the {n_c}-way "
                         f"'{CLIENT_AXIS}' axis (pad the cohort to a multiple of it)")
    c_local = n_slots // n_c
    c0 = mesh.coord(CLIENT_AXIS) * c_local
    n_s = mesh.shape.get(SILO_AXIS, 1)
    if batch_size % n_s:
        raise ValueError(f"batch size {batch_size} does not split over the {n_s}-way "
                         f"'{SILO_AXIS}' axis ({batch_size} % {n_s} = {batch_size % n_s})")
    b_local = batch_size // n_s
    b0 = mesh.coord(SILO_AXIS) * b_local if n_s > 1 else 0
    return slice(c0, c0 + c_local), slice(b0, b0 + b_local)
