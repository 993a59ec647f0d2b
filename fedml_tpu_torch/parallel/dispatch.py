"""Sharded or client-mapped: the port of ``fedml_tpu/parallel/dispatch.py``.

The JAX package lowers every round program through one dispatcher that
picks pjit (GSPMD partitions the math) when a partition spec shards an axis
beyond the mapped ``clients`` axis, and ``shard_map`` (per-device bodies)
otherwise. That choice is kept here as :func:`plan_is_sharded`, over the
same specs; what it selects is not a compiler but the engine's own program:
``sim/engine.py`` runs its sharded round (this rank's blocks cut from the
whole global model, :func:`shard` / :func:`unshard` / :func:`replicate` at
its boundaries) when the plan shards something, and its client-mapped round
otherwise. JAX's ``lower``, ``Lowered``, ``jit_sharded`` and
``to_shardings`` turn specs into compiled programs and device placements,
which eager torch has no use for; they have no counterpart.

A rank holds a tensor's *block*: along each dimension its spec names an
axis of, the tensor is cut into that axis's rank count of equal blocks, and
the rank keeps the block of its coordinate on the axis. A dimension of
``groups`` equal parts (:attr:`RuleSet.groups`, the TransformerLM's fused
``[q|k|v]`` projection) is cut part by part, the rank keeping its block of
each part, concatenated. :func:`unshard` all-gathers the blocks back: a
concatenation, bitwise the full tensor.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.parallel import collectives
from fedml_tpu_torch.parallel.mesh import CLIENT_AXIS, RankMesh
from fedml_tpu_torch.parallel.rules import PartitionSpec

MAPPED_AXES = frozenset({CLIENT_AXIS})


def _spec_leaves(specs) -> list:
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        specs = list(specs.values())
    return [s for tree in specs for s in _spec_leaves(tree)]


def spec_is_sharded(spec: PartitionSpec, mapped_axes=MAPPED_AXES) -> bool:
    """True iff the spec partitions an axis beyond the mapped axes."""
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None and ax not in mapped_axes:
                return True
    return False


def plan_is_sharded(*spec_trees, mapped_axes=MAPPED_AXES) -> bool:
    """True iff any PartitionSpec in the given trees (specs, dicts or
    sequences of them) is sharded beyond the mapped (client) axes — the
    sharded-vs-client-mapped switch."""
    return any(
        spec_is_sharded(s, mapped_axes)
        for tree in spec_trees
        for s in _spec_leaves(tree)
    )


def _cuts(spec: PartitionSpec, mesh: RankMesh, lead: int, mapped_axes):
    """``(dim, axis, rank count)`` of each dimension ``spec`` shards, the
    dimensions counted after ``lead`` leading (unsharded) ones."""
    return [(lead + d, ax, mesh.shape[ax]) for d, ax in enumerate(spec)
            if ax is not None and ax not in mapped_axes and mesh.shape.get(ax, 1) > 1]


def shard(x: torch.Tensor, spec: PartitionSpec, mesh: RankMesh, groups: int = 1,
          lead: int = 0, name: str = "tensor", mapped_axes=MAPPED_AXES) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` by ``spec`` (after ``lead``
    leading dimensions, e.g. a stack's client axis), a view. A dimension
    that does not split evenly raises naming ``name``."""
    for dim, ax, n in _cuts(spec, mesh, lead, mapped_axes):
        size = x.shape[dim]
        if size % (groups * n):
            raise ValueError(
                f"{name} {tuple(x.shape)}: dimension {dim - lead} of size {size} does not "
                f"split into {groups} part(s) over the {n}-way '{ax}' axis")
        part, r = size // groups, mesh.coord(ax)
        block = part // n
        if groups == 1:
            x = x.narrow(dim, r * block, block)
        else:
            x = torch.cat([x.narrow(dim, g * part + r * block, block) for g in range(groups)],
                          dim=dim)
    return x


def unshard(x: torch.Tensor, spec: PartitionSpec, mesh: RankMesh, groups: int = 1,
            lead: int = 0, mapped_axes=MAPPED_AXES) -> torch.Tensor:
    """The full tensor of every rank's block ``x`` (:func:`shard`'s
    inverse): an all-gather along each sharded dimension, differentiable
    (concatenation forward, this rank's block of the gradient backward).
    Bitwise the tensor that was sharded."""
    for dim, ax, n in reversed(_cuts(spec, mesh, lead, mapped_axes)):
        full = collectives.gather_axis(x, dim, mesh.group(ax))
        if groups > 1:
            # [rank][part][block] -> [part][rank][block]
            shape = full.shape
            full = full.reshape(shape[:dim] + (n, groups, -1) + shape[dim + 1:])
            full = full.transpose(dim, dim + 1).reshape(shape)
        x = full
    return x


def shard_tree(tree: dict, specs: dict, mesh: RankMesh, groups_of=None, lead: int = 0) -> dict:
    """:func:`shard` of every tensor of a state dict by its spec
    (``groups_of(name)``: the part count, :meth:`RuleSet.groups_of`)."""
    return {k: shard(v, specs[k], mesh, groups_of(k) if groups_of else 1, lead, name=repr(k))
            for k, v in tree.items()}


def unshard_tree(tree: dict, specs: dict, mesh: RankMesh, groups_of=None, lead: int = 0) -> dict:
    """:func:`unshard` of every tensor of a state dict by its spec."""
    return {k: unshard(v, specs[k], mesh, groups_of(k) if groups_of else 1, lead)
            for k, v in tree.items()}


def replicate(tree: dict, specs: dict, mesh: RankMesh, groups_of=None) -> dict:
    """The gather-for-compute step of the FSDP-style plans
    (:attr:`RuleSet.gather_compute`): every sharded tensor of ``tree``
    gathered whole (one all-gather each, a concatenation), after which every
    arithmetic op sees exactly the tensors the unsharded program sees."""
    return unshard_tree(tree, specs, mesh, groups_of)


def shard_module(module: torch.nn.Module, specs: dict, mesh: RankMesh,
                 groups_of=None) -> torch.nn.Module:
    """A copy of ``module`` that holds this rank's block of each tensor its
    spec shards (same names, the blocks' shapes): the module a
    tensor-parallel plan trains (JAX's ``module.clone(mp_axis=...)`` under a
    placement by the rules). ``module`` itself is left as it is."""
    import copy

    out = copy.deepcopy(module)
    with torch.no_grad():
        for name, t in list(out.named_parameters()) + list(out.named_buffers()):
            spec = specs.get(name)
            if spec is not None and spec_is_sharded(spec):
                t.data = shard(t.data, spec, mesh, groups_of(name) if groups_of else 1,
                               name=repr(name)).clone()
    return out
