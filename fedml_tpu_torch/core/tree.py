"""State-dict arithmetic, the port of ``fedml_tpu/core/tree.py:74-120``.

Model variables in the port are flat ``state_dict``-style dicts of tensors
(name -> tensor) instead of JAX pytrees. Where the JAX package splits them
into collections, ``params`` and ``batch_stats``, the port tells them apart
by name (:func:`is_model_state`): BatchNorm's running statistics are the
model state, every other leaf a parameter, as ``convert.to_flax`` files
them.
"""

from __future__ import annotations

from typing import Iterable

import torch

StateDict = dict[str, torch.Tensor]


# the leaf names of the model state (flax's ``batch_stats`` collection)
_MODEL_STATE = ("running_mean", "running_var")


def is_model_state(name: str) -> bool:
    """Whether leaf ``name`` is model state (a BatchNorm running statistic,
    flax's ``batch_stats``) rather than a parameter."""
    return name.rsplit(".", 1)[-1] in _MODEL_STATE


def params_of(tree: StateDict) -> StateDict:
    """The parameters of a state dict (flax's ``params`` collection), in
    its order."""
    return {k: v for k, v in tree.items() if not is_model_state(k)}


def add(a: StateDict, b: StateDict) -> StateDict:
    return {k: a[k] + b[k] for k in a}


def sub(a: StateDict, b: StateDict) -> StateDict:
    """a - b, leafwise."""
    return {k: a[k] - b[k] for k in a}


def scale(tree: StateDict, s) -> StateDict:
    return {k: v * s for k, v in tree.items()}


def dot(a: StateDict, b: StateDict) -> torch.Tensor:
    """Sum of the leafwise inner products, accumulated in f32."""
    total = torch.zeros((), dtype=torch.float32, device=next(iter(a.values())).device)
    for k in a:
        total = total + torch.vdot(a[k].reshape(-1), b[k].reshape(-1)).float()
    return total


def norm(tree: StateDict) -> torch.Tensor:
    """Global L2 norm over all leaves."""
    return torch.sqrt(dot(tree, tree))


def weighted_mean(trees: Iterable[StateDict], weights: torch.Tensor) -> StateDict:
    """Weighted mean of a sequence of state dicts.

    ``weights`` [C] need not be normalised (raw per-client sample counts);
    they are normalised in f32. Leaves are accumulated in f32, one tree at a
    time in sequence order, and the result is cast back to each leaf's dtype.
    ``trees`` is consumed once, and each tree is folded in before the next is
    drawn, so a lazily produced sequence holds one tree at a time.
    """
    w = weights.float()
    w = w / torch.clamp(w.sum(), min=1e-12)
    acc: StateDict = {}
    dtypes: dict[str, torch.dtype] = {}
    n = 0
    for i, tree in enumerate(trees):
        for k, leaf in tree.items():
            term = leaf.float() * w[i]
            if i == 0:
                acc[k] = term
                dtypes[k] = leaf.dtype
            else:
                acc[k] += term
        n += 1
    if n != len(w):
        raise ValueError(f"weighted_mean: {n} trees for {len(w)} weights")
    return {k: v.to(dtypes[k]) for k, v in acc.items()}


def stacked_weighted_mean(stacked: StateDict, weights: torch.Tensor) -> StateDict:
    """``tree_weighted_mean``: the weighted mean over a leading client axis
    present on every leaf (``[C, ...]`` leaves, ``[C]`` weights). Weights
    are normalised in f32, leaves summed in f32 and cast back to their dtype;
    BN statistics are averaged like any other leaf."""
    w = weights.float()
    w = w / torch.clamp(w.sum(), min=1e-12)
    return {
        k: torch.sum(v.float() * w.reshape((-1,) + (1,) * (v.dim() - 1)), dim=0).to(v.dtype)
        for k, v in stacked.items()
    }


def stack(trees: Iterable[StateDict]) -> StateDict:
    """Stack identically keyed state dicts along a new leading axis."""
    trees = list(trees)
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def unstack(stacked: StateDict, n: int) -> list[StateDict]:
    """The ``n`` per-client views of a stacked state dict (no copies)."""
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]
