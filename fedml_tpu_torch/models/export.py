"""Model-transfer formats, the port of ``fedml_tpu/models/export.py:44-116``:
the aligned flat weight list and the reference's ``is_mobile`` nested-list
wire dict (fedavg/utils.py:7-16).

Both work on the JAX layout, a nested dict of arrays (``convert.to_flax``
of a state dict, or what ``unpack_pytree`` gives), so a port peer and a JAX
peer exchange the same dicts: leaves go in the order of JAX's
``keystr``-sorted paths and are keyed by their ``/``-joined path. The JAX
package's ``export_stablehlo``/``load_stablehlo`` deployment artifacts have
no counterpart here yet (ROADMAP §A11).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

Pytree = Any


def _paths(tree: Pytree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs of a nested dict in JAX's flatten order (each
    dict's keys sorted)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += _paths(tree[k], prefix + (k,))
    return out


def _keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys: ``['a']['b']``."""
    return "".join(f"[{p!r}]" for p in path)


def _path_key(path: tuple) -> str:
    """'/'-joined tree path, the parameter-name key of the wire dict."""
    return "/".join(str(p) for p in path)


def _numpy(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _rebuild(paths: list[tuple], leaves: list) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return out


def params_to_flat_list(params: Pytree) -> list[np.ndarray]:
    """Deterministic (path-sorted) list of weight arrays, the mobile
    runtime's model format."""
    leaves = sorted(_paths(params), key=lambda kv: _keystr(kv[0]))
    return [_numpy(v) for _, v in leaves]


def flat_list_to_params(flat: list[np.ndarray], template: Pytree) -> Pytree:
    """Inverse of :func:`params_to_flat_list` given any same-structure
    template (shape-checked, like the reference's aligned-layer assert)."""
    paths = _paths(template)
    order = sorted(range(len(paths)), key=lambda i: _keystr(paths[i][0]))
    if len(flat) != len(paths):
        raise ValueError(
            f"model format is not aligned: {len(flat)} arrays vs {len(paths)} leaves"
        )
    leaves = [None] * len(paths)
    for slot, arr in zip(order, flat):
        want = tuple(paths[slot][1].shape)
        arr = np.asarray(arr)
        if arr.shape != want:
            arr = arr.reshape(want)  # reference reshapes on mismatch too
        leaves[slot] = arr
    return _rebuild([p for p, _ in paths], leaves)


def params_to_nested_lists(params: Pytree) -> dict[str, list]:
    """Reference ``transform_tensor_to_list``: dict keyed by parameter name,
    each value the ``.tolist()`` nesting of the array (nesting depth ==
    array ndim), in the path-sorted order of :func:`params_to_flat_list`,
    so ``json.dumps`` round-trips with ordering preserved."""
    leaves = sorted(_paths(params), key=lambda kv: _keystr(kv[0]))
    return {_path_key(p): _numpy(v).tolist() for p, v in leaves}


def nested_lists_to_params(obj: dict[str, list], template: Pytree) -> Pytree:
    """Reference ``transform_list_to_tensor``: rebuild parameters from the
    nested-list wire dict. Values are cast to float32 exactly as the
    reference's ``torch.from_numpy(np.asarray(v)).float()`` does, then to
    the template leaf's dtype."""
    paths = _paths(template)
    leaves = []
    for path, tmpl in paths:
        key = _path_key(path)
        if key not in obj:
            raise ValueError(f"wire dict is missing parameter {key!r}")
        arr = np.asarray(obj[key], dtype=np.float32)
        want = tuple(tmpl.shape)
        if arr.shape != want:
            raise ValueError(f"parameter {key!r} has shape {arr.shape}, expected {want}")
        leaves.append(arr.astype(_numpy(tmpl).dtype))
    return _rebuild([p for p, _ in paths], leaves)
