"""Model-transfer formats, the port of ``fedml_tpu/models/export.py``: the
aligned flat weight list and the reference's ``is_mobile`` nested-list wire
dict (fedavg/utils.py:7-16), and the deployment artifact.

The two formats work on the JAX layout, a nested dict of arrays
(``convert.to_flax`` of a state dict, or what ``unpack_pytree`` gives), so a
port peer and a JAX peer exchange the same dicts: leaves go in the order of
JAX's ``keystr``-sorted paths and are keyed by their ``/``-joined path.

The artifact (:func:`export_program` / :func:`load_program`) stands in for
the JAX package's StableHLO one: a ``torch.export`` program saved with
``torch.export.save``. As in JAX the variables are an input of the exported
function (``fwd(variables, x)``): :class:`Functional` makes a module's
forward one.
"""

from __future__ import annotations

from pathlib import Path
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


# -- the deployment artifact ---------------------------------------------------


class Functional(torch.nn.Module):
    """``module`` with its variables as an input: ``forward(variables, x)``
    is ``torch.func.functional_call(module, variables, (x,), kwargs)``, the
    ``fwd(variables, x)`` that JAX's ``model.apply`` is."""

    def __init__(self, module: torch.nn.Module, **kwargs):
        super().__init__()
        self.module, self.kwargs = module, kwargs

    def forward(self, variables: dict, x):
        return torch.func.functional_call(self.module, variables, (x,), self.kwargs)


class _Call(torch.nn.Module):
    """A plain callable as a module, for ``torch.export``."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class LoadedProgram:
    """A loaded artifact; ``.call(*args)`` runs it, as JAX's ``Exported``."""

    def __init__(self, program):
        self.program = program
        self._module = program.module()

    def call(self, *args):
        return self._module(*args)


def export_program(fn, example_args: tuple, path: str | Path) -> bytes:
    """The counterpart of ``fedml_tpu.models.export.export_stablehlo``:
    ``torch.export.export`` of ``fn`` (a module, e.g. :class:`Functional`,
    or a callable) on ``example_args``, saved to ``path`` with
    ``torch.export.save``. Returns the artifact's bytes."""
    module = fn if isinstance(fn, torch.nn.Module) else _Call(fn)
    program = torch.export.export(module, tuple(example_args))
    torch.export.save(program, str(path))
    return Path(path).read_bytes()


def load_program(path: str | Path) -> LoadedProgram:
    """The counterpart of ``fedml_tpu.models.export.load_stablehlo``: the
    artifact at ``path`` (``torch.export.load``); ``.call(*args)`` runs
    it."""
    return LoadedProgram(torch.export.load(str(path)))
