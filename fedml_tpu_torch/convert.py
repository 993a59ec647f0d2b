"""Weights between the JAX package and the port.

:func:`from_flax` turns the JAX package's TransformerLM variables (nested
dicts of numpy arrays, with or without the ``"params"`` collection) into the
port's flat ``state_dict``; :func:`to_flax` is its inverse. Names map one
path component at a time (``block_3`` <-> ``blocks.3``, ``LayerNorm_0`` <->
``ln_0``, ...). Flax ``Dense`` kernels are ``[in, out]`` and the port's
``Dense`` weights ``[out, in]``, so kernels are transposed; ``qkv`` stays one
``[3D, D]`` weight, so the q|k|v split of its output is the same.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

_COMPONENTS = {
    "LayerNorm_0": "ln_0",
    "LayerNorm_1": "ln_1",
    "MultiHeadSelfAttention_0": "attn",
    "Dense_0": "fc_0",
    "Dense_1": "fc_1",
}
_INVERSE = {v: k for k, v in _COMPONENTS.items()}
_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
_LAYER_NORMS = ("ln_0", "ln_1", "ln_f")


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """JAX TransformerLM variables -> the port's state dict (CPU tensors in
    the leaves' own dtype)."""
    params = variables.get("params", variables)
    sd = {}
    for path, leaf in _flatten(dict(params)).items():
        arr = np.asarray(leaf)
        names = []
        for comp in path[:-1]:
            m = re.fullmatch(r"block_(\d+)", comp)
            names += ["blocks", m.group(1)] if m else [_COMPONENTS.get(comp, comp)]
        last = path[-1]
        if last == "kernel":
            arr = arr.T
        names.append(_LEAVES.get(last, last))
        sd[".".join(names)] = torch.tensor(np.ascontiguousarray(arr))
    return sd


def to_flax(state_dict: dict[str, torch.Tensor]) -> dict:
    """The port's state dict -> ``{"params": ...}`` nested dicts of numpy
    arrays in the JAX package's layout."""
    params: dict = {}
    for name, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        parts = name.split(".")
        path = []
        i = 0
        while i < len(parts) - 1:
            if parts[i] == "blocks":
                path.append(f"block_{parts[i + 1]}")
                i += 2
            else:
                path.append(_INVERSE.get(parts[i], parts[i]))
                i += 1
        last = parts[-1]
        parent = parts[-2] if len(parts) > 1 else ""
        if last == "weight":
            if parent in _LAYER_NORMS:
                last = "scale"
            elif parent == "tok_embed":
                last = "embedding"
            else:
                last, arr = "kernel", arr.T
        path.append(last)
        node = params
        for comp in path[:-1]:
            node = node.setdefault(comp, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return {"params": params}
