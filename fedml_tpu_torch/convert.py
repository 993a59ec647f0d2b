"""Weights between the JAX package and the port.

:func:`from_flax` turns the JAX package's variables of a TransformerLM, a
ResNet (CIFAR or ResNet-18, BatchNorm or GroupNorm), MobileNet V1 or V3,
VGG, EfficientNet, a LogisticRegression, one of the CNNs, one of the RNNs,
UNet, DeepLabLite or the DARTS search network (nested dicts of numpy arrays: ``{"params":
...}``, with ``"batch_stats"`` beside it for a BatchNorm network, for DARTS
``"batch_stats"`` and ``"arch"``, or a bare params tree) into the port's
flat ``state_dict``;
:func:`to_flax` is its inverse. Names map one path component at a time:

- TransformerLM: ``block_3`` <-> ``blocks.3``, ``LayerNorm_0`` <-> ``ln_0``,
  ``MultiHeadSelfAttention_0`` <-> ``attn``, a block's ``Dense_0`` <->
  ``fc_0``;
- ResNet: ``BasicBlock_3`` <-> ``blocks.3``, ``Conv_0`` <-> ``conv_0``,
  ``BatchNorm_0`` <-> ``bn_0``, ``GroupNorm_0`` <-> ``gn_0``, the top-level
  ``Dense_0`` <-> ``head``;
- MobileNet, MobileNet V3, VGG and EfficientNet: ``DepthwiseSeparable_3``
  <-> ``separables.3``, ``InvertedResidual_3`` <-> ``inverted.3``,
  ``MBConv_3`` <-> ``mbconvs.3``, ``SqueezeExcite_0`` <-> ``se`` (V3's two
  Dense layers in it are ``fc_0``/``fc_1``, EfficientNet's biased convs
  ``conv_0``/``conv_1``), ``Conv_i``/``BatchNorm_i``/``GroupNorm_i`` as in
  the ResNet, the top-level ``Dense_i`` <-> ``dense_i``;
- LogisticRegression and the CNNs: ``Conv_i`` <-> ``conv_i``, the
  top-level ``Dense_i`` <-> ``dense_i``;
- UNet and DeepLabLite: ``ConvBlock_3`` <-> ``convblocks.3`` (its
  ``Conv_j``/``GroupNorm_j`` as in the ResNet), ``ASPP_0`` <-> ``aspp``
  (its ``ConvBlock_k``, ``Conv_0``, ``Conv_1`` the same way), the
  top-level biased ``Conv_i`` <-> ``conv_i``;
- the DARTS search network: ``Cell_3`` <-> ``cells.3``, ``MixedOp_5`` <->
  ``edges.5``, ``_Op_2`` <-> ``ops.2``, ``Conv_i``/``BatchNorm_i`` as in the
  ResNet, the top-level ``Dense_0`` <-> ``dense_0``, and the ``arch``
  collection's ``alphas_normal`` and ``alphas_reduce`` keep their names;
- the RNNs: ``Embed_0/embedding`` <-> ``embed.weight``, the top-level
  ``Dense_i`` <-> ``dense_i``, and ``OptimizedLSTMCell_n`` <-> ``lstm_n``,
  whose eight per-gate Dense leaves become three stacked tensors: the
  kernels ``ii, if, ig, io`` (``[in, H]``, no bias) transposed and stacked in
  that order are ``weight_ih [4H, in]``, the kernels ``hi, hf, hg, ho``
  (``[H, H]``) ``weight_hh [4H, H]`` and their biases ``bias_hh [4H]``.

The GAN's pair ``{"generator": ..., "discriminator": ...}`` (each a
network's own variables, flax's ``Dense_i`` and ``BatchNorm_i``) is the
port's flat state dict of both, ``generator.<name>`` and
``discriminator.<name>``. The FedGKT server (no stem of its own) is a
ResNet too: :func:`is_resnet` reads it off its blocks' convolutions.

Either direction takes part of a model as well (a backbone without its head,
the parameters without the BatchNorm statistics): ``resnet`` says which
family's names to use where the part alone does not tell (a ResNet's head
is flax's top-level ``Dense_0``), :func:`is_resnet` reads it off the whole
model's state dict.

Leaves: a Dense kernel ``[in, out]`` is the transpose of the port's weight
(``qkv`` stays one ``[3D, D]`` weight, so the q|k|v split of its output is
the same); a Conv kernel HWIO is the port's OIHW weight (a depthwise
kernel ``[k, k, 1, C]`` is ``[C, 1, k, k]``); LayerNorm, BatchNorm and
GroupNorm ``scale`` is ``weight``; BatchNorm's ``batch_stats`` ``mean`` and
``var`` are the buffers ``running_mean`` and ``running_var``.
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
    "Embed_0": "embed",
    "SqueezeExcite_0": "se",
    "ASPP_0": "aspp",
}
_INVERSE = {v: k for k, v in _COMPONENTS.items()}
_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
           "mean": "running_mean", "var": "running_var"}
_STATS = {"running_mean": "mean", "running_var": "var"}
_ARCH = ("alphas_normal", "alphas_reduce")  # DARTS's "arch" collection
_LAYER_NORMS = ("ln_0", "ln_1", "ln_f")
_GATES = "ifgo"  # flax OptimizedLSTMCell's gate order


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# a flax component "<prefix>_<n>" is the port's "<list>.<n>"
_LISTS = {"Cell": "cells", "MixedOp": "edges", "_Op": "ops",
          "DepthwiseSeparable": "separables", "InvertedResidual": "inverted",
          "MBConv": "mbconvs", "ConvBlock": "convblocks"}
_NORMS = {"BatchNorm": "bn", "GroupNorm": "gn"}
_LIST_INVERSE = {v: k for k, v in _LISTS.items()}


def _port_names(comp: str, top_level: bool, resnet: bool) -> list[str]:
    """One flax path component as the port's name components."""
    m = re.fullmatch(r"(?:block|BasicBlock)_(\d+)", comp)
    if m:
        return ["blocks", m.group(1)]
    m = re.fullmatch(r"(\w+)_(\d+)", comp)
    if m and m.group(1) in _LISTS:
        return [_LISTS[m.group(1)], m.group(2)]
    m = re.fullmatch(r"(Conv|BatchNorm|GroupNorm)_(\d+)", comp)
    if m:
        return [f"{_NORMS.get(m.group(1), 'conv')}_{m.group(2)}"]
    m = re.fullmatch(r"Dense_(\d+)", comp)
    if m and top_level:
        return ["head"] if resnet else [f"dense_{m.group(1)}"]
    return [_COMPONENTS.get(comp, comp)]


def is_resnet(state_dict: dict) -> bool:
    """Whether a port state dict is a ResNet's: residual ``blocks`` beside a
    top-level ``bn_0`` or ``gn_0``, or blocks of convolutions (the FedGKT
    server's); a TransformerLM has blocks of neither, DARTS a BatchNorm and
    ``cells``, the other CIFAR models no ``blocks``."""
    return (any(k.startswith("blocks.") for k in state_dict)
            and any(k.startswith(("bn_0.", "gn_0.")) or re.match(r"blocks\.\d+\.conv_0\.", k)
                    for k in state_dict))


_PAIR = ("generator", "discriminator")  # the GAN's two networks


def from_flax(variables: dict, resnet: bool | None = None) -> dict[str, torch.Tensor]:
    """JAX TransformerLM, CifarResNet, LogisticRegression, CNN, RNN or DARTS
    variables, whole or in part -> the port's state dict (CPU tensors in the
    leaves' own dtype). ``resnet`` None: a ResNet when the parameters hold
    a ``BasicBlock``."""
    if set(variables) == set(_PAIR):
        return {f"{net}.{k}": v for net in _PAIR
                for k, v in from_flax(variables[net], resnet=False).items()}
    collections = (variables if "params" in variables or "batch_stats" in variables
                   else {"params": variables})
    if resnet is None:
        resnet = any(k.startswith("BasicBlock_") for k in collections.get("params", {}))
    sd = {}
    for tree in collections.values():
        tree = dict(tree)
        for comp in [c for c in tree if re.fullmatch(r"OptimizedLSTMCell_\d+", c)]:
            sd.update(_lstm_from_flax(f"lstm_{comp.rsplit('_', 1)[1]}", tree.pop(comp)))
        for path, leaf in _flatten(tree).items():
            arr = np.asarray(leaf)
            names = []
            for i, comp in enumerate(path[:-1]):
                names += _port_names(comp, top_level=i == 0, resnet=resnet)
            last = path[-1]
            if last == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            names.append(_LEAVES.get(last, last))
            sd[".".join(names)] = torch.tensor(np.ascontiguousarray(arr))
    return sd


def _lstm_from_flax(name: str, cell: dict) -> dict[str, torch.Tensor]:
    """One ``OptimizedLSTMCell``'s per-gate leaves -> ``lstm_n``'s three
    stacked tensors."""
    def stacked(prefix, leaf):
        arrs = [np.asarray(cell[prefix + g][leaf]) for g in _GATES]
        return torch.tensor(np.concatenate([a.T if a.ndim == 2 else a for a in arrs]))

    return {f"{name}.weight_ih": stacked("i", "kernel"),
            f"{name}.weight_hh": stacked("h", "kernel"),
            f"{name}.bias_hh": stacked("h", "bias")}


def _lstm_to_flax(leaf_name: str, t: torch.Tensor) -> dict:
    """One of ``lstm_n``'s stacked tensors -> its per-gate flax leaves
    (tensors on ``t``'s device)."""
    prefix, leaf = {"weight_ih": ("i", "kernel"), "weight_hh": ("h", "kernel"),
                    "bias_hh": ("h", "bias")}[leaf_name]
    return {prefix + g: {leaf: (a.t() if a.ndim == 2 else a).contiguous()}
            for g, a in zip(_GATES, torch.chunk(t.detach(), 4))}


def to_flax_tensors(state_dict: dict[str, torch.Tensor], resnet: bool | None = None) -> dict:
    """:func:`to_flax` with the leaves kept as contiguous torch tensors on
    their own device: the JAX layout (flax's names and nesting, HWIO and
    ``[in, out]`` kernels) without a trip to the host, which the wire
    client encodes a compressed update in."""
    nets = {k.split(".", 1)[0] for k in state_dict}
    if nets and nets <= set(_PAIR):
        return {net: to_flax_tensors({k[len(net) + 1:]: v for k, v in state_dict.items()
                                      if k.startswith(net + ".")}, resnet=False)
                for net in sorted(nets)}
    if resnet is None:
        resnet = is_resnet(state_dict)
    out: dict = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        m = re.fullmatch(r"lstm_(\d+)", parts[0])
        if m:
            cell = out.setdefault("params", {}).setdefault(f"OptimizedLSTMCell_{m.group(1)}", {})
            for gate, leaves in _lstm_to_flax(parts[1], t).items():
                cell.setdefault(gate, {}).update(leaves)
            continue
        arr = t.detach()
        path = []
        i = 0
        while i < len(parts) - 1:
            comp = parts[i]
            if comp == "blocks":
                path.append(f"{'BasicBlock' if resnet else 'block'}_{parts[i + 1]}")
                i += 2
                continue
            if comp in _LIST_INVERSE:
                path.append(f"{_LIST_INVERSE[comp]}_{parts[i + 1]}")
                i += 2
                continue
            m = re.fullmatch(r"(conv|bn|gn|dense)_(\d+)", comp)
            if m:
                kind = {"conv": "Conv", "bn": "BatchNorm", "gn": "GroupNorm",
                        "dense": "Dense"}[m.group(1)]
                path.append(f"{kind}_{m.group(2)}")
            elif comp == "head" and resnet:
                path.append("Dense_0")
            else:
                path.append(_INVERSE.get(comp, comp))
            i += 1
        last = parts[-1]
        parent = parts[-2] if len(parts) > 1 else ""
        collection = "params"
        if last in _STATS:
            collection, last = "batch_stats", _STATS[last]
        elif last in _ARCH:
            collection = "arch"
        elif last == "weight":
            if parent in _LAYER_NORMS or parent.startswith(("bn_", "gn_")):
                last = "scale"
            elif parent in ("tok_embed", "embed"):
                last = "embedding"
            else:
                last, arr = "kernel", arr.permute(*((2, 3, 1, 0) if arr.ndim == 4
                                                    else reversed(range(arr.ndim))))
        path.append(last)
        node = out.setdefault(collection, {})
        for comp in path[:-1]:
            node = node.setdefault(comp, {})
        node[path[-1]] = arr.contiguous()
    return out


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.ascontiguousarray(tree.cpu().numpy())


def to_flax(state_dict: dict[str, torch.Tensor], resnet: bool | None = None) -> dict:
    """The port's state dict, whole or in part -> ``{"params": ...}`` (and
    ``"batch_stats"`` for a ResNet, ``"batch_stats"`` and ``"arch"`` for
    DARTS) nested dicts of numpy arrays in the JAX package's layout; a
    collection the state dict has no leaf of is left out. ``resnet`` None:
    :func:`is_resnet`."""
    return _to_numpy(to_flax_tensors(state_dict, resnet))
