"""Update-compression codecs, the port of ``fedml_tpu/compress/codec.py``.

Cross-device FL is uplink-bound: the reference ships every client update as
dense float32 state_dicts, so bandwidth, not compute, caps cohort size.
Konečný et al. 2016 and QSGD (Alistarh et al. 2017) show sketched /
quantized updates with error feedback preserve convergence while cutting
uplink bytes 10-100x. This module is the codec layer of that subsystem:

- :class:`EncodedUpdate`: named *planes* (state dicts of tensors, e.g.
  ``values``/``indices``/``scale``, or a nested :class:`EncodedUpdate` in a
  chain's ``values``) plus static JSON metadata. Byte accounting is derived
  from plane shapes and dtypes.
- :class:`Codec` implementations, pure functions over state dicts (name ->
  tensor) that run where their input lies: :class:`NoneCodec` (identity),
  :class:`Bf16Codec` (cast), :class:`TopKCodec` (per-leaf magnitude top-k;
  int32 index + bf16 value planes), :class:`QuantizeCodec` (QSGD-style
  stochastic uniform quantization, 8/4 bit) and :class:`ChainCodec` (stage
  composition, e.g. top-k then 4-bit).
- :func:`make_codec`: the config-string registry behind ``--compressor``.

Delta-domain contract: every codec except ``none`` encodes the *model delta*
(local minus global), which error feedback (``error_feedback.py``)
compensates; ``none`` encodes the model itself (``delta_domain``).

Where the port departs from the JAX package:

- leaves are visited in the state dict's order (the module's), not JAX's
  sorted traversal, and a leaf has the torch layout (a ``Linear`` weight is
  the flax kernel transposed), so the index planes and the q4 nibble pairs
  of one model differ between the packages; on the same flat arrays in the
  same order the planes are bitwise equal, and the byte counts match on
  any model;
- top-k breaks an exact tie of magnitudes as ``jax.lax.top_k`` does, the
  lower index first (a stable sort on the magnitudes, descending);
- the quantizer's uniforms come from ``rng.uniform(shape)``, one call per
  leaf in leaf order (the engine passes the round's
  :class:`~fedml_tpu_torch.core.rng.RoundNoise`); JAX's keys cannot be
  reproduced, so the two packages draw other uniforms.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Sequence

import torch

StateDict = dict[str, torch.Tensor]


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (numpy's names, as JAX writes
    them)."""
    return str(dtype).removeprefix("torch.")


def _leaves(tree: Any):
    """The tensors of a plane tree: dicts in their order, an
    :class:`EncodedUpdate`'s planes by sorted name (JAX's flatten)."""
    if isinstance(tree, EncodedUpdate):
        for name in sorted(tree.planes):
            yield from _leaves(tree.planes[name])
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_bytes(tree: Any) -> int:
    """Total bytes of all tensor leaves (shape and dtype only)."""
    return sum(leaf.numel() * leaf.element_size() for leaf in _leaves(tree))


def tree_spec(tree: StateDict) -> list[dict]:
    """Per-leaf (shape, dtype) spec in the state dict's order: the static
    decode metadata every codec stores in ``EncodedUpdate.meta``."""
    return [{"shape": list(leaf.shape), "dtype": _dtype_name(leaf.dtype)}
            for leaf in tree.values()]


@dataclasses.dataclass
class EncodedUpdate:
    """A compressed update: named planes (state dicts of tensors, or a nested
    update) + static meta. ``meta`` is a JSON string; ``scheme`` names the
    codec that can decode it."""

    scheme: str
    planes: dict[str, Any]
    meta: str = "{}"

    @property
    def nbytes(self) -> int:
        """Encoded payload bytes (what actually crosses the wire)."""
        return tree_bytes(self.planes)

    def meta_dict(self) -> dict:
        return json.loads(self.meta)


def _leaf_meta(tree: StateDict) -> str:
    return json.dumps({"leaves": tree_spec(tree)})


def _rebuild(names, leaves_flat, meta: dict) -> StateDict:
    return {name: leaf.reshape(spec["shape"]).to(getattr(torch, spec["dtype"]))
            for name, leaf, spec in zip(names, leaves_flat, meta["leaves"])}


def _numel(spec: dict) -> int:
    return int(math.prod(spec["shape"])) if spec["shape"] else 1


class Codec:
    """Encode/decode contract. ``encode(tree, rng) -> EncodedUpdate`` and
    ``decode(enc) -> tree`` are pure and inverse up to the codec's
    information loss; both run on the device of their input. ``rng`` serves
    uniforms through ``rng.uniform(shape)`` (only the quantizer draws).
    ``delta_domain`` says whether the wire payload is a model delta
    (compensatable by error feedback) or the model itself (only
    ``none``)."""

    name = "codec"
    delta_domain = True

    def encode(self, tree: StateDict, rng) -> EncodedUpdate:
        raise NotImplementedError

    def decode(self, enc: EncodedUpdate) -> StateDict:
        raise NotImplementedError

    def dense_bytes(self, tree: StateDict) -> int:
        return tree_bytes(tree)

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"


class NoneCodec(Codec):
    """Identity codec: dense planes, bit-exact round trip."""

    name = "none"
    delta_domain = False

    def encode(self, tree, rng):
        return EncodedUpdate("none", {"values": tree}, _leaf_meta(tree))

    def decode(self, enc):
        return enc.planes["values"]


class Bf16Codec(Codec):
    """Cast values to bfloat16 (half the bytes; ~3 decimal digits kept)."""

    name = "bf16"

    def encode(self, tree, rng):
        vals = {k: v.to(torch.bfloat16) for k, v in tree.items()}
        return EncodedUpdate("bf16", {"values": vals}, _leaf_meta(tree))

    def decode(self, enc):
        vals = enc.planes["values"]
        return _rebuild(vals, vals.values(), enc.meta_dict())


def top_k_indices(magnitudes: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest entries of a 1-D tensor, largest
    first, an exact tie the lower index first (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none): a stable descending sort."""
    return torch.sort(magnitudes, descending=True, stable=True).indices[:k]


class TopKCodec(Codec):
    """Per-leaf magnitude top-k sparsification (Konečný et al. sketched
    updates): keep ``ceil(frac * n)`` entries of each flattened leaf as an
    int32 index plane + a value plane (bf16 by default: 6 bytes per kept
    entry vs 4 bytes per dense entry, so the ratio is ~ 1.5 * frac)."""

    def __init__(self, frac: float = 0.01, value_dtype=torch.bfloat16):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk frac must be in (0, 1], got {frac}")
        self.frac = float(frac)
        self.value_dtype = value_dtype
        self.name = f"topk{self.frac:g}"

    def _k(self, n: int) -> int:
        return max(1, int(math.ceil(self.frac * n)))

    def encode(self, tree, rng):
        vals, idxs = {}, {}
        for name, leaf in tree.items():
            flat = leaf.reshape(-1).float()
            idx = top_k_indices(torch.abs(flat), self._k(flat.numel()))
            vals[name] = flat[idx].to(self.value_dtype)
            idxs[name] = idx.to(torch.int32)
        return EncodedUpdate("topk", {"values": vals, "indices": idxs}, _leaf_meta(tree))

    def decode(self, enc):
        meta = enc.meta_dict()
        vals, idxs = enc.planes["values"], enc.planes["indices"]
        out = []
        for v, idx, spec in zip(vals.values(), idxs.values(), meta["leaves"]):
            dense = torch.zeros(_numel(spec), dtype=torch.float32, device=v.device)
            dense[idx.long()] = v.float()
            out.append(dense)
        return _rebuild(vals, out, meta)


class QuantizeCodec(Codec):
    """QSGD-style stochastic uniform quantization (Alistarh et al. 2017):
    per leaf, scale by max|x| onto ``s = 2^(bits-1) - 1`` symmetric integer
    levels with stochastic rounding (unbiased: E[decode(encode(x))] = x).
    8-bit stores int8 planes; 4-bit packs two two's-complement nibbles per
    byte, the even index in the low nibble, so the value plane is n/2
    bytes."""

    def __init__(self, bits: int = 8):
        if bits not in (4, 8):
            raise ValueError(f"quantize bits must be 4 or 8, got {bits}")
        self.bits = bits
        self.levels = 2 ** (bits - 1) - 1
        self.name = f"q{bits}"

    def encode(self, tree, rng):
        if rng is None:
            raise ValueError(f"{self.name} rounds stochastically: encode needs an rng "
                             "with .uniform(shape) (the round's RoundNoise)")
        qs, scales = {}, {}
        for name, leaf in tree.items():
            flat = leaf.reshape(-1).float()
            scale = (torch.max(torch.abs(flat)) if flat.numel()
                     else torch.zeros((), dtype=torch.float32, device=flat.device))
            safe = torch.where(scale > 0, scale, 1.0)
            y = flat / safe * self.levels
            low = torch.floor(y)
            q = low + (rng.uniform(flat.shape) < (y - low)).float()
            q = torch.clamp(q, -self.levels, self.levels).to(torch.int8)
            qs[name] = self._pack(q)
            scales[name] = scale.float()
        return EncodedUpdate(f"q{self.bits}", {"values": qs, "scale": scales},
                             _leaf_meta(tree))

    def _pack(self, q: torch.Tensor) -> torch.Tensor:
        if self.bits == 8:
            return q
        if q.numel() % 2:
            q = torch.cat([q, q.new_zeros(1)])
        nib = q.to(torch.int32) & 0xF
        return (nib[0::2] | (nib[1::2] << 4)).to(torch.uint8)

    def _unpack(self, packed: torch.Tensor, n: int) -> torch.Tensor:
        if self.bits == 8:
            return packed.float()
        p = packed.to(torch.int32)
        nib = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(-1)[:n]
        return torch.where(nib >= 8, nib - 16, nib).float()

    def decode(self, enc):
        # q / levels * scale, the division by a tensor on q's device: CUDA
        # divides by a Python number as a product with its reciprocal,
        # which rounds otherwise than the CPU's (and JAX's op-by-op) IEEE
        # quotient
        meta = enc.meta_dict()
        vals, scales = enc.planes["values"], enc.planes["scale"]
        out = [self._unpack(v, _numel(spec)) / torch.full_like(scale, self.levels) * scale
               for v, scale, spec in zip(vals.values(), scales.values(), meta["leaves"])]
        return _rebuild(vals, out, meta)


class ChainCodec(Codec):
    """Stage composition: each later stage re-encodes the previous stage's
    ``values`` plane (itself a state dict), e.g. ``topk+q4`` sparsifies then
    quantizes the kept values. The nested stage rides inside the outer
    EncodedUpdate's ``values``; every stage draws from the same ``rng`` in
    turn."""

    def __init__(self, stages: Sequence[Codec]):
        if len(stages) < 2:
            raise ValueError("ChainCodec needs at least two stages")
        if any(not s.delta_domain for s in stages):
            raise ValueError("'none' cannot be a chain stage")
        self.stages = list(stages)
        self.name = "+".join(s.name for s in stages)

    def encode(self, tree, rng):
        encs, cur = [], tree
        for stage in self.stages:
            e = stage.encode(cur, rng)
            encs.append(e)
            cur = e.planes["values"]
        nested = encs[-1]
        for e in reversed(encs[:-1]):
            nested = EncodedUpdate(e.scheme, {**e.planes, "values": nested}, e.meta)
        return nested

    def decode(self, enc):
        # unfold the nesting outermost -> innermost (one level per stage)
        layers, e = [], enc
        while isinstance(e.planes.get("values"), EncodedUpdate):
            layers.append(e)
            e = e.planes["values"]
        layers.append(e)
        if len(layers) != len(self.stages):
            raise ValueError(
                f"chain {self.name} has {len(self.stages)} stages but the "
                f"encoded update nests {len(layers)}"
            )
        values = None
        for layer, stage in zip(reversed(layers), reversed(self.stages)):
            if values is not None:
                layer = EncodedUpdate(layer.scheme, {**layer.planes, "values": values},
                                      layer.meta)
            values = stage.decode(layer)
        return values


_BASE = ("none", "bf16", "topk", "q4", "q8", "quantize", "qsgd")


def make_codec(spec: str, topk_frac: float = 0.01, quantize_bits: int = 8) -> Codec:
    """Build a codec from a ``--compressor`` config string.

    Base names: ``none``, ``bf16``, ``topk`` (uses ``topk_frac``),
    ``q8``/``q4``, ``quantize``/``qsgd`` (use ``quantize_bits``). Stages
    compose with ``+`` (applied left to right): ``topk+q4`` sparsifies then
    4-bit-quantizes the kept values. In a chain, ``topk`` keeps f32 values so
    the downstream stage sees full precision.
    """
    parts = [p.strip() for p in spec.split("+") if p.strip()]
    if not parts:
        raise ValueError(f"empty compressor spec {spec!r}")
    unknown = [p for p in parts if p not in _BASE]
    if unknown:
        raise ValueError(
            f"unknown compressor {unknown} in {spec!r}; expected names from "
            f"{_BASE} composed with '+'"
        )

    def base(name: str, in_chain: bool) -> Codec:
        if name == "none":
            return NoneCodec()
        if name == "bf16":
            return Bf16Codec()
        if name == "topk":
            return TopKCodec(topk_frac,
                             value_dtype=torch.float32 if in_chain else torch.bfloat16)
        if name in ("quantize", "qsgd"):
            return QuantizeCodec(quantize_bits)
        return QuantizeCodec(int(name[1:]))

    if len(parts) == 1:
        return base(parts[0], in_chain=False)
    if "none" in parts:
        raise ValueError("'none' cannot appear in a compressor chain")
    return ChainCodec([base(p, in_chain=(i < len(parts) - 1)) for i, p in enumerate(parts)])
