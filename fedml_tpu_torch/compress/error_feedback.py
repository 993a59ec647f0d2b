"""Error feedback for lossy update compression, the port of
``fedml_tpu/compress/error_feedback.py``.

A biased compressor (top-k, deterministic rounding) silently discards update
mass every round; error feedback (EF-SGD / 1-bit Adam lineage; Konečný et
al.'s sketched-update fix) keeps the discarded residual on the client and
adds it back into the *next* round's update before encoding, so the dropped
mass is delayed, never lost, the property that preserves convergence.

Semantics (pure functions of state dicts):

    compensated_r = delta_r + residual_{r-1}          (compensate)
    wire_r        = encode(compensated_r)
    residual_r    = compensated_r - decode(wire_r)    (residual)

On the sim path the state lives in the compressed aggregator's state, a
stacked ``[C, ...]`` residual per cohort slot (``compress/aggregate.py``).
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.core import tree as treelib

StateDict = dict[str, torch.Tensor]


def init(like: StateDict) -> StateDict:
    """Zero residual shaped like one client's update."""
    return {k: torch.zeros_like(v) for k, v in like.items()}


def compensate(delta: StateDict, residual: StateDict | None) -> StateDict:
    """Add the carried residual into this round's update before encoding."""
    if residual is None:
        return delta
    return treelib.add(delta, residual)


def residual(compensated: StateDict, decoded: StateDict) -> StateDict:
    """What the codec dropped this round, carried to the next round."""
    return {k: c - decoded[k].to(c.dtype) for k, c in compensated.items()}


def encode_with_feedback(codec, compensated: StateDict, rng):
    """One EF step after compensation: returns ``(encoded, decoded,
    new_residual)``. Factored so the trainer path and the sim aggregator run
    the identical encode/residual arithmetic."""
    enc = codec.encode(compensated, rng)
    dec = codec.decode(enc)
    return enc, dec, residual(compensated, dec)
