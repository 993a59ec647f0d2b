"""Compression-aware aggregation on the sim engine, the port of
``compressed_aggregator`` (``fedml_tpu/compress/aggregate.py:38-118``).

:func:`compressed_aggregator` wraps any broadcast-mode server rule (FedAvg,
FedProx, FedOpt, FedNova, robust, hierarchical) so each client's delta is
encoded (with optional error feedback), decoded, and the inner rule gets the
*reconstructed* client models: compression is a pure transform on the
client axis, and the per-round bytes-on-wire metrics ride the ordinary
agg-metrics channel into the metrics stream. The message-passing server's
host-side folds of an encoded upload into its f64 tally follow
(:func:`accumulate_encoded`, and :func:`prepare_encoded` with
:func:`fold_encoded_slice` for the sharded fold plane, the port of
``fedml_tpu/compress/aggregate.py:121-235``), and the tree tiers' partial
codecs (:func:`encode_partial`, :func:`decode_partial`, ``:232-277``).

The port's engine streams the cohort's models to a rule that does not ask
for the stack (the scan mode trains one client at a time), and so does the
wrapper: each client is encoded as it comes and its residual row updated,
so no ``[C, ...]`` stack of client models is built unless the inner rule
asks for one (``Aggregator.stacked``). A client's encoding is the same
arithmetic on every path: given the same client models, the vmap, scan,
block and packed rounds encode them bitwise alike.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.algorithms.base import Aggregator, fedavg_aggregator
from fedml_tpu_torch.compress import error_feedback as ef
from fedml_tpu_torch.compress.codec import Codec, EncodedUpdate, tree_bytes
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.obs import metrics as metricslib
from fedml_tpu_torch.obs import trace


def compressed_aggregator(codec: Codec, inner: Aggregator | None = None,
                          error_feedback: bool = True,
                          num_slots: int | None = None) -> Aggregator:
    """Wrap ``inner`` so client updates pass through ``codec`` (+EF) first.

    ``num_slots`` is the cohort size the engine stages; the EF residual stack
    is ``[num_slots, ...]`` and is matched to clients by slot, which is
    identity exactly when the cohort is the full population (the engine
    enforces that precondition). The codec's uniforms come from the round's
    ``rng`` (:class:`~fedml_tpu_torch.core.rng.RoundNoise`), client by client
    in cohort order, leaf by leaf."""
    inner = inner or fedavg_aggregator()
    if getattr(inner, "per_client", False):
        raise NotImplementedError(
            "update compression wraps broadcast-mode aggregators; per-client "
            f"rules ({inner.name}) keep models resident and have no uplink "
            "delta to compress"
        )
    if error_feedback and num_slots is None:
        raise ValueError("error_feedback=True needs num_slots (padded cohort)")

    def init_state(global_variables):
        res = ()
        if error_feedback:
            res = {k: torch.zeros((num_slots,) + v.shape, dtype=v.dtype, device=v.device)
                   for k, v in global_variables.items()}
        return {"inner": inner.init_state(global_variables), "residual": res}

    def aggregate(global_variables, clients, weights, state, rng=None, extras=None):
        residual = ({k: r.clone() for k, r in state["residual"].items()}
                    if error_feedback else ())
        encoded_bytes: list[int] = []

        def reconstructed():
            for c, local in enumerate(clients):
                delta = {k: s - global_variables[k].to(s.dtype) for k, s in local.items()}
                comp = ef.compensate(delta, {k: r[c] for k, r in residual.items()}
                                     if error_feedback else None)
                enc, dec, new_res = ef.encode_with_feedback(codec, comp, rng)
                if error_feedback:
                    for k, r in residual.items():
                        r[c].copy_(new_res[k])
                encoded_bytes.append(enc.nbytes)
                yield {k: (g + dec[k].to(g.dtype)).to(g.dtype)
                       for k, g in global_variables.items()}

        models = reconstructed()
        if inner.stacked:
            models = treelib.stack(models)
        new_global, inner_state, inner_metrics = inner.aggregate(
            global_variables, models, weights, state["inner"], rng, extras)
        # byte accounting is static (shapes and dtypes only); only the
        # non-padding cohort (weight > 0) actually crosses the wire
        per_client = float(encoded_bytes[0])
        dense = float(tree_bytes(global_variables))
        real = torch.sum((weights > 0).float())
        metrics = {
            metricslib.COMM_UPLINK_BYTES: real * per_client,
            metricslib.COMM_UPLINK_DENSE_BYTES: real * dense,
            metricslib.COMM_DOWNLINK_BYTES: real * dense,
            metricslib.COMM_DOWNLINK_DENSE_BYTES: real * dense,
            metricslib.COMM_RATIO: torch.full((), dense / per_client, dtype=torch.float32,
                                              device=weights.device),
        }
        new_state = {"inner": inner_state, "residual": residual}
        return new_global, new_state, {**inner_metrics, **metrics}

    return Aggregator(init_state, aggregate, name=f"compressed[{codec.name}]>{inner.name}")


# ---------------------------------------------------------------------------
# Host-side streaming accumulation for the message-passing server
# ---------------------------------------------------------------------------


def _flat_leaves(plane) -> list[np.ndarray]:
    """A plane's leaves (a state dict in JAX path order, as the wire client
    encodes the JAX layout) as flat host numpy, bfloat16 widened to f32
    (exact)."""
    out = []
    for t in plane.values():
        t = t.detach().cpu().reshape(-1)
        out.append((t.float() if t.dtype == torch.bfloat16 else t).numpy())
    return out


def accumulate_encoded(acc: np.ndarray, enc: EncodedUpdate, weight: float,
                       codec: Codec) -> None:
    """``acc += weight * decode(enc)`` into a flat f64 accumulator laid out in
    the ``pack_pytree`` wire order. Plain top-k updates scatter-add straight
    from their index/value planes (no dense copy per client); other schemes
    decode one client at a time."""
    with trace.span("compress/accumulate", scheme=enc.scheme):
        if enc.scheme == "topk" and not isinstance(enc.planes.get("values"), EncodedUpdate):
            vals = _flat_leaves(enc.planes["values"])
            idxs = _flat_leaves(enc.planes["indices"])
            off = 0
            for v, idx, spec in zip(vals, idxs, enc.meta_dict()["leaves"]):
                n = int(np.prod(spec["shape"])) if spec["shape"] else 1
                np.add.at(acc, off + idx.astype(np.int64), weight * v.astype(np.float64))
                off += n
            return
        with trace.span("compress/decode", scheme=enc.scheme):
            dense = _flat_leaves(codec.decode(enc))
        off = 0
        for leaf in dense:
            acc[off : off + leaf.size] += weight * leaf.astype(np.float64)
            off += leaf.size


def prepare_encoded(enc: EncodedUpdate, weight: float, codec: Codec):
    """One-shot per-upload prep for chunk-partitioned folding: the decode
    (or top-k's global index sort) of :func:`accumulate_encoded`, so
    :func:`fold_encoded_slice` can apply any ``[lo, hi)`` slice with the
    serial fold's arithmetic."""
    with trace.span("compress/accumulate", scheme=enc.scheme):
        if enc.scheme == "topk" and not isinstance(enc.planes.get("values"), EncodedUpdate):
            vals = _flat_leaves(enc.planes["values"])
            idxs = _flat_leaves(enc.planes["indices"])
            gidx_parts, contrib_parts = [], []
            off = 0
            for v, idx, spec in zip(vals, idxs, enc.meta_dict()["leaves"]):
                n = int(np.prod(spec["shape"])) if spec["shape"] else 1
                gidx_parts.append(off + idx.astype(np.int64))
                contrib_parts.append(weight * v.astype(np.float64))
                off += n
            gidx = np.concatenate(gidx_parts) if gidx_parts else np.zeros(0, np.int64)
            contrib = (np.concatenate(contrib_parts) if contrib_parts
                       else np.zeros(0, np.float64))
            order = np.argsort(gidx, kind="stable")
            return ("topk", gidx[order], contrib[order])
        with trace.span("compress/decode", scheme=enc.scheme):
            dense = _flat_leaves(codec.decode(enc))
        full = (np.concatenate([leaf.astype(np.float64) for leaf in dense])
                if dense else np.zeros(0, np.float64))
        return ("dense", float(weight), full)


def fold_encoded_slice(acc: np.ndarray, prep, lo: int, hi: int) -> None:
    """Apply the ``[lo, hi)`` slice of a prepared upload to ``acc``: top-k
    through a bincount over the chunk's index partition (each element gets
    at most one contribution, so the sums are the serial ``np.add.at``'s),
    dense schemes with the serial per-element expression."""
    kind = prep[0]
    if kind == "topk":
        _, sidx, scontrib = prep
        a, b = np.searchsorted(sidx, (lo, hi))
        if a == b:
            return
        acc[lo:hi] += np.bincount(sidx[a:b] - lo, weights=scontrib[a:b], minlength=hi - lo)
    else:
        _, weight, full = prep
        acc[lo:hi] += weight * full[lo:hi]


# ---------------------------------------------------------------------------
# Tier partials through the codec plane (async_agg/tree.py encoded uplinks)
# ---------------------------------------------------------------------------


def encode_partial(acc64: np.ndarray, weight_sum: float, base64: np.ndarray | None,
                   codec: Codec, rng) -> EncodedUpdate:
    """Encode an edge tier's raw partial (the f64 accumulator ``sum_i w_i
    x_i``) for the tier-to-tier uplink, on the host.

    Delta-domain codecs ship ``acc - weight_sum * base`` as f32 (the parent
    holds the same round global, so the weighted base mass is
    reconstructable and only the update mass pays for quantization). The
    ``none`` codec ships the f64 accumulator itself, a pure passthrough, so
    a none-coded partial is bitwise the raw-f64 wire payload. ``rng`` serves
    the quantizer's uniforms (``rng.uniform(shape)``)."""
    if codec.delta_domain:
        if base64 is None:
            raise ValueError(
                f"delta-domain tier codec {codec.name!r} needs the round "
                "global as its base (dense downlink only)"
            )
        tree = {"acc": torch.from_numpy(
            (acc64 - float(weight_sum) * base64).astype(np.float32))}
    else:
        tree = {"acc": torch.from_numpy(np.ascontiguousarray(acc64))}
    with trace.span("compress/encode", scheme=codec.name, partial=True):
        return codec.encode(tree, rng)


def decode_partial(enc: EncodedUpdate, weight_sum: float, base64: np.ndarray | None,
                   codec: Codec) -> np.ndarray:
    """Inverse of :func:`encode_partial`: recover the f64 accumulator a
    parent tier folds. The ``none`` path is a dtype-preserving view: no
    cast touches the bits."""
    with trace.span("compress/decode", scheme=enc.scheme, partial=True):
        leaves = _flat_leaves(codec.decode(enc))
    arr = (np.asarray(leaves[0], np.float64) if len(leaves) == 1
           else np.concatenate([leaf.astype(np.float64) for leaf in leaves]))
    if codec.delta_domain:
        if base64 is None:
            raise ValueError(
                f"delta-domain tier codec {codec.name!r} needs the round "
                "global to reconstruct the partial"
            )
        arr = arr + float(weight_sum) * base64
    return arr
