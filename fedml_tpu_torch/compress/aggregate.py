"""Compression-aware aggregation on the sim engine, the port of
``compressed_aggregator`` (``fedml_tpu/compress/aggregate.py:38-118``).

:func:`compressed_aggregator` wraps any broadcast-mode server rule (FedAvg,
FedProx, FedOpt, FedNova, robust, hierarchical) so each client's delta is
encoded (with optional error feedback), decoded, and the inner rule gets the
*reconstructed* client models: compression is a pure transform on the
client axis, and the per-round bytes-on-wire metrics ride the ordinary
agg-metrics channel into the metrics stream. The wire path's host-side
helpers (``accumulate_encoded``, ``prepare_encoded``, ...) belong to the
message-passing backends (ROADMAP §A11).

The port's engine streams the cohort's models to a rule that does not ask
for the stack (the scan mode trains one client at a time), and so does the
wrapper: each client is encoded as it comes and its residual row updated,
so no ``[C, ...]`` stack of client models is built unless the inner rule
asks for one (``Aggregator.stacked``). A client's encoding is the same
arithmetic on every path: given the same client models, the vmap, scan,
block and packed rounds encode them bitwise alike.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.algorithms.base import Aggregator, fedavg_aggregator
from fedml_tpu_torch.compress import error_feedback as ef
from fedml_tpu_torch.compress.codec import Codec, tree_bytes
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.obs import metrics as metricslib


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
