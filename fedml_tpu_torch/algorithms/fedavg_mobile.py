"""`is_mobile` federated rounds, the port of
``fedml_tpu/algorithms/fedavg_mobile.py``: phone-side clients speak the
reference's nested-list JSON wire format.

Reference: fedml_api/distributed/fedavg/ — with ``args.is_mobile == 1`` the
server transforms every outgoing model through ``transform_tensor_to_list``
and every incoming one through ``transform_list_to_tensor``
(FedAvgServerManager.py:36,77; FedAVGAggregator.py:65). For ranks declared
mobile the model payload is a JSON string of
:func:`~fedml_tpu_torch.models.export.params_to_nested_lists` over the JAX
layout (float32 survives ``tolist()``/JSON bit-exactly), so it is the JAX
package's JSON for the same model; everything else about the protocol is
inherited from ``fedavg_distributed``.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms.fedavg_distributed import (
    FedAvgClientManager,
    FedAvgServerManager,
    MyMessage,
    StateDict,
    run_distributed_fedavg,
)
from fedml_tpu_torch.comm.message import Message, pack_pytree, unpack_pytree
from fedml_tpu_torch.models.export import nested_lists_to_params, params_to_nested_lists


def variables_to_wire(variables) -> str:
    """Reference ``transform_tensor_to_list`` over the full variables (a
    JAX-layout nested dict), as a JSON string (the mobile app's message
    body)."""
    return json.dumps(params_to_nested_lists(variables))


def wire_to_variables(payload: str, template):
    """Reference ``transform_list_to_tensor``: JSON wire dict back to a
    JAX-layout nested dict shaped like ``template``."""
    return nested_lists_to_params(json.loads(payload), template)


class MobileFedAvgServerManager(FedAvgServerManager):
    """FedAvg server that speaks nested-list JSON to its ``mobile_ranks``
    and the packed byte vector to everyone else."""

    def __init__(self, *args, mobile_ranks=(), **kwargs):
        super().__init__(*args, **kwargs)
        self.mobile_ranks = set(mobile_ranks)
        self._wire_cache: tuple[Any, str] | None = None

    def _current_variables(self):
        return unpack_pytree(np.asarray(self.global_flat), self.model_desc)

    def _model_payload(self, rank: int):
        if rank not in self.mobile_ranks:
            return super()._model_payload(rank)
        # encode once per global model, not once per mobile rank
        cached = self._wire_cache
        if cached is not None and cached[0] is self.global_flat:
            return cached[1]
        payload = variables_to_wire(self._current_variables())
        self._wire_cache = (self.global_flat, payload)
        return payload

    def _decode_upload(self, msg: Message) -> np.ndarray:
        if msg.get_sender_id() in self.mobile_ranks:
            # the shape template is the current global
            variables = wire_to_variables(msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS),
                                          self._current_variables())
            return pack_pytree(variables)[0]
        return super()._decode_upload(msg)


class MobileFedAvgClientManager(FedAvgClientManager):
    """The phone-side participant: model state crosses the wire ONLY as the
    reference's JSON dict; local training here stands in for the on-device
    runtime."""

    def _decode_model(self, msg: Message) -> StateDict:
        return convert.from_flax(wire_to_variables(
            msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS), convert.to_flax(self.template)))

    def _encode_model(self, new_vars: StateDict) -> str:
        return variables_to_wire(convert.to_flax(new_vars))


def mobile_runner_kwargs(mobile_ranks) -> dict:
    """The manager wiring that makes ``run_distributed_fedavg`` (or its
    loopback wrapper) speak JSON to ``mobile_ranks``: one definition shared
    by :func:`run_distributed_fedavg_mobile` and the ``--is_mobile`` CLI
    path."""
    mobile = set(mobile_ranks)
    return {
        "server_cls": MobileFedAvgServerManager,
        "server_kwargs": {"mobile_ranks": mobile},
        "client_cls_for_rank": lambda r: (
            MobileFedAvgClientManager if r in mobile else FedAvgClientManager
        ),
    }


def run_distributed_fedavg_mobile(*args, mobile_ranks=(), **kwargs):
    """:func:`run_distributed_fedavg` with ``mobile_ranks`` speaking the
    JSON wire format; every base-runner option passes through."""
    return run_distributed_fedavg(*args, **mobile_runner_kwargs(mobile_ranks), **kwargs)
