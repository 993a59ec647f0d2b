"""Cross-silo FL, the port of ``fedml_tpu/algorithms/cross_silo.py``: WAN
federation between silos, each silo one device here.

Reference: fedml_api/distributed/fedavg_cross_silo/ — each silo runs a
master process (ClientMasterManager.py:32) plus DDP slave processes over the
silo's GPUs, and masters talk to the FL server over the WAN transport. The
JAX package runs a silo's local epochs as one program over the silo's
device mesh; the port runs a silo on one device (the trainer's, the card
unless the module lives on the CPU), and a silo of more than one device, a
data-parallel silo, is ROADMAP §A12. The server is the unmodified
distributed FedAvg server: cross-silo is a client-side composition.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg_distributed import (
    FedAvgClientManager,
    FedAvgServerManager,
    init_template,
    run_manager_protocol,
    unpack_state,
)
from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.core.trainer import ClientTrainer, make_local_train
from fedml_tpu_torch.sim.cohort import FederatedArrays


def make_silo_local_train(trainer: ClientTrainer, silo_mesh=None) -> Callable:
    """The in-silo round program: the port's ``make_local_train`` on the
    silo's one device. ``silo_mesh`` is None (the trainer's device), a
    device, or a sequence of devices; more than one device, or a device
    other than the trainer's, raises."""
    device = next(trainer.module.parameters()).device
    devices = ([] if silo_mesh is None
               else list(silo_mesh) if isinstance(silo_mesh, (list, tuple)) else [silo_mesh])
    if len(devices) > 1:
        raise NotImplementedError(
            f"a silo over {len(devices)} devices (in-silo data parallelism) is not "
            "ported to fedml_tpu_torch yet: ROADMAP §A12")
    want = torch.device(devices[0]) if devices else device
    if want.type != device.type or want.index not in (None, device.index):
        raise ValueError(f"silo device {want} is not the trainer's device {device}")
    return make_local_train(trainer)


def run_cross_silo(
    trainer: ClientTrainer,
    silo_data: list[FederatedArrays],
    round_num: int,
    batch_size: int,
    make_comm: Callable[[int], BaseCommunicationManager],
    silo_meshes: list | None = None,
    seed: int = 0,
    on_round_done: Callable[[int, Any], None] | None = None,
):
    """End-to-end cross-silo FedAvg: one FL server + one manager per silo.
    ``silo_data[i]`` is silo i's private dataset (single-client
    FederatedArrays: the silo IS the client); transports come from
    ``make_comm``; ``silo_meshes[i]`` names silo i's device
    (:func:`make_silo_local_train`). Returns the final global variables
    (the port's state dict)."""
    n_silos = len(silo_data)
    if silo_meshes is None:
        silo_meshes = [None] * n_silos
    template, flat, desc = init_template(trainer, silo_data[0].arrays, batch_size, seed)

    results: dict[str, np.ndarray] = {}

    def _done(r, f):
        results["final"] = f
        if on_round_done is not None:
            on_round_done(r, unpack_state(f, desc))

    server = FedAvgServerManager(
        make_comm(0), n_silos, round_num, flat, desc,
        client_num_in_total=n_silos, on_round_done=_done,
    )
    # in-process execution serialization: the silo threads share the
    # trainer's module (the working copy of the model) and its one device,
    # so a silo's local round runs alone, under the clients' default
    # TRAIN_LOCK (the JAX package's own exec_lock)
    clients = []
    for r in range(1, n_silos + 1):
        # full participation assigns worker r the global client index r-1;
        # key the silo's single private shard under that index
        data = silo_data[r - 1]
        if len(data.partition) != 1:
            raise ValueError(
                f"silo {r - 1}: cross-silo data must be a single-client "
                f"FederatedArrays (the silo IS the client); got "
                f"{len(data.partition)} partition entries"
            )
        keyed = FederatedArrays(data.arrays, {r - 1: next(iter(data.partition.values()))})
        clients.append(FedAvgClientManager(
            make_comm(r), r, n_silos + 1, trainer, keyed, batch_size, template,
            local_train_fn=make_silo_local_train(trainer, silo_meshes[r - 1]),
        ))
    run_manager_protocol(server, clients)
    if "final" not in results:
        raise RuntimeError("cross-silo run produced no final model")
    return unpack_state(results["final"], desc)
