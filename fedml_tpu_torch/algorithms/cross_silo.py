"""Cross-silo FL, the port of ``fedml_tpu/algorithms/cross_silo.py``: WAN
federation between silos, data parallelism within.

Reference: fedml_api/distributed/fedavg_cross_silo/ — each silo runs a
master process (ClientMasterManager.py:32) plus DDP slave processes over the
silo's GPUs, and masters talk to the FL server over the WAN transport. The
JAX package runs a silo's local epochs as one program over the silo's
device mesh, its batch axis sharded. The port runs a silo over the ranks of
a silo mesh (``parallel/mesh.py`` ``silo_mesh``, one rank per card): each
rank trains on its rows of every batch, and the silo's ranks sum their
gradients and BatchNorm moments in each step, as DDP does
(:func:`make_silo_local_train`). :func:`run_cross_silo` runs each silo on
one device; a multi-rank silo there needs the silo's other ranks to follow
its master over the wire (ROADMAP §A12b.4). The server is the unmodified
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
from fedml_tpu_torch.parallel import collectives
from fedml_tpu_torch.parallel import mesh as meshlib
from fedml_tpu_torch.sim.cohort import FederatedArrays


def make_silo_local_train(trainer: ClientTrainer, silo_mesh=None) -> Callable:
    """The in-silo data-parallel round program (``cross_silo.py:42-66``):
    ``make_local_train``'s contract, each rank called with its rows of the
    ``[S, B, ...]`` batches and the same variables. ``silo_mesh`` is a
    :class:`~fedml_tpu_torch.parallel.mesh.RankMesh` (its ``silo`` axis, or
    its only axis, is the silo's ranks: they sum their gradients and
    BatchNorm moments in each step, and every rank gets the silo's model),
    None or one device (the trainer's: a silo of one rank). Several devices
    of one process raise: the port runs one rank per device."""
    device = next(trainer.module.parameters()).device
    local_train = make_local_train(trainer)
    if isinstance(silo_mesh, meshlib.RankMesh):
        axis = (meshlib.SILO_AXIS if meshlib.SILO_AXIS in silo_mesh.axis_names
                else silo_mesh.axis_names[0])
        group = silo_mesh.group(axis)

        def silo_train(*args, **kwargs):
            with collectives.bind(meshlib.SILO_AXIS, group):
                return local_train(*args, **kwargs)

        return silo_train
    devices = ([] if silo_mesh is None
               else list(silo_mesh) if isinstance(silo_mesh, (list, tuple)) else [silo_mesh])
    if len(devices) > 1:
        raise NotImplementedError(
            f"a silo over {len(devices)} devices of one process: the port runs a "
            "data-parallel silo over the ranks of a silo mesh (parallel.mesh.silo_mesh, one "
            "rank per device); a multi-rank silo in run_cross_silo is ROADMAP §A12b.4")
    want = torch.device(devices[0]) if devices else device
    if want.type != device.type or want.index not in (None, device.index):
        raise ValueError(f"silo device {want} is not the trainer's device {device}")
    return local_train


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
