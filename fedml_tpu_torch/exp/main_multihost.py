"""Multi-process federated training entry, the port of
``fedml_tpu/exp/main_multihost.py``.

Reference role: fedml_experiments/distributed/* launched via mpirun — one
process per worker, MPI for transport. The JAX entry runs one controller a
host and fuses every host's chips into one mesh; the port runs one process
(a rank) per card in a ``torch.distributed`` world, and the engine's round
spans the world's ``clients x silo`` mesh (``parallel/multihost.py``).
Every rank evaluates the replicated model and writes the same result.

The JAX flags, plus:

- ``--local_device_count N`` spawns N local ranks (the JAX flag forces N
  virtual devices a process), so the same command line builds a mesh of the
  same size: ``--num_processes K`` hosts x N ranks, rank ``k * N + j``;
- ``--platform cpu|cuda`` (default ``cuda``), a rank's device: the CPU, or
  card ``local rank % card count``;
- ``--dist_backend nccl|gloo`` names the backend (default NCCL on cards,
  gloo on the CPU); a backend that fails to initialise raises;
- ``--share_device 1`` lets local ranks outnumber the cards (gloo only);
- ``--timeout_s S`` bounds a rank's wait in a collective and the spawned
  ranks' run: a rank that fails or hangs fails the launch.

Launch the same command on every host, or N local ranks:

  python -m fedml_tpu_torch.exp.main_multihost --coordinator host0:9911 \\
      --num_processes K --process_id <k> --local_device_count 8 ...
  python -m fedml_tpu_torch.exp.main_multihost --local_device_count 2 \\
      --platform cpu --out final.npz

Without a coordinator and with one local rank the run joins the world a
launcher such as ``torchrun`` describes in the environment, or, with none,
runs on one rank. ``--out`` is the final model's npz (``flat``, the
variables in the JAX leaf order, and the last record's metrics), the JAX
layout; spawned local ranks write ``<stem>.rank<r><suffix>``.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    # cluster topology
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port of rank 0 (default: the launcher's environment)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--local_device_count", type=int, default=None,
                        help="spawn N local ranks (one world rank each)")
    parser.add_argument("--platform", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="a rank's device: a card, or the CPU")
    parser.add_argument("--dist_backend", type=str, default=None, choices=("nccl", "gloo"),
                        help="the world's backend (default: nccl on cuda, gloo on cpu)")
    parser.add_argument("--share_device", type=int, default=0,
                        help="1: local ranks may share a card (gloo only)")
    parser.add_argument("--timeout_s", type=float, default=3600.0,
                        help="a collective's and the spawned ranks' time limit")
    parser.add_argument("--silo", type=int, default=1,
                        help="ranks per silo group (clients x silo global mesh)")
    # the reference experiment flags (main_fedavg.py:46-130 subset)
    parser.add_argument("--dataset", type=str, default="synthetic")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--partition_method", type=str, default="hetero")
    parser.add_argument("--partition_alpha", type=float, default=0.5)
    parser.add_argument("--model", type=str, default="lr")
    parser.add_argument("--client_num_in_total", type=int, default=16)
    parser.add_argument("--client_num_per_round", type=int, default=8)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--comm_round", type=int, default=10)
    parser.add_argument("--frequency_of_the_test", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default=None,
                        help="npz path for the final model (per process)")
    return parser


def _rank_out(out: str | None, rank: int | None) -> str | None:
    if out is None or rank is None:
        return out
    path = Path(out)
    return str(path.with_name(f"{path.stem}.rank{rank}{path.suffix}"))


def train_rank(device, args, out: str | None) -> dict:
    """One rank's run over the world's mesh (one rank without a world):
    returns the final record, and writes ``out``."""
    import numpy as np
    import torch.distributed as dist

    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.data.registry import load_partition_data
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.obs.metrics import logging_config
    from fedml_tpu_torch.parallel.multihost import flatten_variables, global_client_mesh
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    logging_config(rank)
    logging.info("multihost: rank %d/%d on %s", rank, world, device)
    ds = load_partition_data(
        args.dataset, args.data_dir, args.partition_method, args.partition_alpha,
        args.client_num_in_total, args.seed,
    )
    trainer = ClientTrainer(
        module=create_model(args.model, ds.class_num, args.dataset, device=device,
                            input_shape=tuple(ds.train.arrays["x"].shape[1:])),
        optimizer=sgd(args.lr), epochs=args.epochs,
    )
    cfg = SimConfig(
        client_num_in_total=ds.train.num_clients,
        client_num_per_round=args.client_num_per_round,
        batch_size=args.batch_size, comm_round=args.comm_round,
        epochs=args.epochs, frequency_of_the_test=args.frequency_of_the_test,
        seed=args.seed,
    )
    mesh = global_client_mesh(silo=args.silo)
    sim = FedSim(trainer, ds.train, ds.test_arrays, cfg, device=device, mesh=mesh)
    variables, history = sim.run()
    final = history[-1]
    if out:
        np.savez(out, flat=flatten_variables(variables), **{
            k.replace("/", "_"): v for k, v in final.items()
        })
    logging.info("multihost final: %s", final)
    return final


def run(args) -> dict:
    """The run ``args`` describe; returns the final record (of local rank
    0 when the ranks were spawned here)."""
    import torch.distributed as dist

    from fedml_tpu_torch.parallel import launch, multihost

    n_local = args.local_device_count or 1
    if n_local > 1:
        hosts = args.num_processes or 1
        finals = launch.launch(
            _spawned_rank, n_local, args,
            backend=args.dist_backend, platform=args.platform,
            share_device=bool(args.share_device), timeout_s=args.timeout_s,
            coordinator=args.coordinator, world_size=hosts * n_local,
            first_rank=(args.process_id or 0) * n_local)
        return finals[0]
    formed = args.coordinator is not None or "WORLD_SIZE" in os.environ
    if formed:
        multihost.init_multihost(args.coordinator, args.num_processes, args.process_id,
                                 backend=args.dist_backend, platform=args.platform,
                                 timeout_s=args.timeout_s)
    try:
        device = multihost.rank_device(args.platform, share_device=bool(args.share_device))
        return train_rank(device, args, args.out)
    finally:
        if formed:
            dist.destroy_process_group()


def _spawned_rank(device, args) -> dict:
    import torch.distributed as dist

    return train_rank(device, args, _rank_out(args.out, dist.get_rank()))


def main(argv=None):
    args = add_args(argparse.ArgumentParser("fedml_tpu_torch multihost entry")).parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
