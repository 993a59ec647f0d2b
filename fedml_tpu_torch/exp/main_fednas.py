"""FedNAS experiment entry, the port of ``fedml_tpu/exp/main_fednas.py``:
clients run the DARTS bilevel search (the α step, then the weight step, per
batch), the server averages weights, α and BN statistics, and the genotype
is decoded each round.

The JAX CLI's flags with the same names and defaults, plus ``--device``
(default ``cuda``, which raises without a card; ``--device cpu`` runs on
the CPU). ``synthetic_cv`` is the JAX CLI's numpy draw; any other dataset
comes from the registry's ``load_partition_data`` (hetero, alpha 0.5).
Each client's batches are stacked once and serve as both its training and
its validation batches; the clients search one after another. Each record
holds ``round``, ``Train/Loss`` (the mean over clients of each client's
last-epoch loss), ``genotype_normal`` and ``round_time``; the last is
returned. At the DARTS search width (Liu et al., ICLR 2019, §3.1)::

    python -m fedml_tpu_torch.exp.main_fednas --dataset cifar10 \\
        --channels 16 --layers 8 --steps 4 --batch_size 64 --lr 0.025 \\
        --arch_lr 3e-4
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--dataset", type=str, default="synthetic_cv")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--client_number", type=int, default=2)
    parser.add_argument("--comm_round", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--arch_lr", type=float, default=3e-3)
    parser.add_argument("--channels", type=int, default=4)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--search_mode", type=str, default="darts",
                        choices=["darts", "gdas"],
                        help="darts = softmax mixture over ops; gdas = "
                             "Gumbel-softmax hard sample per forward")
    parser.add_argument("--tau", type=float, default=5.0,
                        help="gdas Gumbel temperature")
    parser.add_argument("--unrolled", type=int, default=0,
                        help="1 = second-order architect: one unrolled "
                             "weight step + exact Hessian-vector term")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser


def _load(args):
    """``(train FederatedArrays, class count)``."""
    from fedml_tpu_torch.sim.cohort import FederatedArrays

    if args.dataset == "synthetic_cv":
        rng = np.random.RandomState(args.seed)
        n, hw, classes = args.client_number * 4 * args.batch_size, 8, 4
        x = rng.rand(n, hw, hw, 3).astype(np.float32)
        y = rng.randint(0, classes, n).astype(np.int32)
        per = n // args.client_number
        train = FederatedArrays(
            {"x": x, "y": y},
            {c: np.arange(c * per, (c + 1) * per) for c in range(args.client_number)},
        )
        return train, classes
    from fedml_tpu_torch.data import registry

    ds = registry.load_partition_data(
        args.dataset, args.data_dir, "hetero", 0.5, args.client_number, args.seed)
    return ds.train, ds.class_num


def run(args) -> dict:
    import torch

    from fedml_tpu_torch.algorithms.fednas import (FedNASTrainer, fednas_aggregator,
                                                   global_genotype)
    from fedml_tpu_torch.core import tree as treelib
    from fedml_tpu_torch.core.trainer import adam, sgd
    from fedml_tpu_torch.device import resolve_device
    from fedml_tpu_torch.models.darts import DARTSNetwork
    from fedml_tpu_torch.obs.metrics import logging_config
    from fedml_tpu_torch.sim.cohort import stack_cohort

    logging_config(0)
    device = resolve_device(args.device)
    train, classes = _load(args)
    net = DARTSNetwork(num_classes=classes, channels=args.channels, layers=args.layers,
                       steps=args.steps, search_mode=args.search_mode, tau=args.tau,
                       device=device)
    tr = FedNASTrainer(net, sgd(args.lr), adam(args.arch_lr), epochs=args.epochs,
                       unrolled=bool(args.unrolled), unrolled_eta=args.lr)
    agg = fednas_aggregator()

    # per-client train/val batch stacks (the bilevel search needs both)
    stacks, weights = [], []
    for c in range(train.num_clients):
        stack, w = stack_cohort(train, np.asarray([c]), args.batch_size)
        stacks.append({k: torch.from_numpy(v[0]).to(device) for k, v in stack.items()})
        weights.append(float(w[0]))
    weights = torch.tensor(weights, device=device)

    variables = tr.init(torch.Generator(device=device).manual_seed(args.seed))
    state = agg.init_state(variables)
    generator = torch.Generator(device=device)
    history = []
    for r in range(args.comm_round):
        t0 = time.perf_counter()
        outs, losses = [], []
        for c in range(train.num_clients):
            generator.manual_seed(r * 7919 + c)
            out, m = tr.local_search(variables, stacks[c], stacks[c], generator)
            outs.append(out)
            losses.append(float(m["train_loss"]))
        variables, state, _ = agg.aggregate(variables, treelib.stack(outs), weights, state)
        genotype = global_genotype(variables)
        rec = {"round": r, "Train/Loss": float(np.mean(losses)),
               "genotype_normal": str(genotype.normal),
               "round_time": time.perf_counter() - t0}
        history.append(rec)
        logging.info("fednas round %d: loss=%.4f genotype=%s", r, rec["Train/Loss"],
                     genotype.normal[:2])
    return history[-1]


def main(argv=None):
    args = add_args(argparse.ArgumentParser("fedml_tpu_torch fednas entry")).parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
