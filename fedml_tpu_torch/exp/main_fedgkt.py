"""FedGKT experiment entry, the port of ``fedml_tpu/exp/main_fedgkt.py``:
clients train a small feature extractor (the ResNet-8 class), upload each
batch's features, logits and labels; the server trains the large network on
the features with bidirectional temperature-scaled KL distillation
(:func:`~fedml_tpu_torch.algorithms.fedgkt.run_fedgkt`).

The JAX CLI's flags with the same names and defaults, plus ``--device``
(default ``cuda``, which raises without a card; ``--device cpu`` runs on
the CPU). ``synthetic_cv`` is the JAX CLI's numpy draw, copied; any other
dataset comes from the port's registry. ``--backend inprocess`` runs the
rounds in this process; ``loopback`` runs the server and the clients as
separate parties over the in-process comm fabric
(``algorithms/fedgkt_dist.py``), with the features, logits and labels as
wire payloads; identical arguments give identical models either way.
Returns ``{"Train/Acc": ...}``, the train accuracy through the whole
client-to-server pipeline::

    python -m fedml_tpu_torch.exp.main_fedgkt --device cpu
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--dataset", type=str, default="synthetic_cv")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--partition_method", type=str, default="hetero")
    parser.add_argument("--partition_alpha", type=float, default=0.5)
    parser.add_argument("--client_number", type=int, default=2)
    parser.add_argument("--comm_round", type=int, default=2)
    parser.add_argument("--epochs_client", type=int, default=1)
    parser.add_argument("--epochs_server", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=0.03)
    parser.add_argument("--temperature", type=float, default=3.0)
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--backend", type=str, default="inprocess",
                        choices=["inprocess", "loopback"],
                        help="inprocess: orchestrated in this process; loopback: server + "
                             "clients as separate parties with features/logits as wire "
                             "payloads")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser


def _load_images(args):
    """The CV dataset through the registry, or the synthetic image fixture
    (a copy of the JAX CLI's draw): ``(train FederatedArrays, classes)``."""
    from fedml_tpu_torch.sim.cohort import FederatedArrays

    if args.dataset == "synthetic_cv":
        rng = np.random.RandomState(args.seed)
        n, hw, classes = args.client_number * 4 * args.batch_size, 8, 4
        x = rng.rand(n, hw, hw, 3).astype(np.float32)
        y = rng.randint(0, classes, n).astype(np.int32)
        part = {
            c: np.arange(c * (n // args.client_number), (c + 1) * (n // args.client_number))
            for c in range(args.client_number)
        }
        return FederatedArrays({"x": x, "y": y}, part), classes
    from fedml_tpu_torch.data.registry import load_partition_data

    ds = load_partition_data(args.dataset, args.data_dir, args.partition_method,
                             args.partition_alpha, args.client_number, args.seed)
    return ds.train, ds.class_num


def build(args, device):
    """The run's :class:`FedGKT` (a 1-block client and 1 block a server
    stage, as the JAX CLI builds them) and each
    client's fixed ``[S, B, ...]`` batch stack on ``device``."""
    from fedml_tpu_torch.algorithms.fedgkt import FedGKT
    from fedml_tpu_torch.core.trainer import sgd
    from fedml_tpu_torch.models.resnet_gkt import ResNetGKTClient, ResNetGKTServer
    from fedml_tpu_torch.sim.cohort import stack_cohort

    train, class_num = _load_images(args)
    gkt = FedGKT(ResNetGKTClient(num_classes=class_num, blocks=1, device=device),
                 ResNetGKTServer(num_classes=class_num, blocks_per_stage=1, device=device),
                 sgd(args.lr), sgd(args.lr), temperature=args.temperature, alpha=args.alpha)
    # per-client fixed batch stacks: the per-batch feature exchange keys on
    # stable batch identity (GKTClientTrainer.train extracted_feature_dict)
    client_batches = []
    for c in range(train.num_clients):
        stack, _ = stack_cohort(train, np.asarray([c]), args.batch_size)
        client_batches.append({k: torch.as_tensor(v[0], device=device) for k, v in stack.items()})
    return gkt, client_batches


def run(args) -> dict:
    """The run ``args`` describe."""
    from fedml_tpu_torch.algorithms.fedgkt import run_fedgkt
    from fedml_tpu_torch.core import rng as rnglib
    from fedml_tpu_torch.device import resolve_device
    from fedml_tpu_torch.obs.metrics import logging_config

    logging_config(0)
    device = resolve_device(args.device)
    gkt, client_batches = build(args, device)
    generator = rnglib.generator(args.seed, device)
    if args.backend == "loopback":
        from fedml_tpu_torch.algorithms.fedgkt_dist import run_distributed_fedgkt_loopback

        cvars_list, svars = run_distributed_fedgkt_loopback(
            gkt, client_batches, args.comm_round, args.epochs_client, args.epochs_server,
            generator, key_seed=args.seed)
    else:
        cvars_list, svars, _ = run_fedgkt(gkt, client_batches, rounds=args.comm_round,
                                          client_epochs=args.epochs_client,
                                          server_epochs=args.epochs_server,
                                          generator=generator)
    return _final_metrics(gkt, cvars_list, svars, client_batches)


@torch.no_grad()
def _final_metrics(gkt, cvars_list, svars, client_batches) -> dict:
    """The final train accuracy through the client-to-server pipeline."""
    correct = total = 0.0
    for c, batches in enumerate(client_batches):
        feats = [f for f, _ in gkt._evaluate(gkt.client_module, cvars_list[c], batches["x"])]
        logits = gkt._evaluate(gkt.server_module, svars, feats)
        for s, lg in enumerate(logits):
            m = batches["mask"][s]
            correct += float(torch.sum((torch.argmax(lg, -1) == batches["y"][s]).float() * m))
            total += float(torch.sum(m))
    out = {"Train/Acc": correct / max(total, 1.0)}
    logging.info("fedgkt final: %s", out)
    return out


def main(argv=None):
    args = add_args(argparse.ArgumentParser("fedml_tpu_torch fedgkt entry")).parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
