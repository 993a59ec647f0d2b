"""SplitNN experiment entry, the port of ``fedml_tpu/exp/main_splitnn.py``:
clients hold the bottom network, the server the top one; activations and
their gradients cross the cut layer, and the clients take turns in a relay
ring (:func:`~fedml_tpu_torch.algorithms.splitnn.run_splitnn_relay`).

The JAX CLI's flags with the same names and defaults, plus ``--device``
(default ``cuda``, which raises without a card; ``--device cpu`` runs on
the CPU). ``--backend inprocess`` only: ``loopback`` and ``shm`` run the
halves as separate parties over the comm layer, ROADMAP §A11, and raise.
Returns ``{"Train/Loss": last turn's loss, "Test/Acc": ...}`` (the latter
when the dataset has a test set, client 0's half with the server's)::

    python -m fedml_tpu_torch.exp.main_splitnn --dataset mnist \\
        --data_dir build/mnist --device cpu
"""

from __future__ import annotations

import argparse
import logging
import math

import numpy as np
import torch
from torch import nn

from fedml_tpu_torch.models.resnet import reset_flax
from fedml_tpu_torch.models.transformer import Dense


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--dataset", type=str, default="synthetic")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--partition_method", type=str, default="homo")
    parser.add_argument("--partition_alpha", type=float, default=0.5)
    parser.add_argument("--client_number", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--hidden", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--backend", type=str, default="inprocess",
                        choices=["inprocess", "loopback", "shm"],
                        help="inprocess only; loopback/shm (the halves over the comm "
                             "layer) are ROADMAP §A11")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser


class Bottom(nn.Module):
    """The client half: flatten, one Dense to ``hidden``, ReLU (flax's
    ``Dense_0`` is ``dense_0``)."""

    def __init__(self, in_features: int, hidden: int, device=None):
        super().__init__()
        self.dense_0 = Dense(in_features, hidden, device=device)

    def reset_parameters(self, generator=None):
        reset_flax(self, generator)

    def forward(self, x, train: bool = False):
        return torch.relu(self.dense_0(x.reshape(x.shape[0], -1).float()))


class Top(nn.Module):
    """The server half: one Dense from the activations to the classes."""

    def __init__(self, hidden: int, classes: int, device=None):
        super().__init__()
        self.dense_0 = Dense(hidden, classes, device=device)

    def reset_parameters(self, generator=None):
        reset_flax(self, generator)

    def forward(self, acts, train: bool = False):
        return self.dense_0(acts)


def build(args, ds, device):
    """The run's :class:`SplitNN` and each client's ``[S, B, ...]`` batch
    stack on ``device`` (the JAX CLI's ``stack_cohort`` of one client)."""
    from fedml_tpu_torch.algorithms.splitnn import SplitNN
    from fedml_tpu_torch.core.trainer import sgd
    from fedml_tpu_torch.sim.cohort import stack_cohort

    in_features = math.prod(ds.train.arrays["x"].shape[1:])
    split = SplitNN(Bottom(in_features, args.hidden, device), Top(args.hidden, ds.class_num,
                                                                  device),
                    sgd(args.lr), sgd(args.lr))
    client_batches = []
    for c in range(ds.train.num_clients):
        stack, _ = stack_cohort(ds.train, np.asarray([c]), args.batch_size)
        client_batches.append({k: torch.as_tensor(v[0], device=device) for k, v in stack.items()})
    return split, client_batches


def run(args) -> dict:
    """The run ``args`` describe."""
    from fedml_tpu_torch.algorithms.splitnn import run_splitnn_relay, splitnn_eval
    from fedml_tpu_torch.core import rng as rnglib
    from fedml_tpu_torch.data.registry import load_partition_data
    from fedml_tpu_torch.device import resolve_device
    from fedml_tpu_torch.obs.metrics import logging_config
    from fedml_tpu_torch.sim.cohort import batch_array

    logging_config(0)
    if args.backend != "inprocess":
        raise NotImplementedError(
            f"--backend {args.backend} (the split halves as parties over the comm layer) is "
            "not ported to fedml_tpu_torch yet: ROADMAP §A11")
    device = resolve_device(args.device)
    ds = load_partition_data(args.dataset, args.data_dir, args.partition_method,
                             args.partition_alpha, args.client_number, args.seed)
    split, client_batches = build(args, ds, device)
    cvars, svars, losses = run_splitnn_relay(split, client_batches, args.epochs,
                                             rnglib.generator(args.seed, device))
    out = {"Train/Loss": float(losses[-1])}
    if ds.test_arrays is not None:
        test_b = {k: torch.as_tensor(v, device=device)
                  for k, v in batch_array(ds.test_arrays, 64).items()}
        out["Test/Acc"] = float(splitnn_eval(split, cvars[0], svars, test_b))
    logging.info("splitnn final: %s", out)
    return out


def main(argv=None):
    args = add_args(argparse.ArgumentParser("fedml_tpu_torch splitnn entry")).parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
