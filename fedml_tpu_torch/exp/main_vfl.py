"""Classical vertical-FL experiment entry, the port of
``fedml_tpu/exp/main_vfl.py``: the guest holds the labels and a feature
block, the hosts the other columns; per batch the logits flow to the guest
and each host's gradient flows back
(:func:`~fedml_tpu_torch.algorithms.vertical.run_vfl`).

The JAX CLI's flags with the same names and defaults, plus ``--device``
(default ``cuda``, which raises without a card; ``--device cpu`` runs on
the CPU). ``--backend inprocess`` runs the protocol in one program;
``loopback`` runs the guest and the hosts as separate parties over the
in-process comm fabric (``algorithms/vertical_dist.py``), with the logits
and their gradient as wire payloads. Returns ``{"Train/Loss": the last step's loss, "Test/Acc": ...}``::

    python -m fedml_tpu_torch.exp.main_vfl --device cpu
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--dataset", type=str, default="synthetic_vfl",
                        choices=["synthetic_vfl", "lending_club", "nus_wide"])
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--party_num", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=40)
    parser.add_argument("--lr", type=float, default=0.3)
    parser.add_argument("--epochs", type=int, default=8)
    parser.add_argument("--hidden", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--backend", type=str, default="inprocess",
                        choices=["inprocess", "loopback"],
                        help="inprocess: a single program; loopback: guest + hosts as "
                             "separate parties over the comm layer")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser


def load(args):
    """``(train splits, y_train, test splits, y_test)`` as the JAX CLI loads
    them (numpy)."""
    from fedml_tpu_torch.data.vertical_tabular import load_vertical, synthetic_vertical

    if args.dataset == "synthetic_vfl":
        return synthetic_vertical(dims=tuple([16] * args.party_num), seed=args.seed)
    return load_vertical(args.dataset, args.data_dir, n_parties=args.party_num, seed=args.seed)


def run(args) -> dict:
    """The run ``args`` describe."""
    from fedml_tpu_torch.algorithms.vertical import PartyModel, VerticalFL, run_vfl
    from fedml_tpu_torch.core import rng as rnglib
    from fedml_tpu_torch.core.trainer import sgd
    from fedml_tpu_torch.device import resolve_device
    from fedml_tpu_torch.obs.metrics import logging_config

    logging_config(0)
    device = resolve_device(args.device)
    tr_splits, y_tr, te_splits, y_te = load(args)

    def put(a):
        return torch.as_tensor(np.asarray(a), device=device)

    if args.backend == "loopback":
        from fedml_tpu_torch.algorithms.vertical_dist import run_distributed_vfl_loopback

        vfl = VerticalFL([PartyModel(s.shape[1], hidden=args.hidden, device=device)
                          for s in tr_splits], sgd(args.lr))
        pvars, losses = run_distributed_vfl_loopback(
            vfl, [put(s) for s in tr_splits], put(y_tr), args.epochs, args.batch_size,
            rnglib.generator(args.seed, device))
    else:
        vfl, pvars, losses = run_vfl([put(s) for s in tr_splits], put(y_tr),
                                     epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                                     hidden=args.hidden, seed=args.seed)
    pred = vfl.predict(pvars, [put(s) for s in te_splits]).cpu().numpy() > 0.5
    out = {"Train/Loss": float(losses[-1]),
           "Test/Acc": float((pred == np.asarray(y_te)).mean())}
    logging.info("vfl final: %s", out)
    return out


def main(argv=None):
    args = add_args(argparse.ArgumentParser("fedml_tpu_torch vertical-FL entry")).parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
