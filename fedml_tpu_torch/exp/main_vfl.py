"""Classical vertical-FL experiment entry, the port of
``fedml_tpu/exp/main_vfl.py``: the guest holds the labels and a feature
block, the hosts the other columns; per batch the logits flow to the guest
and each host's gradient flows back
(:func:`~fedml_tpu_torch.algorithms.vertical.run_vfl`).

The JAX CLI's flags with the same names and defaults, plus ``--device``
(default ``cuda``, which raises without a card; ``--device cpu`` runs on
the CPU). ``--backend inprocess`` only: ``loopback`` runs the guest and the
hosts as separate parties over the comm layer, ROADMAP §A11, and raises.
Returns ``{"Train/Loss": the last step's loss, "Test/Acc": ...}``::

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
                        help="inprocess only; loopback (the parties over the comm layer) is "
                             "ROADMAP §A11")
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
    from fedml_tpu_torch.algorithms.vertical import run_vfl
    from fedml_tpu_torch.device import resolve_device
    from fedml_tpu_torch.obs.metrics import logging_config

    logging_config(0)
    if args.backend != "inprocess":
        raise NotImplementedError(
            f"--backend {args.backend} (the guest and hosts as parties over the comm layer) "
            "is not ported to fedml_tpu_torch yet: ROADMAP §A11")
    device = resolve_device(args.device)
    tr_splits, y_tr, te_splits, y_te = load(args)

    def put(a):
        return torch.as_tensor(np.asarray(a), device=device)

    vfl, pvars, losses = run_vfl([put(s) for s in tr_splits], put(y_tr), epochs=args.epochs,
                                 batch_size=args.batch_size, lr=args.lr, hidden=args.hidden,
                                 seed=args.seed)
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
