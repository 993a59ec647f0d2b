"""Fixture ceilings, the port of ``fedml_tpu/exp/repro_ceilings.py``: the
centralized-baseline accuracy every fixture-based repro row is measured
against.

On offline fixtures a federated curve can neither fail nor regress unless
the fixture's attainable accuracy is known. This runner trains the SAME
model centrally (pooled data, same optimizer family) on each repro row's
exact fixture and records the best test accuracy, the ceiling; for the
Markov char-LM fixture also the analytic Bayes optimum
``sum_i pi_i * max_j T[i, j]`` (:func:`markov_bayes_ceiling`, a copy).

Departures from the JAX entry point:

- ``--store`` and ``--out`` default to no file: the JAX defaults are the
  JAX package's own ``repro_ceilings.json`` and ``REPRO.md``;
- the ``femnist_cnn`` and ``fed_cifar100`` rows need the TFF h5 fixtures
  and raise (ROADMAP §A6b), so ``--rows`` defaults to the four others;
- ``--device`` (default ``cuda``) names the device; with no card the run
  raises unless ``--device cpu``;
- the randomness of an epoch (augmentation draws, dropout masks) comes
  from the port's seeded streams, not from JAX keys.

Usage:
  python -m fedml_tpu_torch.exp.repro_ceilings                 # the ported rows
  python -m fedml_tpu_torch.exp.repro_ceilings --rows shakespeare mnist_lr --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
from pathlib import Path

import numpy as np


def centralized_ceiling(trainer, train_arrays, test_arrays, batch_size,
                        epochs, seed=0, patience=5, log_label="", device="cuda"):
    """Best pooled-test accuracy over ``epochs`` of centralized minibatch
    SGD (one epoch per call of the port's ``make_local_train``), early-stopped
    after ``patience`` epochs without improvement. The pooled set is
    shuffled once with ``numpy.random.RandomState(seed)`` and uploaded to
    ``device`` once; the variables start from ``trainer.init`` with a
    generator seeded by ``seed``. Epoch ``e``'s augmentation draws and
    dropout masks come from the port's streams seeded by ``(seed, e)``.
    Returns ``(best_acc, epochs_run)``."""
    import torch

    from fedml_tpu_torch.core.trainer import DropoutStream, make_local_eval, make_local_train
    from fedml_tpu_torch.device import resolve_device
    from fedml_tpu_torch.ops.augment import round_generator
    from fedml_tpu_torch.sim.cohort import batch_array

    if epochs < 1:
        raise ValueError(f"centralized_ceiling needs epochs >= 1, got {epochs}")
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    n = len(train_arrays["y"])
    # ONE shuffle + ONE device upload; each epoch reuses the resident batches
    perm = rng.permutation(n)

    def upload(arrays):
        return {k: torch.as_tensor(v).to(device) for k, v in arrays.items()}

    batches = upload(batch_array({k: v[perm] for k, v in train_arrays.items()}, batch_size))
    eval_b = upload(batch_array(test_arrays, 256))
    step = make_local_train(dataclasses.replace(trainer, epochs=1))
    eval_fn = make_local_eval(trainer)
    steps = batches["mask"].shape[0]

    variables = trainer.init(torch.Generator(device=device).manual_seed(seed))
    best, best_epoch = 0.0, 0
    for e in range(epochs):
        draws = None
        if trainer.augment is not None:
            draws = trainer.augment.draw(round_generator(seed, e, 0), (1, steps, batch_size),
                                         tuple(train_arrays["x"].shape[1:3]))
        dropout = (DropoutStream(trainer.dropout_sites, seed, e, 1, batch_size, device)
                   if trainer.dropout_sites else None)
        variables, _ = step(variables, batches, draws=draws, dropout=dropout)
        m = eval_fn(variables, eval_b)
        acc = float(m["test_correct"]) / max(float(m["test_total"]), 1.0)
        if acc > best:
            best, best_epoch = acc, e
        logging.info("ceiling %s epoch %d: acc %.4f (best %.4f)", log_label, e, acc, best)
        if e - best_epoch >= patience:
            break
    return best, e + 1


def markov_bayes_ceiling(vocab=90, seed=0):
    """Exact Bayes-optimal next-char accuracy of the synthetic_char_lm
    fixture: the generator's transition matrix is reproducible from the
    seed (``data.registry.synthetic_char_lm`` draws it FIRST from its
    RandomState), and the optimum predictor argmax_j T[i, j] is right with
    probability sum_i pi_i max_j T[i, j] under the stationary distribution
    pi."""
    rng = np.random.RandomState(seed)
    trans = rng.dirichlet(np.ones(vocab) * 0.05, size=vocab)
    # stationary distribution: leading left eigenvector of T
    evals, evecs = np.linalg.eig(trans.T)
    pi = np.real(evecs[:, np.argmax(np.real(evals))])
    pi = np.abs(pi) / np.abs(pi).sum()
    return float(np.sum(pi * trans.max(axis=1)))


# -- per-row builders: the repro scripts' fixture + model --------------------
# each returns [(label, fixture, trainer, train arrays, test arrays, batch,
# epochs, note)]


def _row_mnist_lr(args):
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.data.leaf_fixture import write_leaf_mnist_fixture
    from fedml_tpu_torch.data.registry import load_partition_data
    from fedml_tpu_torch.models.linear import LogisticRegression

    d = Path(args.data_root) / "mnist"
    write_leaf_mnist_fixture(d, n_clients=1000, seed=0)
    ds = load_partition_data("mnist", str(d), client_num_in_total=1000)
    tr = ClientTrainer(module=LogisticRegression(num_classes=10, device=args.device),
                       optimizer=sgd(0.03), epochs=1)
    return [("mnist_lr", "LEAF-format sklearn-digits fixture", tr,
             ds.train.arrays, ds.test_arrays, 10, 60, None)]


def _row_synthetic(args):
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.data.synthetic import synthetic_classification
    from fedml_tpu_torch.models.linear import LogisticRegression

    rows = []
    for a, b in ((0.0, 0.0), (0.5, 0.5), (1.0, 1.0)):
        train, test = synthetic_classification(n_clients=30, alpha=a, beta=b, seed=0)
        tr = ClientTrainer(module=LogisticRegression(num_classes=10, in_features=60,
                                                     device=args.device),
                           optimizer=sgd(0.01), epochs=1)
        rows.append((f"synthetic({a},{b})", "FedProx generator (exact math)",
                     tr, train.arrays, test, 10, 300, None))
    return rows


def _row_femnist(args):
    raise NotImplementedError(
        "the femnist_cnn ceiling row reads the TFF-schema h5 fixture, not ported to "
        "fedml_tpu_torch yet: ROADMAP §A6b")


def _row_fed_cifar100(args):
    raise NotImplementedError(
        "the fed_cifar100 ceiling row reads the TFF-schema h5 fixture, not ported to "
        "fedml_tpu_torch yet: ROADMAP §A6b")


def _row_shakespeare(args):
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.data.registry import synthetic_char_lm
    from fedml_tpu_torch.models.rnn import RNNOriginalFedAvg

    train, test_arrays, _ = synthetic_char_lm(
        n_clients=715, vocab=90, seq_len=80, samples=16, seed=0
    )
    tr = ClientTrainer(module=RNNOriginalFedAvg(vocab_size=90, device=args.device),
                       task="nwp", optimizer=sgd(1.0), epochs=1)
    bayes = markov_bayes_ceiling(vocab=90, seed=0)
    return [("shakespeare", "Markov char-LM fixture", tr, train.arrays,
             test_arrays, 4, 40,
             f"analytic Bayes optimum {bayes * 100:.1f}")]


def _row_cross_silo(args):
    import torch

    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.data.cv import load_cifar
    from fedml_tpu_torch.exp.repro_cross_silo import write_cifar10_fixture
    from fedml_tpu_torch.models.resnet import resnet56

    d = Path(args.data_root) / "cifar10"
    # signal=1.0 pins the trivially-separable fixture the recorded cross-silo
    # rows of the JAX package ran on; new cross-silo runs measure their own
    # (hard-fixture) ceiling inline via --ceiling_epochs
    write_cifar10_fixture(d, seed=0, signal=1.0)
    train, test, class_num = load_cifar("cifar10", str(d), "homo", 0.5, 10, 0,
                                        allow_synthetic=False)
    tr = ClientTrainer(
        module=resnet56(class_num=class_num, dtype=torch.bfloat16, device=args.device),
        optimizer=sgd(0.001, weight_decay=0.001), epochs=1)
    return [("cross_silo cifar10 (signal=1.0, round-3 rows)",
             "CIFAR-format class-blob fixture", tr, train.arrays, test, 64, 8, None)]


BUILDERS = {
    "mnist_lr": _row_mnist_lr,
    "synthetic": _row_synthetic,
    "femnist_cnn": _row_femnist,
    "fed_cifar100": _row_fed_cifar100,
    "shakespeare": _row_shakespeare,
    "cross_silo": _row_cross_silo,
}
# the rows that run on the port's fixtures (the h5 rows wait for §A6b)
PORTED_ROWS = ["mnist_lr", "synthetic", "shakespeare", "cross_silo"]


def run(args) -> dict:
    from fedml_tpu_torch.obs.metrics import logging_config

    logging_config(0)
    results = {}
    for name in args.rows:
        for (label, fixture, trainer, train_arrays, test_arrays, bs,
             epochs, note) in BUILDERS[name](args):
            t0 = time.time()
            acc, ran = centralized_ceiling(
                trainer, train_arrays, test_arrays, bs, epochs,
                seed=args.seed, patience=args.patience, log_label=label,
                device=args.device,
            )
            results[label] = {
                "fixture": fixture,
                "ceiling_acc": round(acc, 4),
                "epochs": ran,
                "note": note,
                "secs": round(time.time() - t0, 1),
                # provenance: partial reruns under different settings stay
                # detectable in the merged store
                "seed": args.seed,
                "patience": args.patience,
            }
            logging.info("ceiling %s: %.4f (%d epochs, %.0fs)",
                         label, acc, ran, results[label]["secs"])
    merged = dict(results)
    if args.store:
        # merge into the sidecar store so a partial --rows rerun refreshes
        # only its rows instead of overwriting the whole table
        store = Path(args.store)
        merged = {}
        if store.exists():
            try:
                merged = json.loads(store.read_text())
            except json.JSONDecodeError:
                merged = {}
            if not isinstance(merged, dict):
                merged = {}  # valid-but-non-object JSON (truncated/hand-edited)
        merged.update(results)
        store.write_text(json.dumps(merged, indent=1))
    if args.out:
        _write_report(Path(args.out), merged)
    print(json.dumps(results))
    return results


def _write_report(path: Path, results: dict) -> None:
    from fedml_tpu_torch.exp._report import update_section

    rows = "\n".join(
        f"| {label} | {r['fixture']} | {r['ceiling_acc'] * 100:.2f}"
        f"{' (' + r['note'] + ')' if r['note'] else ''} | {r['epochs']} |"
        for label, r in results.items()
    )
    update_section(path, "fixture_ceilings_torch", f"""# Fixture ceilings, PyTorch port — what the repro curves are measured against

Every fixture-based repro row is bounded by what its offline fixture can
actually reach. This table records the **centralized** best test accuracy
of each row's exact fixture under the same model/optimizer family (pooled
data, early-stopped SGD): the per-row federated curves should be read as a
fraction of THIS ceiling, not of the reference's real-data target. These
are early-stopped centralized baselines, not suprema; only the analytic
Bayes entries are true upper bounds.

| row | fixture | centralized ceiling (best test acc %) | epochs |
|---|---|---|---|
{rows}

Reproduce with: `python -m fedml_tpu_torch.exp.repro_ceilings --store repro_ceilings.json --out REPORT.md`
""")


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--rows", nargs="+", default=list(PORTED_ROWS),
                        choices=list(BUILDERS))
    parser.add_argument("--data_root", type=str, default="./data")
    parser.add_argument("--patience", type=int, default=5,
                        help="early-stop patience (epochs without a new best)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--store", type=str, default=None,
                        help="sidecar JSON store to merge the rows into (default: none)")
    parser.add_argument("--out", type=str, default=None,
                        help="markdown report to update (default: none)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    args = add_args(argparse.ArgumentParser("fixture ceilings")).parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
