"""BASELINE reproduction, fed_cifar100 + ResNet18-GN (shallow-NN table row),
the port of ``fedml_tpu/exp/repro_fed_cifar100.py``.

Reference config (benchmark/README.md:54-57; BASELINE.md): CIFAR-100
federated (500 clients, Pachinko allocation), ResNet-18 with GroupNorm
(the Adaptive-FedOpt paper config, model/cv/resnet_gn.py:183), 10
clients/round, B=20, SGD lr=0.1 — test accuracy 44.7 beyond ~4000 rounds.

Runs on the real fed_cifar100 h5 archives when ``--data_dir`` has them;
otherwise writes the offline TFF-schema fixture
(``data/tff_fixture.py::write_fed_cifar100_h5_fixture`` — class-blob images
with per-client Dirichlet class skew; NOT real CIFAR-100) and reads it
through ``tff_h5.load_fed_cifar100`` (h5py both, which the card's machine
lacks). The rounds run through ``exp/_loop.run_rounds``.

Departures from the JAX entry point:

- ``--out`` defaults to no report and ``--metrics_out`` to no file: the JAX
  defaults write ``REPRO.md`` and ``repro_fed_cifar100_metrics.jsonl``,
  files of the JAX package's own runs;
- ``--device`` (default ``cuda``) names the device; with no card the run
  raises unless ``--device cpu``.

Usage: python -m fedml_tpu_torch.exp.repro_fed_cifar100 [--comm_round 4000] [--out REPORT.md]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path


def run(args) -> dict:
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.data.fixture_util import is_fixture
    from fedml_tpu_torch.data.registry import load_partition_data
    from fedml_tpu_torch.data.tff_fixture import write_fed_cifar100_h5_fixture
    from fedml_tpu_torch.device import resolve_device
    from fedml_tpu_torch.exp._loop import run_rounds
    from fedml_tpu_torch.models.resnet import resnet18_gn
    from fedml_tpu_torch.obs.metrics import logging_config
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    logging_config(0)
    device = resolve_device(args.device)
    data_dir = Path(args.data_dir)
    real = ((data_dir / "fed_cifar100_train.h5").exists()
            and not is_fixture(data_dir, "fed_cifar100"))
    if not real:
        logging.info("no real fed_cifar100 h5 at %s — using offline fixture", data_dir)
        write_fed_cifar100_h5_fixture(
            data_dir, n_train_clients=args.client_num_in_total,
            n_test_clients=args.n_test_clients,
            samples_per_client=args.samples_per_client, seed=args.seed,
        )
    ds = load_partition_data("fed_cifar100", str(data_dir))

    trainer = ClientTrainer(
        module=resnet18_gn(class_num=ds.class_num, device=device),
        optimizer=sgd(args.lr),
        epochs=1,
    )
    cfg = SimConfig(
        client_num_in_total=ds.train.num_clients,
        client_num_per_round=args.client_num_per_round,
        batch_size=args.batch_size,
        comm_round=args.comm_round,
        epochs=1,
        frequency_of_the_test=args.frequency_of_the_test,
        seed=args.seed,
    )
    sim = FedSim(trainer, ds.train, ds.test_arrays, cfg, device=device)
    records, wall = run_rounds(sim, cfg, args.metrics_out)

    evals = [r for r in records if "Test/Acc" in r]
    if not evals:
        raise RuntimeError("no completed eval rounds — nothing to report")
    best = max(e["Test/Acc"] for e in evals)
    first_over = next((e["round"] for e in evals if e["Test/Acc"] > 0.447), None)
    result = {
        "dataset": "fed_cifar100 h5" if real else "TFF-schema offline fixture (class blobs)",
        "clients": ds.train.num_clients,
        "samples": ds.train.num_samples,
        "rounds": len(records),
        "best_test_acc": round(best, 4),
        "first_round_over_44.7": first_over,
        "rounds_per_sec": round(len(records) / wall, 2),
        "final": {k: round(v, 4) for k, v in evals[-1].items() if k != "round"},
    }
    if args.out:
        _write_report(Path(args.out), args, result, evals)
    logging.info("fed_cifar100 repro result: %s", result)
    return result


def _write_report(path: Path, args, result: dict, evals: list) -> None:
    from fedml_tpu_torch.exp._report import acc_curve, update_section

    curve = acc_curve(evals, points=12)
    fixture_note = (
        "Real fed_cifar100 h5 archives were used."
        if result["dataset"] == "fed_cifar100 h5"
        else (
            "**Data note:** the real fed_cifar100 h5 archives were not found "
            "under `--data_dir`. The run uses the TFF-schema offline fixture "
            "(`fedml_tpu_torch/data/tff_fixture.py::write_fed_cifar100_h5_fixture`): "
            "class-blob RGB images with per-client Dirichlet class skew, in the "
            "exact `examples/<client>/image|label` h5 schema, read by "
            "`tff_h5.load_fed_cifar100`. Blob classes are far easier than real "
            "CIFAR-100, so the absolute accuracy is not comparable to the "
            "published 44.7."
        )
    )
    update_section(path, "fed_cifar100_resnet18gn_torch", f"""# BASELINE reproduction — fed_cifar100 + ResNet18-GN (shallow-NN table row), PyTorch port

Reference target (BASELINE.md / benchmark/README.md:54-57): test acc **44.7**
beyond **~4000 rounds** — 500 clients, 10/round, B=20, SGD lr=0.1, E=1,
ResNet-18 with GroupNorm.

{fixture_note}

## Config

| clients | per round | batch | lr | local epochs | rounds | device |
|---|---|---|---|---|---|---|
| {result['clients']} | {args.client_num_per_round} | {args.batch_size} | {args.lr} | 1 | {result['rounds']} | {args.device} |

## Result

- best test accuracy: **{result['best_test_acc'] * 100:.2f}**
- first round with test acc > 44.7: **{result['first_round_over_44.7']}**
- wall-clock: {result['rounds_per_sec']} rounds/sec
- raw per-round metrics: `{args.metrics_out}`

Accuracy curve (round:acc): {curve}

Reproduce with: `python -m fedml_tpu_torch.exp.repro_fed_cifar100 --out REPORT.md`
""")


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--data_dir", type=str, default="./data/fed_cifar100")
    parser.add_argument("--client_num_in_total", type=int, default=500)
    parser.add_argument("--n_test_clients", type=int, default=100,
                        help="fixture-only: test clients to generate")
    parser.add_argument("--samples_per_client", type=int, default=100,
                        help="fixture-only: samples per generated client")
    parser.add_argument("--client_num_per_round", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=20)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--comm_round", type=int, default=4000)
    parser.add_argument("--frequency_of_the_test", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--metrics_out", type=str, default=None,
                        help="JSONL file of the round records (none by default)")
    parser.add_argument("--out", type=str, default=None,
                        help="markdown report to write (none by default)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    return parser


def main(argv=None):
    args = add_args(argparse.ArgumentParser("fed_cifar100 baseline repro")).parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
