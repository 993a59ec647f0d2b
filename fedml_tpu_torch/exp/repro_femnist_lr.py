"""BASELINE reproduction, FederatedEMNIST + LogisticRegression (Linear row
2), the port of ``fedml_tpu/exp/repro_femnist_lr.py``.

Reference config (benchmark/README.md:12-14; BASELINE.md): 200 clients,
10/round, B=10, SGD lr=0.003, E=1 — published test accuracy band **10-40
beyond ~200 rounds** (the 62-class EMNIST task is hard for a linear model).

Runs on real fed_emnist h5 when ``--data_dir`` has it; otherwise the same
TFF-schema offline fixture as the CNN row (``data/tff_fixture.py``, 10 digit
classes) written at THIS row's 200-client scale and read through
``tff_h5.load_federated_emnist`` (h5py both, which the card's machine
lacks). The 10-class fixture is far easier than 62-class EMNIST, so the
result also carries the fixture's own centralized LR ceiling and the
federated best as a fraction of it. The rounds run through
``exp/_loop.run_rounds``.

Departures from the JAX entry point:

- ``--out`` defaults to no report and ``--metrics_out`` to no file: the JAX
  defaults write ``REPRO.md`` and ``repro_femnist_lr_metrics.jsonl``, files
  of the JAX package's own runs;
- ``--device`` (default ``cuda``) names the device; with no card the run
  raises unless ``--device cpu``.

Usage: python -m fedml_tpu_torch.exp.repro_femnist_lr [--comm_round 400] [--out REPORT.md]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path


def run(args) -> dict:
    from fedml_tpu_torch.obs.trace import run_traced

    return run_traced(_run, args)


def _run(args) -> dict:
    from fedml_tpu_torch.algorithms.robust import sim_config_fields as robust_fields
    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.data.fixture_util import is_fixture
    from fedml_tpu_torch.data.registry import load_partition_data
    from fedml_tpu_torch.data.tff_fixture import write_femnist_h5_fixture
    from fedml_tpu_torch.device import resolve_device
    from fedml_tpu_torch.exp._loop import run_rounds
    from fedml_tpu_torch.exp.repro_ceilings import centralized_ceiling
    from fedml_tpu_torch.models.linear import LogisticRegression
    from fedml_tpu_torch.obs.metrics import logging_config
    from fedml_tpu_torch.population import sim_config_fields as population_fields
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    logging_config(0)
    device = resolve_device(args.device)
    data_dir = Path(args.data_dir)
    real = (data_dir / "fed_emnist_train.h5").exists() and not is_fixture(data_dir, "femnist")
    if not real:
        logging.info("no real fed_emnist h5 at %s — using offline fixture", data_dir)
        write_femnist_h5_fixture(data_dir, n_clients=args.client_num_in_total, seed=args.seed)
    ds = load_partition_data("femnist", str(data_dir),
                             client_num_in_total=args.client_num_in_total)

    in_features = int(ds.train.arrays["x"][0].size)
    trainer = ClientTrainer(
        module=LogisticRegression(num_classes=ds.class_num, in_features=in_features,
                                  device=device),
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
        pack_lanes=args.pack_lanes,
        pack_capacity_factor=args.pack_capacity_factor,
        **robust_fields(args),
        **population_fields(args),
    )
    sim = FedSim(trainer, ds.train, ds.test_arrays, cfg, device=device)
    records, wall = run_rounds(sim, cfg, args.metrics_out)

    evals = [r for r in records if "Test/Acc" in r]
    if not evals:
        raise RuntimeError("no completed eval rounds — nothing to report")
    best = max(e["Test/Acc"] for e in evals)
    in_band = next((e["round"] for e in evals if e["Test/Acc"] > 0.10), None)
    result = {
        "dataset": "FederatedEMNIST h5" if real else "TFF-format offline fixture (10-class)",
        "clients": ds.train.num_clients,
        "samples": ds.train.num_samples,
        "rounds": len(records),
        "best_test_acc": round(best, 4),
        "first_round_over_10": in_band,
        "rounds_per_sec": round(len(records) / wall, 2),
        "final": {k: round(v, 4) for k, v in evals[-1].items() if k != "round"},
    }
    if not real:
        # the FIXTURE's own attainable accuracy: centralized LR,
        # early-stopped (real-data runs compare to the published band)
        ceiling, ceiling_epochs = centralized_ceiling(
            trainer, ds.train.arrays, ds.test_arrays, args.batch_size,
            epochs=60, seed=args.seed, log_label="femnist_lr", device=device,
        )
        result["fixture_ceiling"] = round(ceiling, 4)
        result["ceiling_epochs"] = ceiling_epochs
        result["pct_of_ceiling"] = round(100 * best / max(ceiling, 1e-9), 1)
    if args.out:
        _write_report(Path(args.out), args, result, evals, real)
    logging.info("femnist_lr repro result: %s", result)
    return result


def _ceiling_line(result: dict) -> str:
    if result.get("fixture_ceiling") is None:
        return ""
    return (
        f"\n- fixture centralized-LR ceiling: "
        f"**{result['fixture_ceiling'] * 100:.2f}** "
        f"({result['ceiling_epochs']} early-stopped epochs) -> federated "
        f"best is **{result['pct_of_ceiling']}% of ceiling**"
    )


def _write_report(path: Path, args, result: dict, evals: list, real: bool) -> None:
    from fedml_tpu_torch.exp._report import acc_curve, update_section

    curve = acc_curve(evals, points=12)
    note = (
        "Real FederatedEMNIST h5 archives were used."
        if real else (
            "**Data note:** the real fed_emnist h5 archives were not found "
            "under `--data_dir`. The run uses the TFF-schema offline fixture "
            "(`fedml_tpu_torch/data/tff_fixture.py`) written at this row's "
            "200-client scale — real handwritten digits, per-writer styles, "
            "the exact `examples/<client>/pixels|label` h5 schema, read by "
            "`tff_h5.load_federated_emnist`. It has 10 digit classes, NOT "
            "62-class EMNIST, so the published 10-40 band does not transfer; "
            "the comparison is against the fixture's own centralized-LR "
            "ceiling below."
        )
    )
    update_section(path, "femnist_lr_torch", f"""# BASELINE reproduction — FederatedEMNIST + LogisticRegression (Linear Models row 2), PyTorch port

Reference target (BASELINE.md / benchmark/README.md:12-14): test acc
**10-40** beyond **~200 rounds** — 200 clients, 10/round, B=10, SGD
lr=0.003, E=1.

{note}

## Config

| clients | per round | batch | lr | local epochs | rounds | device |
|---|---|---|---|---|---|---|
| {result['clients']} | {args.client_num_per_round} | {args.batch_size} | {args.lr} | 1 | {result['rounds']} | {args.device} |

## Result

- best test accuracy: **{result['best_test_acc'] * 100:.2f}**{_ceiling_line(result)}
- first round inside the published 10-40 band (>10): **{result['first_round_over_10']}**
- wall-clock: {result['rounds_per_sec']} rounds/sec
- raw per-round metrics: `{args.metrics_out}`

Accuracy curve (round:acc): {curve}

Reproduce with: `python -m fedml_tpu_torch.exp.repro_femnist_lr --out REPORT.md`
""")


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    from fedml_tpu_torch.algorithms.robust import add_cli_flags as add_robust_cli_flags
    from fedml_tpu_torch.exp.repro_femnist_cnn import add_pack_flags
    from fedml_tpu_torch.obs.trace import add_cli_flag as add_trace_cli_flag
    from fedml_tpu_torch.population import add_cli_flags as add_population_cli_flags

    parser.add_argument("--data_dir", type=str, default="./data/femnist_lr")
    parser.add_argument("--client_num_in_total", type=int, default=200)
    parser.add_argument("--client_num_per_round", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=10)
    parser.add_argument("--lr", type=float, default=0.003)
    parser.add_argument("--comm_round", type=int, default=400)
    parser.add_argument("--frequency_of_the_test", type=int, default=10)
    add_pack_flags(parser)
    add_trace_cli_flag(parser)
    add_robust_cli_flags(parser)
    add_population_cli_flags(parser)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--metrics_out", type=str, default=None,
                        help="JSONL file of the round records (none by default)")
    parser.add_argument("--out", type=str, default=None,
                        help="markdown report to write (none by default)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    return parser


def main(argv=None):
    args = add_args(argparse.ArgumentParser("femnist+lr baseline repro")).parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
