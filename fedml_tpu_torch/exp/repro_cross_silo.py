"""The cross-silo flagship table on one card, the port of
``fedml_tpu/exp/repro_cross_silo.py``: the six dataset x model combos,
{cifar10, cifar100, cinic10} x {resnet56, mobilenet}, selected by
``--dataset`` / ``--model``.

Reference recipe (benchmark/README.md:102-110; BASELINE.md cross-silo table):
10 silo-clients, B=64, SGD lr .001 wd .001, E=20 local epochs, 100 rounds,
non-IID Dirichlet alpha=0.5 (published, IID/non-IID: 93.19/87.12,
68.91/64.70, 82.57/73.49, 91.12/86.32, 55.12/53.54, 79.95/71.23). The model
trains in bf16 compute with f32 parameters, BatchNorm statistics federated
with the weights, and crop/flip/cutout augmentation on the device. The
cohort trains in ``cohort_execution="vmap"``, MobileNet in ``"scan"``
(:func:`resolve_cohort_execution`). The JAX clients x silo mesh is 1 x 1 on
one card, so the run is ``FedSim`` on one device.

Data: the real files when ``--data_dir`` holds them; otherwise an offline
fixture in the dataset's exact on-disk format (CIFAR-10 and CIFAR-100
pickles, CINIC-10 PNG folders; each writer byte-identical to the JAX
package's for the same arguments) read through the real reader
(``data/cv.py``). On a fixture, ``--ceiling_epochs`` > 0 trains the same
model centrally on the pooled fixture (``exp/repro_ceilings.py``
``centralized_ceiling``) and reports the federated best as a share of it.

Departures from the JAX entry point:

- ``--out`` defaults to no report and ``--metrics_out`` to no file: the JAX
  defaults write ``REPRO.md`` and ``repro_cross_silo_metrics.jsonl``, files
  of the JAX package's own runs;
- ``--device`` (default ``cuda``) names the device; with no card the run
  raises unless ``--device cpu``.

Usage: python -m fedml_tpu_torch.exp.repro_cross_silo --partition_method hetero
"""

from __future__ import annotations

import argparse
import logging
import pickle
from pathlib import Path

import numpy as np

from fedml_tpu_torch.data import fixture_util


def write_cifar10_fixture(out_dir: str | Path, n_train: int = 50_000,
                          n_test: int = 10_000, seed: int = 0,
                          signal: float = 1.0) -> Path:
    """Write class-blob images in the real CIFAR-10 batch format
    (5 x data_batch_i + test_batch pickles of uint8 [N, 3072] rows).

    ``signal`` scales class separation: pixels are
    ``0.5 + signal * (center - 0.5) + N(0, 0.25)``, so signal=1.0 is a
    trivially separable fixture and small values (~0.04) leave genuine class
    overlap, keeping a 100-round curve below its ceiling.

    Idempotency, real-data preservation, and stale regeneration follow the
    shared :mod:`fedml_tpu_torch.data.fixture_util` contract; data files land
    via tmp+rename so a crash mid-generation never leaves a half-fixture that
    a matching marker would pin forever."""
    sub = "cifar-10-batches-py"
    names = [f"{sub}/data_batch_{i}" for i in range(1, 6)] + [f"{sub}/test_batch"]
    out = Path(out_dir) / sub
    if not fixture_util.prepare(
        out_dir, "cifar10",
        {"n_train": n_train, "n_test": n_test, "seed": seed,
         "signal": signal}, names,
    ):
        return out
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    centers = rng.rand(10, 32, 32, 3).astype(np.float32)

    def make(n):
        y = rng.randint(0, 10, n).astype(np.int64)
        x = np.clip(0.5 + signal * (centers[y] - 0.5)
                    + rng.normal(0, 0.25, (n, 32, 32, 3)), 0, 1)
        # CIFAR layout: uint8 rows of 3072 in CHW order
        rows = (x * 255).astype(np.uint8).transpose(0, 3, 1, 2).reshape(n, 3072)
        return rows, y

    per = n_train // 5
    tmp_final = []
    for name, n in [(f"data_batch_{i}", per) for i in range(1, 6)] + [("test_batch", n_test)]:
        rows, y = make(n)
        tmp = out / (name + ".tmp")
        with open(tmp, "wb") as fh:
            pickle.dump({b"data": rows, b"labels": y.tolist()}, fh)
        tmp_final.append((tmp, out / name))
    # probe file (data_batch_1) LAST: a crash between renames leaves the
    # probe missing, so prepare() regenerates instead of pinning a half-set
    for tmp, final in sorted(tmp_final, key=lambda tf: tf[1].name == "data_batch_1"):
        tmp.rename(final)
    return out


def write_cifar100_fixture(out_dir: str | Path, n_train: int = 50_000,
                           n_test: int = 10_000, seed: int = 0,
                           signal: float = 1.0) -> Path:
    """100-class-blob images in the real CIFAR-100 python format
    (``cifar-100-python/{train,test}`` pickles with ``fine_labels``).
    ``signal`` scales class separation exactly as in
    :func:`write_cifar10_fixture`."""
    sub = "cifar-100-python"
    out = Path(out_dir) / sub
    if not fixture_util.prepare(
        out_dir, "cifar100",
        {"n_train": n_train, "n_test": n_test, "seed": seed,
         "signal": signal},
        [f"{sub}/train", f"{sub}/test"],
    ):
        return out
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    centers = rng.rand(100, 32, 32, 3).astype(np.float32)
    tmp_final = []
    for name, n in (("test", n_test), ("train", n_train)):
        y = rng.randint(0, 100, n).astype(np.int64)
        x = np.clip(0.5 + signal * (centers[y] - 0.5)
                    + rng.normal(0, 0.25, (n, 32, 32, 3)), 0, 1)
        rows = (x * 255).astype(np.uint8).transpose(0, 3, 1, 2).reshape(n, 3072)
        tmp = out / (name + ".tmp")
        with open(tmp, "wb") as fh:
            pickle.dump({b"data": rows, b"fine_labels": y.tolist()}, fh)
        tmp_final.append((tmp, out / name))
    # probe file (train) LAST
    for tmp, final in sorted(tmp_final, key=lambda tf: tf[1].name == "train"):
        tmp.rename(final)
    return out


def write_cinic10_fixture(out_dir: str | Path, n_train_per_class: int = 2_000,
                          n_valid_per_class: int = 500,
                          n_test_per_class: int = 500, seed: int = 0) -> Path:
    """Class-blob 32x32 PNGs in the real CINIC-10 ImageFolder layout
    (``train/valid/test`` x 10 class dirs), written with PIL (imported
    here only).

    Scale is the caller's: the CLI default (``--fixture_train_n 50000``)
    writes 5 000 train + 2x1 000 valid/test PNGs per class, 70k files.
    On a config change the split directories are cleared wholesale (the
    marker guard only tracks the probe file; globbed PNG trees must not mix
    generations)."""
    import shutil

    from PIL import Image

    classes = ["airplane", "automobile", "bird", "cat", "deer",
               "dog", "frog", "horse", "ship", "truck"]
    probe = f"train/{classes[0]}/fx00000.png"
    if not fixture_util.prepare(
        out_dir, "cinic10",
        {"n_train_per_class": n_train_per_class,
         "n_valid_per_class": n_valid_per_class,
         "n_test_per_class": n_test_per_class, "seed": seed},
        [probe],
    ):
        return Path(out_dir)
    for split in ("train", "valid", "test"):
        shutil.rmtree(Path(out_dir) / split, ignore_errors=True)
    rng = np.random.RandomState(seed)
    centers = rng.rand(10, 32, 32, 3).astype(np.float32)
    out = Path(out_dir)
    for split, n_per in (("valid", n_valid_per_class), ("test", n_test_per_class),
                         ("train", n_train_per_class)):
        # the probe file (train/airplane/fx00000.png) must land LAST so a
        # crash mid-generation leaves the probe missing and prepare()
        # regenerates: train is the last split, airplane its last class,
        # fx00000 its last file
        order = classes[1:] + classes[:1] if split == "train" else classes
        for cname in order:
            label = classes.index(cname)
            d = out / split / cname
            d.mkdir(parents=True, exist_ok=True)
            x = np.clip(
                centers[label] + rng.normal(0, 0.25, (n_per, 32, 32, 3)), 0, 1
            )
            arr = (x * 255).astype(np.uint8)
            idxs = range(n_per)
            if split == "train" and cname == classes[0]:
                idxs = reversed(range(n_per))
            for i in idxs:
                Image.fromarray(arr[i]).save(d / f"fx{i:05d}.png")
    return out


# per dataset: the files whose presence means real data a reader accepts
_PROBES = {
    "cifar10": ["cifar-10-batches-py/data_batch_1", "data_batch_1"],
    "cifar100": ["cifar-100-python/train", "train"],
    "cinic10": ["train/airplane", "CINIC-10/train/airplane", "cinic-10/train/airplane"],
}


def resolve_cohort_execution(model: str, explicit: str | None) -> str:
    """Auto cohort mode, as the JAX entry point resolves it: a vmapped
    cohort turns MobileNet's depthwise convolutions into grouped ones with a
    slow weight gradient, so MobileNet trains clients one after another;
    dense-conv models keep the vmapped cohort."""
    if explicit is not None:
        return explicit
    return "scan" if model == "mobilenet" else "vmap"


def run(args) -> dict:
    import torch

    from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
    from fedml_tpu_torch.data.cv import load_cifar
    from fedml_tpu_torch.device import resolve_device
    from fedml_tpu_torch.exp._loop import run_rounds
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.ops.augment import ImageAugment
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    device = resolve_device(args.device)
    args.cohort_execution = resolve_cohort_execution(args.model, args.cohort_execution)
    data_dir = Path(args.data_dir) if args.data_dir else Path(f"./data/{args.dataset}")
    # real = data exists in a layout the reader accepts and no fixture
    # marker claims it
    real = (any((data_dir / p).exists() for p in _PROBES[args.dataset])
            and not fixture_util.is_fixture(data_dir, args.dataset))
    if not real:
        logging.info("no real %s under %s — using offline fixture", args.dataset, data_dir)
        if args.dataset == "cinic10":
            write_cinic10_fixture(
                data_dir, n_train_per_class=args.fixture_train_n // 10,
                n_valid_per_class=args.fixture_test_n // 10,
                n_test_per_class=args.fixture_test_n // 10, seed=args.seed)
        else:
            {"cifar10": write_cifar10_fixture, "cifar100": write_cifar100_fixture}[
                args.dataset](data_dir, n_train=args.fixture_train_n,
                              n_test=args.fixture_test_n, seed=args.seed,
                              signal=args.fixture_signal)

    train, test, class_num = load_cifar(
        args.dataset, data_dir, args.partition_method, args.partition_alpha,
        args.client_num_in_total, args.seed, allow_synthetic=False,
    )
    # the flagship numerics: bf16 compute, f32 params, weight decay on the
    # parameters, augmentation of the training batches (either model)
    model = create_model(args.model, class_num, dtype=torch.bfloat16, device=device)
    trainer = ClientTrainer(module=model, optimizer=sgd(args.lr, weight_decay=args.wd),
                            epochs=args.epochs, augment=ImageAugment())
    cfg = SimConfig(
        client_num_in_total=args.client_num_in_total,
        client_num_per_round=args.client_num_in_total,  # all silos, every round
        batch_size=args.batch_size,
        comm_round=args.comm_round,
        epochs=args.epochs,
        frequency_of_the_test=args.frequency_of_the_test,
        seed=args.seed,
        # per-round dispatch, as the JAX recipe sets it (run_rounds dispatches
        # one round at a time whatever this says)
        block_dispatch=False,
        cohort_execution=args.cohort_execution,
    )
    sim = FedSim(trainer, train, test, cfg, device=device)

    saturation_stop = {"fired": False}

    def _saturated(records):
        # stop once the last 2 evals pin at ~100%: a saturated fixture adds
        # no convergence signal (the stop round is reported)
        if not args.stop_at_saturation:
            return False
        ev = [r["Test/Acc"] for r in records if "Test/Acc" in r]
        if len(ev) >= 2 and min(ev[-2:]) >= 0.995:
            saturation_stop["fired"] = True
            return True
        return False

    records, wall = run_rounds(sim, cfg, args.metrics_out, round_sleep=args.round_sleep,
                               stop_when=_saturated)
    evals = [r for r in records if "Test/Acc" in r]
    if not evals:
        raise RuntimeError("no completed eval rounds — nothing to report")
    best = max(e["Test/Acc"] for e in evals)
    result = {
        "dataset": (f"real {args.dataset}" if real
                    else f"offline {args.dataset}-format fixture"),
        "model": args.model,
        "samples_per_client": train.num_samples // max(train.num_clients, 1),
        "partition": f"{args.partition_method}"
                     + (f"(alpha={args.partition_alpha})"
                        if args.partition_method == "hetero" else ""),
        "clients": args.client_num_in_total,
        "batch_size": args.batch_size,
        "local_epochs": args.epochs,
        "rounds": len(records),
        "rounds_requested": cfg.comm_round,
        "stopped_at_saturation": saturation_stop["fired"],
        "best_test_acc": round(best, 4),
        "final_test_acc": round(evals[-1]["Test/Acc"], 4),
        "rounds_per_sec": round(len(records) / wall, 4),
        "wall_clock_sec": round(wall, 1),
        "mesh": {"clients": 1, "silo": 1},
        "fixture_signal": None if real else args.fixture_signal,
    }
    if not real and args.ceiling_epochs > 0:
        # the fixture's own attainable accuracy: the same model trained
        # centrally on the pooled fixture, from fresh variables
        from fedml_tpu_torch.exp.repro_ceilings import centralized_ceiling

        ceiling, ce = centralized_ceiling(
            trainer, train.arrays, test, args.batch_size, epochs=args.ceiling_epochs,
            seed=args.seed, log_label=f"{args.dataset}+{args.model}", device=device)
        result["fixture_ceiling"] = round(ceiling, 4)
        result["ceiling_epochs"] = ce
        result["pct_of_ceiling"] = round(100 * best / max(ceiling, 1e-9), 1)
    if args.out:
        device_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "the CPU")
        _write_report(Path(args.out), args, result, evals, real, device_name)
    logging.info("cross-silo repro result: %s", result)
    return result


# published cross-silo table (benchmark/README.md:102-110): (IID, non-IID)
_TARGETS = {
    ("cifar10", "resnet56"): (93.19, 87.12),
    ("cifar100", "resnet56"): (68.91, 64.70),
    ("cinic10", "resnet56"): (82.57, 73.49),
    ("cifar10", "mobilenet"): (91.12, 86.32),
    ("cifar100", "mobilenet"): (55.12, 53.54),
    ("cinic10", "mobilenet"): (79.95, 71.23),
}


def _ceiling_lines(result: dict) -> str:
    """Extra Result bullets: fixture ceiling + saturation stop, when known."""
    out = ""
    if result.get("fixture_ceiling") is not None:
        out += (
            f"\n- fixture centralized ceiling (signal="
            f"{result['fixture_signal']}): "
            f"**{result['fixture_ceiling'] * 100:.2f}** "
            f"({result['ceiling_epochs']} early-stopped epochs) -> federated "
            f"best is **{result['pct_of_ceiling']}% of ceiling**"
        )
    if result.get("stopped_at_saturation"):
        out += (
            f"\n- stopped early at round {result['rounds'] - 1}: the last 2 "
            "evals pinned at >=99.5% (fixture saturated — further rounds "
            "carry no convergence signal)"
        )
    return out


def _write_report(path: Path, args, result: dict, evals: list, real: bool,
                  device_name: str) -> None:
    from fedml_tpu_torch.exp._report import acc_curve, update_section

    iid, noniid = _TARGETS[(args.dataset, args.model)]
    target = f"{iid} (IID)" if args.partition_method == "homo" else f"{noniid} (LDA α=0.5)"
    data = (f"Real {args.dataset} data was used." if real else
            f"An offline class-blob fixture in the {args.dataset} on-disk format was used "
            f"({result['samples_per_client']} samples a client, class-separation "
            f"signal={result['fixture_signal']}); its accuracy is not comparable to the "
            "published table.")
    section = ("torch_cross_silo_" + args.partition_method
               if (args.dataset, args.model) == ("cifar10", "resnet56")
               else f"torch_cross_silo_{args.dataset}_{args.model}_{args.partition_method}")
    update_section(path, section, f"""# Cross-silo flagship, PyTorch port ({args.dataset} + {args.model}, {args.partition_method})

Reference target (BASELINE.md / benchmark/README.md:102-110): test acc
**{target}** at 100 rounds — 10 clients, B=64, SGD lr .001 wd .001, E=20.
{data}

| clients | batch | lr | wd | local epochs | rounds | partition | cohort | device |
|---|---|---|---|---|---|---|---|---|
| {result['clients']} | {result['batch_size']} | {args.lr} | {args.wd} | {result['local_epochs']} | {result['rounds']} | {result['partition']} | {args.cohort_execution} | {device_name} |

- best test accuracy: **{result['best_test_acc'] * 100:.2f}**{_ceiling_lines(result)}
- final test accuracy: {result['final_test_acc'] * 100:.2f}
- {result['rounds_per_sec']} rounds/sec ({result['wall_clock_sec']} s in all)
- accuracy curve (round:acc): {acc_curve(evals, points=14)}
""")


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--dataset", type=str, default="cifar10",
                        choices=["cifar10", "cifar100", "cinic10"])
    parser.add_argument("--model", type=str, default="resnet56",
                        choices=["resnet56", "mobilenet"])
    parser.add_argument("--data_dir", type=str, default=None,
                        help="default: ./data/<dataset>")
    parser.add_argument("--fixture_train_n", type=int, default=50_000,
                        help="fixture-only: train samples to generate "
                             "(cinic10: split across classes, valid extra)")
    parser.add_argument("--fixture_signal", type=float, default=0.045,
                        help="fixture class-separation scale: 1.0 = trivially "
                             "separable blobs; ~0.045 leaves real class overlap")
    parser.add_argument("--stop_at_saturation", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="stop when the last 2 evals pin at >=99.5%% "
                             "(saturated fixture; stop round is reported)")
    parser.add_argument("--ceiling_epochs", type=int, default=6,
                        help="centralized-ceiling budget on the fixture "
                             "(0 disables)")
    parser.add_argument("--fixture_test_n", type=int, default=10_000,
                        help="fixture-only: test samples to generate")
    parser.add_argument("--partition_method", type=str, default="hetero",
                        choices=["hetero", "homo"])
    parser.add_argument("--partition_alpha", type=float, default=0.5)
    parser.add_argument("--client_num_in_total", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--wd", type=float, default=0.001)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--comm_round", type=int, default=100)
    parser.add_argument("--frequency_of_the_test", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cohort_execution", type=str, default=None,
                        choices=("vmap", "scan"),
                        help="None = auto: scan for mobilenet, vmap otherwise")
    parser.add_argument("--round_sleep", type=float, default=2.0,
                        help="idle gap between rounds")
    parser.add_argument("--metrics_out", type=str, default=None,
                        help="per-round metrics JSONL (default: none)")
    parser.add_argument("--out", type=str, default=None,
                        help="markdown report to update (default: none)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    args = add_args(argparse.ArgumentParser("cross-silo flagship repro")).parse_args(argv)
    return run(args)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
