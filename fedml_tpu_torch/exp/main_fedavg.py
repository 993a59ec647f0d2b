"""The unified experiment entry point, the port of
``fedml_tpu/exp/main_fedavg.py`` for ``--backend sim``, ``loopback``, ``shm``,
``grpc`` and ``mqtt_s3``.

Every flag of the JAX CLI is here with the same name, dest and default
(reference flag names, fedml_experiments/distributed/fedavg/main_fedavg.py:
46-130), plus ``--device`` (default ``cuda``; ``--device cpu`` runs on the
CPU). Ported: ``--algorithm fedavg``, ``fedprox`` (with the straggler
protocol), ``fedopt`` (``--server_optimizer``, ``--server_lr``,
``--server_momentum``), ``fednova``, ``fedavg_robust`` (``--robust_rule``,
``--norm_bound``, ``--stddev``), ``hierarchical`` (``--group_num``,
``--group_comm_round``) and ``decentralized`` (gossip on a ring of every
client, each training from its own model, all of them every round) on the
sim engine, update compression (``--compressor``, ``--topk_frac``,
``--quantize_bits``, ``--error_feedback``), every model and dataset the port's registries
hold (among them ``--model lr`` on ``mnist``, ``synthetic_*`` and
``stackoverflow_lr``, the ``tag`` task; ``--model cnn`` on ``femnist``;
``--model rnn`` on ``shakespeare``, ``fed_shakespeare`` and
``stackoverflow_nwp``; the CIFAR zoo, ``resnet56``, ``resnet110``,
``resnet18_gn``, ``mobilenet``, ``mobilenet_v3``, ``vgg*`` and
``efficientnet*``, on ``cifar10``, ``cifar100``, ``cinic10`` and
``fed_cifar100``'s fallback; the datasets without their files on the
registry's fixtures), ``--client_optimizer sgd|adam`` with ``--wd`` and ``--momentum``,
``--augment``, ``--eval_on_clients``, ``--stage_on_device`` (0: host
staging), ``--pack_lanes`` and ``--pack_capacity_factor`` (packed lanes),
``--population``, ``--population_trace`` and ``--population_seed`` (the
heterogeneous population), ``--pipeline_depth``, ``--profile_dir``,
``--trace_dir`` (host spans as ``trace.jsonl`` and Chrome JSON),
``--checkpoint_dir`` / ``--checkpoint_every`` / ``--resume`` (round
checkpoints; with ``--checkpoint_every`` the rounds run one dispatch at a
time, so every saved round has its exact state), ``--init_from`` /
``--save_params_to`` (a params file in the JAX package's layout, read and
written by either package), ``--run_dir``/``--enable_wandb`` and ``--cf`` (a YAML
config; it needs PyYAML, imported only when ``--cf`` is given).

``--backend loopback|shm|grpc|mqtt_s3`` runs the message-passing FedAvg
protocol (``algorithms/fedavg_distributed.py``) in one process: a server and
``--client_num_per_round`` client managers exchanging the JAX package's wire
frames over the in-process loopback fabric, the native shm rings, localhost
gRPC (``--grpc_send_timeout``, ``--grpc_send_workers``) or MQTT topics with
the payloads in an object store (``--mqtt_host``/``--mqtt_port``: a broker,
by default the in-process one; ``--object_store_dir``,
``--offload_threshold_bytes``, ``--broadcast_generations``), the clients
training on the card unless ``--device cpu`` is given; ``--algorithm
fedavg``, ``fedprox`` and ``fedavg_robust`` (the streaming robust server,
``--reservoir_k``) with ``--compressor``/``--topk_frac``/
``--quantize_bits``/``--error_feedback``, ``--is_mobile 1`` (the nested-list
JSON format), ``--fault_spec`` (seeded wire faults), ``--population`` (per-rank
upload delays and drops), ``--heartbeat_interval``, ``--init_from``,
``--checkpoint_dir``/``--checkpoint_every``/``--resume`` (server round
checkpoints), ``--send_retries``/``--retry_base_delay``, ``--fleet_stats``
and ``--run_dir``; ``--server_mode async`` (the buffered-async server:
``--buffer_goal``, ``--staleness_weight``) and ``--server_mode tree`` (edge
aggregator tiers: ``--tree_fan_ins``, ``--tree_transport
loopback|shm|grpc``, ``--buffer_goal``, ``--staleness_weight``,
``--tier_timeout``, ``--tier_compressor``); ``--jobs FILE`` (N federations
co-scheduled over one shared loopback wire, ``fedml_tpu_torch/tenancy``).

The JAX CLI's own flag-combination errors are kept as they are; after them,
a flag whose plane is not ported (downlink coding, the multi-GPU mesh)
raises ``NotImplementedError`` naming its ROADMAP item when it is set away
from its default.

    python -m fedml_tpu_torch.exp.main_fedavg --model lr --dataset mnist \\
        --client_num_in_total 1000 --client_num_per_round 10 --batch_size 10
"""

from __future__ import annotations

import argparse
import logging


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    # canonical reference flag set (main_fedavg.py:46-130); the help of a
    # flag whose plane is not ported names its ROADMAP item
    parser.add_argument("--cf", "--config_file", dest="cf", type=str, default=None,
                        help="YAML config file; keys are the flag names below "
                             "(CLI flags override file values); needs PyYAML")
    parser.add_argument("--model", type=str, default="lr")
    parser.add_argument("--dataset", type=str, default="mnist")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--partition_method", type=str, default="hetero")
    parser.add_argument("--partition_alpha", type=float, default=0.5)
    parser.add_argument("--dataidx_map_path", type=str, default=None,
                        help="saved net_dataidx_map file for --partition_method hetero-fix")
    parser.add_argument("--client_num_in_total", type=int, default=10)
    parser.add_argument("--client_num_per_round", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--client_optimizer", type=str, default="sgd",
                        help="sgd, or adam (any other value is adam, as in the JAX CLI)")
    parser.add_argument("--lr", type=float, default=0.03)
    parser.add_argument("--wd", type=float, default=0.0,
                        help="weight decay added to the gradient before the optimizer")
    parser.add_argument("--momentum", type=float, default=0.0)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--comm_round", type=int, default=10)
    parser.add_argument("--frequency_of_the_test", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ci", type=int, default=0)
    parser.add_argument("--is_mobile", type=int, default=0,
                        help="every client speaks the reference's nested-list JSON wire "
                             "format (--backend loopback)")
    parser.add_argument("--backend", type=str, default="sim",
                        choices=["sim", "loopback", "shm", "grpc", "mqtt_s3"],
                        help="sim = the single-device engine; loopback/shm/grpc/mqtt_s3 = "
                             "the message-passing protocol in one process over that "
                             "transport (mqtt_s3: control plane on MQTT topics, model "
                             "payloads through an object store)")
    # message-passing transports beyond loopback
    parser.add_argument("--mqtt_host", type=str, default=None)
    parser.add_argument("--mqtt_port", type=int, default=1883)
    parser.add_argument("--object_store_dir", type=str, default=None)
    parser.add_argument("--offload_threshold_bytes", type=int, default=1 << 14)
    parser.add_argument("--grpc_send_timeout", type=float, default=600.0)
    parser.add_argument("--grpc_send_workers", type=int, default=4)
    # multi-tenant job plane and barrier-free server plane
    parser.add_argument("--jobs", type=str, default=None)
    parser.add_argument("--server_mode", type=str, default="sync",
                        choices=["sync", "async", "tree"])
    parser.add_argument("--buffer_goal", type=int, default=0)
    parser.add_argument("--staleness_weight", type=str, default="const")
    parser.add_argument("--tree_fan_ins", type=str, default=None)
    parser.add_argument("--tree_transport", type=str, default="loopback",
                        choices=["loopback", "shm", "grpc"])
    parser.add_argument("--tier_timeout", type=float, default=0.0)
    parser.add_argument("--tier_compressor", type=str, default=None)
    # algorithm switch (fedall) + algorithm-specific knobs
    parser.add_argument("--algorithm", type=str, default="fedavg",
                        choices=["fedavg", "fedopt", "fedprox", "fednova", "fedgan",
                                 "hierarchical", "decentralized", "fedavg_robust"])
    parser.add_argument("--server_optimizer", type=str, default="adam")
    parser.add_argument("--server_lr", type=float, default=1e-1)
    parser.add_argument("--server_momentum", type=float, default=0.9)
    parser.add_argument("--fedprox_mu", type=float, default=0.1)
    parser.add_argument("--straggler_frac", type=float, default=0.0,
                        help="fraction of each cohort running a reduced uniform 1..E-1 "
                             "local-epoch budget (FedProx straggler protocol)")
    parser.add_argument("--group_num", type=int, default=2)
    parser.add_argument("--group_comm_round", type=int, default=2)
    # robustness knobs (ROADMAP §A10)
    parser.add_argument("--norm_bound", type=float, default=0.0)
    parser.add_argument("--stddev", "--dp_stddev", dest="stddev", type=float, default=0.0)
    parser.add_argument("--robust_rule", type=str, default="mean",
                        choices=["mean", "median", "trimmed_mean", "krum"])
    parser.add_argument("--reservoir_k", type=int, default=0)
    parser.add_argument("--fault_spec", type=str, default=None)
    # fault-tolerant wire runtime (the heartbeat plane is ROADMAP §A11)
    parser.add_argument("--send_retries", type=int, default=0)
    parser.add_argument("--retry_base_delay", type=float, default=0.05)
    parser.add_argument("--heartbeat_interval", type=float, default=0.0)
    # heterogeneous population model (fedml_tpu_torch/population): cohort
    # eligibility, step budgets and mid-round dropout on the sim engine
    from fedml_tpu_torch.population import add_cli_flags as add_population_cli_flags

    add_population_cli_flags(parser)
    # update compression (fedml_tpu_torch/compress) and downlink coding (§A11)
    parser.add_argument("--compressor", type=str, default="none",
                        help="client->server update codec: none | bf16 | topk | q8 | q4, "
                             "composable with '+' (e.g. topk+q4). 'none' keeps the dense "
                             "path; round metrics gain Comm/* bytes-on-wire keys")
    parser.add_argument("--topk-frac", "--topk_frac", dest="topk_frac", type=float,
                        default=0.01, help="fraction of entries the topk codec keeps per leaf")
    parser.add_argument("--quantize_bits", type=int, default=8, choices=[4, 8],
                        help="bit width for the quantize/q* codecs")
    parser.add_argument("--error_feedback", type=int, default=1,
                        help="carry the codec's dropped mass into the next round's update "
                             "(EF-SGD residual)")
    parser.add_argument("--downlink_compressor", type=str, default="none")
    parser.add_argument("--downlink_keyframe_every", type=int, default=8)
    parser.add_argument("--downlink_retention", type=int, default=4)
    parser.add_argument("--broadcast_generations", type=int, default=2)
    # engine knobs
    parser.add_argument("--model_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="compute dtype for models that support one; params stay float32")
    parser.add_argument("--augment", type=int, default=0,
                        help="on-device crop/flip/cutout train augmentation (CIFAR family)")
    parser.add_argument("--eval_on_clients", type=int, default=0,
                        help="also run the per-client server eval at test rounds "
                             "(FedAVGAggregator test_on_server_for_all_clients)")
    parser.add_argument("--stage_on_device", type=int, default=-1,
                        help="-1 auto (on the device up to 2 GiB of training arrays), "
                             "0 host staging, 1 device-resident dataset + on-device gather")
    parser.add_argument("--pack_lanes", type=int, default=0,
                        help="packed-lane cohort execution: bin-pack each round's "
                             "per-client step streams into N fixed-length lanes instead "
                             "of padding every client to the cohort max (on the card each "
                             "pass a CUDA graph replay). 0 = off (padded path); the same "
                             "results either way")
    parser.add_argument("--pack_capacity_factor", type=float, default=1.25,
                        help="lane-length head room over the expected cohort load; "
                             "overflow draws spill to an extra sequential pass")
    parser.add_argument("--mesh_shape", type=str, default=None)
    parser.add_argument("--shard_rules", type=str, default=None)
    parser.add_argument("--pipeline_depth", type=int, default=-1,
                        help="pipelined round driver: -1 auto (depth 1: staging on a "
                             "background thread, metrics fetched a round behind), 0 serial "
                             "driver, N>0 stage up to N rounds ahead; bit-identical results "
                             "either way")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace of the round loop here")
    # observability
    parser.add_argument("--trace_dir", type=str, default=None)
    parser.add_argument("--fleet_stats", type=str, default=None)
    parser.add_argument("--run_dir", type=str, default=None)
    parser.add_argument("--enable_wandb", type=int, default=0)
    parser.add_argument("--checkpoint_dir", type=str, default=None)
    parser.add_argument("--checkpoint_every", type=int, default=0)
    parser.add_argument("--resume", type=int, default=0)
    parser.add_argument("--init_from", type=str, default=None)
    parser.add_argument("--save_params_to", type=str, default=None)
    # the port's own
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    return parser


# flags whose plane the port does not implement yet: dest -> ROADMAP item.
# Setting one away from its default raises (checked after the JAX CLI's own
# flag-combination errors).
_UNPORTED_FLAGS = {
    "downlink_compressor": "§A11.4 (downlink delta coding)",
    "downlink_keyframe_every": "§A11.4 (downlink delta coding)",
    "downlink_retention": "§A11.4 (downlink delta coding)",
    "mesh_shape": "§A12 (multi-GPU)", "shard_rules": "§A12 (multi-GPU)",
}


def build_trainer(args, model, dataset_name: str):
    from fedml_tpu_torch.core.trainer import ClientTrainer, adam, sgd
    from fedml_tpu_torch.models.registry import task_for_dataset

    if args.client_optimizer == "sgd":
        opt = sgd(args.lr, momentum=args.momentum, weight_decay=args.wd)
    else:
        opt = adam(args.lr, weight_decay=args.wd)
    prox = args.fedprox_mu if args.algorithm == "fedprox" else 0.0
    augment = None
    if getattr(args, "augment", 0):
        from fedml_tpu_torch.ops.augment import ImageAugment

        if task_for_dataset(dataset_name) != "classification":
            raise ValueError("--augment is for image classification datasets")
        if dataset_name not in ("cifar10", "cifar100", "cinic10"):
            raise ValueError(
                "--augment currently implements the CIFAR-family pipeline "
                "(pad-4 crop / flip / cutout-16, reference "
                "cifar10/data_loader.py:58-76); compose "
                "fedml_tpu_torch.ops.augment primitives directly for other shapes"
            )
        augment = ImageAugment()
    return ClientTrainer(module=model, task=task_for_dataset(dataset_name), optimizer=opt,
                         epochs=args.epochs, augment=augment, prox_mu=prox)


def build_aggregator(args, train_data):
    from fedml_tpu_torch.algorithms.base import fedavg_aggregator
    from fedml_tpu_torch.algorithms.fednova import fednova_aggregator
    from fedml_tpu_torch.algorithms.fedopt import fedopt_aggregator, server_optimizer
    from fedml_tpu_torch.algorithms.fedprox import fedprox_aggregator
    from fedml_tpu_torch.algorithms.robust import RobustConfig, robust_aggregator

    if args.algorithm == "fedopt":
        return fedopt_aggregator(
            server_optimizer(args.server_optimizer, args.server_lr, args.server_momentum))
    if args.algorithm == "fednova":
        return fednova_aggregator(
            client_lr=args.lr, momentum=args.momentum, mu=0.0, batch_size=args.batch_size,
            epochs=args.epochs, max_client_samples=train_data.max_client_size())
    if args.algorithm == "fedavg_robust":
        return robust_aggregator(RobustConfig(
            norm_bound=args.norm_bound, stddev=args.stddev, rule=args.robust_rule))
    if args.algorithm == "fedprox":
        return fedprox_aggregator()
    if args.algorithm in ("fedavg", "hierarchical"):
        return fedavg_aggregator()
    if args.algorithm == "decentralized":
        from fedml_tpu_torch.algorithms.decentralized import gossip_aggregator
        from fedml_tpu_torch.topology.topology import ring_topology

        return gossip_aggregator(ring_topology(train_data.num_clients))
    if args.algorithm == "fedgan":
        from fedml_tpu_torch.algorithms.fedgan import fedgan_aggregator

        return fedgan_aggregator()
    raise ValueError(f"--algorithm {args.algorithm} has no aggregator")


def _check_flag_combinations(args) -> None:
    """The JAX CLI's own flag-combination errors (``main_fedavg.py:991-
    1169``), kept as they are."""
    if getattr(args, "is_mobile", 0) and args.backend == "sim":
        raise NotImplementedError(
            "--is_mobile 1 selects the JSON wire format, which only exists "
            "on the message-passing backends — pick --backend "
            "loopback|shm|grpc|mqtt_s3"
        )
    if getattr(args, "fault_spec", None) and args.backend == "sim":
        raise NotImplementedError(
            "--fault_spec injects wire faults — there is no wire on "
            "--backend sim; pick --backend loopback|shm|grpc|mqtt_s3"
        )
    if getattr(args, "population_trace", None) and args.backend != "sim":
        raise NotImplementedError(
            "--population_trace replays recorded sim cohorts/step budgets/"
            "dropouts; the message-passing backends take the generative "
            "--population spec (per-rank delay/drop adapter) — use "
            "--backend sim"
        )
    if getattr(args, "population", None) and getattr(args, "fault_spec", None):
        raise NotImplementedError(
            "--population and --fault_spec both drive the seeded wire "
            "fault injector — one schedule would silently shift the "
            "other; pick one"
        )
    if getattr(args, "fleet_stats", None) and args.backend == "sim":
        raise NotImplementedError(
            "--fleet_stats records per-CLIENT wire/health telemetry — on "
            "--backend sim there are no client processes or uploads to "
            "observe; pick --backend loopback|shm|grpc|mqtt_s3 (the sim "
            "engine's observability is --trace_dir, docs/OBSERVABILITY.md)"
        )
    server_mode = getattr(args, "server_mode", "sync")
    if server_mode != "sync":
        if args.backend == "sim":
            raise NotImplementedError(
                f"--server_mode {server_mode} selects a message-passing "
                "server execution mode — there is no server process on "
                "--backend sim; pick --backend loopback|shm|grpc|mqtt_s3"
            )
        if getattr(args, "is_mobile", 0):
            raise NotImplementedError(
                f"--server_mode {server_mode} and --is_mobile both redefine "
                "the server protocol; pick one"
            )
    if server_mode not in ("async", "tree"):
        misapplied = [
            flag for flag, val in [
                ("--buffer_goal", getattr(args, "buffer_goal", 0)),
                ("--staleness_weight",
                 getattr(args, "staleness_weight", "const") != "const"),
            ] if val
        ]
        if misapplied:
            raise NotImplementedError(
                f"not valid with --server_mode {server_mode}: "
                f"{', '.join(misapplied)} (buffered-async fold knobs) — "
                "pick --server_mode async|tree"
            )
    if server_mode != "tree":
        tree_only = [
            flag for flag, val in [
                ("--tree_fan_ins", getattr(args, "tree_fan_ins", None)),
                ("--tree_transport",
                 getattr(args, "tree_transport", "loopback") != "loopback"),
                ("--tier_timeout", getattr(args, "tier_timeout", 0.0)),
                ("--tier_compressor",
                 getattr(args, "tier_compressor", None) is not None),
            ] if val
        ]
        if tree_only:
            raise NotImplementedError(
                f"{', '.join(tree_only)} shape the hierarchical tier plane "
                f"and are ignored under --server_mode {server_mode} — pick "
                "--server_mode tree"
            )
    if server_mode == "tree":
        if args.backend != "loopback":
            raise NotImplementedError(
                "--server_mode tree builds its own comm fabric per tier "
                "cell; the cell transport is --tree_transport "
                "loopback|shm|grpc, not --backend — keep --backend "
                "loopback"
            )
        if args.algorithm == "fedavg_robust":
            raise NotImplementedError(
                "--algorithm fedavg_robust's flat-cohort rules "
                "(median/krum/...) need every upload resident and do not "
                "compose with streaming tiers; the tree's per-tier "
                "clip+DP defense is the harness API "
                "(async_agg.tree.run_tree_fedavg(tier_defense=...)) — "
                "use --server_mode sync|async for fedavg_robust"
            )
        unwired = [
            flag for flag, val in [
                ("--fault_spec", getattr(args, "fault_spec", None)),
                ("--checkpoint_dir", getattr(args, "checkpoint_dir", None)),
                ("--resume", getattr(args, "resume", 0)),
            ] if val
        ]
        if unwired:
            raise NotImplementedError(
                f"{', '.join(unwired)} not wired into --server_mode tree "
                "yet: the tree branch drives its own per-cell harness "
                "(async_agg.tree.run_tree_fedavg), which does not take the "
                "fault-injection/checkpoint planes — use --server_mode "
                "sync|async, or drive the harness API directly "
                "(churn rides --population instead)"
            )
    if (getattr(args, "send_retries", 0)
            or getattr(args, "heartbeat_interval", 0.0)) and args.backend == "sim":
        raise NotImplementedError(
            "--send_retries/--heartbeat_interval configure the "
            "message-passing send/liveness planes — there is no wire on "
            "--backend sim; pick --backend loopback|shm|grpc|mqtt_s3"
        )
    if getattr(args, "downlink_compressor", "none") != "none" \
            and getattr(args, "is_mobile", 0):
        raise NotImplementedError(
            "--downlink_compressor and --is_mobile both redefine the "
            "downlink wire format; pick one"
        )
    if getattr(args, "broadcast_generations", 2) != 2 \
            and args.backend != "mqtt_s3":
        raise NotImplementedError(
            "--broadcast_generations shapes the mqtt_s3 object-store "
            "blob retention; the other backends keep no broadcast blobs "
            "— pick --backend mqtt_s3"
        )
    if (getattr(args, "shard_rules", None)
            or getattr(args, "mesh_shape", None)) and args.backend != "sim":
        raise NotImplementedError(
            "--shard_rules/--mesh_shape configure the sim engine's device "
            "mesh and jitted round programs; the message-passing backends "
            "train whole models per worker — use --backend sim"
        )


def _check_ported(args, defaults: dict) -> None:
    """Raise for a flag of a plane the port does not implement yet, set away
    from its default, naming its ROADMAP item."""
    for dest, item in _UNPORTED_FLAGS.items():
        value = getattr(args, dest)
        if value != defaults[dest]:
            raise NotImplementedError(
                f"--{dest}={value!r} is not ported to fedml_tpu_torch yet: ROADMAP {item}")


def run(args) -> list[dict]:
    """Run the experiment ``args`` describe; returns the round history. With
    ``--trace_dir`` the run is traced (``obs/trace.py`` ``run_traced``)."""
    from fedml_tpu_torch.obs.trace import run_traced

    return run_traced(_run, args)


def build(args):
    """The dataset, model, trainer, rule and ``FedSim`` that ``args``
    describe, as :func:`run` builds them: ``(sim, config)``."""
    from fedml_tpu_torch.data.registry import load_partition_data
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.population import sim_config_fields as population_fields
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    _check_flag_combinations(args)
    _check_ported(args, vars(add_args(argparse.ArgumentParser()).parse_args([])))
    ds = load_partition_data(
        args.dataset, args.data_dir, args.partition_method, args.partition_alpha,
        args.client_num_in_total, args.seed,
        dataidx_map_path=getattr(args, "dataidx_map_path", None),
    )
    model = create_model(args.model, ds.class_num, args.dataset, dtype=args.model_dtype,
                         device=args.device,
                         input_shape=tuple(ds.train.arrays["x"].shape[1:]))
    trainer = build_trainer(args, model, args.dataset)
    aggregator = build_aggregator(args, ds.train)
    # decentralized/gossip: every node participates every round
    per_round = (ds.train.num_clients if args.algorithm == "decentralized"
                 else min(args.client_num_per_round, ds.train.num_clients))
    cfg = SimConfig(
        client_num_in_total=ds.train.num_clients,
        client_num_per_round=per_round,
        batch_size=args.batch_size,
        comm_round=args.comm_round,
        epochs=args.epochs,
        frequency_of_the_test=args.frequency_of_the_test if not args.ci else args.comm_round,
        seed=args.seed,
        straggler_frac=args.straggler_frac,
        eval_on_clients=bool(args.eval_on_clients),
        stage_on_device=None if args.stage_on_device < 0 else bool(args.stage_on_device),
        pipeline_depth=None if args.pipeline_depth < 0 else args.pipeline_depth,
        profile_dir=args.profile_dir,
        pack_lanes=args.pack_lanes,
        pack_capacity_factor=args.pack_capacity_factor,
        compressor=args.compressor,
        topk_frac=args.topk_frac,
        quantize_bits=args.quantize_bits,
        error_feedback=bool(args.error_feedback),
        **population_fields(args),
    )
    if args.algorithm == "fedgan":
        sim = _gan_sim(args, ds, cfg, aggregator)
    else:
        sim = FedSim(trainer, ds.train, ds.test_arrays, cfg, aggregator=aggregator,
                     device=args.device)
    return sim, cfg


def _run(args) -> list[dict]:
    from fedml_tpu_torch.obs.metrics import MetricsLogger, logging_config

    logging_config(0)
    if getattr(args, "jobs", None):
        # the multi-tenant job plane: N federations over one shared wire;
        # the flag combinations are gated before any data/model work, then
        # each job builds its own data/model/trainer from its overlaid flags
        _reject_multijob_conflicts(args)
        _check_ported(args, vars(add_args(argparse.ArgumentParser()).parse_args([])))
        with MetricsLogger(run_dir=args.run_dir, use_wandb=bool(args.enable_wandb)) as metrics:
            return _run_multi_job(args, metrics)
    if args.backend != "sim":
        return _run_message_passing(args)
    sim, cfg = build(args)
    with MetricsLogger(run_dir=args.run_dir, use_wandb=bool(args.enable_wandb)) as metrics:
        if args.algorithm == "hierarchical":
            from fedml_tpu_torch.algorithms.hierarchical import HierarchicalFedAvg, HierConfig

            hier = HierarchicalFedAvg(sim, HierConfig(
                group_num=args.group_num, global_comm_round=args.comm_round,
                group_comm_round=args.group_comm_round))
            return hier.run(callback=metrics.log)[1]
        return _run_checkpointed(args, sim, cfg, metrics)


def _wire_eval_fn(trainer, test_arrays, eval_batch_size: int = 256):
    """Full-test-set eval of a global model (the message-passing harness's
    per-round eval, the JAX CLI's ``_make_eval_fn``): ``ev(variables) ->
    (acc, loss)``, None without a test split. It runs on the trainer's
    module under the wire clients' ``TRAIN_LOCK``, so a straggler's local
    round cannot interleave with it."""
    if test_arrays is None:
        return None
    import torch

    from fedml_tpu_torch.algorithms.fedavg_distributed import TRAIN_LOCK
    from fedml_tpu_torch.core.trainer import make_local_eval
    from fedml_tpu_torch.sim.cohort import batch_array

    device = next(trainer.module.parameters()).device
    batches = {k: torch.from_numpy(v).to(device)
               for k, v in batch_array(test_arrays, eval_batch_size).items()}
    local_eval = make_local_eval(trainer)

    def ev(variables):
        with TRAIN_LOCK:
            s = local_eval(variables, batches)
        tot = torch.clamp(s["test_total"], min=1.0)
        return float(s["test_correct"] / tot), float(s["test_loss"] / tot)

    return ev


def _run_message_passing(args) -> list[dict]:
    """Drive the message-passing FedAvg protocol (typed array messages,
    server + worker managers) over the selected transport (the JAX CLI's
    ``_run_message_passing``, ``main_fedavg.py:436-733``): rank threads in
    one process on loopback queues, native shm rings, localhost gRPC or
    MQTT + object store, the clients training on ``--device``."""
    import functools
    import json
    import os

    from fedml_tpu_torch.algorithms.fedavg_distributed import (
        run_distributed_fedavg_grpc,
        run_distributed_fedavg_loopback,
        run_distributed_fedavg_mqtt_s3,
        run_distributed_fedavg_shm,
    )
    from fedml_tpu_torch.data.registry import load_partition_data
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.obs import checkpoint
    from fedml_tpu_torch.obs.metrics import MetricsLogger

    _check_flag_combinations(args)
    _check_ported(args, vars(add_args(argparse.ArgumentParser()).parse_args([])))
    if args.algorithm not in ("fedavg", "fedprox", "fedavg_robust"):
        raise NotImplementedError(
            f"--backend {args.backend} runs the message-passing FedAvg "
            f"protocol; --algorithm {args.algorithm} is sim-engine only"
        )
    ds = load_partition_data(
        args.dataset, args.data_dir, args.partition_method, args.partition_alpha,
        args.client_num_in_total, args.seed,
        dataidx_map_path=getattr(args, "dataidx_map_path", None),
    )
    model = create_model(args.model, ds.class_num, args.dataset, dtype=args.model_dtype,
                         device=args.device,
                         input_shape=tuple(ds.train.arrays["x"].shape[1:]))
    trainer = build_trainer(args, model, args.dataset)
    worker_num = min(args.client_num_per_round, ds.train.num_clients)
    freq = args.frequency_of_the_test if not args.ci else args.comm_round
    ev = _wire_eval_fn(trainer, ds.test_arrays)
    comm_stats: dict = {}
    robust_stats: dict = {}
    async_stats: dict = {}
    tier_stats: dict = {}
    history: list[dict] = []
    metrics = MetricsLogger(run_dir=args.run_dir, use_wandb=bool(args.enable_wandb))

    def on_round(r, variables):
        rec = {"round": r}
        # the server's accountant flushes the round's Comm/* record into
        # comm_stats just before this callback fires; ditto the robust
        # tally's Robust/* record and the async server's per-emission
        # Async/* record
        for crec in (comm_stats.get("rounds", []) + robust_stats.get("rounds", [])
                     + async_stats.get("rounds", [])):
            if crec.get("round") == r:
                rec.update({k: v for k, v in crec.items() if k != "round"})
        if ev is not None and ((r + 1) % freq == 0 or r == args.comm_round - 1):
            acc, loss = ev(variables)
            rec.update({"Test/Acc": acc, "Test/Loss": loss})
        history.append(rec)
        metrics.log(rec, round_idx=r)

    runners = {
        "loopback": run_distributed_fedavg_loopback,
        "shm": run_distributed_fedavg_shm,
        "grpc": functools.partial(run_distributed_fedavg_grpc,
                                  send_timeout=args.grpc_send_timeout,
                                  send_workers=args.grpc_send_workers),
        "mqtt_s3": functools.partial(run_distributed_fedavg_mqtt_s3,
                                     store_dir=args.object_store_dir,
                                     mqtt_host=args.mqtt_host, mqtt_port=args.mqtt_port,
                                     threshold_bytes=args.offload_threshold_bytes,
                                     broadcast_generations=args.broadcast_generations),
    }
    kwargs: dict = {}
    if args.algorithm == "fedavg_robust":
        from fedml_tpu_torch.algorithms.robust_distributed import RobustDistConfig

        kwargs.update(robust_config=RobustDistConfig(
            rule=args.robust_rule, norm_bound=args.norm_bound, dp_stddev=args.stddev,
            dp_seed=args.seed, reservoir_k=args.reservoir_k), robust_stats=robust_stats)
    if args.fault_spec:
        kwargs.update(fault_specs=args.fault_spec, fault_seed=args.seed)
    if args.population:
        # the spec's distributions become per-rank upload delays/drops
        from fedml_tpu_torch.population import population_fault_specs

        kwargs["population"] = population_fault_specs(
            args.population, worker_num,
            seed=args.seed if args.population_seed is None else args.population_seed)
    if args.heartbeat_interval:
        kwargs["heartbeat_interval"] = args.heartbeat_interval
    if args.send_retries:
        from fedml_tpu_torch.comm.retry import RetryPolicy

        kwargs["retry_policy"] = RetryPolicy(max_attempts=1 + args.send_retries,
                                             base_delay=args.retry_base_delay)
        kwargs["comm_stats"] = comm_stats
    if args.checkpoint_dir:
        kwargs.update(checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=max(1, args.checkpoint_every or 1),
                      resume=bool(args.resume))
    if args.compressor != "none":
        if args.is_mobile:
            raise NotImplementedError(
                "--compressor and --is_mobile both redefine the wire format; pick one")
        from fedml_tpu_torch.compress import make_codec

        kwargs.update(codec=make_codec(args.compressor, topk_frac=args.topk_frac,
                                       quantize_bits=args.quantize_bits),
                      error_feedback=bool(args.error_feedback), comm_stats=comm_stats)
    if args.is_mobile:
        # every client is a phone: all model payloads cross as JSON
        from fedml_tpu_torch.algorithms.fedavg_mobile import mobile_runner_kwargs

        kwargs.update(mobile_runner_kwargs(set(range(1, worker_num + 1))))
    fleet_stats: dict | None = {} if args.fleet_stats else None
    if fleet_stats is not None:
        kwargs["fleet_stats"] = fleet_stats
    overrides = None
    if args.init_from:
        overrides = checkpoint.load_params(args.init_from)
        logging.info("warm-starting from %s", args.init_from)
    try:
        if args.server_mode == "tree":
            final_variables = _run_tree(args, trainer, ds, worker_num, on_round, overrides,
                                        kwargs, comm_stats, tier_stats)
        else:
            if args.server_mode == "async":
                kwargs.update(server_mode="async", buffer_goal=args.buffer_goal or None,
                              staleness_weight=args.staleness_weight,
                              async_stats=async_stats)
            final_variables = runners[args.backend](
                trainer, ds.train, worker_num=worker_num, round_num=args.comm_round,
                batch_size=args.batch_size, seed=args.seed, on_round_done=on_round,
                init_overrides=overrides, **kwargs)
    finally:
        metrics.close()
    if comm_stats.get("totals"):
        logging.info("bytes on wire: %s", comm_stats["totals"])
    if async_stats.get("totals"):
        logging.info("async server: %s", async_stats["totals"])
    if tier_stats.get("totals"):
        logging.info("edge tiers: %s", tier_stats["totals"])
    if fleet_stats is not None:
        from fedml_tpu_torch.obs.registry import FLEET_JSONL_NAME

        os.makedirs(args.fleet_stats, exist_ok=True)
        with open(os.path.join(args.fleet_stats, FLEET_JSONL_NAME), "w") as f:
            for rec in fleet_stats.get("rounds", []):
                f.write(json.dumps(rec) + "\n")
        with open(os.path.join(args.fleet_stats, "fleet.json"), "w") as f:
            json.dump({"totals": fleet_stats.get("totals"),
                       "registry": fleet_stats.get("registry"),
                       "rounds_recorded": len(fleet_stats.get("rounds", []))}, f)
        logging.info("fleet telemetry written to %s", args.fleet_stats)
    if args.save_params_to:
        saved = checkpoint.save_params(args.save_params_to, final_variables)
        logging.info("saved final model variables to %s", saved)
    return history


def _run_tree(args, trainer, ds, worker_num, on_round, overrides, kwargs, comm_stats,
              tier_stats):
    """``--server_mode tree`` (the JAX CLI's tree branch, ``main_fedavg.py:
    610-675``): hierarchical aggregation, its process topology a tree of comm
    cells over ``--tree_transport``; the flat runner's population, retry,
    heartbeat, codec and fleet planes ride along, the leaves training on
    ``--device``."""
    from fedml_tpu_torch.async_agg.tree import (
        GrpcGroupComm,
        TreeTopology,
        run_tree_fedavg_loopback,
        run_tree_fedavg_shm,
    )

    fan_ins = (tuple(int(f) for f in args.tree_fan_ins.split(","))
               if args.tree_fan_ins else (1, worker_num))
    topo = TreeTopology(fan_ins)
    if topo.leaf_count != worker_num:
        raise ValueError(
            f"--tree_fan_ins {fan_ins} has {topo.leaf_count} leaves but "
            f"--client_num_per_round is {worker_num}; the "
            "leaves ARE the per-round cohort"
        )
    logging.info("tree mode: fan-ins %s (%d leaves, %d edge tiers)",
                 fan_ins, topo.leaf_count, topo.tier_count)
    tree_kwargs: dict = {"tier_stats": tier_stats, "comm_stats": comm_stats}
    if args.buffer_goal:
        tree_kwargs["buffer_goal"] = args.buffer_goal
    if args.staleness_weight != "const":
        tree_kwargs["tier_staleness"] = args.staleness_weight
    if args.tier_timeout:
        tree_kwargs["tier_timeout"] = args.tier_timeout
    if args.tier_compressor is not None:
        tree_kwargs["tier_uplink_codec"] = args.tier_compressor
    if "codec" in kwargs:
        # the flat runners' client codec, applied at the leaf edges (each
        # decodes its children's encoded deltas into the model domain)
        tree_kwargs["client_codec"] = kwargs["codec"]
        tree_kwargs["client_error_feedback"] = kwargs["error_feedback"]
    if "population" in kwargs:
        # one churn trace over the whole hierarchy, by global leaf number
        tree_kwargs["population"] = kwargs["population"]
        tree_kwargs["fault_seed"] = kwargs["population"].seed
    for k in ("retry_policy", "heartbeat_interval", "fleet_stats"):
        if k in kwargs:
            tree_kwargs[k] = kwargs[k]
    if args.tree_transport == "shm":
        runner = run_tree_fedavg_shm
    else:
        runner = run_tree_fedavg_loopback
        if args.tree_transport == "grpc":
            tree_kwargs["make_group_comm"] = GrpcGroupComm(
                base_port=getattr(args, "grpc_base_port", 8890))
    return runner(trainer, ds.train, topo, args.comm_round, args.batch_size, seed=args.seed,
                  on_round_done=on_round, init_overrides=overrides, **tree_kwargs)


# per-job override keys the --jobs entries may carry (the JAX CLI's): the
# core training / codec / defense flags; everything else stays single-job
# and is rejected in _reject_multijob_conflicts, never silently dropped
_JOBS_OVERRIDE_KEYS = frozenset({
    "model", "dataset", "data_dir", "partition_method", "partition_alpha",
    "dataidx_map_path", "client_num_in_total", "client_num_per_round",
    "batch_size", "client_optimizer", "lr", "wd", "momentum", "epochs",
    "comm_round", "frequency_of_the_test", "seed", "algorithm",
    "fedprox_mu", "robust_rule", "norm_bound", "stddev", "reservoir_k",
    "compressor", "topk_frac", "quantize_bits", "error_feedback",
    "downlink_compressor", "downlink_keyframe_every", "downlink_retention",
    "model_dtype",
})


def _reject_multijob_conflicts(args) -> None:
    """Flag-combination gate for --jobs (the JAX CLI's, ``main_fedavg.py:
    753-795``): fail before any data/model work."""
    if args.backend != "loopback":
        raise NotImplementedError(
            "--jobs co-schedules every job's federation over ONE shared "
            "endpoint with job-id demux (fedml_tpu_torch/tenancy); only the "
            "loopback transport has the shared-fabric wiring — pick "
            "--backend loopback"
        )
    if getattr(args, "server_mode", "sync") != "sync":
        raise NotImplementedError(
            f"--server_mode {args.server_mode} reshapes the single server "
            "plane the jobs share; --jobs runs each job's sync round "
            "protocol — pick --server_mode sync"
        )
    if getattr(args, "is_mobile", 0):
        raise NotImplementedError(
            "--is_mobile selects the JSON nested-list wire format, which "
            "is not wired through the shared job plane; pick one"
        )
    unwired = [
        flag for flag, val in [
            ("--fault_spec", getattr(args, "fault_spec", None)),
            ("--population", getattr(args, "population", None)),
            ("--send_retries", getattr(args, "send_retries", 0)),
            ("--heartbeat_interval", getattr(args, "heartbeat_interval", 0.0)),
            ("--checkpoint_dir", getattr(args, "checkpoint_dir", None)),
            ("--resume", getattr(args, "resume", 0)),
            ("--init_from", getattr(args, "init_from", None)),
            ("--save_params_to", getattr(args, "save_params_to", None)),
        ] if val
    ]
    if unwired:
        raise NotImplementedError(
            f"{', '.join(unwired)} not wired into --jobs yet: the "
            "multi-tenant entry wires the training/codec/defense planes "
            "per job — drive tenancy.run_multi_job(run_kwargs=...) "
            "directly for the fault/retry/liveness/checkpoint planes"
        )


def _multijob_run_kwargs(overlay):
    """One job's composition kwargs for run_distributed_fedavg (the --jobs
    subset of the single-job harness planes: the uplink codec and the robust
    defense; a job's downlink delta coding raises, naming ROADMAP §A11.4).
    Returns (run_kwargs, stats_dicts), each stats dict filling with
    per-round records to merge into the job's metric stream."""
    run_kwargs: dict = {}
    comm_stats: dict = {}
    robust_stats: dict = {}
    if getattr(overlay, "compressor", "none") != "none":
        from fedml_tpu_torch.compress import make_codec

        run_kwargs.update(
            codec=make_codec(overlay.compressor, topk_frac=overlay.topk_frac,
                             quantize_bits=overlay.quantize_bits),
            error_feedback=bool(overlay.error_feedback),
            comm_stats=comm_stats,
        )
    if getattr(overlay, "downlink_compressor", "none") != "none":
        from fedml_tpu_torch.algorithms.fedavg_distributed import _unported

        raise _unported(f"a job's --downlink_compressor {overlay.downlink_compressor!r} "
                        "(downlink delta coding)", "§A11.4")
    if overlay.algorithm == "fedavg_robust":
        from fedml_tpu_torch.algorithms.robust_distributed import RobustDistConfig

        run_kwargs.update(
            robust_config=RobustDistConfig(
                rule=overlay.robust_rule, norm_bound=overlay.norm_bound,
                dp_stddev=overlay.stddev, dp_seed=overlay.seed,
                reservoir_k=getattr(overlay, "reservoir_k", 0),
            ),
            robust_stats=robust_stats,
        )
    return run_kwargs, [comm_stats, robust_stats]


def _run_multi_job(args, metrics) -> list[dict]:
    """--jobs harness (the JAX CLI's ``_run_multi_job``, ``main_fedavg.py:
    845-966``): load the JSON job list, build each job's data/model/trainer
    from the overlaid flags on ``--device``, and hand the whole set to
    ``tenancy.run_multi_job``: one shared wire, send pool and scheduler.
    Each job's per-round records (Comm/*, Robust/*, Test/* at the job's test
    frequency) are logged tagged with its name; with --fleet_stats DIR the
    runner writes DIR/<job>/fleet.jsonl + DIR/jobs.json."""
    import copy
    import json

    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.data.registry import load_partition_data
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.tenancy import JobSpec, job_key, run_multi_job

    with open(args.jobs) as f:
        entries = json.load(f)
    if not isinstance(entries, list) or not entries:
        raise ValueError(
            f"--jobs {args.jobs}: expected a non-empty JSON list of job "
            "objects (docs/MULTITENANCY.md 'Job specs')"
        )
    specs: list = []
    hist_by_job: dict[str, list[dict]] = {}
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict):
            raise ValueError(f"--jobs entry {i} is not a JSON object: {entry!r}")
        entry = dict(entry)
        # the spec field is spelled like the wire header the name becomes
        job_id = entry.pop(Message.MSG_ARG_KEY_JOB_ID, None)
        if job_id is None and len(entries) > 1:
            raise ValueError(
                f"--jobs entry {i} has no job_id — with more than one job "
                "every entry needs a unique name on the shared wire"
            )
        unknown = sorted(set(entry) - _JOBS_OVERRIDE_KEYS)
        if unknown:
            raise ValueError(
                f"--jobs entry {i} ({job_key(job_id)}): unknown override "
                f"keys {unknown}; supported: {sorted(_JOBS_OVERRIDE_KEYS)}"
            )
        overlay = copy.copy(args)
        for k, v in entry.items():
            setattr(overlay, k, v)
        if overlay.algorithm not in ("fedavg", "fedprox", "fedavg_robust"):
            raise NotImplementedError(
                f"--jobs entry {job_key(job_id)}: --algorithm "
                f"{overlay.algorithm} is sim-engine only; the job plane "
                "runs the message-passing protocol (fedavg | fedprox | "
                "fedavg_robust)"
            )
        run_kwargs, stats_dicts = _multijob_run_kwargs(overlay)
        ds = load_partition_data(
            overlay.dataset, overlay.data_dir, overlay.partition_method,
            overlay.partition_alpha, overlay.client_num_in_total, overlay.seed,
            dataidx_map_path=getattr(overlay, "dataidx_map_path", None),
        )
        model = create_model(overlay.model, ds.class_num, overlay.dataset,
                             dtype=overlay.model_dtype, device=args.device,
                             input_shape=tuple(ds.train.arrays["x"].shape[1:]))
        trainer = build_trainer(overlay, model, overlay.dataset)
        name = job_key(job_id)
        history = hist_by_job.setdefault(name, [])
        ev = _wire_eval_fn(trainer, ds.test_arrays)
        freq = max(overlay.frequency_of_the_test if not overlay.ci else overlay.comm_round, 1)
        last = overlay.comm_round - 1

        def on_round(r, variables, name=name, history=history, ev=ev,
                     stats_dicts=stats_dicts, freq=freq, last=last):
            rec = {"job": name, "round": r}
            for stats in stats_dicts:
                for srec in stats.get("rounds", []):
                    if srec.get("round") == r:
                        rec.update({k: v for k, v in srec.items() if k != "round"})
            if ev is not None and ((r + 1) % freq == 0 or r == last):
                acc, loss = ev(variables)
                rec.update({"Test/Acc": float(acc), "Test/Loss": float(loss)})
            history.append(rec)

        specs.append(JobSpec(
            trainer=trainer, train_data=ds.train,
            worker_num=min(overlay.client_num_per_round, ds.train.num_clients),
            round_num=overlay.comm_round, batch_size=overlay.batch_size,
            job_id=job_id, seed=overlay.seed, on_round=on_round,
            fleet=bool(getattr(args, "fleet_stats", None)),
            run_kwargs=run_kwargs,
        ))
    out_dir = getattr(args, "fleet_stats", None)
    logging.info("--jobs: co-scheduling %d jobs (%d workers total) over one shared wire",
                 len(specs), sum(s.worker_num for s in specs))
    results = run_multi_job(specs, out_dir=out_dir)
    history: list[dict] = []
    failed: dict[str, BaseException] = {}
    for spec in specs:
        res = results[spec.name]
        for rec in hist_by_job.get(spec.name, []):
            metrics.log(rec)
            history.append(rec)
        logging.info("job %s: totals %s", spec.name, res.totals)
        if res.error is not None:
            failed[spec.name] = res.error
    if out_dir:
        logging.info("per-job telemetry written to %s (jobs.json + <job>/fleet.jsonl)",
                     out_dir)
    if failed:
        # neighbors' results are already logged above; the CLI still exits
        # nonzero when any tenant failed
        raise RuntimeError(
            f"{len(failed)}/{len(specs)} jobs failed: "
            + "; ".join(f"{n}: {e!r}" for n, e in sorted(failed.items()))
        )
    return history


def _gan_sim(args, ds, cfg, aggregator):
    """The fedgan arm (``main_fedavg.py:1196-1215``): the MNIST GAN pair on
    the dataset's image shape, Adam(lr, b1=0.5) on each network, the
    adversarial round program and no test set."""
    from fedml_tpu_torch.algorithms.fedgan import GANTrainer, make_gan_local_train
    from fedml_tpu_torch.core.trainer import Adam
    from fedml_tpu_torch.models.gan import Discriminator, Generator
    from fedml_tpu_torch.sim.engine import FedSim

    img_shape = tuple(ds.train.arrays["x"].shape[1:])
    gan = GANTrainer(Generator(img_shape=img_shape, device=args.device),
                     Discriminator(img_shape=img_shape, device=args.device),
                     Adam(args.lr, b1=0.5), Adam(args.lr, b1=0.5), epochs=args.epochs)
    return FedSim(gan, ds.train, None, cfg, aggregator=aggregator, device=args.device,
                  local_train_fn=make_gan_local_train(gan))


def _run_checkpointed(args, sim, cfg, metrics) -> list[dict]:
    """The checkpoint-aware run (``main_fedavg.py:1234-1302``): warm start
    from ``--init_from``, ``--resume`` from the latest round checkpoint, then
    the engine's :meth:`~FedSim.run` (blocks, pipelining, profiling), or,
    with ``--checkpoint_every``, one round a dispatch with a checkpoint every
    N rounds; ``--save_params_to`` saves the final model."""
    from fedml_tpu_torch.obs import checkpoint

    ckptr = checkpoint.RoundCheckpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    overrides = None
    if args.init_from:
        overrides = checkpoint.load_params(args.init_from, like=sim.init_variables())
        logging.info("warm-starting from %s", args.init_from)
    variables = sim.init_round_variables(overrides)
    server_state = sim.aggregator.init_state(variables)
    start_round = 0
    history: list[dict] = []
    if args.resume and ckptr is not None and ckptr.latest_round() is not None:
        variables, server_state, start_round, history = ckptr.restore(
            variables, like_server_state=server_state)
        start_round += 1
        logging.info("resumed from round %d", start_round - 1)

    def save_params(final_variables):
        if args.save_params_to:
            saved = checkpoint.save_params(args.save_params_to, sim.consensus(final_variables))
            logging.info("saved final model variables to %s", saved)

    if ckptr is None or not args.checkpoint_every:
        final_variables, run_history = sim.run(
            callback=lambda rec: metrics.log(rec, round_idx=rec["round"]),
            variables=variables, server_state=server_state, start_round=start_round)
        save_params(final_variables)
        return history + run_history
    if cfg.profile_dir:
        logging.warning("--profile_dir is not captured on the checkpointed per-round "
                        "path; run without --checkpoint_every to profile")
    freq = max(cfg.frequency_of_the_test, 1)
    for r in range(start_round, cfg.comm_round):
        variables, server_state, m = sim.run_round(r, variables, server_state)
        rec = {"round": r, **{k: float(v) for k, v in m.items()}}
        if (r + 1) % freq == 0 or r == cfg.comm_round - 1:
            rec.update(sim.eval_record(variables))
        history.append(rec)
        metrics.log(rec, round_idx=r)
        if (r + 1) % args.checkpoint_every == 0:
            ckptr.save(r, variables, server_state, history)
    save_params(variables)
    return history


def parse_with_config(parser: argparse.ArgumentParser, argv=None):
    """Parse argv, honoring ``--cf config.yaml``. File keys are flag names;
    explicit CLI flags override file values; unknown keys fail loudly. The
    file is read with PyYAML, imported only here."""
    args = parser.parse_args(argv)
    if not args.cf:
        return args
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(f"--cf {args.cf}: reading a YAML config needs PyYAML, which is "
                           "not installed; pass the flags on the command line") from e

    with open(args.cf) as f:
        conf = yaml.safe_load(f) or {}
    if not isinstance(conf, dict):
        raise ValueError(f"--cf {args.cf}: top level must be a mapping")
    actions = {a.dest: a for a in parser._actions}
    known = set(vars(args)) - {"cf"}  # no config chaining: cf-in-cf is an error
    unknown = sorted(set(conf) - known)
    if unknown:
        raise ValueError(f"--cf {args.cf}: unknown keys {unknown}")
    coerced = {}
    for key, val in conf.items():
        a = actions[key]
        # apply the type coercion + choices validation the CLI path gets
        # (YAML reads "1e-3" as a string, set_defaults alone would smuggle
        # it past type=float)
        if val is None:
            if a.default is not None:
                raise ValueError(
                    f"--cf {args.cf}: key {key} has no value "
                    f"(flag default is {a.default!r})"
                )
        elif a.type is not None:
            if a.type is int and isinstance(val, float) and int(val) != val:
                raise ValueError(
                    f"--cf {args.cf}: key {key}: {val!r} is not an integer"
                )
            try:
                val = a.type(val)
            except (TypeError, ValueError) as e:
                raise ValueError(f"--cf {args.cf}: key {key}: {e}") from None
        if a.choices is not None and val not in a.choices:
            raise ValueError(
                f"--cf {args.cf}: key {key}: {val!r} not in {sorted(a.choices)}"
            )
        coerced[key] = val
    parser.set_defaults(**coerced)
    return parser.parse_args(argv)  # CLI flags still win over file values


def main(argv=None):
    parser = add_args(argparse.ArgumentParser("fedml_tpu_torch unified entry"))
    args = parse_with_config(parser, argv)
    history = run(args)
    final = history[-1] if history else {}
    logging.info("final: %s", final)
    return final


if __name__ == "__main__":
    main()
