"""Rank programs that hold a multi-rank run to its one-rank counterpart.

Each function takes the rank's device and a plain spec (dicts, numpy arrays
and paths, which pickle), builds what the spec names, runs it on this rank
and returns numpy results. Run in-process without a world, a function is
the one-rank run; under :func:`~fedml_tpu_torch.parallel.launch.launch`
every rank of the world runs it on its mesh. The CPU tests and the card's
smoke script compare the two:

- :func:`run_sim` — a ``FedSim`` over the world's client (or clients x
  silo) mesh: final variables in the JAX leaf order, the history, what the
  collectives moved and the flash kernels' launches;
- :func:`silo_local_train` — ``algorithms.cross_silo.make_silo_local_train``
  on this rank's rows of a silo's batches;
- :func:`sync_batchnorm` — ``ops.syncbn.SyncBatchNorm``'s forward and
  backward on this rank's rows of a batch;
- :func:`cross_silo_entry` — the cross-silo flagship through its entry
  point, ``exp/repro_cross_silo.run``, which lays its mesh over the world;
- :func:`world_probe` — one all-reduce over the world's own backend;
- :func:`shard_roundtrip` — ``dispatch.shard`` and ``unshard`` of a state
  dict by a rule set;
- :func:`head_parallel` — ``ops.attention.flash_attention_head_parallel``
  on this rank's heads of a ``clients x model`` mesh's model axis;
- :func:`ring_attention_check` — ``parallel.ring_attention`` on this
  rank's block of a sequence, forward and gradients;
- :func:`sp_lm_step` — ``parallel.sequence.make_sp_lm_train_step``, one
  step of a ring-attention LM on this rank's block of the tokens;
- :func:`run_jobs` — several of these in one launch, in order.

:func:`run_sim` takes the sharded plans too (``config``'s ``mesh_shape``
and ``shard_rules``: the engine lays the mesh over the world).
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from fedml_tpu_torch.parallel import collectives
from fedml_tpu_torch.parallel import mesh as meshlib

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


def save_federated(path, train, test: dict | None) -> None:
    """A ``FederatedArrays`` and a test set in one npz (the ranks of a
    launch load it instead of re-reading the dataset's files)."""
    arrays = {f"train/{k}": np.asarray(v) for k, v in train.arrays.items()}
    arrays.update({f"part/{c}": np.asarray(ix) for c, ix in train.partition.items()})
    arrays.update({f"test/{k}": np.asarray(v) for k, v in (test or {}).items()})
    np.savez(path, **arrays)


def load_federated(path):
    """``(FederatedArrays, test arrays or None)`` of :func:`save_federated`."""
    from fedml_tpu_torch.sim.cohort import FederatedArrays

    with np.load(path) as z:
        train = {k[6:]: z[k] for k in z.files if k.startswith("train/")}
        part = {int(k[5:]): z[k] for k in z.files if k.startswith("part/")}
        test = {k[5:]: z[k] for k in z.files if k.startswith("test/")}
    return FederatedArrays(train, dict(sorted(part.items()))), (test or None)


def build_model(spec: dict, device) -> torch.nn.Module:
    """``spec["model"]`` = ``(name, class_num, kwargs)``: a registry name
    (``models.registry.create_model``) or ``"cifar_resnet"`` (a
    ``CifarResNet`` of ``kwargs["depth"]``); ``kwargs["dtype"]`` a dtype
    name, ``"float64"`` the whole model in float64."""
    from fedml_tpu_torch.models.registry import create_model, to_float64
    from fedml_tpu_torch.models.resnet import CifarResNet

    name, class_num, kwargs = spec["model"]
    kwargs = dict(kwargs)
    dtype_name = kwargs.pop("dtype", "float32")
    dtype = torch.float32 if dtype_name == "float64" else _DTYPES[dtype_name]
    if name == "cifar_resnet":
        model = CifarResNet(num_classes=class_num, dtype=dtype, device=device, **kwargs)
    else:
        model = create_model(name, class_num, dtype=dtype, device=device, **kwargs)
    return to_float64(model) if dtype_name == "float64" else model


def build_trainer(spec: dict, device):
    """``spec["trainer"]``: ``task``, ``optimizer`` (``("sgd", lr, momentum,
    wd)`` or ``("adam", lr, wd)``), ``epochs``, ``augment`` (bool),
    ``prox_mu``."""
    from fedml_tpu_torch.core.trainer import ClientTrainer, adam, sgd
    from fedml_tpu_torch.ops.augment import ImageAugment

    t = spec["trainer"]
    kind, *opt_args = t["optimizer"]
    optimizer = sgd(*opt_args) if kind == "sgd" else adam(*opt_args)
    return ClientTrainer(module=build_model(spec, device), task=t.get("task", "classification"),
                         optimizer=optimizer, epochs=t.get("epochs", 1),
                         prox_mu=t.get("prox_mu", 0.0),
                         augment=ImageAugment() if t.get("augment") else None)


def _mesh(spec: dict):
    """The world's ``clients x silo`` mesh of silo-group size
    ``spec["silo"]``; without a world, one rank."""
    from fedml_tpu_torch.parallel.multihost import global_client_mesh

    return global_client_mesh(silo=spec.get("silo", 1) if len(meshlib.world_ranks()) > 1
                              else 1)


def _numpy(tree: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def _counted(device, fn, *args):
    """``fn(*args)`` timed to the device's end, with what the collectives
    moved and the flash kernels' launches in it (and, beside the kernels'
    own counters, the head count of each launch on the card), the warnings
    it logged (each text once); ``started_at`` is the start on the host's
    wall clock (to order it against other processes)."""
    import collections
    import logging

    from fedml_tpu_torch.ops import attention

    collectives.TRAFFIC.reset()
    attention.FLASH_FWD_F32_LAUNCHES = attention.FLASH_FWD_BF16_LAUNCHES = 0
    heads: collections.Counter = collections.Counter()
    launch_kernel = attention.flash_fwd_cuda

    def recorded(q, *rest):
        heads[int(q.shape[1])] += 1
        return launch_kernel(q, *rest)

    warnings: list[str] = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warnings.append(record.getMessage())
    logging.getLogger().addHandler(handler)
    attention.flash_fwd_cuda = recorded
    try:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        started_at, t0 = time.time(), time.perf_counter()
        out = fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        attention.flash_fwd_cuda = launch_kernel
        logging.getLogger().removeHandler(handler)
    return out, {"seconds": time.perf_counter() - t0, "started_at": started_at,
                 "traffic": collectives.TRAFFIC.snapshot(),
                 "flash": (attention.FLASH_FWD_F32_LAUNCHES, attention.FLASH_FWD_BF16_LAUNCHES),
                 "heads_per_launch": dict(heads), "warnings": sorted(set(warnings))}


def run_sim(device, spec: dict) -> dict:
    """A ``FedSim`` of ``spec`` on this rank's device over the world's mesh
    (``spec["silo"]``: the silo-group size, default 1), from
    ``spec["init"]`` (a state dict of numpy arrays) or from the seed.
    ``spec["data"]``: an npz path (:func:`save_federated`) or ``(train
    arrays, partition, test arrays)``; ``spec["config"]``: ``SimConfig``
    fields (``mesh_shape`` and ``shard_rules`` too); ``spec["gossip_ring"]``:
    the per-client mode, gossip over a ring of the config's clients;
    ``spec["flat_file"]``: a path prefix, under which the rank saves the
    flat view (``<prefix>.rank<r>.npy``) in place of returning the
    variables."""
    from fedml_tpu_torch.parallel.multihost import flatten_variables
    from fedml_tpu_torch.sim.cohort import FederatedArrays
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    data = spec["data"]
    if isinstance(data, str):
        train, test = load_federated(data)
    else:
        arrays, part, test = data
        train = FederatedArrays(arrays, part)
    trainer = build_trainer(spec, device)
    cfg = SimConfig(**spec["config"])
    aggregator = None
    if spec.get("gossip_ring"):
        from fedml_tpu_torch.algorithms.decentralized import gossip_aggregator
        from fedml_tpu_torch.topology.topology import ring_topology

        aggregator = gossip_aggregator(ring_topology(cfg.client_num_in_total))
    # a sharded plan lays its clients x model mesh over the world itself
    mesh = None if cfg.mesh_shape is not None or cfg.shard_rules else _mesh(spec)
    sim = FedSim(trainer, train, test, cfg, aggregator=aggregator, device=device, mesh=mesh)
    init = spec.get("init")
    variables = sim.init_round_variables(
        None if init is None else {k: torch.as_tensor(v) for k, v in init.items()})
    (final, history), counted = _counted(device, sim.run, None, variables)
    out = {"history": [{k: v for k, v in rec.items() if k != "round_time"} for rec in history],
           "round_times": [rec["round_time"] for rec in history], "mesh": sim.mesh.shape,
           "shard_summary": sim.shard_summary(), **counted}
    if spec.get("flat_file"):
        # a large model's flat view goes to a file, not through the launch
        path = f"{spec['flat_file']}.rank{sim.mesh.rank}.npy"
        np.save(path, flatten_variables(final))
        return {**out, "flat_file": path}
    return {**out, "variables": _numpy(final), "flat": flatten_variables(final)}


def silo_local_train(device, spec: dict) -> dict:
    """``make_silo_local_train`` over the world's ``1 x N`` silo mesh on
    this rank's rows of ``spec["batches"]`` (``[S, B, ...]`` numpy arrays),
    from ``spec["init"]``: the trained variables and the train loss."""
    from fedml_tpu_torch.algorithms.cross_silo import make_silo_local_train

    trainer = build_trainer(spec, device)
    mesh = meshlib.silo_mesh(1)
    batches = spec["batches"]
    _, cols = meshlib.cohort_batch_slices(mesh, 1, batches["mask"].shape[1])
    local = {k: torch.as_tensor(np.ascontiguousarray(v[:, cols])).to(device)
             for k, v in batches.items()}
    init = {k: torch.as_tensor(v).to(device) for k, v in spec["init"].items()}
    variables, metrics = make_silo_local_train(trainer, mesh)(init, local)
    return {"variables": _numpy(variables), "train_loss": float(metrics["train_loss"])}


def sync_batchnorm(device, spec: dict) -> dict:
    """``SyncBatchNorm`` in training over the world's ``1 x N`` silo mesh on
    this rank's rows of ``spec["x"]`` (NCHW or ``[N, F]``), with the
    gradients of ``sum(y * spec["dy"])``: ``y`` (this rank's rows), the new
    statistics and the gradients of the scale, the bias and ``x``."""
    from fedml_tpu_torch.ops.syncbn import SyncBatchNorm

    dtype = _DTYPES[spec.get("dtype", "float32")]
    x, dy = spec["x"], spec["dy"]
    mesh = meshlib.silo_mesh(1)
    _, rows = meshlib.cohort_batch_slices(mesh, 1, x.shape[0])
    bn = SyncBatchNorm(x.shape[1], momentum=spec.get("momentum", 0.9), dtype=dtype,
                       device=device).to(dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(spec["scale"]))
        bn.bias.copy_(torch.as_tensor(spec["bias"]))
    xl = torch.as_tensor(x[rows]).to(device, dtype).requires_grad_(True)
    group = mesh.group(meshlib.SILO_AXIS)

    def forward_backward():
        with collectives.bind(meshlib.SILO_AXIS, group):
            y, stats = bn(xl, train=True)
            torch.sum(y * torch.as_tensor(dy[rows]).to(device, dtype)).backward()
        # the parameters' gradients are each rank's share: the silo sums them
        return y, stats, {k: collectives.all_reduce(p.grad, group)
                          for k, p in (("scale", bn.weight), ("bias", bn.bias))}

    (y, (mean, var), grads), counted = _counted(device, forward_backward)
    return {"y": y.detach().cpu().numpy(), "mean": mean.detach().cpu().numpy(),
            "var": var.detach().cpu().numpy(), "dx": xl.grad.cpu().numpy(),
            **{f"d{k}": g.cpu().numpy() for k, g in grads.items()}, **counted}


def cross_silo_entry(device, argv: list) -> dict:
    """``exp/repro_cross_silo.run`` of ``argv`` on this rank (its mesh is
    the world's): its result dict, with the run's seconds, collectives and
    flash launches."""
    from fedml_tpu_torch.exp import repro_cross_silo

    args = repro_cross_silo.add_args(argparse.ArgumentParser()).parse_args(argv)
    result, counted = _counted(device, repro_cross_silo.run, args)
    return {"result": result, **counted}


def world_probe(device, spec: dict) -> dict:
    """One all-reduce of a tensor on this rank's device over the world's
    group, in the world's own backend (NCCL's communicator is formed at its
    first collective): the backend, the world size and the sum of
    ``rank + 1``; then ``collectives``' all-gather and broadcast (from the
    last rank) of ``[rank + 1]`` over the world's group."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    t = torch.full((4,), float(rank + 1), device=device)
    dist.all_reduce(t)
    mine = torch.tensor([float(rank + 1)], device=device)
    group = dist.group.WORLD
    return {"backend": dist.get_backend(), "world": world, "sum": float(t[0]),
            "gather": collectives.all_gather(mine, group).tolist(),
            "broadcast": float(collectives.broadcast(mine, world - 1, group))}


def attention_inputs(spec: dict, device):
    """An attention job's ``q``, ``k``, ``v`` (``[B, H, T, D]``) on
    ``device`` in ``spec["dtype"]`` (default float32): ``spec["q"]``,
    ``["k"]``, ``["v"]`` (numpy), or else three standard normal draws of
    ``spec["shape"]`` on the host from a generator seeded with
    ``spec["seed"]``."""
    if "q" in spec:
        arrays = [torch.as_tensor(spec[k]) for k in ("q", "k", "v")]
    else:
        gen = torch.Generator().manual_seed(spec["seed"])
        arrays = [torch.randn(spec["shape"], generator=gen) for _ in range(3)]
    return [a.to(device, _DTYPES[spec.get("dtype", "float32")]) for a in arrays]


def head_parallel(device, spec: dict) -> dict:
    """``flash_attention_head_parallel`` on this rank's heads of
    :func:`attention_inputs`, on the model axis of
    ``shard_mesh(spec["mesh_shape"])``, causal as ``spec["causal"]``. The
    inputs are laid out as a tensor-parallel ``MultiHeadSelfAttention``
    gives them: this rank's ``[B, T, 3C/M]`` column-parallel qkv output
    split into q, k and v, views of row stride ``3C/M``. Returns this
    rank's block of the output (``[B, T, C/M]``), the strides of its q
    view, the flash launches, the heads of each launch and the warnings the
    call logged."""
    from fedml_tpu_torch.ops import attention

    mesh = meshlib.shard_mesh(spec["mesh_shape"])
    group = mesh.group(meshlib.MODEL_AXIS)
    n = collectives.group_size(group)
    r = mesh.coord(meshlib.MODEL_AXIS)
    qkv = attention_inputs(spec, device)
    b, h, t, d = qkv[0].shape
    c = h * d
    local = torch.cat([a.transpose(1, 2).reshape(b, t, c)[..., r * c // n:(r + 1) * c // n]
                       for a in qkv], dim=-1)
    blocks = local.split(c // n, dim=-1)
    with collectives.bind(meshlib.MODEL_AXIS, group):
        out, counted = _counted(device, functools.partial(
            attention.flash_attention_head_parallel, axis=meshlib.MODEL_AXIS, num_heads=h,
            causal=spec["causal"]), *blocks)
    return {"out": out.float().cpu().numpy(), "rank": r, "ranks": n,
            "q_stride": tuple(blocks[0].stride()), **counted}


def shard_roundtrip(device, spec: dict) -> dict:
    """``spec["state"]`` (a state dict of numpy arrays) cut to this rank's
    blocks by the rule set ``spec["rules"]`` on ``shard_mesh(
    spec["mesh_shape"])`` (``dispatch.shard``) and gathered back
    (``dispatch.unshard``): the blocks and the gathered state."""
    from fedml_tpu_torch.parallel import dispatch, rules

    mesh = meshlib.shard_mesh(spec["mesh_shape"])
    ruleset = rules.rule_set(spec["rules"])
    state = {k: torch.as_tensor(v).to(device) for k, v in spec["state"].items()}
    specs = rules.match_partition_rules(ruleset.rules, state)
    blocks = dispatch.shard_tree(state, specs, mesh, ruleset.groups_of)
    full = dispatch.unshard_tree(blocks, specs, mesh, ruleset.groups_of)
    return {"blocks": _numpy(blocks), "full": _numpy(full),
            "coord": mesh.coord(meshlib.MODEL_AXIS)}


def ring_attention_check(device, spec: dict) -> dict:
    """``ring_attention`` over the world's ``sp`` mesh on this rank's block
    of the sequence of ``spec["q"]``, ``["k"]``, ``["v"]`` (``[B, H, T,
    D]`` numpy), causal as ``spec["causal"]``, with the gradients of
    ``sum(out * spec["dy"])``: this rank's blocks of the output and of dq,
    dk and dv."""
    from fedml_tpu_torch.parallel import sequence
    from fedml_tpu_torch.parallel.ring_attention import ring_attention

    mesh = sequence.sequence_mesh()
    group = mesh.group(sequence.SP_AXIS)
    n = collectives.group_size(group)
    r = mesh.coord(sequence.SP_AXIS) if n > 1 else 0
    t = spec["q"].shape[2] // n
    q, k, v = (a[:, :, r * t:(r + 1) * t].contiguous().requires_grad_(True)
               for a in attention_inputs(spec, device))
    dy = torch.as_tensor(spec["dy"][:, :, r * t:(r + 1) * t]).to(device, q.dtype)

    def forward_backward():
        with collectives.bind(sequence.SP_AXIS, group):
            out = ring_attention(q, k, v, sequence.SP_AXIS, causal=spec["causal"])
            torch.sum(out.float() * dy.float()).backward()
        return out

    out, counted = _counted(device, forward_backward)
    return {"out": out.detach().float().cpu().numpy(), "rank": r,
            **{f"d{name}": a.grad.float().cpu().numpy() for name, a in
               (("q", q), ("k", k), ("v", v))}, **counted}


def sp_lm_step(device, spec: dict) -> dict:
    """One ``make_sp_lm_train_step`` step over the world's ``sp`` mesh:
    ``spec["model"]`` (``TransformerLM`` kwargs, ``attn_impl`` forced to
    ``"ring"``), ``spec["init"]`` (its parameters, numpy; None: the model's
    own seeded initialisation), ``spec["batch"]`` (``x``, ``y``, ``mask``
    ``[B, T]`` numpy) and ``spec["lr"]`` (SGD): the new parameters and the
    loss."""
    from fedml_tpu_torch.core.trainer import sgd
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.parallel import sequence

    kwargs = dict(spec["model"])
    kwargs["dtype"] = _DTYPES[kwargs.get("dtype", "float32")]
    model = TransformerLM(**{**kwargs, "attn_impl": "ring"}, device=device)
    mesh = sequence.sequence_mesh()
    opt = sgd(spec["lr"])
    params = ({k: v.detach() for k, v in model.named_parameters()} if spec.get("init") is None
              else {k: torch.as_tensor(v).to(device) for k, v in spec["init"].items()})
    step = sequence.make_sp_lm_train_step(model, opt, mesh)
    batch = sequence.shard_lm_batch(spec["batch"], mesh, device=device)
    (params, _, loss), counted = _counted(device, step, params, opt.init(params), batch)
    return {"params": _numpy(params), "loss": float(loss), **counted}


def run_jobs(device, jobs: list) -> list:
    """``[(name, spec), ...]``: each function of this module by name, in
    order, on this rank; their results."""
    return [globals()[name](device, spec) for name, spec in jobs]
