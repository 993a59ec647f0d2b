"""The federated-simulation engine, the port of ``fedml_tpu/sim/engine.py``.

One FedAvg round: sample the cohort with the reference's seeded numpy draw,
stage its ``[C, S, B]`` index map, sample-count weights and per-client step
budgets (the FedProx straggler protocol), gather the cohort's batches on the
device from the resident dataset (zero-fill and mask), train the clients from
the broadcast global model, and fold their models (model state included) into
the sample-weighted mean in f32 in cohort order. Both of the JAX engine's
cohort modes are ported:

- ``cohort_execution="vmap"`` (the default, as in the JAX engine): every
  client at once, ``torch.func.vmap`` over the stacked ``[C, ...]``
  variables (``fedml_tpu/sim/engine.py:905-908``);
- ``"scan"``: one client after another, one client's transient state live at
  a time (the mode the JAX LM bench asks for, ``bench.py:166``).

Augmentation draws for a round come from a generator seeded from (seed,
round, client slot), and dropout masks from one seeded from (seed, round,
step), so both modes train on the same augmented batches and masks.

Staging and dispatch follow the JAX engine's rule (:func:`resolve_dispatch`,
``engine.py:681-691``): the training arrays live on the device when they
take at most 2 GiB (``stage_on_device``), else each round's ``[C, S, B,
...]`` batch stack is built on the host and copied through pinned memory;
with the dataset on the device and a card, rounds run in eval-aligned blocks
(``block_dispatch``): each block's rounds are staged together and replayed
from one CUDA graph of the round (``sim/graphs.py``), captured once per
FedSim, so a block's host work does not grow with the kernels of a step. On
the CPU a block runs its rounds one after another, with the same staging
and stacked metrics.

Packed lanes (``pack_lanes`` > 0, ``engine.py:1082-1266,1669-1856``): a
round's clients' executed steps are bin-packed into L lanes of a fixed
length (:func:`~fedml_tpu_torch.sim.cohort.pack_cohort`, on the staging
thread); a lane pass runs them vmapped over the lanes, each lane resetting
to the global model at a client's first step and writing the client's model
into its slot of the update stack at its last, and the aggregation gets the
padded round's update stack in slot order (an unwritten slot holds the
global model) and the loss summed as the padded round sums it. On the card
each pass is one replay of a CUDA graph of the lane pass
(``sim/graphs.py`` :class:`PassGraph`); on the CPU it runs eagerly. The
heterogeneous population (``population``/``population_trace``,
:mod:`fedml_tpu_torch.population`) drives cohort eligibility, step budgets
and mid-round dropout (a dropped client weighs 0), through the JAX engine's
hooks (``engine.py:1503-1631``); without one every round is what it was.

The server rule (``aggregator``, ``algorithms/``) gets the cohort's models in
cohort order, or the stacked ``[C, ...]`` state dict when it asks for it
(``Aggregator.stacked``: the scan mode then stacks the clients as they
finish), with the round's :class:`~fedml_tpu_torch.core.rng.RoundNoise` and
``extras`` (each client's true step count ``tau`` and its bound ``max_tau``,
``engine.py:916-984``), on every path: vmap, scan and packed. The robust
defenses (``robust_rule``, ``norm_bound``, ``dp_stddev``) build the robust
rule, as the JAX engine does. :meth:`FedSim.run_cohort_round` runs a round
over an explicit cohort (hierarchical FedAvg's groups). The JAX engine's
trace points (``obs/trace.py``: ``engine/stage``, ``engine/dispatch``,
``engine/eval``, ``engine/sync``, ``engine/lane_occupancy``,
``engine/overflow_passes``) time the host's part of each.

Update compression (``compressor``, ``topk_frac``, ``quantize_bits``,
``error_feedback``, ``engine.py:350-392``) wraps the server rule in
:func:`~fedml_tpu_torch.compress.aggregate.compressed_aggregator`: each
client's delta is encoded (its error-feedback residual, keyed by cohort
slot, in the server state) and the rule gets the reconstructed models, on
every path. A per-client rule (``Aggregator.per_client``, the gossip rules
of ``algorithms/decentralized.py``) selects the per-client mode
(``engine.py:394-415,893-972,1418-1461,1622-1626``): the model variables
are the ``[N, ...]`` stack of every client's model, every client runs
every round in id order from its own row, the rule maps the previous
stack and the trained one to the next, and evals read the clients' mean
(:meth:`FedSim.consensus`).

:meth:`FedSim.run` is the JAX engine's driver (``engine.py:2069-2183``):
with ``pipeline_depth`` >= 1 (the default, depth 1) a background thread
stages the next segments (a round or a block, ``sim/prefetch.py``) into
pinned host memory and copies them non-blocking, and round metrics are
fetched a segment behind, so the host synchronises with the device only at
eval rounds and at the end; ``pipeline_depth=0`` is the serial driver. Both
give bitwise-equal histories: staging is a pure function of (seed, round).
At eval rounds it runs the pooled eval and, with ``eval_on_clients``, the
per-client server eval (:meth:`FedSim.evaluate_per_client`). ``profile_dir``
records a ``torch.profiler`` Chrome trace of the rounds after the first.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from fedml_tpu_torch import population as poplib
from fedml_tpu_torch.algorithms.base import Aggregator, EmptyRoundError, fedavg_aggregator
from fedml_tpu_torch.algorithms.fedprox import straggler_epochs
from fedml_tpu_torch.algorithms.robust import RobustConfig, robust_aggregator
from fedml_tpu_torch.compress.aggregate import compressed_aggregator
from fedml_tpu_torch.compress.codec import make_codec
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.trainer import (ClientTrainer, DropoutStream, LaneDropout, _last_epoch,
                                          make_lane_step, make_local_eval, make_local_train,
                                          make_vmap_train)
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.obs import trace
from fedml_tpu_torch.ops import augment as augmentlib
from fedml_tpu_torch.sim import cohort as cohortlib
from fedml_tpu_torch.sim.graphs import PassGraph, RoundGraph
from fedml_tpu_torch.sim.prefetch import MetricsDrain, Prefetcher

StateDict = dict[str, torch.Tensor]

# SimConfig fields of the JAX engine that the port does not implement yet:
# the values the port accepts (the JAX default first) and the ROADMAP item
# that ports the rest (downlink coding, which the JAX sim engine refuses
# too, is refused in its words before this table is read).
_NOT_PORTED = {
    "downlink_compressor": (("none", ""), "§A11"),
    "mesh_shape": ((None,), "§A12"),
    "shard_rules": ((None,), "§A12"),
}


@dataclasses.dataclass
class SimConfig:
    """Flag names follow the reference CLI (main_fedavg.py:46-130).
    ``cohort_execution`` is ``"vmap"`` (every client at once, the default)
    or ``"scan"`` (one after another). ``straggler_frac`` gives that share of
    each cohort a uniform 1..E-1 local-epoch budget (FedProx's protocol);
    ``eval_on_clients`` adds the per-client server eval at eval rounds;
    ``stage_on_device`` and ``block_dispatch`` (None = the JAX engine's
    defaults, :func:`resolve_dispatch`) keep the dataset on the device and
    run eval-aligned blocks of rounds;
    ``pipeline_depth`` is the driver's staging depth (None = 1, 0 = serial);
    ``profile_dir`` records a ``torch.profiler`` trace. ``population``
    (a spec string, :func:`~fedml_tpu_torch.population.parse_population_spec`)
    or ``population_trace`` (a saved trace) drive cohort eligibility, step
    budgets and mid-round dropout, drawn from ``population_seed`` (None =
    ``seed``); ``pack_lanes`` > 0 bin-packs each round's client step streams
    into that many lanes, ``pack_capacity_factor`` the lane length's head
    room. ``robust_rule``, ``norm_bound`` and ``dp_stddev`` configure the
    robust defenses (``algorithms/robust.py``). A value of the JAX engine's
    other fields that the port does not implement raises."""

    client_num_in_total: int = 10
    client_num_per_round: int = 10
    batch_size: int = 32
    comm_round: int = 10
    epochs: int = 1  # local epochs per round
    frequency_of_the_test: int = 1
    eval_batch_size: int = 256
    seed: int = 0
    shuffle_each_round: bool = True
    straggler_frac: float = 0.0
    population: str | None = None
    population_trace: str | None = None
    population_seed: int | None = None
    eval_on_clients: bool = False
    # cap the pooled train eval to the first N samples (None = all)
    train_eval_samples: int | None = None
    stage_on_device: bool | None = None
    block_dispatch: bool | None = None
    # "vmap": every client of the cohort at once; "scan": one after another
    cohort_execution: str = "vmap"
    pack_lanes: int = 0
    pack_capacity_factor: float = 1.25
    compressor: str = "none"
    topk_frac: float = 0.01
    quantize_bits: int = 8
    downlink_compressor: str = "none"
    robust_rule: str = "mean"
    norm_bound: float = 0.0
    dp_stddev: float = 0.0
    error_feedback: bool = True
    mesh_shape: tuple | None = None
    shard_rules: str | None = None
    pipeline_depth: int | None = None
    profile_dir: str | None = None

    def __post_init__(self):
        if self.cohort_execution not in ("vmap", "scan"):
            raise ValueError(f"unknown cohort_execution {self.cohort_execution!r} "
                             "(expected 'vmap' or 'scan')")
        if self.downlink_compressor and self.downlink_compressor != "none":
            # the JAX sim engine refuses downlink coding too, in these words
            raise ValueError(
                f"downlink_compressor={self.downlink_compressor!r}: "
                "downlink delta coding is a wire-path plane "
                "(compress/downlink.py) — the sim engine broadcasts "
                "in-memory views, so there are no downlink bytes to "
                "compress; run a message-passing backend "
                "(loopback/shm/grpc/mqtt_s3), or 'none' for the "
                "bit-identical sim path"
            )
        for name, (accepted, item) in _NOT_PORTED.items():
            value = getattr(self, name)
            if value not in accepted:
                raise NotImplementedError(
                    f"SimConfig.{name}={value!r} is not ported to fedml_tpu_torch yet "
                    f"(ROADMAP {item}); leave it at {accepted[0]!r}")


def resolve_dispatch(config: SimConfig, nbytes: int, platform: str) -> tuple[bool, bool]:
    """``(on_device, block_dispatch)`` for training arrays of ``nbytes`` on a
    device of type ``platform`` (``"cuda"``, ``"cpu"``): the JAX engine's rule
    (``fedml_tpu/sim/engine.py:681-691``). The dataset stays on the device as
    ``config.stage_on_device`` says, by default when it takes at most 2 GiB;
    rounds run in blocks as ``config.block_dispatch`` says, by default with
    the dataset on the device and a device that is not the CPU, never with
    the dataset on the host and never under packed lanes (``pack_lanes`` >
    0: a packed round dispatches one pass at a time). The JAX rule also
    turns blocks off under sharded rounds (``shard_rules``), which
    ``SimConfig`` still refuses in the port (§A12)."""
    on_device = (config.stage_on_device if config.stage_on_device is not None
                 else nbytes <= 2 << 30)
    block = (config.block_dispatch if config.block_dispatch is not None
             else on_device and platform != "cpu")
    return on_device, bool(block and on_device and config.pack_lanes <= 0)


@dataclasses.dataclass(frozen=True)
class Staged:
    """One round's staged payload (:meth:`FedSim.stage_round`) on the
    device: the cohort, its ``[C, S, B]`` index map into the resident
    dataset (on-device staging) or its ``[C, S, B, ...]`` batch stack
    (host staging), ``[C]`` weights and step budgets, and the augmentation
    draws. The budgets are also on the host (the scan mode skips there),
    except in a captured round (None: the scan mode masks on the device)."""

    round_idx: int
    cohort: np.ndarray
    idx: torch.Tensor | None
    batches: dict[str, torch.Tensor] | None
    weights: torch.Tensor
    num_steps: torch.Tensor
    num_steps_host: np.ndarray | None
    draws: dict | None


@dataclasses.dataclass(frozen=True)
class BlockStaged:
    """``n_rounds`` consecutive rounds staged together
    (:meth:`FedSim.stage_block`, the JAX ``_stage_block``): the cohorts, the
    stacked ``[R, C, S, B]`` index maps, ``[R, C]`` weights and budgets
    (the budgets also on the host) and ``[R, C, E, S, B]`` augmentation
    draws on the device."""

    round_idx: int
    n_rounds: int
    cohorts: list
    idx: torch.Tensor
    weights: torch.Tensor
    num_steps: torch.Tensor
    num_steps_host: np.ndarray
    draws: dict | None

    def round(self, j: int) -> Staged:
        """Round ``round_idx + j`` of the block, as views."""
        return Staged(self.round_idx + j, self.cohorts[j], self.idx[j], None, self.weights[j],
                      self.num_steps[j], self.num_steps_host[j],
                      None if self.draws is None else {k: d[j] for k, d in self.draws.items()})


@dataclasses.dataclass(frozen=True)
class LanePass:
    """One pass of a packed round on the device (``[L, S_lane]`` plan of a
    :class:`~fedml_tpu_torch.sim.cohort.PackPass`): ``data`` is its
    ``[L, S_lane, B]`` lane index map into the resident dataset (on-device
    staging) or the gathered ``[L, S_lane, B, ...]`` lane batch stacks (host
    staging); ``slot``, ``gidx`` and ``boundary`` are int64; ``dropout``
    is the pass's :meth:`LaneDropout.fill` order (None without dropout)."""

    data: Any
    slot: torch.Tensor
    gidx: torch.Tensor
    boundary: torch.Tensor
    dropout: tuple | None


@dataclasses.dataclass(frozen=True)
class PackedStaged:
    """A packed round's staged payload (``pack_lanes`` > 0, the JAX
    ``PackedStaged``): one :class:`LanePass` a pass, the cohort's ``[C]``
    weights and step budgets on the device, the round's ``[C, E, S, B]``
    augmentation draws in the place of the JAX round key (``rkey``), and
    ``stats``, the host's plan accounting (``n_passes``, ``total_steps``,
    ``capacity``, ``padded_steps``); then the port's own fields, the round
    and its cohort."""

    passes: tuple
    weights: torch.Tensor
    num_steps: torch.Tensor
    draws: dict | None
    stats: dict
    round_idx: int
    cohort: np.ndarray


class FedSim:
    """Federated simulator on one device, in either cohort mode
    (``config.cohort_execution``: ``"vmap"`` trains the cohort at once,
    ``"scan"`` one client after another; a model the vmap mode cannot run
    raises, it is never trained in scan instead).

    Parameters
    ----------
    trainer: ClientTrainer (module + task + optimizer + epochs +
        augmentation + prox_mu); its module must live on ``device``
    train_data: FederatedArrays (client-partitioned train set)
    test_arrays: dict of [N, ...] arrays, the pooled global test set, or None
    config: SimConfig
    aggregator: server rule; defaults to the FedAvg weighted mean, or to the
        robust rule ``config``'s defense fields describe (an explicit
        aggregator beside them raises)
    device: where the model and the round run, and the dataset with
        on-device staging
    local_train_fn: a custom round program in place of the trainer's
        (``fedml_tpu_torch.algorithms.fedgan.make_gan_local_train``'s
        adversarial loop): called, one client's training with the contract
        of ``make_local_train`` (the scan mode); its ``vmap`` attribute, the
        cohort's with that of ``make_vmap_train`` (the vmap mode). A trainer
        without ``eval_batch`` (the GAN's) skips the server's evaluation.
    """

    def __init__(self, trainer: ClientTrainer, train_data: cohortlib.FederatedArrays,
                 test_arrays: dict[str, np.ndarray] | None, config: SimConfig,
                 aggregator: Aggregator | None = None, device: str | torch.device = "cuda",
                 local_train_fn=None):
        self.device = resolve_device(device)
        self.trainer = trainer
        self.train_data = train_data
        self.config = config
        # the heterogeneous population (fedml_tpu_torch.population): the
        # spec or the trace that drives cohorts, budgets and dropout
        self._population = self._make_population(config)
        self._pop_view_cache: tuple | None = None
        robust_on = (config.robust_rule != "mean" or config.norm_bound > 0
                     or config.dp_stddev > 0)
        if robust_on and aggregator is not None:
            raise ValueError(
                "SimConfig robust defense flags (robust_rule/norm_bound/"
                "dp_stddev) conflict with an explicit aggregator= — one of "
                "them would silently win; configure the defense in exactly "
                "one place")
        if robust_on:
            aggregator = robust_aggregator(RobustConfig(
                norm_bound=config.norm_bound, stddev=config.dp_stddev, rule=config.robust_rule))
        self.aggregator = aggregator or fedavg_aggregator()
        if config.compressor and config.compressor != "none":
            self.aggregator = self._compressed(config, self.aggregator)
        # per-client persistent models (decentralized/gossip FL): each client
        # trains from its own round-(r-1) model instead of a broadcast global
        self._per_client = bool(getattr(self.aggregator, "per_client", False))
        self._check_per_client(config)
        self._pack = self._check_pack(config, local_train_fn)
        if local_train_fn is None:
            if config.cohort_execution == "vmap":
                self._vmap_train = make_vmap_train(trainer, per_client=self._per_client)
            else:
                self._local_train = make_local_train(trainer)
        elif config.cohort_execution == "vmap":
            if not callable(getattr(local_train_fn, "vmap", None)):
                raise TypeError("cohort_execution='vmap' runs local_train_fn.vmap, the "
                                "cohort form of the round program; this one has none")
            self._vmap_train = local_train_fn.vmap
        else:
            self._local_train = local_train_fn
        # a trainer without eval_batch (the GAN) skips server-side evaluation
        self._can_eval = hasattr(trainer, "eval_batch")
        self._local_eval = make_local_eval(trainer) if self._can_eval else None
        # pin steps-per-epoch to the population max, as the JAX engine does
        self._steps = cohortlib.steps_per_epoch(train_data.max_client_size(), config.batch_size)
        if self._pack:
            # the lane length, fixed for the FedSim (engine.py:570-590): the
            # population's largest per-client step count, with capacity
            # head room over the expected cohort load; a round that
            # overflows every lane spills to an extra pass of the same shape
            self._c_pad = config.client_num_per_round
            sizes = train_data.client_sizes()
            slots = self._steps * config.batch_size
            d = np.ceil(np.minimum(sizes, slots) / max(config.batch_size, 1)).astype(np.int64)
            t = trainer.epochs * d
            t_max = int(t.max()) if len(t) else 1
            mean_t = float(t.mean()) if len(t) else 1.0
            need = config.pack_capacity_factor * mean_t * self._c_pad / config.pack_lanes
            self._s_lane = max(t_max, int(np.ceil(need)), 1)
            self._lane_step = torch.func.vmap(make_lane_step(trainer),
                                              in_dims=(0, 0, 0, None, None, 0, 0, None))
        nbytes = sum(np.asarray(a).nbytes for a in train_data.arrays.values())
        self._on_device, self._block_dispatch = resolve_dispatch(config, nbytes,
                                                                 self.device.type)
        # on-device staging: the training arrays live on the device and each
        # round (and the pooled train eval) gathers from them through an
        # index map; host staging keeps them on the host and copies each
        # round's batch stack and each eval's batches
        self._dataset = self._put(train_data.arrays) if self._on_device else None
        test_batches = (cohortlib.batch_array(test_arrays, config.eval_batch_size)
                        if test_arrays is not None else None)
        self._test_batches = (self._put(test_batches)
                              if self._on_device and test_batches is not None else test_batches)
        n_eval = train_data.num_samples
        if config.train_eval_samples is not None:
            n_eval = min(n_eval, config.train_eval_samples)
        bs = config.eval_batch_size
        if self._on_device:
            eidx = np.full(cohortlib.steps_per_epoch(n_eval, bs) * bs, -1, np.int32)
            eidx[:n_eval] = np.arange(n_eval, dtype=np.int32)
            self._train_eval = torch.as_tensor(eidx.reshape(-1, bs), device=self.device)
        else:
            self._train_eval = cohortlib.batch_array(
                {k: v[:n_eval] for k, v in train_data.arrays.items()}, bs)
        # block dispatch on the card: one captured round per staged shape;
        # packed rounds: one captured lane pass per pass shape
        self._graphs: dict[tuple, RoundGraph] = {}
        self._pass_graphs: dict[tuple, PassGraph] = {}
        # program kinds dispatched so far (the first dispatch of each is
        # marked in the trace, engine.py:1768-1777)
        self._dispatched: set[str] = set()

    def _compressed(self, config: SimConfig, inner: Aggregator) -> Aggregator:
        """``inner`` behind the update codec ``config`` names, with error
        feedback keyed by cohort slot, and the JAX engine's refusals
        (``engine.py:361-392``)."""
        if self._population is not None and config.error_feedback:
            raise ValueError(
                "sim-mode error feedback keys residuals by cohort "
                "slot; a population's availability churn maps slots "
                "to different clients every round — use "
                "error_feedback=False or a message-passing backend"
            )
        if (config.error_feedback
                and config.client_num_per_round != config.client_num_in_total):
            raise ValueError(
                "sim-mode error feedback keys residuals by cohort slot, "
                "which matches client identity only at full participation "
                f"(got {config.client_num_per_round}/"
                f"{config.client_num_in_total} per round); use full "
                "participation, error_feedback=False, or a "
                "message-passing backend (residuals keyed by assigned "
                "client index)"
            )
        return compressed_aggregator(
            make_codec(config.compressor, topk_frac=config.topk_frac,
                       quantize_bits=config.quantize_bits),
            inner=inner, error_feedback=config.error_feedback,
            num_slots=config.client_num_per_round)

    def _check_per_client(self, config: SimConfig) -> None:
        """The per-client mode's preconditions, with the JAX engine's
        errors (``engine.py:394-415``): slot i is client i every round."""
        if not self._per_client:
            return
        if self._population is not None:
            raise ValueError(
                "per-client aggregators (decentralized/gossip) keep slot i "
                "== client i with full participation every round; a "
                "population's availability churn breaks that identity — "
                "run populations with broadcast-mode aggregation")
        if config.client_num_per_round != config.client_num_in_total:
            raise ValueError(
                "per-client aggregators (decentralized/gossip) require full "
                "participation: client_num_per_round == client_num_in_total "
                f"(got {config.client_num_per_round} != {config.client_num_in_total})"
            )
        agg_n = getattr(self.aggregator, "num_clients", None)
        if agg_n is not None and agg_n != config.client_num_in_total:
            raise ValueError(
                f"aggregator '{self.aggregator.name}' is configured for "
                f"{agg_n} clients (e.g. its mixing-matrix order) but "
                f"client_num_in_total={config.client_num_in_total} — a "
                "mismatched topology would silently isolate clients"
            )

    @staticmethod
    def _make_population(config: SimConfig):
        """The population that ``config`` names (None without one), with the
        JAX engine's checks and errors (``engine.py:243-299``)."""
        if not (config.population or config.population_trace):
            return None
        if config.population and config.population_trace:
            raise ValueError(
                "SimConfig.population and SimConfig.population_trace "
                "are both set — one of them would silently win; pick "
                "the generative spec OR the trace replay")
        if config.straggler_frac > 0:
            raise ValueError(
                "SimConfig.population replaces the uniform "
                "straggler_frac draw with speed-model step budgets — "
                "configure per-client heterogeneity in exactly one "
                "place (drop straggler_frac)")
        pop_seed = config.population_seed if config.population_seed is not None else config.seed
        if config.population_trace:
            population = poplib.load_trace(config.population_trace)
            if population.num_clients != config.client_num_in_total:
                raise ValueError(
                    f"population trace {config.population_trace} was "
                    f"captured over {population.num_clients} "
                    f"clients but client_num_in_total="
                    f"{config.client_num_in_total} — a trace replays "
                    "one population only")
            if population.jitter_active:
                raise NotImplementedError(
                    f"population trace {config.population_trace} "
                    "records upload-arrival jitter — a wire-only "
                    "knob; there is no wire on the sim engine "
                    "(re-capture without jitter, or run the "
                    "message-passing backends)")
            return population
        spec = poplib.parse_population_spec(config.population)
        if spec.jitter_active:
            raise NotImplementedError(
                "population jitter schedules upload-arrival delays "
                "— a wire-only knob; there is no wire on the sim "
                "engine (run the message-passing backends, or drop "
                "jitter from the spec)")
        return poplib.Population(spec, config.client_num_in_total, pop_seed)

    def _check_pack(self, config: SimConfig, local_train_fn) -> bool:
        """Whether rounds run packed, with the JAX engine's conflicts
        (``engine.py:526-567``), each error leading with the field to
        change."""
        if config.pack_lanes < 0:
            raise ValueError(
                f"pack_lanes must be >= 0 (got {config.pack_lanes}); "
                "0 disables packing")
        if config.pack_lanes == 0:
            return False
        if self._per_client:
            raise ValueError(
                f"aggregator={self.aggregator.name!r} (per-client) "
                f"conflicts with pack_lanes={config.pack_lanes}: packed "
                "lanes reset carries to the BROADCAST global params at "
                "client boundaries, but per-client aggregators (decentralized/"
                "gossip) keep a model per client — use the padded path "
                "(pack_lanes=0)")
        if config.cohort_execution == "scan":
            raise ValueError(
                "SimConfig.cohort_execution='scan' conflicts with "
                f"pack_lanes={config.pack_lanes}: packed lanes replace "
                "the cohort execution loop entirely — leave "
                "cohort_execution='vmap' (lanes are vmapped)")
        if local_train_fn is not None:
            raise ValueError(
                "local_train_fn conflicts with pack_lanes="
                f"{config.pack_lanes}: packed lanes drive "
                "ClientTrainer.train_step directly (boundary-aware lane "
                "steps) and cannot honor a custom round program (e.g. "
                "the GAN adversarial loop) — use the padded path "
                "(pack_lanes=0)")
        if config.block_dispatch:
            raise ValueError(
                "SimConfig.block_dispatch=True conflicts with "
                f"pack_lanes={config.pack_lanes}: packed rounds already "
                "dispatch one program per pass — leave block_dispatch "
                "off (or unset) with pack_lanes")
        return True

    @property
    def pipeline_depth(self) -> int:
        """Effective prefetch/drain depth (0 = serial driver); see
        SimConfig.pipeline_depth."""
        d = self.config.pipeline_depth
        return 1 if d is None else max(0, int(d))

    def _put(self, arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v), device=self.device) for k, v in arrays.items()}

    def _stage_put(self, value):
        """A host array or CPU tensor on the device, through pinned memory
        and a non-blocking copy on the card. The copy joins the device's
        stream in issue order, ahead of the round that reads it, and the
        pinned block is kept until the copy is done."""
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(value))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    @staticmethod
    def _gather_batches(dataset: dict[str, torch.Tensor], idx: torch.Tensor):
        """Gather [*, S, B] index maps (-1 = empty slot) into batch stacks
        with stack_cohort's exact zero-fill/mask semantics."""
        valid = (idx >= 0).float()
        safe = torch.clamp(idx, min=0).reshape(-1)
        batches = {
            k: v.index_select(0, safe).reshape(idx.shape + v.shape[1:])
            for k, v in dataset.items()
        }
        batches = {
            k: v * valid.reshape(valid.shape + (1,) * (v.dim() - idx.dim())).to(v.dtype)
            for k, v in batches.items()
        }
        if "mask" in dataset:
            batches["mask"] = batches["mask"].float()
        else:
            batches["mask"] = valid
        return batches

    # -- host loop -----------------------------------------------------------

    def init_variables(self) -> StateDict:
        """Fresh model variables drawn from ``config.seed``."""
        return self.trainer.init(rnglib.generator(self.config.seed, self.device))

    def init_round_variables(self, overrides: StateDict | None = None) -> StateDict:
        """Model state in the engine's layout (``engine.py:1418-1453``):
        :meth:`init_variables`, with ``overrides`` (a partial state dict,
        name -> tensor) grafted over it; in the per-client mode the ``[N,
        ...]`` stack of N copies of it (every node starts from the same
        point, the standard decentralized-optimization setup)."""
        v = self.init_variables()
        for k, t in (overrides or {}).items():
            if k not in v or tuple(t.shape) != tuple(v[k].shape):
                raise ValueError(f"override {k!r} {tuple(t.shape)} matches no variable of the "
                                 f"model ({tuple(v[k].shape) if k in v else 'no such name'})")
            v[k] = torch.as_tensor(t).to(self.device, v[k].dtype)
        if not self._per_client:
            return v
        n = self.config.client_num_in_total
        return {k: t.unsqueeze(0).repeat((n,) + (1,) * t.dim()) for k, t in v.items()}

    def consensus(self, variables: StateDict) -> StateDict:
        """A single evaluable model: the identity in broadcast mode; the
        average of the N clients' models in the per-client mode
        (``engine.py:1455-1461``)."""
        if not self._per_client:
            return variables
        n = self.config.client_num_in_total
        return {k: torch.mean(v[:n], dim=0) for k, v in variables.items()}

    def _population_view(self, round_idx: int):
        """The round's realized population state, cached per round (the
        sampler, budget, weight and pack hooks all read it). Raises
        :class:`EmptyRoundError` when availability churn or dropout leaves
        the round nothing to aggregate (``engine.py:1503-1531``)."""
        cached = self._pop_view_cache
        if cached is not None and cached[0] == round_idx:
            return cached[1]
        view = self._population.round_view(round_idx, self.config.client_num_per_round)
        if view.eligible_count == 0 or not view.real().any():
            raise EmptyRoundError(
                f"round {round_idx}: availability churn left no eligible "
                f"clients (population of {self._population.num_clients}, "
                "0 available) — nothing to aggregate; widen avail/"
                "avail_block or skip the round")
        if bool((view.dropped | ~view.real()).all()):
            raise EmptyRoundError(
                f"round {round_idx}: every sampled cohort member "
                f"({int(view.real().sum())} of "
                f"{view.cohort_size}) dropped mid-round — no update "
                "survives to aggregate (the wire path's all-dropped-round "
                "semantics)")
        self._pop_view_cache = (round_idx, view)
        return view

    def _population_budgets(self, view) -> tuple[np.ndarray, np.ndarray]:
        """``(actual, predicted)`` per-slot step budgets of a population
        round, in scan-step units of the epochs x steps chain."""
        return poplib.step_budgets(view, self.trainer.epochs * self._steps)

    def _round_budgets(self, cohort, round_idx: int) -> np.ndarray:
        """Per-client local-step budgets (scan-step units): stragglers run a
        reduced epoch count e_i, i.e. the first e_i * steps-per-epoch steps.
        With a population, the budgets come from its speed model instead
        (dropout truncation included)."""
        cfg = self.config
        if self._population is not None:
            view = self._population_view(round_idx)
            if not np.array_equal(np.asarray(cohort), view.cohort):
                raise ValueError(
                    "SimConfig.population drives cohort selection; "
                    "compositions that pick their own cohorts (e.g. "
                    "hierarchical groups) need the population off")
            actual, _ = self._population_budgets(view)
            return actual
        if cfg.straggler_frac > 0.0:
            epochs_arr = straggler_epochs(
                round_idx, len(cohort), cfg.epochs, cfg.straggler_frac, cfg.seed)
        else:
            epochs_arr = np.full(len(cohort), cfg.epochs, np.int32)
        return (epochs_arr * self._steps).astype(np.int32)

    def _host_cohort_indices(self, cohort, round_idx: int):
        """[C, S, B] int32 index map (-1 = empty slot), [C] sample-count
        weights and per-client step budgets for one round."""
        cfg = self.config
        shuffle = (
            np.random.RandomState(cfg.seed * 1_000_003 + round_idx)
            if cfg.shuffle_each_round else None
        )
        idx, weights = cohortlib.cohort_index_map(
            self.train_data, cohort, cfg.batch_size, steps=self._steps, rng=shuffle)
        num_steps = self._round_budgets(cohort, round_idx)
        return idx, self._population_weights(weights, round_idx), num_steps

    def _population_weights(self, weights: np.ndarray, round_idx: int) -> np.ndarray:
        """Zero the aggregation weight of the cohort members that drop
        mid-round: they trained part of their budget, but their update never
        reaches the server, so they leave the weighted mean and the loss
        average as a padding slot does. The identity without a
        population."""
        if self._population is None:
            return weights
        view = self._population_view(round_idx)
        return np.where(view.dropped, 0.0, weights).astype(np.float32)

    def _round_draws(self, round_idx: int, n_clients: int):
        """The round's augmentation draws, ``[C, E, S, B]`` CPU tensors,
        client slot c's drawn from
        :func:`~fedml_tpu_torch.ops.augment.round_generator` (so the card and
        the CPU draw the same); None when the trainer does not augment."""
        aug = getattr(self.trainer, "augment", None)
        if aug is None:
            return None
        shape = (self.trainer.epochs, self._steps, self.config.batch_size)
        image = tuple(self.train_data.arrays["x"].shape[1:3])
        per = [aug.draw(augmentlib.round_generator(self.config.seed, round_idx, c), shape, image)
               for c in range(n_clients)]
        return {k: torch.stack([d[k] for d in per]) for k in per[0]}

    def _sample_cohort(self, round_idx: int) -> np.ndarray:
        """The round's cohort: the reference's seeded draw, or with a
        population its availability-aware one (``client_num_per_round``
        slots, -1 for an empty slot when churn leaves fewer clients); in the
        per-client mode every client in id order (``engine.py:1622-1626``)."""
        cfg = self.config
        if self._per_client:
            # stable identity order: slot i is client i every round, so the
            # persistent stack and the mixing matrix's adjacency line up
            return np.arange(cfg.client_num_in_total)
        if self._population is not None:
            return self._population_view(round_idx).cohort
        cohort = rnglib.sample_clients(round_idx, cfg.client_num_in_total,
                                       cfg.client_num_per_round)
        if len(cohort) == 0:
            raise EmptyRoundError(f"round {round_idx}: the cohort is empty")
        return cohort

    def stage_round(self, round_idx: int) -> Staged:
        """All host work for one round: cohort sampling, the index map (or,
        with host staging, the batch stack gathered through it: the JAX
        ``stage_cohort``), weights, step budgets and augmentation draws,
        copied to the device. Pure in (config, round_idx), so staging it
        ahead of the dispatch loop (``sim/prefetch.py``) cannot change
        cohorts or metrics. Under ``pack_lanes`` a :class:`PackedStaged`
        lane plan, bin-packing included (:meth:`_stage_packed_round`)."""
        return self.stage_cohort_round(self._sample_cohort(round_idx), round_idx)

    def stage_cohort_round(self, cohort, round_idx: int) -> Staged | PackedStaged:
        """:meth:`stage_round`'s payload for an explicit ``cohort`` (client
        ids), ``engine.py:1650-1665``: what compositions that pick their own
        cohorts (hierarchical FedAvg's groups) stage."""
        cohort = np.asarray(cohort)
        with trace.span("engine/stage", round=round_idx, packed=self._pack):
            if self._pack:
                return self._stage_packed_round(cohort, round_idx)
            idx, weights, num_steps = self._host_cohort_indices(cohort, round_idx)
            draws = self._round_draws(round_idx, len(cohort))
            if self._on_device:
                idx_t, batches = self._stage_put(idx), None
            else:
                idx_t = None
                batches = {k: self._stage_put(v) for k, v in
                           cohortlib.gather_index_stack(self.train_data.arrays, idx).items()}
            return Staged(
                round_idx, cohort, idx_t, batches, self._stage_put(weights),
                self._stage_put(num_steps), num_steps,
                None if draws is None else {k: self._stage_put(d) for k, d in draws.items()})

    def stage_block(self, start_round: int, n_rounds: int) -> BlockStaged:
        """Host staging for an ``n_rounds`` block (``engine.py:1308-1333``):
        each round's index map, weights and budgets stacked ``[R, ...]``,
        and the rounds' augmentation draws, copied to the device. Pure in
        (config, rounds), so the prefetch thread can stage the next block
        while the current one runs."""
        with trace.span("engine/stage", round=start_round, n_rounds=n_rounds, block=True):
            rounds = range(start_round, start_round + n_rounds)
            cohorts = [self._sample_cohort(r) for r in rounds]
            per = [self._host_cohort_indices(c, r) for c, r in zip(cohorts, rounds)]
            draws = [self._round_draws(r, len(c)) for c, r in zip(cohorts, rounds)]
            budgets = np.stack([p[2] for p in per])
            return BlockStaged(
                start_round, n_rounds, cohorts,
                *(self._stage_put(np.stack([p[i] for p in per])) for i in range(2)),
                self._stage_put(budgets), budgets,
                None if draws[0] is None else
                {k: self._stage_put(torch.stack([d[k] for d in draws])) for k in draws[0]})

    def _stage_segment(self, segment: tuple[int, int]):
        r, n = segment
        return self.stage_round(r) if n == 1 else self.stage_block(r, n)

    # -- packed lanes (SimConfig.pack_lanes) ---------------------------------

    def _pack_round_plan(self, cohort, round_idx: int):
        """Host-only planning for one packed round (``engine.py:1669-1704``):
        the round's ``[C, S, B]`` index map, built as the padded round builds
        it, and the lane packing of each client's executed-step stream,
        binned by the population's predicted budgets when there is one
        (the planner cannot know who drops mid-round; dropped clients are
        re-packed by their actual streams into overflow passes)."""
        idx, weights, num_steps = self._host_cohort_indices(cohort, round_idx)
        if len(weights) != self._c_pad:
            raise ValueError(
                f"packed execution compiled for {self._c_pad} cohort slots "
                f"but this cohort stages {len(weights)} — compositions that "
                "pick their own cohort sizes (e.g. hierarchical groups) "
                "need the padded path")
        B = self.config.batch_size
        data_steps = -(-(idx >= 0).reshape(len(weights), -1).sum(axis=1) // B)
        predicted = None
        if self._population is not None:
            _, predicted = self._population_budgets(self._population_view(round_idx))
        plan = cohortlib.pack_cohort(
            num_steps, data_steps, self._steps, self.trainer.epochs,
            self.config.pack_lanes, self._s_lane, 1, predicted_steps=predicted)
        return idx, weights, num_steps, plan

    def _plan_stats(self, n_slots: int, plan) -> dict:
        return {"n_passes": len(plan.passes), "total_steps": plan.total_steps,
                "capacity": plan.capacity,
                "padded_steps": n_slots * self.trainer.epochs * self._steps}

    def pack_round_stats(self, round_idx: int) -> dict:
        """Plan accounting for the round the engine would run (its sampled
        cohort, its budgets), all on the host: pass count, executed steps,
        lane capacity and the padded round's step count."""
        _, weights, _, plan = self._pack_round_plan(self._sample_cohort(round_idx), round_idx)
        return self._plan_stats(len(weights), plan)

    @staticmethod
    def _dropout_order(pack_pass) -> tuple:
        """The host half of a pass's :meth:`LaneDropout.fill` order: the flat
        ``t * L + l`` positions of its live lane steps and their client
        slots, sorted by chain step, and the ``(g, lo, hi)`` runs of one
        chain step in them."""
        L = pack_pass.slot.shape[0]
        slot_t, gidx_t = pack_pass.slot.T, pack_pass.gidx.T  # [S_lane, L]
        t, lane = np.nonzero(slot_t >= 0)
        g = gidx_t[t, lane]
        order = np.argsort(g, kind="stable")
        pos, slots, g = (t * L + lane)[order], slot_t[t, lane][order], g[order]
        starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]]) if len(g) else np.zeros(0, int)
        ends = np.r_[starts[1:], len(g)]
        groups = tuple((int(g[a]), int(a), int(b)) for a, b in zip(starts, ends))
        return pos.astype(np.int64), slots.astype(np.int64), groups

    def _stage_packed_round(self, cohort, round_idx: int) -> PackedStaged:
        """Host staging for one packed round (``engine.py:1721-1777``): plan
        it (:meth:`_pack_round_plan`), lay each pass's lane index map out
        (or, with host staging, gather its lane batch stacks) and copy plan
        and data to the device. Pure in (config, round_idx) like every
        staging path, so the prefetch thread runs it ahead."""
        idx, weights, num_steps, plan = self._pack_round_plan(cohort, round_idx)
        # lane occupancy (executed steps / scanned lane slots, overflow passes
        # included) and the overflow pass count: whether the lane geometry
        # fits the population
        trace.gauge("engine/lane_occupancy", plan.total_steps / max(plan.capacity, 1),
                    round=round_idx)
        trace.counter("engine/overflow_passes", len(plan.passes) - 1, round=round_idx)
        sites = self.trainer.dropout_sites
        passes = []
        for pp in plan.passes:
            pidx = cohortlib.pack_index_map(idx, pp)
            if self._on_device:
                data = self._stage_put(pidx)
            else:
                data = {k: self._stage_put(v) for k, v in
                        cohortlib.gather_index_stack(self.train_data.arrays, pidx).items()}
            order = None
            if sites:
                pos, slots, groups = self._dropout_order(pp)
                order = (self._stage_put(pos), self._stage_put(slots), groups)
            passes.append(LanePass(data, *(self._stage_put(a.astype(np.int64))
                                           for a in (pp.slot, pp.gidx, pp.boundary)), order))
        draws = self._round_draws(round_idx, len(cohort))
        return PackedStaged(
            passes=tuple(passes), weights=self._stage_put(weights),
            num_steps=self._stage_put(num_steps),
            draws=None if draws is None else {k: self._stage_put(d) for k, d in draws.items()},
            stats=self._plan_stats(len(weights), plan), round_idx=round_idx, cohort=cohort)

    def _packed_buffers(self, variables: StateDict, lanes: int) -> tuple:
        """A packed round's zeroed output buffers (``engine.py:1084-1101``):
        the ``[C + L, ...]`` update stack, its ``[C + L]`` written flags and
        the ``[C + L, E * S]`` per-(client, chain step) loss and weight
        buffers the round's loss is rebuilt from. Row ``C + l`` is lane
        ``l``'s scratch row, where its writes land when it runs no client
        (the JAX scatter's ``mode="drop"``)."""
        rows = self._c_pad + lanes
        T = self.trainer.epochs * self._steps
        stack = {k: torch.zeros((rows,) + v.shape, dtype=v.dtype, device=v.device)
                 for k, v in variables.items()}
        zeros = functools.partial(torch.zeros, dtype=torch.float32, device=self.device)
        return stack, zeros(rows), zeros((rows, T)), zeros((rows, T))

    def lane_pass(self, lp: LanePass, global_variables: StateDict, bufs: tuple,
                  draws: dict | None, dropout: LaneDropout | None) -> None:
        """One pass over an ``[L, S_lane]`` lane plan (``engine.py:1103-1191``),
        a function of its tensors alone (what a CUDA graph of the pass
        captures, ``sim/graphs.py``), writing into ``bufs``
        (:meth:`_packed_buffers`). Each lane carries one client's training
        state at a time: at a client's first chain step (``gidx`` 0) it is
        reset to the global model and a fresh optimizer state
        (:func:`~fedml_tpu_torch.core.trainer.make_lane_step`); each step's
        loss and weight land at the client's (slot, chain step) entry, and
        at its last step (``boundary``) the lane's model lands in the
        client's row of the update stack. Augmentation draws and dropout
        masks are the client's at its chain step, as in the padded round."""
        stack, written, lbuf, wbuf = bufs
        opt = self.trainer.optimizer
        L, s_lane = lp.slot.shape
        S, T = self._steps, self.trainer.epochs * self._steps
        data = (lp.data if isinstance(lp.data, dict)
                else self._gather_batches(self._dataset, lp.data))
        param_names = [k for k, _ in self.trainer.module.named_parameters()]
        global_params = {k: global_variables[k] for k in param_names}
        prox_params = global_params if self.trainer.prox_mu > 0.0 else {}
        opt0 = opt.init(global_params, ())
        lanes = {k: v.unsqueeze(0).expand((L,) + v.shape) for k, v in global_variables.items()}
        params = {k: lanes[k] for k in param_names}
        state = {k: v for k, v in lanes.items() if k not in params}
        opt_state = {k: v.unsqueeze(0).expand((L,) + v.shape) for k, v in opt0.items()}
        scratch = self._c_pad + torch.arange(L, device=lp.slot.device)
        ones = torch.ones(L, dtype=written.dtype, device=written.device)
        lane_draws = None
        if draws is not None:
            slot0 = torch.clamp(lp.slot, min=0)
            g0 = torch.clamp(lp.gidx, 0, T - 1)
            lane_draws = {k: d[slot0, g0 // S, g0 % S] for k, d in draws.items()}
        for t in range(s_lane):
            batch = {k: v[:, t] for k, v in data.items()}
            if lane_draws is not None:
                batch["x"] = self.trainer.augment.apply(
                    batch["x"], {k: d[:, t] for k, d in lane_draws.items()})
            if dropout is not None:
                batch["dropout"] = dropout.masks(t)
            slot, gidx = lp.slot[:, t], lp.gidx[:, t]
            live = slot >= 0
            params, state, opt_state, loss, w = self._lane_step(
                params, state, opt_state, global_variables, opt0, batch,
                live & (gidx == 0), prox_params)
            row = torch.where(live, slot, scratch)
            g = torch.clamp(gidx, 0, T - 1)
            lbuf.index_put_((row, g), loss)
            wbuf.index_put_((row, g), w)
            emit = torch.where(live & (lp.boundary[:, t] > 0), slot, scratch)
            merged = {**params, **state}
            for k, st in stack.items():
                st.index_copy_(0, emit, merged[k])
            written.index_copy_(0, emit, ones)

    def _packed_aggregate(self, global_variables: StateDict, server_state, bufs: tuple,
                          weights: torch.Tensor, num_steps: torch.Tensor, noise):
        """Rebuild the padded round's per-client quantities from a packed
        round's buffers and aggregate them (``engine.py:1211-1266``): each
        written slot's model (an unwritten one holds the global model, as
        the padded round's fully masked client does), in slot order, and
        each client's train loss summed step by step in the padded
        ``make_vmap_train``'s order, so the two agree bitwise."""
        stack, written, lbuf, wbuf = bufs
        C, E, S = self._c_pad, self.trainer.epochs, self._steps
        done = written[:C] > 0
        local = {k: torch.where(done.reshape((C,) + (1,) * g.dim()), stack[k][:C], g.unsqueeze(0))
                 for k, g in global_variables.items()}
        products, ws = lbuf[:C] * wbuf[:C], wbuf[:C]
        loss_sums, w_sums = [], []
        for e in range(E):
            total = torch.zeros(C, dtype=torch.float32, device=ws.device)
            w = torch.zeros_like(total)
            for s in range(S):
                total = total + products[:, e * S + s]
                w = w + ws[:, e * S + s]
            loss_sums.append(total)
            w_sums.append(w)
        last = _last_epoch(num_steps, S, E)
        rows = torch.arange(C, device=last.device)
        train_loss = (torch.stack(loss_sums)[last, rows]
                      / torch.clamp(torch.stack(w_sums)[last, rows], min=1.0))
        new_global, server_state, agg_metrics = self._aggregate(
            global_variables, local, weights, num_steps, server_state, noise)
        metrics = {"Train/Loss": torch.sum(train_loss * weights / torch.sum(weights)),
                   **agg_metrics}
        return new_global, server_state, metrics

    def _round_noise(self, round_idx: int) -> rnglib.RoundNoise:
        return rnglib.RoundNoise(self.config.seed, round_idx, self.device)

    def _aggregate(self, global_variables: StateDict, clients, weights: torch.Tensor,
                   num_steps: torch.Tensor, server_state, noise):
        """The round's server side on every path (``engine.py:916-984``):
        the rule gets ``global_variables`` (in the per-client mode the
        previous ``[N, ...]`` stack), the cohort's models (``clients``: a
        stacked ``[C, ...]`` state dict, or an iterable of the clients' in
        cohort order) as it asks for them, the round's noise and
        ``extras``: each client's
        true SGD step count ``tau = e_i * ceil(max(n_i, 1) / B)`` (e_i the
        client's epochs of budget, ``num_steps / steps``) and the static
        bound ``max_tau``."""
        epochs_i = num_steps.float() / float(self._steps)
        tau = epochs_i * torch.ceil(torch.clamp(weights.float(), min=1.0)
                                    / self.config.batch_size)
        extras = {"tau": tau, "max_tau": self.trainer.epochs * self._steps}
        # the per-client mode's rule maps the previous stack and the trained
        # one to the next stack (engine.py:951-972); broadcast mode's the
        # global model and the clients' to the next global model
        if self.aggregator.stacked:
            if not isinstance(clients, dict):
                clients = _stack_as_they_come(clients, len(weights))
        elif isinstance(clients, dict):
            clients = iter(treelib.unstack(clients, len(weights)))
        return self.aggregator.aggregate(global_variables, clients, weights, server_state,
                                         noise, extras)

    def _run_packed(self, staged: PackedStaged, global_variables: StateDict, server_state):
        """One packed round (``engine.py:1829-1856``): zeroed buffers, the
        passes one after another (on the card each one replay of the
        FedSim's CUDA graph of the pass, ``sim/graphs.py``; on the CPU
        eagerly), then the aggregation."""
        dropout = self._dropout(staged.round_idx, len(staged.cohort))
        if self.device.type == "cuda":
            self.capture_pass_graph(staged=staged, variables=global_variables)
            graph = self._pass_graphs[self._pass_graph_key(staged)]
            bufs = graph.run_round(staged, global_variables, dropout)
        else:
            L = staged.passes[0].slot.shape[0]
            bufs = self._packed_buffers(global_variables, L)
            lane_dropout = (LaneDropout(self.trainer.dropout_sites, self._s_lane, L,
                                        self.config.batch_size, self.device)
                            if dropout is not None else None)
            for lp in staged.passes:
                if lane_dropout is not None:
                    lane_dropout.fill(dropout, lp.dropout)
                self.lane_pass(lp, global_variables, bufs, staged.draws, lane_dropout)
        return self._packed_aggregate(global_variables, server_state, bufs, staged.weights,
                                      staged.num_steps, self._round_noise(staged.round_idx))

    @staticmethod
    def _pass_graph_key(staged: PackedStaged) -> tuple:
        lp = staged.passes[0]
        data = lp.data if isinstance(lp.data, dict) else {"idx": lp.data}
        return (tuple((k, tuple(v.shape)) for k, v in sorted(data.items())),
                tuple((k, tuple(d.shape)) for k, d in sorted((staged.draws or {}).items())))

    def capture_pass_graph(self, round_idx: int = 0, staged: PackedStaged | None = None,
                           variables: StateDict | None = None) -> float:
        """Capture the lane pass as a CUDA graph (``sim/graphs.py``
        :class:`PassGraph`), warmed up on the first pass of round
        ``round_idx`` (or of ``staged``) from ``variables`` (default: fresh
        ones); returns the seconds the warm-up and the capture took, 0 if
        this FedSim already holds the graph. :meth:`run` calls it before its
        prefetch thread starts; a caller who calls it first keeps the
        capture out of the rounds it times."""
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {self.device}")
        if not self._pack:
            raise ValueError("capture_pass_graph needs packed lanes (pack_lanes > 0)")
        staged = staged if staged is not None else self.stage_round(round_idx)
        key = self._pass_graph_key(staged)
        if key in self._pass_graphs:
            return 0.0
        t0 = time.perf_counter()
        if variables is None:
            variables = self.init_round_variables()
        self._pass_graphs[key] = PassGraph(self, staged, variables)
        return time.perf_counter() - t0

    def pack_summary(self) -> dict:
        """Static packed-execution accounting (empty when ``pack_lanes`` is
        off): the lane geometry and the step count one padded round would
        run, logged at run start (``engine.py:1858-1872``)."""
        if not self._pack:
            return {}
        return {
            "pack_lanes": self.config.pack_lanes,
            "s_lane": self._s_lane,
            "lane_capacity_per_pass": self.config.pack_lanes * self._s_lane,
            "padded_scan_steps": self._c_pad * self.trainer.epochs * self._steps,
        }

    def population_summary(self) -> dict:
        """Static population accounting (empty without a population): the
        spec or trace and its geometry, logged at run start."""
        if self._population is None:
            return {}
        return self._population.describe()

    def _dropout(self, round_idx: int, n_clients: int) -> DropoutStream | None:
        cfg = self.config
        return (DropoutStream(self.trainer.dropout_sites, cfg.seed, round_idx, n_clients,
                              cfg.batch_size, self.device)
                if self.trainer.dropout_sites else None)

    def run_staged_round(self, staged: Staged | PackedStaged, global_variables: StateDict,
                         server_state=()):
        """One round from a :meth:`stage_round` payload: returns
        ``(new_global, server_state, metrics)`` with ``metrics["Train/Loss"]``
        the sample-weighted mean of the clients' train losses (a device
        tensor: nothing here waits for the device). It trains on the staged
        batch stack (host staging) or gathers from the resident dataset
        (``engine.py:1779-1828``); a :class:`PackedStaged` round runs its
        lane passes (:meth:`_run_packed`)."""
        if isinstance(staged, PackedStaged):
            with trace.span("engine/dispatch", program="packed",
                            n_passes=staged.stats["n_passes"],
                            first=self._first_dispatch("packed")):
                return self._run_packed(staged, global_variables, server_state)
        program = "gather" if staged.idx is not None else "padded"
        with trace.span("engine/dispatch", program=program,
                        first=self._first_dispatch(program)):
            return self.round_step(staged, global_variables, server_state,
                                   self._dropout(staged.round_idx, len(staged.cohort)))

    def _first_dispatch(self, program: str) -> bool:
        """True exactly once per program kind, marking it in the trace
        (``engine.py:1768-1777``): on the card a kind's first dispatch pays
        its one-time costs (a graph capture, cuDNN's algorithm search)."""
        if program in self._dispatched:
            return False
        self._dispatched.add(program)
        trace.event("engine/first_dispatch", program=program)
        return True

    def round_step(self, staged: Staged, global_variables: StateDict, server_state,
                   dropout: DropoutStream | None, noise=None):
        """The round's device work, a function of its tensors alone (what a
        CUDA graph of the round captures, ``sim/graphs.py``): ``dropout``
        serves each step's masks, ``noise`` the server rule's random draws
        (by default the round's :class:`~fedml_tpu_torch.core.rng.RoundNoise`)."""
        cfg = self.config
        if noise is None:
            noise = self._round_noise(staged.round_idx)
        n = len(staged.cohort)
        weights, draws = staged.weights, staged.draws

        def client_batches(c=None):
            if staged.batches is not None:
                return (staged.batches if c is None
                        else {k: v[c] for k, v in staged.batches.items()})
            return self._gather_batches(self._dataset,
                                        staged.idx if c is None else staged.idx[c])

        if cfg.cohort_execution == "vmap":
            stacked, train_metrics = self._vmap_train(
                global_variables, client_batches(), staged.num_steps, draws, dropout)
            new_global, server_state, agg_metrics = self._aggregate(
                global_variables, stacked, weights, staged.num_steps, server_state, noise)
            losses_t = train_metrics["train_loss"]
        else:
            losses: list[torch.Tensor] = []

            def trained_clients():
                for c in range(n):
                    start = ({k: v[c] for k, v in global_variables.items()}
                             if self._per_client else global_variables)
                    variables, metrics = self._local_train(
                        start, client_batches(c),
                        (staged.num_steps[c] if staged.num_steps_host is None
                         else int(staged.num_steps_host[c])),
                        None if draws is None else {k: d[c] for k, d in draws.items()},
                        dropout, c)
                    losses.append(metrics["train_loss"])
                    yield variables

            new_global, server_state, agg_metrics = self._aggregate(
                global_variables, trained_clients(), weights, staged.num_steps, server_state,
                noise)
            losses_t = torch.stack(losses)
        metrics = {"Train/Loss": torch.sum(losses_t * weights / torch.sum(weights)),
                   **agg_metrics}
        return new_global, server_state, metrics

    def run_round(self, round_idx: int, global_variables: StateDict, server_state=()):
        """One round, staged and run: ``(new_global, server_state, metrics)``."""
        return self.run_staged_round(self.stage_round(round_idx), global_variables,
                                     server_state)

    def run_cohort_round(self, cohort, round_idx: int, global_variables: StateDict,
                         server_state=()):
        """One round over an explicit ``cohort`` (client ids), staged and
        run (``engine.py:1636-1644``): what compositions that pick their own
        cohorts (hierarchical FedAvg's groups) dispatch, one at a time."""
        return self.run_staged_round(self.stage_cohort_round(cohort, round_idx),
                                     global_variables, server_state)

    @staticmethod
    def _graph_key(staged: Staged) -> tuple:
        draws = staged.draws or {}
        return tuple(staged.idx.shape), tuple((k, tuple(d.shape)) for k, d in sorted(draws.items()))

    def capture_round_graph(self, round_idx: int = 0, staged: BlockStaged | None = None,
                            variables: StateDict | None = None, server_state=None) -> float:
        """Capture the round as a CUDA graph for block dispatch on the card
        (``sim/graphs.py``), warmed up on round ``round_idx`` (or on block
        ``staged``'s first round) and on ``variables`` (default: fresh
        ones); returns the seconds the warm-up and the capture took, 0 if
        this FedSim already holds the graph. :meth:`run` calls it before its
        first block and before its prefetch thread starts; a caller who
        calls it first keeps the capture out of the rounds it times."""
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {self.device}")
        if not self._on_device:
            raise ValueError("block dispatch needs the on-device dataset (stage_on_device): "
                             "a block's rounds gather from it")
        first = (staged if staged is not None else self.stage_block(round_idx, 1)).round(0)
        key = self._graph_key(first)
        if key in self._graphs:
            return 0.0
        t0 = time.perf_counter()
        if variables is None:
            variables = self.init_round_variables()
        if server_state is None:
            server_state = self.aggregator.init_state(variables)
        self._graphs[key] = RoundGraph(self, first, variables, server_state)
        return time.perf_counter() - t0

    def run_block(self, start_round: int, n_rounds: int, global_variables: StateDict,
                  server_state=(), staged: BlockStaged | None = None):
        """Run ``n_rounds`` consecutive rounds as one dispatch
        (``engine.py:1335-1365``; on-device dataset only). Returns
        ``(variables, server_state, metrics)``, each metric stacked with a
        leading ``[n_rounds]`` axis. On the card each round replays the
        FedSim's CUDA graph of the round (captured at the first block), the
        global model and server state carried on the device; a failed
        capture or replay raises. On the CPU the rounds run one after
        another. ``staged`` passes a :meth:`stage_block` payload (the
        pipelined driver's prefetch thread); by default it is staged here."""
        if not self._on_device:
            raise ValueError("run_block requires the on-device dataset path "
                             "(stage_on_device): host-staged rounds dispatch one at a time")
        if self._pack:
            raise ValueError("run_block runs padded rounds: packed rounds (pack_lanes > 0) "
                             "dispatch one pass at a time")
        block = staged if staged is not None else self.stage_block(start_round, n_rounds)
        if (block.round_idx, block.n_rounds) != (start_round, n_rounds):
            raise ValueError(f"run_block({start_round}, {n_rounds}) got the block staged for "
                             f"({block.round_idx}, {block.n_rounds})")
        if self.device.type != "cuda":
            per_round = []
            for j in range(n_rounds):
                global_variables, server_state, metrics = self.run_staged_round(
                    block.round(j), global_variables, server_state)
                per_round.append(metrics)
            return global_variables, server_state, {
                k: torch.stack([m[k] for m in per_round]) for k in per_round[0]}
        self.capture_round_graph(staged=block, variables=global_variables,
                                 server_state=server_state)
        graph = self._graphs[self._graph_key(block.round(0))]
        program = f"block{n_rounds}"
        with trace.span("engine/dispatch", program=program, round=start_round,
                        n_rounds=n_rounds, first=self._first_dispatch(program)):
            return graph.run_block(self, block, global_variables, server_state)

    def _eval(self, variables: StateDict, batches: dict[str, torch.Tensor]):
        summed = self._local_eval(variables, batches)
        total = torch.clamp(summed["test_total"], min=1.0)
        return {"Acc": summed["test_correct"] / total, "Loss": summed["test_loss"] / total}

    def evaluate(self, variables: StateDict) -> dict[str, float]:
        """Pooled eval: ``Train/Acc``/``Train/Loss`` over the (capped) train
        pool, ``Test/Acc``/``Test/Loss`` over the test set, each normalised
        by its masked token or example count. Both evals are queued before
        anything is read, and the four values come back in one copy
        (``engine.py:2013-2039``). Empty for a trainer without
        ``eval_batch``."""
        if not self._can_eval:
            return {}
        if self._on_device:
            train_batches = self._gather_batches(self._dataset, self._train_eval)
        else:
            train_batches = {k: self._stage_put(v) for k, v in self._train_eval.items()}
        queued = [("Train", self._eval(variables, train_batches))]
        if self._test_batches is not None:
            test_batches = (self._test_batches if self._on_device else
                            {k: self._stage_put(v) for k, v in self._test_batches.items()})
            queued.append(("Test", self._eval(variables, test_batches)))
        names = [f"{split}/{m}" for split, _ in queued for m in ("Acc", "Loss")]
        values = torch.stack([out[m].float() for _, out in queued for m in ("Acc", "Loss")])
        return dict(zip(names, values.tolist()))

    @torch.no_grad()
    def _client_eval(self, variables: StateDict, batches: dict[str, torch.Tensor]):
        """Summed metrics of one model on each client of a ``[C, S, B, ...]``
        stack: ``{key: [C]}``. Each step's C batches run as one forward of
        C x B examples; the metric sums are taken per client."""
        module = self.trainer.module
        module.load_state_dict(variables)
        module.eval()
        metric_fn = self.trainer.loss_and_metrics[1]
        C, S, B = batches["mask"].shape[:3]
        summed: dict[str, torch.Tensor] = {}
        for s in range(S):
            batch = {k: v[:, s] for k, v in batches.items()}
            logits = module(batch["x"].reshape((C * B,) + batch["x"].shape[2:]))
            logits = logits.reshape((C, B) + logits.shape[1:])
            m = torch.func.vmap(metric_fn)(logits, batch)
            summed = {k: summed.get(k, 0) + v for k, v in m.items()}
        return summed

    def evaluate_per_client(self, variables: StateDict, client_ids=None,
                            data: cohortlib.FederatedArrays | None = None,
                            batch_size: int | None = None,
                            chunk: int = 64) -> dict[str, np.ndarray]:
        """Server-side eval of one model on every client's shard
        (``engine.py:1930-1987``; the reference's serial
        ``test_on_server_for_all_clients``). Returns the summed metric arrays
        of ``trainer``'s metrics (test_correct/test_total/test_loss), each
        with a leading [num_clients] axis. Clients go in chunks of ``min(chunk,
        len(ids))``; the last chunk is padded with fully masked rows, and each
        chunk's steps are sized by its largest client. ``data`` defaults to
        the train set: gathered from the resident dataset with on-device
        staging, else each chunk's stack built on the host and copied.
        Empty for a trainer without ``eval_batch``."""
        if not self._can_eval:
            return {}
        cfg = self.config
        resident = data is None and self._on_device
        data = data if data is not None else self.train_data
        ids = np.asarray(client_ids if client_ids is not None else np.arange(data.num_clients))
        if len(ids) == 0:
            return {}
        bs = batch_size or cfg.eval_batch_size
        csz = min(chunk, len(ids))
        outs = []
        for lo in range(0, len(ids), csz):
            sel = ids[lo:lo + csz]
            # steps sized by the chunk's largest client, not the population's
            # (the JAX engine's, one compiled shape): the steps cut held only
            # padding, whose metrics are exact zeros
            idx, _ = cohortlib.cohort_index_map(data, sel, bs)
            if csz > len(sel):  # pad rows stay all -1 (fully masked)
                idx = np.concatenate(
                    [idx, np.full((csz - len(sel),) + idx.shape[1:], -1, np.int32)])
            if resident:
                batches = self._gather_batches(self._dataset,
                                               torch.as_tensor(idx, device=self.device))
            else:
                batches = {k: self._stage_put(v) for k, v in
                           cohortlib.gather_index_stack(data.arrays, idx).items()}
            m = self._client_eval(variables, batches)
            outs.append({k: v[:len(sel)].cpu().numpy() for k, v in m.items()})
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def per_client_summary(self, variables: StateDict) -> dict[str, float]:
        """Pooled train metrics from the per-client eval — the numbers the
        reference logs from test_on_server_for_all_clients (sum of per-client
        corrects / totals, FedAVGAggregator.py:139-147)."""
        m = self.evaluate_per_client(variables)
        if not m or "test_total" not in m:
            return {}
        total = max(float(m["test_total"].sum()), 1.0)
        return {
            "Train/AccOnClients": float(m["test_correct"].sum()) / total,
            "Train/LossOnClients": float(m["test_loss"].sum()) / total,
        }

    def eval_record(self, variables: StateDict) -> dict[str, float]:
        """The test-round metric block: pooled eval (+ per-client summary
        when configured). One definition for every run loop."""
        with trace.span("engine/eval", on_clients=self.config.eval_on_clients):
            eval_vars = self.consensus(variables)
            out = self.evaluate(eval_vars)
            if self.config.eval_on_clients:
                out.update(self.per_client_summary(eval_vars))
            return out

    def _dispatch_plan(self, start_round: int) -> list[tuple[int, int]]:
        """The run's dispatch segments ``[(first_round, n_rounds), ...]``
        (``engine.py:2041-2061``): eval-aligned blocks when block dispatch
        is on (every eval falls at a block's end, so accuracy is attributed
        to the right round), single rounds otherwise. Under ``profile_dir``
        the first segment runs alone, so the trace skips it. Deterministic
        up front, so staging can be prefetched ahead of the dispatch loop."""
        cfg = self.config
        freq = max(cfg.frequency_of_the_test, 1)
        plan = []
        r = start_round
        while r < cfg.comm_round:
            next_eval = ((r // freq) + 1) * freq
            n = min(cfg.comm_round, next_eval) - r if self._block_dispatch else 1
            if cfg.profile_dir and r == start_round:
                n = 1
            plan.append((r, n))
            r += n
        return plan

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profiler(self, prof) -> None:
        self._synchronize()
        prof.stop()
        out = Path(self.config.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"fedsim_{time.strftime('%Y%m%d_%H%M%S')}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        logging.info("profile trace written to %s", path)

    def run(self, callback=None, variables: StateDict | None = None, server_state=None,
            start_round: int = 0) -> tuple[StateDict, list[dict]]:
        """Run the configured rounds; returns ``(variables, history)``.
        ``variables``/``server_state``/``start_round`` resume a run; the
        defaults start fresh.

        Rounds are dispatched in the segments of :meth:`_dispatch_plan`: a
        single round through :meth:`run_staged_round`, a block through
        :meth:`run_block`. On the card the round's CUDA graph is captured
        before the first block, ahead of the prefetch thread. With
        ``pipeline_depth`` > 0 (the default) the driver is pipelined: a
        background thread stages upcoming segments while the device runs the
        current one, and metrics drain a segment behind — the host
        synchronises with the device only at eval rounds and at the end.
        Bit-identical to the serial driver (``pipeline_depth=0``); records
        reach ``callback`` and the history in round order, delivered at each
        synchronisation point. Each record holds ``round``, ``round_time``
        (the synchronisation window's per-round wall-time mean, so its sum
        over the run is the run's wall time as in the serial driver),
        ``Train/Loss`` and, on eval rounds, the pooled eval's ``Train/Acc``,
        ``Train/Loss`` (which replaces the round's, as in the JAX engine),
        ``Test/Acc``, ``Test/Loss`` and, with ``eval_on_clients``,
        ``Train/AccOnClients`` and ``Train/LossOnClients``."""
        cfg = self.config
        if variables is None:
            variables = self.init_round_variables()
        if server_state is None:
            server_state = self.aggregator.init_state(variables)
        history: list[dict] = []
        freq = max(cfg.frequency_of_the_test, 1)
        plan = self._dispatch_plan(start_round)
        depth = self.pipeline_depth
        blocks = [segment for segment in plan if segment[1] > 1]
        if blocks and self.device.type == "cuda":
            # a capture may not overlap the prefetch thread's pinned copies
            self.capture_round_graph(blocks[0][0], variables=variables,
                                     server_state=server_state)
        if self._pack and plan and self.device.type == "cuda":
            self.capture_pass_graph(plan[0][0], variables=variables)
        prefetch = Prefetcher(plan, self._stage_segment, depth) if depth and plan else None
        drain = MetricsDrain(depth)
        profiler = None

        def is_eval_round(rr: int) -> bool:
            return (rr + 1) % freq == 0 or rr == cfg.comm_round - 1

        def emit(segment, host_metrics, per_round_time, eval_rec=None):
            r0, n = segment
            for j in range(n):
                rec: dict[str, Any] = {"round": r0 + j, "round_time": per_round_time}
                rec.update({k: float(v[j]) for k, v in host_metrics.items()})
                if eval_rec and j == n - 1:
                    rec.update(eval_rec)
                history.append(rec)
                if callback:
                    callback(rec)
                logging.info("round %d: %s", r0 + j,
                             {k: v for k, v in rec.items() if k != "round"})

        t_mark = time.perf_counter()
        rounds_in_window = 0
        # metrics fetched mid-window (they fell off the drain's back) are
        # held here and emitted at the window's sync point, where the
        # per-round wall time they should carry is known
        pending: list[tuple] = []
        try:
            for segment in plan:
                r0, n = segment
                # start the trace after the first segment so first-call costs
                # don't drown the steady-state rounds (a 1-round run traces
                # its only round)
                if cfg.profile_dir and profiler is None and (
                        r0 > start_round or cfg.comm_round - start_round == 1):
                    profiler = self._start_profiler()
                staged = prefetch.get(segment) if prefetch else self._stage_segment(segment)
                if n == 1:
                    variables, server_state, metrics = self.run_staged_round(
                        staged, variables, server_state)
                    stacked = {k: v.reshape(1) for k, v in metrics.items()}
                else:
                    variables, server_state, stacked = self.run_block(
                        r0, n, variables, server_state, staged=staged)
                rounds_in_window += n
                last = r0 + n - 1
                if is_eval_round(last) or depth == 0:
                    # synchronisation point: fetch everything queued
                    # (including this segment's metrics), then eval
                    with trace.span("engine/sync", round=last):
                        ready = pending + drain.push(segment, stacked) + drain.flush()
                        pending = []
                        if depth == 0:
                            self._synchronize()
                    per_round = (time.perf_counter() - t_mark) / max(rounds_in_window, 1)
                    eval_rec = self.eval_record(variables) if is_eval_round(last) else None
                    for pseg, host in ready:
                        emit(pseg, host, per_round,
                             eval_rec=eval_rec if pseg == segment else None)
                    t_mark = time.perf_counter()
                    rounds_in_window = 0
                else:
                    # non-blocking: metrics that fell off the drain's back
                    # are copied to the host in the background and emitted at
                    # the window's sync point with its timing
                    pending.extend(drain.push(segment, stacked))
        finally:
            if prefetch:
                prefetch.close()
            if profiler is not None:
                self._stop_profiler(profiler)
        return variables, history


def _stack_as_they_come(clients, n: int) -> StateDict:
    """The ``[n, ...]`` stack of ``n`` client state dicts drawn from an
    iterable, each copied into its row as it comes (the scan mode's clients,
    one trained at a time)."""
    stack: StateDict = {}
    count = 0
    for c, tree in enumerate(clients):
        if not stack:
            stack = {k: torch.empty((n,) + v.shape, dtype=v.dtype, device=v.device)
                     for k, v in tree.items()}
        for k, v in tree.items():
            stack[k][c].copy_(v)
        count += 1
    if count != n:
        raise ValueError(f"{count} client models for {n} weights")
    return stack
