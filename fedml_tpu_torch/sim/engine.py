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

:meth:`FedSim.run` is the JAX engine's driver (``engine.py:2069-2183``):
with ``pipeline_depth`` >= 1 (the default, depth 1) a background thread
stages the next rounds (``sim/prefetch.py``) into pinned host memory and
copies them non-blocking, and round metrics are fetched a round behind,
so the host synchronises with the device only at eval rounds and at the end;
``pipeline_depth=0`` is the serial driver. Both give bitwise-equal
histories: staging is a pure function of (seed, round). At eval rounds it
runs the pooled eval and, with ``eval_on_clients``, the per-client server
eval (:meth:`FedSim.evaluate_per_client`). ``profile_dir`` records a
``torch.profiler`` Chrome trace of the rounds after the first.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from fedml_tpu_torch.algorithms.base import Aggregator, EmptyRoundError, fedavg_aggregator
from fedml_tpu_torch.algorithms.fedprox import straggler_epochs
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.trainer import (ClientTrainer, DropoutStream, make_local_eval,
                                          make_local_train, make_vmap_train)
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.ops import augment as augmentlib
from fedml_tpu_torch.sim import cohort as cohortlib
from fedml_tpu_torch.sim.prefetch import MetricsDrain, Prefetcher

StateDict = dict[str, torch.Tensor]

# SimConfig fields of the JAX engine that the port does not implement yet:
# the values the port accepts (the JAX default first) and the ROADMAP item
# that ports the rest. stage_on_device=True and block_dispatch=False
# describe what the port does anyway.
_NOT_PORTED = {
    "population": ((None,), "§A10"),
    "population_trace": ((None,), "§A10"),
    "population_seed": ((None,), "§A10"),
    "stage_on_device": ((None, True), "§A4: the port keeps the dataset on the device"),
    "block_dispatch": ((None, False), "§A4: whole-round blocks in one program"),
    "pack_lanes": ((0,), "§A10"),
    "pack_capacity_factor": ((1.25,), "§A10"),
    "compressor": (("none",), "§A10"),
    "topk_frac": ((0.01,), "§A10"),
    "quantize_bits": ((8,), "§A10"),
    "downlink_compressor": (("none",), "§A11"),
    "robust_rule": (("mean",), "§A10"),
    "norm_bound": ((0.0,), "§A10"),
    "dp_stddev": ((0.0,), "§A10"),
    "error_feedback": ((True,), "§A10"),
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
    ``pipeline_depth`` is the driver's staging depth (None = 1, 0 = serial);
    ``profile_dir`` records a ``torch.profiler`` trace. A value of the JAX
    engine's other fields that the port does not implement raises."""

    client_num_in_total: int = 10
    client_num_per_round: int = 10
    batch_size: int = 32
    comm_round: int = 10
    epochs: int = 1  # local epochs per round
    frequency_of_the_test: int = 1
    eval_batch_size: int = 256
    seed: int = 0
    shuffle_each_round: bool = True
    # cap the pooled train eval to the first N samples (None = all)
    train_eval_samples: int | None = None
    # "vmap": every client of the cohort at once; "scan": one after another
    cohort_execution: str = "vmap"
    straggler_frac: float = 0.0
    population: str | None = None
    population_trace: str | None = None
    population_seed: int | None = None
    eval_on_clients: bool = False
    stage_on_device: bool | None = None
    block_dispatch: bool | None = None
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
        for name, (accepted, item) in _NOT_PORTED.items():
            value = getattr(self, name)
            if value not in accepted:
                raise NotImplementedError(
                    f"SimConfig.{name}={value!r} is not ported to fedml_tpu_torch yet "
                    f"(ROADMAP {item}); leave it at {accepted[0]!r}")


@dataclasses.dataclass(frozen=True)
class Staged:
    """One round's staged payload (:meth:`FedSim.stage_round`): the cohort,
    its ``[C, S, B]`` index map, ``[C]`` weights and step budgets on the
    device (the budgets also on the host, for the scan mode), and the
    augmentation draws."""

    round_idx: int
    cohort: np.ndarray
    idx: torch.Tensor
    weights: torch.Tensor
    num_steps: torch.Tensor
    num_steps_host: np.ndarray
    draws: dict | None


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
    aggregator: server rule; defaults to the FedAvg weighted mean
    device: where the dataset, the model and the round run
    """

    def __init__(self, trainer: ClientTrainer, train_data: cohortlib.FederatedArrays,
                 test_arrays: dict[str, np.ndarray] | None, config: SimConfig,
                 aggregator: Aggregator | None = None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.trainer = trainer
        self.train_data = train_data
        self.config = config
        self.aggregator = aggregator or fedavg_aggregator()
        if config.cohort_execution == "vmap":
            self._vmap_train = make_vmap_train(trainer)
        else:
            self._local_train = make_local_train(trainer)
        self._local_eval = make_local_eval(trainer)
        # pin steps-per-epoch to the population max, as the JAX engine does
        self._steps = cohortlib.steps_per_epoch(train_data.max_client_size(), config.batch_size)
        # the training arrays live on the device; each round gathers from them
        self._dataset = self._put(train_data.arrays)
        self._test_batches = (
            self._put(cohortlib.batch_array(test_arrays, config.eval_batch_size))
            if test_arrays is not None else None
        )
        n_eval = train_data.num_samples
        if config.train_eval_samples is not None:
            n_eval = min(n_eval, config.train_eval_samples)
        bs = config.eval_batch_size
        eidx = np.full(cohortlib.steps_per_epoch(n_eval, bs) * bs, -1, np.int32)
        eidx[:n_eval] = np.arange(n_eval, dtype=np.int32)
        self._train_eval_idx = torch.as_tensor(eidx.reshape(-1, bs), device=self.device)

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
        """The global model the rounds start from: :meth:`init_variables`,
        with ``overrides`` (a partial state dict, name -> tensor) grafted
        over it. The port runs broadcast mode only, so this is the model
        itself (the JAX engine's per-client stacked layout is §A10's)."""
        v = self.init_variables()
        for k, t in (overrides or {}).items():
            if k not in v or tuple(t.shape) != tuple(v[k].shape):
                raise ValueError(f"override {k!r} {tuple(t.shape)} matches no variable of the "
                                 f"model ({tuple(v[k].shape) if k in v else 'no such name'})")
            v[k] = torch.as_tensor(t).to(self.device, v[k].dtype)
        return v

    def consensus(self, variables: StateDict) -> StateDict:
        """A single evaluable model: the identity in broadcast mode."""
        return variables

    def _round_budgets(self, cohort, round_idx: int) -> np.ndarray:
        """Per-client local-step budgets (scan-step units): stragglers run a
        reduced epoch count e_i, i.e. the first e_i * steps-per-epoch steps."""
        cfg = self.config
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
        return idx, weights, self._round_budgets(cohort, round_idx)

    def _round_draws(self, round_idx: int, n_clients: int):
        """The round's augmentation draws, ``[C, E, S, B]`` CPU tensors,
        client slot c's drawn from
        :func:`~fedml_tpu_torch.ops.augment.round_generator` (so the card and
        the CPU draw the same); None when the trainer does not augment."""
        aug = self.trainer.augment
        if aug is None:
            return None
        shape = (self.trainer.epochs, self._steps, self.config.batch_size)
        image = tuple(self._dataset["x"].shape[1:3])
        per = [aug.draw(augmentlib.round_generator(self.config.seed, round_idx, c), shape, image)
               for c in range(n_clients)]
        return {k: torch.stack([d[k] for d in per]) for k in per[0]}

    def stage_round(self, round_idx: int) -> Staged:
        """All host work for one round: cohort sampling, the index map,
        weights, step budgets and augmentation draws, copied to the device.
        Pure in (config, round_idx), so staging it ahead of the dispatch
        loop (``sim/prefetch.py``) cannot change cohorts or metrics."""
        cfg = self.config
        cohort = rnglib.sample_clients(round_idx, cfg.client_num_in_total,
                                       cfg.client_num_per_round)
        if len(cohort) == 0:
            raise EmptyRoundError(f"round {round_idx}: the cohort is empty")
        idx, weights, num_steps = self._host_cohort_indices(cohort, round_idx)
        draws = self._round_draws(round_idx, len(cohort))
        return Staged(
            round_idx, cohort, self._stage_put(idx), self._stage_put(weights),
            self._stage_put(num_steps), num_steps,
            None if draws is None else {k: self._stage_put(d) for k, d in draws.items()})

    def run_staged_round(self, staged: Staged, global_variables: StateDict,
                         server_state=()):
        """One round from a :meth:`stage_round` payload: returns
        ``(new_global, server_state, metrics)`` with ``metrics["Train/Loss"]``
        the sample-weighted mean of the clients' train losses (a device
        tensor: nothing here waits for the device)."""
        cfg = self.config
        n = len(staged.cohort)
        weights, draws = staged.weights, staged.draws
        dropout = (DropoutStream(self.trainer.dropout_sites, cfg.seed, staged.round_idx, n,
                                 cfg.batch_size, self.device)
                   if self.trainer.dropout_sites else None)
        if cfg.cohort_execution == "vmap":
            stacked, train_metrics = self._vmap_train(
                global_variables, self._gather_batches(self._dataset, staged.idx),
                staged.num_steps, draws, dropout)
            new_global, server_state, agg_metrics = self.aggregator.aggregate(
                global_variables, iter(treelib.unstack(stacked, n)), weights, server_state)
            losses_t = train_metrics["train_loss"]
        else:
            losses: list[torch.Tensor] = []

            def trained_clients():
                for c in range(n):
                    data = self._gather_batches(self._dataset, staged.idx[c])
                    variables, metrics = self._local_train(
                        global_variables, data, int(staged.num_steps_host[c]),
                        None if draws is None else {k: d[c] for k, d in draws.items()},
                        dropout, c)
                    losses.append(metrics["train_loss"])
                    yield variables

            new_global, server_state, agg_metrics = self.aggregator.aggregate(
                global_variables, trained_clients(), weights, server_state)
            losses_t = torch.stack(losses)
        metrics = {"Train/Loss": torch.sum(losses_t * weights / torch.sum(weights)),
                   **agg_metrics}
        return new_global, server_state, metrics

    def run_round(self, round_idx: int, global_variables: StateDict, server_state=()):
        """One round, staged and run: ``(new_global, server_state, metrics)``."""
        return self.run_staged_round(self.stage_round(round_idx), global_variables,
                                     server_state)

    def _eval(self, variables: StateDict, batches: dict[str, torch.Tensor]):
        summed = self._local_eval(variables, batches)
        total = torch.clamp(summed["test_total"], min=1.0)
        return {"Acc": summed["test_correct"] / total, "Loss": summed["test_loss"] / total}

    def evaluate(self, variables: StateDict) -> dict[str, float]:
        """Pooled eval: ``Train/Acc``/``Train/Loss`` over the (capped) train
        pool, ``Test/Acc``/``Test/Loss`` over the test set, each normalised
        by its masked token or example count."""
        train_m = self._eval(variables,
                             self._gather_batches(self._dataset, self._train_eval_idx))
        out = {"Train/Acc": float(train_m["Acc"]), "Train/Loss": float(train_m["Loss"])}
        if self._test_batches is not None:
            test_m = self._eval(variables, self._test_batches)
            out["Test/Acc"] = float(test_m["Acc"])
            out["Test/Loss"] = float(test_m["Loss"])
        return out

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
        the resident train set."""
        cfg = self.config
        resident = data is None
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
                batches = self._put(cohortlib.gather_index_stack(data.arrays, idx))
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
        eval_vars = self.consensus(variables)
        out = self.evaluate(eval_vars)
        if self.config.eval_on_clients:
            out.update(self.per_client_summary(eval_vars))
        return out

    def _dispatch_plan(self, start_round: int) -> list[tuple[int, int]]:
        """The run's dispatch segments ``[(first_round, n_rounds), ...]``:
        single rounds (block dispatch is not ported). Deterministic up
        front, so staging can be prefetched ahead of the dispatch loop."""
        return [(r, 1) for r in range(start_round, self.config.comm_round)]

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

        With ``pipeline_depth`` > 0 (the default) the driver is pipelined: a
        background thread stages upcoming rounds while the device runs the
        current one, and round metrics drain a round behind — the host
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
        prefetch = (Prefetcher(plan, lambda segment: self.stage_round(segment[0]), depth)
                    if depth and plan else None)
        drain = MetricsDrain(depth)
        profiler = None

        def is_eval_round(rr: int) -> bool:
            return (rr + 1) % freq == 0 or rr == cfg.comm_round - 1

        def emit(segment, host_metrics, per_round_time, eval_rec=None):
            rec: dict[str, Any] = {"round": segment[0], "round_time": per_round_time}
            rec.update({k: float(v) for k, v in host_metrics.items()})
            if eval_rec:
                rec.update(eval_rec)
            history.append(rec)
            if callback:
                callback(rec)
            logging.info("round %d: %s", segment[0],
                         {k: v for k, v in rec.items() if k != "round"})

        t_mark = time.perf_counter()
        rounds_in_window = 0
        # metrics fetched mid-window (they fell off the drain's back) are
        # held here and emitted at the window's sync point, where the
        # per-round wall time they should carry is known
        pending: list[tuple] = []
        try:
            for segment in plan:
                r0 = segment[0]
                # start the trace after the first round so first-call costs
                # don't drown the steady-state rounds (a 1-round run traces
                # its only round)
                if cfg.profile_dir and profiler is None and (
                        r0 > start_round or cfg.comm_round - start_round == 1):
                    profiler = self._start_profiler()
                staged = prefetch.get(segment) if prefetch else self.stage_round(r0)
                variables, server_state, metrics = self.run_staged_round(
                    staged, variables, server_state)
                rounds_in_window += 1
                if is_eval_round(r0) or depth == 0:
                    # synchronisation point: fetch everything queued
                    # (including this round's metrics), then eval
                    ready = pending + drain.push(segment, metrics) + drain.flush()
                    pending = []
                    if depth == 0:
                        self._synchronize()
                    per_round = (time.perf_counter() - t_mark) / max(rounds_in_window, 1)
                    eval_rec = self.eval_record(variables) if is_eval_round(r0) else None
                    for pseg, host in ready:
                        emit(pseg, host, per_round,
                             eval_rec=eval_rec if pseg == segment else None)
                    t_mark = time.perf_counter()
                    rounds_in_window = 0
                else:
                    # non-blocking: metrics that fell off the drain's back
                    # are copied to the host in the background and emitted at
                    # the window's sync point with its timing
                    pending.extend(drain.push(segment, metrics))
        finally:
            if prefetch:
                prefetch.close()
            if profiler is not None:
                self._stop_profiler(profiler)
        return variables, history
