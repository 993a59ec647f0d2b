"""The federated-simulation engine, the port of ``fedml_tpu/sim/engine.py``.

One FedAvg round: sample the cohort with the reference's seeded numpy draw,
stage its ``[C, S, B]`` index map, gather the cohort's batches on the
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
round, client slot), so both modes train on the same augmented batches.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any

import numpy as np
import torch

from fedml_tpu_torch.algorithms.base import Aggregator, EmptyRoundError, fedavg_aggregator
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.trainer import (ClientTrainer, make_local_eval, make_local_train,
                                          make_vmap_train)
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.ops import augment as augmentlib
from fedml_tpu_torch.sim import cohort as cohortlib

StateDict = dict[str, torch.Tensor]

# SimConfig fields of the JAX engine that the port does not implement yet
# (both cohort modes are ported; these are the rest): the values the port
# accepts (the JAX default first) and the ROADMAP item that ports the rest.
# stage_on_device=True, block_dispatch=False and pipeline_depth=0 describe
# what the port does anyway.
_NOT_PORTED = {
    "straggler_frac": ((0.0,), "§A10"),
    "population": ((None,), "§A10"),
    "population_trace": ((None,), "§A10"),
    "population_seed": ((None,), "§A10"),
    "eval_on_clients": ((False,), "§A4"),
    "stage_on_device": ((None, True), "§A4: the port keeps the dataset on the device"),
    "block_dispatch": ((None, False), "§A4"),
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
    "pipeline_depth": ((None, 0), "§A4"),
    "profile_dir": ((None,), "§A4"),
}


@dataclasses.dataclass
class SimConfig:
    """Flag names follow the reference CLI (main_fedavg.py:46-130).
    ``cohort_execution`` is ``"vmap"`` (every client at once, the default)
    or ``"scan"`` (one after another). The fields after it are the JAX
    engine's that the port does not implement yet: a value the port does not
    implement raises."""

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


class FedSim:
    """Federated simulator on one device, in either cohort mode
    (``config.cohort_execution``: ``"vmap"`` trains the cohort at once,
    ``"scan"`` one client after another; a model the vmap mode cannot run
    raises, it is never trained in scan instead).

    Parameters
    ----------
    trainer: ClientTrainer (module + task + optimizer + epochs +
        augmentation); its module must live on ``device``
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

    def _put(self, arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v), device=self.device) for k, v in arrays.items()}

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
        num_steps = np.full(len(cohort), cfg.epochs * self._steps, np.int32)
        return idx, weights, num_steps

    def _round_draws(self, round_idx: int, n_clients: int):
        """The round's augmentation draws, ``[C, E, S, B]`` tensors on the
        device, client slot c's drawn on the CPU from
        :func:`~fedml_tpu_torch.ops.augment.round_generator` (so the card and
        the CPU draw the same); None when the trainer does not augment."""
        aug = self.trainer.augment
        if aug is None:
            return None
        shape = (self.trainer.epochs, self._steps, self.config.batch_size)
        image = tuple(self._dataset["x"].shape[1:3])
        per = [aug.draw(augmentlib.round_generator(self.config.seed, round_idx, c), shape, image)
               for c in range(n_clients)]
        return {k: torch.stack([d[k] for d in per]).to(self.device) for k in per[0]}

    def run_round(self, round_idx: int, global_variables: StateDict, server_state=()):
        """One round: returns ``(new_global, server_state, metrics)`` with
        ``metrics["Train/Loss"]`` the sample-weighted mean of the clients'
        train losses."""
        cfg = self.config
        cohort = rnglib.sample_clients(round_idx, cfg.client_num_in_total,
                                       cfg.client_num_per_round)
        if len(cohort) == 0:
            raise EmptyRoundError(f"round {round_idx}: the cohort is empty")
        idx, weights, num_steps = self._host_cohort_indices(cohort, round_idx)
        idx = torch.as_tensor(idx, device=self.device)
        weights = torch.as_tensor(weights, device=self.device)
        draws = self._round_draws(round_idx, len(cohort))
        if cfg.cohort_execution == "vmap":
            stacked, train_metrics = self._vmap_train(
                global_variables, self._gather_batches(self._dataset, idx),
                torch.as_tensor(num_steps, device=self.device), draws)
            new_global, server_state, agg_metrics = self.aggregator.aggregate(
                global_variables, iter(treelib.unstack(stacked, len(cohort))), weights,
                server_state)
            losses_t = train_metrics["train_loss"]
        else:
            losses: list[torch.Tensor] = []

            def trained_clients():
                for c in range(len(cohort)):
                    data = self._gather_batches(self._dataset, idx[c])
                    variables, metrics = self._local_train(
                        global_variables, data, int(num_steps[c]),
                        None if draws is None else {k: d[c] for k, d in draws.items()})
                    losses.append(metrics["train_loss"])
                    yield variables

            new_global, server_state, agg_metrics = self.aggregator.aggregate(
                global_variables, trained_clients(), weights, server_state)
            losses_t = torch.stack(losses)
        metrics = {"Train/Loss": torch.sum(losses_t * weights / torch.sum(weights)),
                   **agg_metrics}
        return new_global, server_state, metrics

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

    def eval_record(self, variables: StateDict) -> dict[str, float]:
        """The test-round metric block (pooled eval)."""
        return self.evaluate(variables)

    def run(self, variables: StateDict | None = None) -> tuple[StateDict, list[dict]]:
        """Run the configured rounds; returns ``(variables, history)``. Each
        record holds ``round``, ``round_time`` (seconds of the round, up to
        its synchronisation, eval excluded), ``Train/Loss`` and, on test
        rounds, the pooled eval's ``Train/Acc``, ``Train/Loss`` (which
        replaces the round's, as in the JAX engine), ``Test/Acc`` and
        ``Test/Loss``."""
        cfg = self.config
        if variables is None:
            variables = self.init_variables()
        server_state = self.aggregator.init_state(variables)
        freq = max(cfg.frequency_of_the_test, 1)
        history: list[dict] = []
        for r in range(cfg.comm_round):
            t0 = time.perf_counter()
            variables, server_state, metrics = self.run_round(r, variables, server_state)
            rec: dict[str, Any] = {"round": r}
            rec.update({k: float(v) for k, v in metrics.items()})  # synchronises
            rec["round_time"] = time.perf_counter() - t0
            if (r + 1) % freq == 0 or r == cfg.comm_round - 1:
                rec.update(self.eval_record(variables))
            history.append(rec)
            logging.info("round %d: %s", r, {k: v for k, v in rec.items() if k != "round"})
        return variables, history
