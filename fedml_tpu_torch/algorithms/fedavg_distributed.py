"""Distributed FedAvg over the message-passing comm layer, the port of
``fedml_tpu/algorithms/fedavg_distributed.py``.

Reference: the canonical 6-file package fedml_api/distributed/fedavg/ —
message_define.py:6-9 (S2C_INIT_CONFIG=1, S2C_SYNC_MODEL=2, C2S_SEND_MODEL=3),
FedAvgServerManager.py:18-82 (round loop in the receive handler),
FedAvgClientManager.py:18-72, FedAVGAggregator.py:13-164.

Server and clients are managers exchanging typed array messages over a comm
fabric: the in-process loopback, the native shm rings, gRPC, or MQTT with an
object store for the payloads (the runners below). What crosses the wire is
the JAX package's, byte for byte:
the model as ``pack_pytree`` bytes in the JAX layout, so a JAX server folds
a port client's upload unchanged and a port client trains from a JAX
server's sync, in one federation.

- **Server.** The round tally stays host numpy: each upload folds into ONE
  f64 accumulator on arrival (or at round close, the buffered arm), exactly
  the JAX package's arithmetic, so the same upload bytes in the same order
  give the bitwise-same global. The round timeout, exclusion, readmission,
  checkpoint/restore, the fold plane and fleet telemetry are the JAX
  server's.
- **Client.** A sync's bytes are unpacked and moved into the port's layout
  (``convert.from_flax``), trained with ``make_local_train`` on the
  trainer's device (the card unless the module lives on the CPU), and
  uploaded through ``convert.to_flax``. The batches are the JAX client's:
  ``stack_cohort`` with ``RandomState(1000 + round)``. Every client of the
  process trains under one lock (``TRAIN_LOCK``): the trainer's module is
  the working copy of the model, and one card runs one client at a time
  anyway. A compressed upload is encoded in the JAX layout (the delta
  moved to flax's leaves, in JAX's sorted path order, on the device), so
  top-k's indices and q4's nibble pairs are the JAX client's on the same
  delta; the error-feedback residual is kept in that layout, keyed by
  client index.
- **Random draws.** The JAX client trains under ``key(rng_rank * 100003 +
  round)`` and quantizes under ``fold_in(key(0xC0DEC ^ rank), round)``.
  JAX's keys cannot be reproduced in torch: the port seeds its dropout
  stream and augmentation draws with ``rng_rank * 100003 + round`` and the
  quantizer's :class:`~fedml_tpu_torch.core.rng.RoundNoise` with ``(0xC0DEC
  ^ rank, round)``, the same integers and other numbers (ROADMAP §C).

Fault injection (``comm/faults.py``), the population adapter
(``population/wire.py``), heartbeats with the server's SLOW judgement
(``comm/status.py``) and the robust wire server
(``algorithms/robust_distributed.py``) are the JAX runner's, and so is the
buffered-async server (``server_mode="async"``, ``async_agg/server.py``),
for which the sync carries the model version (``_sync_extra_params``) and
the client echoes it. Refused, naming its ROADMAP item: the downlink delta
codec (§A11.4).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms.base import EmptyRoundError
from fedml_tpu_torch.algorithms.fold_plane import DenseFoldTask, FoldPlane, FoldTask
from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.managers import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import (
    Message,
    pack_pytree,
    tree_leaves_with_paths,
    unpack_pytree,
)
from fedml_tpu_torch.comm.send_pool import BroadcastSendError
from fedml_tpu_torch.comm.status import ClientStatus, ClientStatusTracker, HeartbeatSender
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core.trainer import ClientTrainer, DropoutStream, make_local_train
from fedml_tpu_torch.obs import jobscope, registry
from fedml_tpu_torch.obs import metrics as metricslib
from fedml_tpu_torch.obs import trace
from fedml_tpu_torch.sim.cohort import FederatedArrays, stack_cohort

StateDict = dict[str, torch.Tensor]

# every wire client of the process trains under this lock (module docstring)
TRAIN_LOCK = threading.Lock()


class MyMessage:
    """Message types (reference message_define.py:6-9)."""

    MSG_TYPE_S2C_INIT_CONFIG = 1
    MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = 2
    MSG_TYPE_C2S_SEND_MODEL_TO_SERVER = 3

    MSG_ARG_KEY_MODEL_PARAMS = Message.MSG_ARG_KEY_MODEL_PARAMS
    MSG_ARG_KEY_MODEL_DESC = Message.MSG_ARG_KEY_MODEL_DESC
    MSG_ARG_KEY_NUM_SAMPLES = Message.MSG_ARG_KEY_NUM_SAMPLES
    MSG_ARG_KEY_CLIENT_INDEX = Message.MSG_ARG_KEY_CLIENT_INDEX
    MSG_ARG_KEY_ROUND_IDX = Message.MSG_ARG_KEY_ROUND_IDX


def _unported(what: str, item: str = "§A11") -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to fedml_tpu_torch yet: ROADMAP {item}")


# -- the JAX layout on the wire ------------------------------------------------


def unpack_state(flat: np.ndarray, desc: str) -> StateDict:
    """Sync bytes (``pack_pytree`` of the JAX layout) as the port's state
    dict of host tensors: each read-only wire view is copied once."""
    return convert.from_flax(unpack_pytree(flat, desc))


def pack_state(variables: StateDict) -> np.ndarray:
    """The port's state dict as upload bytes: ``pack_pytree`` of its JAX
    layout, the bytes a JAX client sends for the same values."""
    return pack_pytree(convert.to_flax(variables))[0]


def jax_layout(variables: StateDict) -> StateDict:
    """The variables in the JAX layout, kept on their device: flax's leaves
    keyed by their ``/``-joined path, in JAX's sorted path order (the order
    ``pack_pytree`` and JAX's codecs visit them)."""
    return dict(tree_leaves_with_paths(convert.to_flax_tensors(variables)))


def train_wire_round(trainer: ClientTrainer, local_train, train_data: FederatedArrays,
                     client_idx: int, batch_size: int, round_idx: int, rng_seed: int,
                     variables: StateDict, exec_lock=None) -> tuple[StateDict, float]:
    """One client's local round as the JAX wire client runs it: the batches
    of ``stack_cohort`` under ``RandomState(1000 + round_idx)``, the model
    trained from ``variables`` on the trainer's device; the dropout and
    augmentation draws are seeded with ``rng_seed`` (the JAX client's key
    integer). Returns ``(new variables, sample count)``."""
    batches, weights = stack_cohort(train_data, np.asarray([client_idx]), batch_size,
                                    rng=np.random.RandomState(1000 + round_idx))
    device = next(trainer.module.parameters()).device
    data = {k: torch.from_numpy(v[0]).to(device) for k, v in batches.items()}
    variables = {k: v.to(device) for k, v in variables.items()}
    kw = {}
    if trainer.dropout_sites:
        kw["dropout"] = DropoutStream(trainer.dropout_sites, rng_seed, round_idx, 1,
                                      batch_size, device)
    if trainer.augment is not None:
        E, (S, B) = trainer.epochs, data["mask"].shape[:2]
        kw["draws"] = trainer.augment.draw(rnglib.generator(rng_seed, device), (E, S, B),
                                           tuple(data["x"].shape[2:4]))
    # client/train: the local round alone, inside the lock (a span around
    # the lock would count the wait for the other clients); on the card it
    # times the queueing, the upload's copy to the host waits for the rest
    with exec_lock or TRAIN_LOCK, trace.span("client/train", round=round_idx,
                                             client_idx=client_idx):
        new_vars, _ = local_train(variables, data, **kw)
    return new_vars, float(weights[0])


class FedAvgDistAggregator:
    """Server-side round tally, streaming (accumulate-on-arrival).

    The reference (FedAVGAggregator.py:13-108) buffers every worker's model
    until round end and sums on one thread — O(workers x model) peak host
    memory, with all the summation work serialized at round close. Here each
    upload is folded into ONE f64 accumulator as it lands
    (``acc += n_i * x_i``, ``wsum += n_i``) and ``aggregate()`` divides at
    round close: peak memory is O(model) and the adds amortize over the
    receive timeline. Elastic-timeout renormalization is unchanged — the
    divisor is the weight sum over whoever actually uploaded, so dropped
    stragglers renormalize away.

    Folds happen in arrival order (f64 addition is not associative, so two
    runs with different arrival orders can differ in the accumulator's last
    ULPs — the standard streaming-aggregation tradeoff).
    :class:`BufferedFedAvgDistAggregator` keeps the legacy retain-then-sum
    shape but replays the SAME fold arithmetic in the same arrival order, so
    streaming == buffered bit-for-bit under any schedule
    (the JAX package's tests/test_wire_path.py and the port's tests hold the contract)."""

    def __init__(self, worker_num: int):
        self.worker_num = worker_num
        self.sample_num_dict: dict[int, float] = {}  # guarded-by: _lock
        self.flag_client_model_uploaded_dict = {i: False for i in range(worker_num)}  # guarded-by: _lock
        self._lock = threading.Lock()  # reference hazard fixed (SURVEY §5.2)
        self._acc: np.ndarray | None = None  # guarded-by: _lock
        self._wsum = 0.0  # guarded-by: _lock
        # workers dropped via exclude_worker
        self._excluded: list[int] = []  # guarded-by: _lock
        # sharded fold plane (algorithms/fold_plane.py): None = serial fold
        # on the receive thread, exactly the pre-plane behavior
        self._plane: FoldPlane | None = None
        self._pending_finalize: list[FoldTask] = []  # guarded-by: _lock
        # bumped on every tally mutation (fold submit/apply, finish,
        # restore) — the torn-copy detector for the outside-the-lock
        # snapshot copy (snapshot_state retries while it moves)
        self._fold_epoch = 0  # guarded-by: _lock
        # the plane creates the accumulator at submit time (workers need a
        # target before the first fold lands); if NO submitted task ends up
        # contributing vector mass (a robust all-rejected window) the drain
        # nulls it again so `_acc is None` keeps meaning "empty tally"
        self._acc_provisional = False  # guarded-by: _lock

    def exclude_worker(self, index: int) -> None:
        """Stop expecting this worker (marked OFFLINE): later rounds
        complete on the live set alone instead of re-waiting for the
        timeout every round. Only workers that have NOT uploaded this round
        can be excluded — a streaming tally cannot retract a folded
        contribution (the timeout path only ever excludes missing workers).
        No longer a life sentence: :meth:`readmit_worker` reverses it when
        the worker reappears."""
        with self._lock:
            if self.flag_client_model_uploaded_dict.get(index):
                raise ValueError(
                    f"worker {index} already uploaded this round; a streaming "
                    "tally cannot retract a folded contribution"
                )
            if self.flag_client_model_uploaded_dict.pop(index, None) is not None:
                self._excluded.append(index)
            self.sample_num_dict.pop(index, None)

    def readmit_worker(self, index: int) -> None:
        """Inverse of :meth:`exclude_worker`, applied at a ROUND BOUNDARY
        (the server defers readmission to round close — a mid-round
        readmit would stall the all-received barrier until the returnee
        uploads): the worker re-enters the expected set for later rounds."""
        with self._lock:
            if index in self.flag_client_model_uploaded_dict:
                return  # already live
            self.flag_client_model_uploaded_dict[index] = False
            if index in self._excluded:
                self._excluded.remove(index)

    def excluded_workers(self) -> list[int]:
        with self._lock:
            return sorted(self._excluded)

    def _empty_round_error(self) -> "EmptyRoundError":  # lock-held: _lock
        """Diagnosable all-dropped-round error naming WHICH ranks were
        missing and which were already OFFLINE-excluded (caller holds the
        lock) — an all-dropped round must be debuggable from the log
        alone."""
        flags = self.flag_client_model_uploaded_dict
        msg = (
            "no worker uploads this round: all "
            f"{len(flags)} live workers (ranks "
            f"{sorted(i + 1 for i in flags)}) were dropped by the round "
            "timeout"
        )
        if self._excluded:
            msg += (f"; ranks {sorted(i + 1 for i in self._excluded)} "
                    "already excluded as OFFLINE")
        msg += ("; keeping the previous global model — nothing to "
                "aggregate")
        return EmptyRoundError(msg)

    # -- crash-recovery snapshot (docs/ROBUSTNESS.md "Failure recovery") -----

    def snapshot_state(self) -> dict:
        """Round-close tally snapshot for the server checkpoint: np.ndarray
        values plus JSON-safe scalars (obs.checkpoint.RoundCheckpointer.
        save_server splits them). Saved at round close, when the streaming
        accumulator is empty; mid-round acc/wsum are included anyway so a
        future mid-round snapshotter inherits them for free.

        The full-model accumulator copy happens OUTSIDE the lock (the
        checkpoint-write-outside-lock discipline — a checkpoint must not
        stall arriving folds): grab the reference and the fold epoch under
        the lock, copy unlocked, and retry if the epoch moved (a fold
        landed mid-copy — serial or from a plane worker — so the copy may
        be torn)."""
        while True:
            with self._lock:
                self._drain_locked()
                epoch = self._fold_epoch
                acc_ref = self._acc
                out: dict = {
                    "wsum": float(self._wsum),
                    "live": sorted(self.flag_client_model_uploaded_dict),
                    "uploaded": sorted(
                        i for i, f in
                        self.flag_client_model_uploaded_dict.items() if f
                    ),
                    "excluded": sorted(self._excluded),
                    "sample_num": {str(i): float(v)
                                   for i, v in self.sample_num_dict.items()},
                }
            acc_copy = None if acc_ref is None else np.array(acc_ref)
            with self._lock:
                if self._fold_epoch != epoch:
                    continue  # a fold landed mid-copy; re-snapshot
                if acc_copy is not None:
                    out["acc"] = acc_copy
                return out

    def restore_state(self, state: dict) -> None:
        with self._lock:
            # retire any in-flight folds against the PRE-restore tally
            # first: their target array and scalar bookkeeping are both
            # replaced wholesale below, exactly as a serial restore
            # overwrites folds that already landed
            self._drain_locked()
            self._fold_epoch += 1
            self._acc_provisional = False
            self._wsum = float(state.get("wsum", 0.0))
            acc = state.get("acc")
            self._acc = None if acc is None else np.asarray(acc, np.float64)
            live = state.get("live")
            if live is not None:
                uploaded = {int(i) for i in state.get("uploaded", [])}
                self.flag_client_model_uploaded_dict = {
                    int(i): int(i) in uploaded for i in live
                }
            self._excluded = [int(i) for i in state.get("excluded", [])]
            self.sample_num_dict = {
                int(i): float(v)
                for i, v in state.get("sample_num", {}).items()
            }

    def live_workers(self) -> list[int]:
        with self._lock:
            return sorted(self.flag_client_model_uploaded_dict)

    def is_live(self, index: int) -> bool:
        with self._lock:
            return index in self.flag_client_model_uploaded_dict

    # -- sharded fold plane seam (algorithms/fold_plane.py) ------------------

    def attach_fold_plane(self, plane: FoldPlane) -> None:
        """Arm the chunk-parallel fold plane: subsequent arrivals that have
        a task form (:meth:`_fold_task`) enqueue to the plane's workers
        instead of folding on the receive thread. Aggregator families whose
        fold is not chunkable (a non-mean robust rule) override this to a
        no-op and keep the serial path."""
        self._plane = plane

    def close_fold_plane(self) -> None:
        """Shut the plane's workers down (idempotent; serial-mode no-op)."""
        if self._plane is not None:
            self._plane.close()

    def _fold_task(self, payload, weight: float) -> FoldTask | None:
        """The family-specific task form of one arrival, or None when this
        payload must fold serially (caller holds the lock)."""
        return DenseFoldTask(payload, weight)

    def _fold_arrival(self, payload, weight: float) -> None:  # lock-held: _lock
        """Arrival-order fold dispatch: serial ``_fold`` when the plane is
        off (or the payload has no task form — the queues drain first so a
        mixed schedule stays in arrival order), task submit when it is on.
        Caller holds ``_lock``, so plane sequence order IS arrival order."""
        self._fold_epoch += 1
        task = self._fold_task(payload, weight) if self._plane is not None else None
        if task is None:
            self._drain_locked()
            self._fold(payload, weight)
            return
        if self._acc is None:
            self._acc = np.zeros(task.acc_elems, np.float64)
            self._acc_provisional = True
            task.first = True
        self._pending_finalize.append(task)
        self._plane.submit(task, self._acc)

    def _drain_locked(self) -> None:  # lock-held: _lock
        """Quiesce the plane before any read of the tally: help-fold
        whatever is still queued (wait-free — see FoldPlane.drain), then
        run each task's scalar finalize in arrival order so order-sensitive
        float sums (weight totals, defense stats) reproduce the serial
        bits. Every tally reader (aggregate / snapshot / restore / emit /
        export) calls this first."""
        if self._plane is None or not self._pending_finalize:
            return
        t0 = time.perf_counter()
        with trace.span("fold/drain", pending=len(self._pending_finalize)):
            self._plane.drain()
            pending, self._pending_finalize = self._pending_finalize, []
            folded = False
            for task in pending:
                folded = bool(task.finalize(self)) or folded
            if self._acc_provisional:
                self._acc_provisional = False
                if not folded:
                    self._acc = None
        registry.observe(metricslib.FOLD_STALL_MS,
                         (time.perf_counter() - t0) * 1000.0)

    def _fold(self, payload, sample_num: float) -> None:  # lock-held: _lock
        """Fold one upload into the running tally (caller holds the lock).
        Payloads are pack_pytree byte vectors; model leaves are float32
        (validated against the descriptor at server init), so the weighted
        accumulation runs on an f32 view."""
        self._fold_epoch += 1
        x = np.ascontiguousarray(payload).view(np.float32)
        if self._acc is None:
            self._acc = np.zeros(x.size, np.float64)
        self._acc += np.multiply(x, float(sample_num), dtype=np.float64)
        self._wsum += float(sample_num)

    def _finish(self) -> np.ndarray:  # lock-held: _lock
        """Close the tally (caller holds the lock): divide by the weight sum
        and return wire bytes."""
        self._fold_epoch += 1
        out = (self._acc / self._wsum).astype(np.float32).view(np.uint8)
        self._acc = None
        self._wsum = 0.0
        return out

    def add_local_trained_result(self, index: int, flat_params: np.ndarray, sample_num: float) -> bool:
        with self._lock:
            flags = self.flag_client_model_uploaded_dict
            if index not in flags:
                return False  # excluded (OFFLINE) worker resurfaced; ignore
            if flags[index]:
                # duplicate upload within one round: first wins (a streaming
                # tally cannot replace a folded contribution; the protocol's
                # round-idx guard keeps this unreachable in practice)
                return all(flags.values())
            self._fold_arrival(flat_params, sample_num)
            self.sample_num_dict[index] = sample_num
            flags[index] = True
            return all(flags.values())

    def received_workers(self) -> list[int]:
        with self._lock:
            return [i for i, f in self.flag_client_model_uploaded_dict.items() if f]

    def aggregate(self) -> np.ndarray:
        # Closes over whichever workers uploaded this round (all of them in
        # the synchronous case; the survivors when the elastic round timeout
        # dropped stragglers) with weights renormalized over that subset.
        with self._lock:
            self._drain_locked()
            flags = self.flag_client_model_uploaded_dict
            if not any(flags.values()):
                raise self._empty_round_error()
            out = self._finish()
            for i in flags:
                flags[i] = False
            return out


class BufferedFedAvgDistAggregator(FedAvgDistAggregator):
    """Legacy-shaped tally (the reference's FedAVGAggregator memory
    profile): retains every worker's payload and folds them at round close —
    in arrival order, through the SAME ``_fold``/``_finish`` arithmetic as
    the streaming base, so the two are bit-identical under any schedule.
    Kept as the A/B reference for the streaming path (``buffered_
    aggregation=True`` on the server manager)."""

    def __init__(self, worker_num: int):
        super().__init__(worker_num)
        # insertion == arrival
        self.model_dict: dict[int, np.ndarray] = {}  # guarded-by: _lock

    def attach_fold_plane(self, plane) -> None:
        """No-op: the buffered A/B arm replays at round close by contract
        (its whole point is the legacy retain-then-sum shape), so there is
        nothing to move off the receive thread."""

    def add_local_trained_result(self, index: int, flat_params: np.ndarray, sample_num: float) -> bool:
        with self._lock:
            flags = self.flag_client_model_uploaded_dict
            if index not in flags:
                return False
            if flags[index]:
                return all(flags.values())
            self.model_dict[index] = flat_params
            self.sample_num_dict[index] = sample_num
            flags[index] = True
            return all(flags.values())

    def aggregate(self) -> np.ndarray:
        with self._lock:
            if not self.model_dict:
                raise self._empty_round_error()
            flags = self.flag_client_model_uploaded_dict
            for i, payload in self.model_dict.items():
                self._fold(payload, self.sample_num_dict[i])
            self.model_dict.clear()
            out = self._finish()
            for i in flags:
                flags[i] = False
            return out



class FedAvgServerManager(ServerManager):
    """Round protocol (FedAvgServerManager.py:31-82)."""

    def __init__(self, comm: BaseCommunicationManager, worker_num: int, round_num: int,
                 init_flat: np.ndarray, model_desc: str,
                 client_num_in_total: int | None = None,
                 round_timeout: float | None = None,
                 exclude_after: int = 2,
                 on_round_done: Callable[[int, np.ndarray], None] | None = None,
                 use_broadcast: bool = True,
                 buffered_aggregation: bool = False,
                 heartbeat_timeout: float | None = None,
                 readmission: bool = False,
                 checkpointer=None,
                 checkpoint_every: int = 1,
                 fleet=None,
                 downlink_codec=None,
                 fold_workers: int = 0,
                 fold_chunk: int | None = None):
        if downlink_codec is not None:
            raise _unported("the downlink delta codec (compress/downlink.py)", "§A11.4")
        super().__init__(comm, rank=0, size=worker_num + 1)
        # sharded fold plane (algorithms/fold_plane.py): fold_workers > 0
        # moves upload folding off the receive thread onto that many chunk
        # workers, bit-identical to the serial fold; 0 keeps the serial path
        self.fold_workers = int(fold_workers)
        self.fold_chunk = fold_chunk
        self.worker_num = worker_num
        self.round_num = round_num
        self.round_idx = 0
        # use_broadcast=False reverts downlink to the per-rank send loop;
        # buffered_aggregation=True reverts the tally to retain-then-sum:
        # both kept as the A/B reference arms
        self.use_broadcast = bool(use_broadcast)
        self.buffered_aggregation = bool(buffered_aggregation)
        self.global_flat = init_flat
        self.model_desc = model_desc
        # elastic rounds: if set, a round closes round_timeout seconds after
        # its first upload even when stragglers are missing; their weight is
        # renormalized away and they are marked OFFLINE in ``status``
        self.round_timeout = round_timeout
        # a worker missing this many CONSECUTIVE timed-out rounds is
        # excluded; with readmission an excluded worker that re-contacts
        # the server rejoins later cohorts
        self.exclude_after = exclude_after
        self._miss_counts: dict[int, int] = {}  # guarded-by: _round_lock
        # liveness plane: a worker missing at the round timeout but heard
        # from (heartbeat/status) within heartbeat_timeout seconds is SLOW:
        # alive, dropped from this round, but not marched toward exclusion
        self.heartbeat_timeout = heartbeat_timeout
        self.readmission = bool(readmission)
        self._pending_readmit: set[int] = set()  # guarded-by: _round_lock
        # crash recovery: a RoundCheckpointer (obs/checkpoint.py) given here
        # snapshots the server round state every checkpoint_every closes;
        # restore_from_checkpoint() resumes
        self.checkpointer = checkpointer
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.status = ClientStatusTracker(worker_num)
        # fleet telemetry plane (obs/registry.py FleetHealth): per-rank
        # health records beside the protocol state; None keeps every hook a
        # single attribute check
        self.fleet = fleet
        if fleet is not None:
            self.status.on_transition = fleet.record_state
        self._round_timer: "threading.Timer | None" = None  # guarded-by: _round_lock
        self._round_lock = threading.Lock()
        import json

        non_f32 = [d["path"] for d in json.loads(model_desc) if d["dtype"] != "float32"]
        if non_f32:
            raise ValueError(
                f"flat-vector aggregation requires float32 model leaves; got {non_f32}"
            )
        self.client_num_in_total = client_num_in_total or worker_num
        self.on_round_done = on_round_done
        # stale-round uploads from live workers are discarded by the sync
        # protocol, counted here (Comm/StaleUploads in comm_stats totals)
        self.stale_uploads = 0  # guarded-by: _round_lock
        # the bytes-on-wire ledger (the encoded uplink's subclass arms it)
        self.accountant = self._make_accountant()
        # the ONE aggregator construction: subclasses override
        # _make_aggregator; the fold plane attaches at the same seam
        self.aggregator = self._attach_fold_plane(self._make_aggregator())

    def _make_aggregator(self):
        """Build this server's round tally, once, at the end of the base
        ``__init__``."""
        return (
            BufferedFedAvgDistAggregator if self.buffered_aggregation
            else FedAvgDistAggregator
        )(self.worker_num)

    def _attach_fold_plane(self, agg):
        """Arm the sharded fold plane on the freshly-built tally when
        ``fold_workers > 0`` (pass-through otherwise)."""
        if self.fold_workers > 0:
            kwargs = {}
            if self.fold_chunk is not None:
                kwargs["chunk_elems"] = int(self.fold_chunk)
            agg.attach_fold_plane(FoldPlane(self.fold_workers, **kwargs))
        return agg

    def finish(self) -> None:
        self.aggregator.close_fold_plane()
        super().finish()

    def _make_accountant(self):
        """The bytes-on-wire ledger, or None when nothing encodes."""
        return None

    def _model_payload(self, rank: int):
        """Model payload for ``rank``, the wire-format seam: the packed flat
        byte vector here, the reference's nested-list JSON for the mobile
        server's ``is_mobile`` ranks (fedavg_mobile.py)."""
        return self.global_flat

    def _round_cohort(self):
        """Client-index assignment for the current round's downlink: worker
        rank w trains as client ``cohort[w - 1]``."""
        return rnglib.sample_clients(self.round_idx, self.client_num_in_total,
                                     self.worker_num)

    def _sync_extra_params(self) -> dict:
        """Extra header params stamped on every downlink sync: the async
        server adds the explicit global-model version here (clients train
        against a version, not a sync count). Header-only scalars: they ride
        the per-receiver head, never the shared payload frame. The sync
        server stamps none (the downlink delta plane, which would stamp the
        version here too, is ROADMAP §A11.4), so its frames are the JAX
        sync server's byte for byte."""
        return {}

    def _decode_upload(self, msg: Message) -> np.ndarray:
        """Inverse seam: a client upload back to the flat byte vector."""
        return np.asarray(msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS))

    def _fanout_model(self, msg_type: int, ranks: list[int], cohort=None,
                      include_desc: bool = False, finished: bool = False) -> None:
        """Downlink fan-out through the encode-once broadcast path: ranks
        whose ``_model_payload`` is the same object share ONE wire frame
        (the mobile server's per-rank JSON payloads fall back to singleton
        groups); per-rank scalars (the assigned client index) ride
        per-receiver header overrides. ``use_broadcast=False`` replays the
        per-rank ``send_message`` loop."""
        if not ranks:
            return
        dense_nbytes = len(self.global_flat)
        payloads = {w: self._model_payload(w) for w in ranks}
        groups: dict[int, list[int]] = {}
        for w in ranks:
            groups.setdefault(id(payloads[w]), []).append(w)
        for group in groups.values():
            per_receiver = None
            if cohort is not None:
                per_receiver = {w: {MyMessage.MSG_ARG_KEY_CLIENT_INDEX: int(cohort[w - 1])}
                                for w in group}

            def build(dst: int) -> Message:
                msg = Message(msg_type, 0, dst)
                msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, payloads[dst])
                # the authoritative round index rides every sync: clients
                # train AS this round instead of counting received syncs
                msg.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self.round_idx)
                for k, v in self._sync_extra_params().items():
                    msg.add_params(k, v)
                if include_desc:
                    msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_DESC, self.model_desc)
                if finished:
                    msg.add_params(Message.MSG_ARG_KEY_FINISHED, 1)
                return msg

            if self.accountant is not None:
                for _w in group:
                    self.accountant.record_downlink(dense_nbytes, dense_nbytes)
            if self.use_broadcast:
                try:
                    self.broadcast_message(build(group[0]), group, per_receiver=per_receiver)
                except BroadcastSendError as e:
                    self._downlink_failed(e.errors)
            else:
                errors: dict[int, BaseException] = {}
                for w in group:
                    msg = build(w)
                    if per_receiver is not None:
                        for k, v in per_receiver[w].items():
                            msg.add_params(k, v)
                    try:
                        self.send_message(msg)
                    except Exception as e:
                        if getattr(e, "unretryable", False):
                            raise  # injected crash: process death, not a leg
                        errors[w] = e
                if errors:
                    self._downlink_failed(errors)

    def _downlink_failed(self, errors: dict[int, BaseException]) -> None:
        """Per-destination fan-out failures are not fatal to the round
        protocol: the affected ranks miss this sync and the round timeout
        accounts for their missing uploads."""
        for e in errors.values():
            if getattr(e, "unretryable", False):
                raise e
        logging.warning(
            "downlink fan-out failed to ranks %s (continuing: the round "
            "timeout covers their missing uploads): %s",
            sorted(errors),
            "; ".join(f"{d}: {type(e).__name__}: {e}" for d, e in sorted(errors.items())),
        )

    def send_init_msg(self) -> None:
        # cohort keyed by round_idx (not literal 0) so a server restarted
        # from a checkpoint re-broadcasts ITS round
        self._fanout_model(MyMessage.MSG_TYPE_S2C_INIT_CONFIG,
                           [w + 1 for w in range(self.worker_num)],
                           cohort=self._round_cohort(), include_desc=True)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self._on_model_from_client)
        self.register_message_receive_handler(
            ClientStatus.MSG_TYPE_CLIENT_STATUS, self._on_client_status)

    def _on_client_status(self, msg: Message) -> None:
        """Status contact: refresh the liveness table, reset the
        consecutive-miss count and, with readmission on, queue an excluded
        worker's return for the next round boundary."""
        sender = msg.get_sender_id()
        status = msg.get(ClientStatus.KEY_STATUS)
        with self._round_lock:
            self.status.update(sender, status)
            if status == ClientStatus.ONLINE:
                self._miss_counts.pop(sender - 1, None)
                if self.readmission and not self.aggregator.is_live(sender - 1):
                    if sender - 1 not in self._pending_readmit:
                        logging.info("excluded worker %d reappeared (status contact); "
                                     "queueing readmission at the next round close", sender)
                    self._pending_readmit.add(sender - 1)

    def _on_model_from_client(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        with trace.span("server/decode", rank=sender):
            flat = self._decode_upload(msg)
        n = float(msg.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES))
        upload_round = msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
        tel = msg.get(Message.MSG_ARG_KEY_TELEMETRY)
        # staleness/exclusion checks and the tally are one critical section:
        # a timer closing the round between them would otherwise let a
        # round-r model slip into round r+1's tally
        with self._round_lock:
            current = self.round_idx
            if not self.aggregator.is_live(sender - 1):
                if self.readmission:
                    self.status.update(sender, ClientStatus.ONLINE)
                    self._miss_counts.pop(sender - 1, None)
                    if sender - 1 not in self._pending_readmit:
                        logging.info("excluded worker %d reappeared (upload for round "
                                     "%s); queueing readmission", sender, upload_round)
                    self._pending_readmit.add(sender - 1)
                else:
                    logging.info("ignoring upload from excluded worker %d", sender)
                return
            if upload_round is not None and int(upload_round) != current:
                # a straggler's upload from a timed-out round must not
                # pollute the current tally; counted, not silent
                self.stale_uploads += 1
                if self.fleet is not None:
                    self.fleet.counter(sender, "stale_uploads")
                    self.fleet.observe(sender, "staleness", current - int(upload_round))
                    self.fleet.merge_report(sender, tel)
                logging.info("discarding stale upload from worker %d (upload_round=%s, "
                             "current=%d; Comm/StaleUploads=%d this run)",
                             sender, upload_round, current, self.stale_uploads)
                return
            self.status.update(sender, ClientStatus.ONLINE)
            with trace.span("server/fold", rank=sender, round=current):
                all_received = self.aggregator.add_local_trained_result(sender - 1, flat, n)
            if self.fleet is not None:
                self.fleet.counter(sender, "uploads")
                self.fleet.observe(sender, "staleness", 0)
                self.fleet.merge_report(sender, tel)
            self._miss_counts.pop(sender - 1, None)  # it spoke: reset misses
            if not all_received and self.round_timeout is not None:
                if self._round_timer is None:
                    self._round_timer = threading.Timer(
                        self.round_timeout,
                        # the timer's thread inherits the server thread's
                        # job binding (obs/jobscope.py)
                        jobscope.wrap_target(self._round_timed_out),
                        args=(current,),
                    )
                    self._round_timer.daemon = True
                    self._round_timer.start()
        if all_received:
            self._complete_round(current)

    def _round_timed_out(self, expected_round: int) -> None:
        with self._round_lock:
            if self.round_idx != expected_round:
                return  # the round completed while this timer was in flight
            got = self.aggregator.received_workers()
            if not got:
                # nothing to aggregate; release the timer slot so the next
                # upload re-arms it
                self._round_timer = None
                return
            missing = sorted(set(self.aggregator.live_workers()) - set(got))
            excluded = []
            slow = []
            for w in missing:
                if (self.heartbeat_timeout is not None
                        and self.status.seen_within(w + 1, self.heartbeat_timeout)):
                    # heartbeat fresh: the worker is SLOW, not dead; it
                    # misses this round's aggregate but accrues no miss
                    self.status.update(w + 1, ClientStatus.SLOW, touch=False)
                    slow.append(w + 1)
                    continue
                self._miss_counts[w] = self._miss_counts.get(w, 0) + 1
                if self._miss_counts[w] >= self.exclude_after:
                    self.status.update(w + 1, ClientStatus.OFFLINE, touch=False)
                    self.aggregator.exclude_worker(w)
                    excluded.append(w + 1)
        logging.warning(
            "round %d timed out: aggregating %d/%d workers, dropping %s%s%s "
            "(weights renormalized)",
            expected_round, len(got), self.worker_num, [w + 1 for w in missing],
            f", slow (heartbeat fresh) {slow}" if slow else "",
            f", excluding {excluded} as OFFLINE" if excluded else "",
        )
        if excluded and not self.readmission:
            # tell the excluded clients to stop training models the server
            # discards every round
            self._fanout_model(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, excluded,
                               finished=True)
        self._complete_round(expected_round, timed_out=True)

    def _complete_round(self, expected_round: int, timed_out: bool = False) -> None:
        # round/close span: aggregate + advance + next fan-out; on the
        # all-received path it nests inside the last upload's comm/recv span
        with trace.span("round/close", round=expected_round, timed_out=int(timed_out)):
            self._complete_round_locked(expected_round)

    def _complete_round_locked(self, expected_round: int) -> None:
        readmitted: list[int] = []
        with self._round_lock:
            if self.round_idx != expected_round:
                return  # a concurrent close won the race for this round
            if not self.aggregator.received_workers():
                return  # benign double fire (timer raced the full tally)
            if self._round_timer is not None:
                self._round_timer.cancel()
                self._round_timer = None
            with trace.span("server/aggregate", round=expected_round):
                self.global_flat = self.aggregator.aggregate()
            self.round_idx += 1
            # readmission boundary: returnees re-enter the expected set
            # here, never mid-round
            if self._pending_readmit:
                for w in sorted(self._pending_readmit):
                    self.aggregator.readmit_worker(w)
                    self._miss_counts.pop(w, None)
                    if self.fleet is not None:
                        self.fleet.record_state(w + 1, registry.STATE_READMITTED)
                        self.fleet.counter(w + 1, "readmissions")
                    self.status.update(w + 1, ClientStatus.ONLINE, touch=False)
                    readmitted.append(w + 1)
                self._pending_readmit.clear()
            # snapshot under the lock, write the files outside it
            ckpt_state = self._checkpoint_state()
        if ckpt_state is not None:
            self._write_checkpoint(ckpt_state)
        if readmitted:
            logging.info("readmitted workers %s into round %d's cohort",
                         readmitted, self.round_idx)
        if self.on_round_done:
            self.on_round_done(expected_round, self.global_flat)
        if self.round_idx >= self.round_num:
            # graceful stop: notify clients, then stop own loop
            self._fanout_model(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                               [w + 1 for w in range(self.worker_num)], finished=True)
            self.finish()
            return
        self._fanout_model(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                           [w + 1 for w in self.aggregator.live_workers()],
                           cohort=self._round_cohort())

    # -- fleet telemetry -------------------------------------------------------

    def _fleet_round_record(self, round_idx: int) -> dict | None:
        """Flush heartbeat freshness into the fleet view and return the
        cumulative fleet snapshot stamped with ``round_idx``; None when
        fleet telemetry is off."""
        if self.fleet is None:
            return None
        now = time.monotonic()
        for w in self.aggregator.live_workers():
            seen = self.status.last_seen(w + 1)
            if seen is not None:
                self.fleet.gauge(w + 1, "heartbeat_age_s", round(now - seen, 4))
        return self.fleet.round_record(round_idx)

    # -- crash recovery --------------------------------------------------------

    def _checkpoint_state(self) -> dict | None:  # lock-held: _round_lock
        """Snapshot the server round state at round close (caller holds
        ``_round_lock``): the new global, the round index, miss counts, the
        status table and the aggregator's tally."""
        if self.checkpointer is None or (self.round_idx % self.checkpoint_every):
            return None
        return {
            "server_round": int(self.round_idx),
            "global_flat": np.asarray(self.global_flat),
            "miss_counts": {str(k): int(v) for k, v in self._miss_counts.items()},
            "status": self.status.snapshot(),
            "aggregator": self.aggregator.snapshot_state(),
        }

    def _write_checkpoint(self, state: dict) -> None:
        """Persist a :meth:`_checkpoint_state` snapshot, before the round
        callback and the next fan-out."""
        with trace.span("ft/checkpoint", round=state["server_round"]):
            self.checkpointer.save_server(state["server_round"], state)

    def restore_from_checkpoint(self, checkpointer=None, round_idx: int | None = None) -> int:
        """Load a server snapshot (latest by default) and resume AS that
        round: the next ``send_init_msg`` re-broadcasts the checkpointed
        round index and global model, clients re-train as that round, and
        the run continues bitwise as one that never stopped. Returns the
        resumed round index."""
        ckptr = checkpointer or self.checkpointer
        if ckptr is None:
            raise ValueError("restore_from_checkpoint needs a checkpointer")
        state = ckptr.restore_server(round_idx)
        with self._round_lock:
            self.round_idx = int(state["server_round"])
            self.global_flat = np.asarray(state["global_flat"], np.uint8)
            self._miss_counts = {int(k): int(v)
                                 for k, v in state.get("miss_counts", {}).items()}
            for cid, st in state.get("status", {}).items():
                self.status.update(int(cid), st, touch=False)
            self.aggregator.restore_state(state.get("aggregator", {}))
        logging.info("restored server round state: resuming as round %d (live workers %s)",
                     self.round_idx, [w + 1 for w in self.aggregator.live_workers()])
        return self.round_idx


class FedAvgClientManager(ClientManager):
    """Client protocol (FedAvgClientManager.py:25-72): receive the global
    model, train ``trainer.epochs`` local epochs on the assigned shard on
    the trainer's device, send the model + sample count."""

    def __init__(self, comm: BaseCommunicationManager, rank: int, size: int,
                 trainer: ClientTrainer, train_data: FederatedArrays,
                 batch_size: int, template_variables: Any,
                 local_train_fn=None, exec_lock=None):
        super().__init__(comm, rank, size)
        self.trainer = trainer
        self.train_data = train_data
        self.batch_size = batch_size
        self.template = template_variables
        # override point: ``local_train(variables, data, **kw)`` of the
        # port's make_local_train, run under ``exec_lock`` (TRAIN_LOCK)
        self._local_train = local_train_fn or make_local_train(trainer)
        self.exec_lock = exec_lock or TRAIN_LOCK
        self.device = next(trainer.module.parameters()).device
        self._round = 0
        # the model version the last sync stamped (the async server's), or None
        self._model_version: int | None = None
        # rng identity on the wire (flat runs: rng_rank == rank)
        self.rng_rank = rank
        # fleet telemetry opt-in (set by the runner when fleet_stats is on)
        self.fleet_telemetry = False
        # per-rank population profile (population/wire.py; set by the runner
        # under population=): feeds the predicted-vs-actual step gauges
        # piggybacked when fleet telemetry is on
        self.population_profile = None

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self._on_sync)
        self.register_message_receive_handler(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                                              self._on_sync)

    def _decode_model(self, msg: Message) -> StateDict:
        """Wire-format seam: a sync payload back to model variables (the
        port's state dict). The mobile client parses the reference's
        nested-list JSON here instead."""
        desc = msg.get(MyMessage.MSG_ARG_KEY_MODEL_DESC)
        if desc is not None:
            self._desc = desc
        if msg.get(Message.MSG_ARG_KEY_ENCODED_UPDATE) is not None:
            raise _unported("a delta-coded sync (the downlink delta codec)", "§A11.4")
        return unpack_state(np.asarray(msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)),
                                   self._desc)

    def _encode_model(self, new_vars: StateDict):
        """Inverse seam: trained variables to the upload payload."""
        with trace.span("client/encode", rank=self.rank):
            return pack_state(new_vars)

    def _fill_upload(self, out: Message, new_vars: StateDict, global_vars: StateDict) -> None:
        """Upload-payload seam: the dense packed model here; the compressed
        client sends an encoded delta instead (formed against
        ``global_vars``, the model it trained from)."""
        out.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, self._encode_model(new_vars))

    def _on_sync(self, msg: Message) -> None:
        if msg.get(Message.MSG_ARG_KEY_FINISHED):
            self.finish()
            return
        # fleet telemetry: when this client opted in AND a process registry
        # is installed, time the local round and piggyback a compact report
        reg = registry.get() if self.fleet_telemetry else None
        t_start = time.perf_counter() if reg is not None else 0.0
        # the explicit model-version stamp (the async server's): remembered
        # here and echoed on the upload, so the server's staleness weight is
        # computed from the version this client verifiably trained against
        # (sync servers stamp no version and get no echo)
        version = msg.get(Message.MSG_ARG_KEY_MODEL_VERSION)
        self._model_version = None if version is None else int(version)
        ridx = msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
        if ridx is not None:
            # train AS the server's round, so a replayed downlink leg
            # re-trains the same round instead of desynchronizing
            self._round = int(ridx)
        with trace.span("client/decode", rank=self.rank):
            variables = {k: v.to(self.device) for k, v in self._decode_model(msg).items()}
        client_idx = int(msg.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX))
        self._client_idx = client_idx  # which client this round trains as
        new_vars, n = train_wire_round(
            self.trainer, self._local_train, self.train_data, client_idx, self.batch_size,
            self._round, self.rng_rank * 100003 + self._round, variables, self.exec_lock)
        self._round += 1
        out = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank, 0)
        self._fill_upload(out, new_vars, variables)
        out.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, n)
        out.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self._round - 1)
        if self._model_version is not None:
            out.add_params(Message.MSG_ARG_KEY_MODEL_VERSION, self._model_version)
        if reg is not None:
            step_ms = (time.perf_counter() - t_start) * 1e3
            reg.observe("client/step_ms", step_ms)
            reg.counter("client/rounds")
            # header-only JSON scalars; "retries" is this manager's count as
            # of the previous send
            report = {
                "step_ms": round(step_ms, 3),
                "sent_at": time.time(),
                "retries": self.comm_retries,
            }
            if self.population_profile is not None:
                report["counts"] = self._population_counts(n)
            out.add_params(Message.MSG_ARG_KEY_TELEMETRY, report)
        self.send_message(out)

    def _population_counts(self, n: float) -> dict:
        """Cumulative predicted-vs-actual step totals of the population
        churn (predicted: the speed model's forecast; actual: the steps this
        client ran, ``stack_cohort``'s one-client S), plus the uploads this
        client's own fault wrapper dropped."""
        steps = max(1, -(-int(n) // self.batch_size))
        actual = int(self.trainer.epochs * steps)
        predicted = int(np.ceil(self.population_profile["predicted_frac"] * actual))
        self._pop_predicted = getattr(self, "_pop_predicted", 0) + max(predicted, 1)
        self._pop_actual = getattr(self, "_pop_actual", 0) + actual
        counts = {"pop_predicted_steps": self._pop_predicted,
                  "pop_actual_steps": self._pop_actual}
        applied = getattr(self.comm, "applied_counts", None)
        if applied is not None:
            counts["pop_dropped_uploads"] = applied().get("drop", 0)
        return counts


# ---------------------------------------------------------------------------
# Compressed-update protocol variant (fedml_tpu_torch/compress)
# ---------------------------------------------------------------------------


class CompressedDistAggregator(FedAvgDistAggregator):
    """Streaming tally for encoded uploads: each client's EncodedUpdate is
    folded into ONE dense f64 accumulator AS IT ARRIVES (top-k scatter-adds
    straight from its index/value planes — the server never materializes
    per-client dense trees, and with streaming it no longer retains the
    encoded uploads either). ``aggregate()`` divides by the weight sum at
    round close; delta-domain codecs add the result onto the current global;
    the ``none`` codec carries models and reproduces the dense protocol's
    arithmetic bit-for-bit."""

    def __init__(self, worker_num: int, codec):
        super().__init__(worker_num)
        self.codec = codec
        self.get_global = None  # wired by the server manager (current flat)

    def _fold(self, payload, sample_num: float) -> None:
        from fedml_tpu_torch.compress.aggregate import accumulate_encoded

        if self._acc is None:
            base = np.ascontiguousarray(self.get_global()).view(np.float32)
            self._acc = np.zeros(base.size, np.float64)
        accumulate_encoded(self._acc, payload, float(sample_num), self.codec)
        self._wsum += float(sample_num)

    def _fold_task(self, payload, weight: float):
        from fedml_tpu_torch.algorithms.fold_plane import EncodedFoldTask

        # sized from the round global like the serial first fold — only the
        # SIZE is read here; decode runs in the task's prepare, off the
        # receive thread
        return EncodedFoldTask(payload, weight, self.codec,
                               np.asarray(self.get_global()).nbytes // 4)

    def _finish(self) -> np.ndarray:
        self._fold_epoch += 1
        acc = self._acc / self._wsum
        if self.codec.delta_domain:
            base = np.ascontiguousarray(self.get_global()).view(np.float32)
            acc += base.astype(np.float64)
        self._acc = None
        self._wsum = 0.0
        return acc.astype(np.float32).view(np.uint8)


class CompressedBufferedDistAggregator(BufferedFedAvgDistAggregator,
                                       CompressedDistAggregator):
    """Legacy-shaped compressed tally: retains the encoded uploads and folds
    them at round close in arrival order, through the same fold arithmetic —
    the A/B reference for :class:`CompressedDistAggregator` (bit-identical
    under any schedule)."""

    def __init__(self, worker_num: int, codec):
        CompressedDistAggregator.__init__(self, worker_num, codec)
        self.model_dict = {}



class CompressedFedAvgServerManager(FedAvgServerManager):
    """FedAvg server speaking the encoded-update uplink: dense model down,
    EncodedUpdate planes up, with bytes-on-wire accounting per round."""

    def __init__(self, *args, codec=None, **kwargs):
        if codec is None:
            raise ValueError("CompressedFedAvgServerManager needs a codec")
        # set before super().__init__ so the base's single
        # _make_aggregator() call sees it
        self.codec = codec
        super().__init__(*args, **kwargs)

    def _make_accountant(self):
        return metricslib.CommBytesAccountant()

    def _make_aggregator(self):
        agg = (
            CompressedBufferedDistAggregator if self.buffered_aggregation
            else CompressedDistAggregator
        )(self.worker_num, self.codec)
        agg.get_global = lambda: self.global_flat
        return agg

    def _decode_upload(self, msg: Message):
        from fedml_tpu_torch.comm.message import unpack_encoded_update

        flat = np.asarray(msg.get(Message.MSG_ARG_KEY_ENCODED_UPDATE))
        desc = msg.get(Message.MSG_ARG_KEY_ENCODED_DESC)
        self.accountant.record_uplink(flat.size + len(desc), len(self.global_flat))
        return unpack_encoded_update(flat, desc)


class CompressedFedAvgClientManager(FedAvgClientManager):
    """FedAvg client that uplinks an encoded update instead of the dense
    model: delta-domain codecs encode (local - global) with error-feedback
    residual carryover; the ``none`` codec encodes the model itself, so the
    wire path stays bitwise the dense protocol. The update is encoded in
    the JAX layout on the trainer's device (:func:`jax_layout`), so its
    planes are the JAX client's on the same delta and uniforms.

    EF residuals are keyed by the *assigned client index*, never by worker:
    at full participation that is exact per-client EF; under resampling a
    client's residual is carried by the last worker that trained it."""

    def __init__(self, comm: BaseCommunicationManager, rank: int, size: int,
                 trainer: ClientTrainer, train_data: FederatedArrays,
                 batch_size: int, template_variables: Any,
                 local_train_fn=None, exec_lock=None, codec=None,
                 error_feedback: bool = True):
        super().__init__(comm, rank, size, trainer, train_data, batch_size,
                         template_variables, local_train_fn=local_train_fn,
                         exec_lock=exec_lock)
        if codec is None:
            raise ValueError("CompressedFedAvgClientManager needs a codec")
        self.codec = codec
        self.error_feedback = bool(error_feedback) and codec.delta_domain
        self._residuals: dict[int, StateDict] = {}

    def upload_noise(self, round_idx: int):
        """The quantizer's uniforms for ``round_idx``: a
        :class:`~fedml_tpu_torch.core.rng.RoundNoise` seeded with the JAX
        client's integers, ``(0xC0DEC ^ rank, round)``."""
        device = next(self.trainer.module.parameters()).device
        return rnglib.RoundNoise(0xC0DEC ^ self.rank, round_idx, device)

    def _fill_upload(self, out: Message, new_vars: StateDict, global_vars: StateDict) -> None:
        from fedml_tpu_torch.comm.message import pack_encoded_update
        from fedml_tpu_torch.compress import error_feedback as eflib

        # the JAX client folds the round counter in after advancing it
        noise = self.upload_noise(self._round)
        with trace.span("compress/encode", scheme=self.codec.name,
                        error_feedback=self.error_feedback):
            new = jax_layout(new_vars)
            if self.codec.delta_domain:
                base = jax_layout(global_vars)
                delta = {k: v - base[k] for k, v in new.items()}
                if self.error_feedback:
                    comp = eflib.compensate(delta, self._residuals.get(self._client_idx))
                    enc, _, self._residuals[self._client_idx] = eflib.encode_with_feedback(
                        self.codec, comp, noise)
                else:
                    enc = self.codec.encode(delta, noise)
            else:
                enc = self.codec.encode(new, noise)
            flat, desc = pack_encoded_update(enc)
        out.add_params(Message.MSG_ARG_KEY_ENCODED_UPDATE, flat)
        out.add_params(Message.MSG_ARG_KEY_ENCODED_DESC, desc)


def init_template(trainer: ClientTrainer, train_arrays: dict, batch_size: int,
                  seed: int = 0, init_overrides: StateDict | None = None):
    """Shared harness setup: fresh variables drawn from ``seed`` on the
    trainer's device (the port's ``FedSim.init_variables``), with
    ``init_overrides`` (a state dict, e.g. a ``load_params`` result or
    ``convert.from_flax`` of JAX variables) grafted over them, packed for
    the wire. Returns (template state dict, flat bytes, descriptor)."""
    from fedml_tpu_torch.obs.checkpoint import graft_params

    device = next(trainer.module.parameters()).device
    template = trainer.init(rnglib.generator(seed, device))
    if init_overrides:
        template = graft_params(template, dict(init_overrides))
    flat, desc = pack_pytree(convert.to_flax(template))
    return template, flat, desc


def run_manager_protocol(server, clients, join_timeout: float = 30.0,
                         client_lanes: list[str] | None = None,
                         server_lane: str | None = None) -> None:
    """Shared run harness: client managers in daemon threads, the server's
    receive loop on the caller thread, graceful join. If the server's loop
    dies, the client transports are stopped so their threads unblock before
    the error propagates. ``client_lanes``/``server_lane`` bind each
    manager's thread to a per-rank lane (obs/jobscope.py)."""
    threads = [
        threading.Thread(
            target=jobscope.wrap_target(c.run, job=client_lanes[i] if client_lanes else None),
            daemon=True)
        for i, c in enumerate(clients)
    ]
    for t in threads:
        t.start()
    with jobscope.bound(server_lane):
        server.register_message_receive_handlers()
        server.send_init_msg()
        try:
            server.comm.handle_receive_message()  # blocks until the protocol finishes
        except BaseException:
            for c in clients:
                try:
                    c.comm.stop_receive_message()
                except Exception:  # noqa: BLE001 — best-effort unblock
                    pass
            raise
    for t in threads:
        t.join(timeout=join_timeout)


def run_distributed_fedavg(
    trainer: ClientTrainer,
    train_data: FederatedArrays,
    worker_num: int,
    round_num: int,
    batch_size: int,
    make_comm: Callable[[int], BaseCommunicationManager],
    seed: int = 0,
    round_timeout: float | None = None,
    on_round_done: Callable[[int, Any], None] | None = None,
    init_overrides=None,
    server_cls: type[FedAvgServerManager] = None,
    server_kwargs: dict | None = None,
    client_cls_for_rank: Callable[[int], type] | None = None,
    codec=None,
    error_feedback: bool = True,
    downlink_codec=None,
    comm_stats: dict | None = None,
    robust_config=None,
    robust_stats: dict | None = None,
    fault_specs=None,
    fault_seed: int = 0,
    population=None,
    retry_policy=None,
    heartbeat_interval: float | None = None,
    heartbeat_timeout: float | None = None,
    readmission: bool | None = None,
    checkpoint_dir=None,
    checkpoint_every: int = 1,
    resume: bool = False,
    server_mode: str = "sync",
    buffer_goal: int | None = None,
    staleness_weight: str = "const",
    async_stats: dict | None = None,
    fleet_stats: dict | None = None,
    trace_lanes: str | None = None,
    trace_wire: bool = False,
    fold_workers: int = 0,
    fold_chunk: int | None = None,
):
    """End-to-end distributed FedAvg over a comm fabric: ``make_comm(rank)``
    builds rank 0's server transport and ranks 1..W's client transports.
    Clients run in threads and train on the trainer's device.
    ``server_cls``/``server_kwargs``/``client_cls_for_rank`` swap in
    protocol variants (fedavg_mobile's JSON-wire managers). ``codec``
    switches the uplink to the compressed-update protocol
    (``error_feedback`` toggles per-client residual carryover,
    ``comm_stats`` receives per-round and total bytes-on-wire records).
    ``init_overrides`` is a state dict grafted over the fresh init.
    ``robust_config`` (a robust_distributed.RobustDistConfig) swaps the
    server tally for the streaming Byzantine-robust + DP one, composing with
    ``codec`` (``robust_stats`` receives per-round Robust/* records).
    ``fault_specs`` (comm/faults.py: a {rank: FaultSpec} map or a spec
    string) wraps every rank's transport in the seeded fault injector
    (``fault_seed``); ``population`` (a spec string, PopulationSpec or
    population/wire.py adapter) schedules per-rank upload delays and drops
    through the same injector.

    Fault tolerance: ``retry_policy`` (comm/retry.py) arms retry/backoff on
    every rank's send plane, outside any fault wrapper so each attempt
    re-rolls its faults; ``round_timeout`` closes a round without its
    stragglers; ``heartbeat_interval`` starts a per-client heartbeat thread
    (and defaults ``heartbeat_timeout``, the server's slow-vs-dead window,
    to 3x the interval); ``readmission`` (default: on iff heartbeats are on)
    lets an OFFLINE-excluded worker rejoin later cohorts when it
    re-contacts the server; ``checkpoint_dir`` snapshots the server round state every
    ``checkpoint_every`` round closes and ``resume=True`` restores the
    latest snapshot and re-broadcasts its round, so a restarted run is
    bitwise an uninterrupted one. ``fleet_stats`` (a caller dict) switches
    on the fleet telemetry plane (obs/registry.py FleetHealth) and receives
    per-round fleet snapshots (``rounds``), the final view (``totals``) and
    the process registry (``registry``); telemetry-on runs are bitwise
    telemetry-off runs. ``fold_workers`` shards the server's fold.

    ``server_mode="async"`` swaps in the buffered-async server
    (``async_agg/server.py``): uploads fold on arrival with a
    ``staleness_weight`` decay (``const`` | ``poly:a`` | ``hinge:a,b``), a
    new global is emitted every ``buffer_goal`` arrivals (default: the
    worker count) with no round barrier, and ``round_num`` counts emitted
    models; ``async_stats`` (a caller dict) receives per-emission Async/*
    records (``rounds``) and the run's ``totals``. With ``buffer_goal ==
    worker_num`` and the constant weight the async path is bitwise the sync
    streaming path. The tree has its own harness
    (``async_agg.tree.run_tree_fedavg_loopback``). ``downlink_codec``
    raises ``NotImplementedError`` naming ROADMAP §A11.4, and
    ``trace_lanes``/``trace_wire`` (the cross-rank trace lanes) naming
    §A11.5. Returns the final global variables (the port's state dict of
    host tensors)."""
    if server_mode not in ("sync", "async"):
        raise ValueError(
            f"unknown server_mode {server_mode!r}: expected 'sync' or "
            "'async' (the hierarchical tree mode runs through "
            "async_agg.tree.run_tree_fedavg_loopback — its process topology "
            "is a tree of comm fabrics, not this harness's flat fan-out)"
        )
    if server_mode == "async":
        if server_cls is not None or client_cls_for_rank is not None:
            raise ValueError(
                "server_mode='async' does not compose with custom manager "
                "classes (e.g. is_mobile's JSON wire format)"
            )
        if round_timeout is not None:
            raise ValueError(
                "server_mode='async' has no round barrier, so the elastic "
                "round_timeout does not apply — drop it (slow workers just "
                "fold late, staleness-weighted)"
            )
    if downlink_codec is not None:
        raise _unported("downlink_codec= (downlink delta coding, compress/downlink.py)",
                        "§A11.4")
    if trace_lanes is not None or trace_wire:
        raise _unported("trace_lanes=/trace_wire= (cross-rank causal trace lanes)", "§A11.5")
    if codec is not None and (server_cls is not None or client_cls_for_rank is not None):
        raise ValueError(
            "codec= does not compose with custom manager classes "
            "(e.g. is_mobile's JSON wire format)"
        )
    if robust_config is not None and not robust_config.enabled:
        robust_config = None  # a no-op defense is exactly plain FedAvg
    if robust_config is not None and (server_cls is not None
                                      or client_cls_for_rank is not None):
        raise ValueError(
            "robust_config= does not compose with custom manager classes "
            "(e.g. is_mobile's JSON wire format)"
        )
    if population is not None:
        # per-rank upload delays/drops drawn from the population
        # distributions, scheduled through the seeded fault machinery
        from fedml_tpu_torch.population.wire import (
            PopulationWireAdapter,
            population_fault_specs,
        )

        if not isinstance(population, PopulationWireAdapter):
            population = population_fault_specs(population, worker_num,
                                                seed=fault_seed or seed)
        elif population.worker_num != worker_num:
            raise ValueError(
                f"population adapter was built for "
                f"{population.worker_num} workers but this run has "
                f"{worker_num} — the uncovered ranks would silently run "
                "un-churned (the trace loader rejects the analogous "
                "num_clients mismatch for the same reason)"
            )
        if fault_specs is not None and population.active:
            raise ValueError(
                "population= and fault_specs= both drive the wire fault "
                "injector — one seeded schedule would silently shift the "
                "other; configure churn in exactly one place"
            )
        if population.drops_uploads:
            if server_mode != "sync":
                raise ValueError(
                    "the population drops uploads but the async server "
                    "has no timeout/readmission path for a silently lost "
                    "upload — the dropped rank never receives another "
                    "downlink and strands forever; run server_mode='sync' "
                    "with round_timeout=, or model the churn as delays "
                    "(jitter) instead of drops"
                )
            if round_timeout is None:
                raise ValueError(
                    "the population drops uploads but the sync round "
                    "barrier has no round_timeout — the first dropped "
                    "upload would wedge the round forever; set "
                    "round_timeout="
                )
        if population.active:
            fault_specs = population.fault_specs
    if fault_specs is not None:
        from fedml_tpu_torch.comm.faults import wrap_make_comm

        make_comm = wrap_make_comm(make_comm, fault_specs, seed=fault_seed)
    if retry_policy is not None:
        # armed on the outermost manager (fault wrappers included): each
        # retry attempt re-runs the full send path with fresh fault draws
        def make_comm(rank: int, _inner=make_comm):
            mgr = _inner(rank)
            mgr.retry_policy = retry_policy
            return mgr

    if readmission is None:
        readmission = heartbeat_interval is not None
    if heartbeat_interval is not None and heartbeat_timeout is None:
        heartbeat_timeout = 3.0 * heartbeat_interval
    ckptr = None
    ft_kwargs: dict = {}
    if fold_workers:
        ft_kwargs["fold_workers"] = int(fold_workers)
        if fold_chunk is not None:
            ft_kwargs["fold_chunk"] = int(fold_chunk)
    if heartbeat_timeout is not None:
        ft_kwargs["heartbeat_timeout"] = heartbeat_timeout
    if readmission:
        ft_kwargs["readmission"] = True
    if checkpoint_dir is not None:
        from fedml_tpu_torch.obs.checkpoint import RoundCheckpointer

        ckptr = RoundCheckpointer(checkpoint_dir)
        ft_kwargs["checkpointer"] = ckptr
        ft_kwargs["checkpoint_every"] = checkpoint_every
    fleet = None
    _sysstats = None
    if fleet_stats is not None:
        from fedml_tpu_torch.obs.registry import FleetHealth
        from fedml_tpu_torch.obs.sysstats import SysStats

        fleet = FleetHealth()
        ft_kwargs["fleet"] = fleet
        _sysstats = SysStats()
    if ft_kwargs:
        # explicit caller server_kwargs still win over the derived knobs
        server_kwargs = {**ft_kwargs, **(server_kwargs or {})}
    template, flat, desc = init_template(trainer, train_data.arrays, batch_size, seed,
                                         init_overrides=init_overrides)
    if robust_config is not None:
        from fedml_tpu_torch.algorithms.robust_distributed import (
            RobustCompressedFedAvgServerManager,
            RobustFedAvgServerManager,
        )

        server_cls = (RobustCompressedFedAvgServerManager if codec is not None
                      else RobustFedAvgServerManager)
        server_kwargs = {**(server_kwargs or {}),
                         "robust_config": robust_config,
                         "robust_stats": robust_stats}
    if codec is not None:
        if server_cls is None:
            server_cls = CompressedFedAvgServerManager
        server_kwargs = {**(server_kwargs or {}), "codec": codec}

        def client_cls_for_rank(rank):
            def make(comm, r, size, tr, data, bs, tmpl):
                return CompressedFedAvgClientManager(comm, r, size, tr, data, bs, tmpl,
                                                     codec=codec, error_feedback=error_feedback)

            return make

    if server_mode == "async":
        # remap the selected sync server class onto its barrier-free
        # counterpart: the same wire seams, the async tally
        from fedml_tpu_torch.async_agg.server import (
            AsyncCompressedFedAvgServerManager,
            AsyncFedAvgServerManager,
            AsyncRobustFedAvgServerManager,
        )

        async_cls = {
            None: AsyncFedAvgServerManager,
            CompressedFedAvgServerManager: AsyncCompressedFedAvgServerManager,
        }
        if robust_config is not None:
            from fedml_tpu_torch.algorithms.robust_distributed import (
                RobustCompressedFedAvgServerManager,
                RobustFedAvgServerManager,
            )

            if server_cls is RobustCompressedFedAvgServerManager:
                raise NotImplementedError(
                    "server_mode='async' composes with a codec OR a robust "
                    "defense, not both at once yet"
                )
            async_cls[RobustFedAvgServerManager] = AsyncRobustFedAvgServerManager
        server_cls = async_cls[server_cls]
        server_kwargs = {**(server_kwargs or {}),
                         "buffer_goal": buffer_goal,
                         "staleness_weight": staleness_weight,
                         "async_stats": async_stats}

    results: dict[str, np.ndarray] = {}

    def _done(r, f):
        results["final"] = f
        if comm_stats is not None and server.accountant is not None:
            comm_stats.setdefault("rounds", []).append(server.accountant.round_record(r))
        if fleet_stats is not None:
            # flushed BEFORE on_round_done so a by-round merge finds it
            _sysstats.publish_device_gauges()
            rec = server._fleet_round_record(r)
            if rec is not None:
                fleet_stats.setdefault("rounds", []).append(rec)
        if on_round_done is not None:
            on_round_done(r, unpack_state(f, desc))

    server = (server_cls or FedAvgServerManager)(
        make_comm(0), worker_num, round_num, flat, desc,
        client_num_in_total=train_data.num_clients,
        round_timeout=round_timeout,
        on_round_done=_done,
        **(server_kwargs or {}),
    )
    if resume:
        if ckptr is None:
            raise ValueError("resume=True requires checkpoint_dir")
        if ckptr.latest_server_round() is not None:
            server.restore_from_checkpoint()
            if server.round_idx >= round_num:
                # every round closed before the stop: the checkpointed
                # global IS the final model
                server.comm.stop_receive_message()
                if fleet_stats is not None:
                    fleet_stats["totals"] = fleet.snapshot()
                return unpack_state(server.global_flat, desc)
        else:
            logging.info("resume requested but no server checkpoint under %s; starting fresh",
                         checkpoint_dir)
    cls_for = client_cls_for_rank or (lambda r: FedAvgClientManager)
    clients = [
        cls_for(r)(make_comm(r), r, worker_num + 1, trainer, train_data, batch_size, template)
        for r in range(1, worker_num + 1)
    ]
    if fleet_stats is not None:
        for c in clients:
            c.fleet_telemetry = True
    if population is not None:
        # per-rank population profile: fleet-telemetry-armed clients
        # piggyback predicted-vs-actual step gauges from it
        for c in clients:
            c.population_profile = population.profiles.get(c.rank)

    from fedml_tpu_torch.comm.retry import retry_stats

    retries_before = retry_stats()["retries"]
    # heartbeats never touch aggregation state, so a heartbeating run is
    # bitwise a silent one
    heartbeats = [HeartbeatSender(c.comm, c.rank, heartbeat_interval).start()
                  for c in clients] if heartbeat_interval is not None else []
    # fleet telemetry needs the process registry installed so clients
    # collect + piggyback; reuse an outer scope's registry when one exists
    _installed_registry = None
    if fleet_stats is not None and registry.get() is None:
        _installed_registry = registry.install()
    try:
        run_manager_protocol(server, clients)
    finally:
        for hb in heartbeats:
            hb.stop()
        if fleet_stats is not None:
            fleet_stats["totals"] = fleet.snapshot()
            reg = registry.get()
            if reg is not None:
                fleet_stats["registry"] = reg.snapshot()
            if _installed_registry is not None and registry.get() is _installed_registry:
                registry.uninstall()
    if comm_stats is not None:
        if server.accountant is not None:
            comm_stats["totals"] = server.accountant.totals()
        if retry_policy is not None:
            comm_stats.setdefault("totals", {})[metricslib.COMM_RETRY_COUNT] = (
                retry_stats()["retries"] - retries_before)
        comm_stats.setdefault("totals", {})[metricslib.COMM_STALE_UPLOADS] = int(
            server.stale_uploads)
    if async_stats is not None and hasattr(server, "async_totals"):
        async_stats["totals"] = server.async_totals()
    return unpack_state(results["final"], desc)


def run_distributed_fedavg_loopback(
    trainer: ClientTrainer,
    train_data: FederatedArrays,
    worker_num: int,
    round_num: int,
    batch_size: int,
    seed: int = 0,
    on_round_done: Callable[[int, Any], None] | None = None,
    init_overrides=None,
    fabric=None,
    **runner_kwargs,
):
    """Distributed FedAvg on the in-process loopback fabric (``fabric``: a
    given :class:`~fedml_tpu_torch.comm.loopback.LoopbackFabric`, e.g. an
    ``OrderedUplinkFabric`` that pins the server's fold order; a fresh one
    by default)."""
    from fedml_tpu_torch.comm.loopback import LoopbackCommManager, LoopbackFabric

    fabric = fabric or LoopbackFabric(worker_num + 1)
    return run_distributed_fedavg(
        trainer, train_data, worker_num, round_num, batch_size,
        lambda r: LoopbackCommManager(fabric, r), seed=seed,
        on_round_done=on_round_done, init_overrides=init_overrides,
        **runner_kwargs,
    )


def run_distributed_fedavg_shm(
    trainer: ClientTrainer,
    train_data: FederatedArrays,
    worker_num: int,
    round_num: int,
    batch_size: int,
    seed: int = 0,
    job: str | None = None,
    on_round_done: Callable[[int, Any], None] | None = None,
    init_overrides=None,
    **runner_kwargs,
):
    """Distributed FedAvg over the native shared-memory rings (the MPI-role
    single-host transport, comm/shm.py + comm/native/shm_ring.cpp)."""
    import uuid

    from fedml_tpu_torch.comm.shm import ShmCommManager

    job = job or f"fedavg_{uuid.uuid4().hex[:8]}"
    mgrs = {r: ShmCommManager(job, r, worker_num + 1) for r in range(worker_num + 1)}
    try:
        return run_distributed_fedavg(
            trainer, train_data, worker_num, round_num, batch_size,
            lambda r: mgrs[r], seed=seed, on_round_done=on_round_done,
            init_overrides=init_overrides, **runner_kwargs,
        )
    finally:
        for m in mgrs.values():
            m.cleanup()


def run_distributed_fedavg_grpc(
    trainer: ClientTrainer,
    train_data: FederatedArrays,
    worker_num: int,
    round_num: int,
    batch_size: int,
    seed: int = 0,
    base_port: int = 29500,
    send_timeout: float = 600.0,
    send_workers: int = 4,
    on_round_done: Callable[[int, Any], None] | None = None,
    init_overrides=None,
    **runner_kwargs,
):
    """Distributed FedAvg over localhost gRPC (cross-host transport run
    single-host; an ip_config table generalizes it to a cluster, reference
    grpc_ipconfig.csv). ``send_timeout``/``send_workers`` plumb the run
    config into every rank's transport (per-send unary deadline and
    broadcast send-pool width)."""
    from fedml_tpu_torch.comm.grpc_backend import GRPCCommManager

    ip_config = {r: ("127.0.0.1", base_port + r) for r in range(worker_num + 1)}
    mgrs = {
        r: GRPCCommManager(r, ip_config, send_timeout=send_timeout, send_workers=send_workers)
        for r in range(worker_num + 1)
    }
    try:
        return run_distributed_fedavg(
            trainer, train_data, worker_num, round_num, batch_size,
            lambda r: mgrs[r], seed=seed, on_round_done=on_round_done,
            init_overrides=init_overrides, **runner_kwargs,
        )
    finally:
        for m in mgrs.values():
            m.stop_receive_message()


def run_distributed_fedavg_mqtt_s3(
    trainer: ClientTrainer,
    train_data: FederatedArrays,
    worker_num: int,
    round_num: int,
    batch_size: int,
    seed: int = 0,
    store_dir: str | None = None,
    mqtt_host: str | None = None,
    mqtt_port: int = 1883,
    topic: str = "fedml",
    threshold_bytes: int = 1 << 14,
    broadcast_generations: int = 2,
    on_round_done: Callable[[int, Any], None] | None = None,
    init_overrides=None,
    **runner_kwargs,
):
    """Distributed FedAvg over the production WAN combination: control
    messages on MQTT topics, model payloads through an object store keyed by
    reference (the reference's MQTT_S3 backend,
    mqtt_s3_multi_clients_comm_manager.py:178-249 / client_manager.py:28-50).

    ``mqtt_host=None`` (offline default) runs the real MqttCommManager logic
    over the in-process broker (comm/inproc_broker.py); a host string
    connects through real paho. The store is a FileSystemStore under
    ``store_dir`` (a temporary directory, removed at the end, by default);
    the S3Store drops in via the same ObjectStore interface.
    ``broadcast_generations`` is the sender-side shared-blob retention (how
    many newer fan-outs exist before a broadcast blob is retired)."""
    import shutil
    import tempfile

    from fedml_tpu_torch.comm.mqtt_backend import MqttCommManager
    from fedml_tpu_torch.comm.object_store import FileSystemStore, OffloadCommManager

    factory = None
    if mqtt_host is None:
        from fedml_tpu_torch.comm.inproc_broker import InProcessBroker

        factory = InProcessBroker().client_factory()
        mqtt_host = "inproc"
    tmp_store = tempfile.mkdtemp(prefix="fedml_store_") if store_dir is None else None
    store_root = store_dir or tmp_store

    def make_comm(rank: int):
        inner = MqttCommManager(mqtt_host, mqtt_port, topic=topic, client_id=rank,
                                client_num=worker_num, client_factory=factory)
        return OffloadCommManager(inner, FileSystemStore(store_root),
                                  threshold_bytes=threshold_bytes,
                                  broadcast_generations=broadcast_generations)

    mgrs = {r: make_comm(r) for r in range(worker_num + 1)}
    try:
        return run_distributed_fedavg(
            trainer, train_data, worker_num, round_num, batch_size,
            lambda r: mgrs[r], seed=seed, on_round_done=on_round_done,
            init_overrides=init_overrides, **runner_kwargs,
        )
    finally:
        for m in mgrs.values():
            m.stop_receive_message()
        if tmp_store is not None:
            shutil.rmtree(tmp_store, ignore_errors=True)
