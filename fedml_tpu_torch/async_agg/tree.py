"""Hierarchical aggregation tree over the message-passing backends, the
port of ``fedml_tpu/async_agg/tree.py``.

Clients upload to edge aggregators, every edge tier is itself a streaming
accumulate-on-arrival tally over its own comm fabric, and each tier
forwards ONE folded super-update upstream: the root's fan-in is O(tiers),
not O(clients), and no process holds more than O(model) aggregation state.

The super-update is the raw tally, not an average: the f64 accumulator
(``sum_i n_i * x_i``) plus its weight sum, so the root's divide-at-close
reproduces the flat server's weighted mean over all leaves. A 1-tier tree
(one edge under the root, all clients under it) folds uploads in exactly
the flat server's sequence and is bitwise the flat server; wider trees
regroup the f64 additions per tier (the last ULPs of a streaming sum).
Every tally is the JAX package's host numpy arithmetic, so the same uploads
in the same order give the bitwise-same partials and globals.

Client-index assignment needs no routing tables: every leaf tier derives
its children's cohort slots from the shared ``rnglib.sample_clients``
schedule (round index + global leaf numbering), the flat server's schedule.

Where the port departs from the JAX package (ROADMAP §C): the tier's weak-DP
noise draws from a :class:`~fedml_tpu_torch.core.rng.RoundNoise` seeded with
the JAX key's integers, ``(dp_seed + leaf_base * 1_000_003, emission)``,
and a quantizing tier codec draws its uniforms from one seeded with
``(0x7EE4 ^ leaf_base, round)`` and the emission's ``seq``; JAX's keys give
other numbers. The downlink delta plane (``downlink_codec``) is encoded at
the root, re-served verbatim by the edges and decoded by the leaves; the
cross-rank trace lanes (``trace_lanes``) give every node a lane of its own.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from typing import Callable

import numpy as np
import torch

from fedml_tpu_torch.algorithms.base import EmptyRoundError
from fedml_tpu_torch.algorithms.fedavg_distributed import (
    CompressedFedAvgClientManager,
    FedAvgClientManager,
    FedAvgDistAggregator,
    FedAvgServerManager,
    MyMessage,
    init_template,
    unpack_state,
)
from fedml_tpu_torch.algorithms.fold_plane import FoldPlane, TierPartialFoldTask
from fedml_tpu_torch.async_agg.server import _AsyncTallyMixin
from fedml_tpu_torch.async_agg.staleness import make_staleness_fn, memoize_staleness
from fedml_tpu_torch.comm.managers import DistributedManager
from fedml_tpu_torch.comm.message import (
    Message,
    pack_encoded_update,
    unpack_encoded_update,
)
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.obs import jobscope
from fedml_tpu_torch.obs import metrics as metricslib
from fedml_tpu_torch.obs import registry
from fedml_tpu_torch.obs import trace


class TierNoise(rnglib.RoundNoise):
    """A :class:`~fedml_tpu_torch.core.rng.RoundNoise` with a third integer,
    the emission's ``seq``: the k-th draw reseeds from ``(seed, round, seq,
    k, tag)``, so every emission of a tier draws its own uniforms."""

    def __init__(self, seed: int, round_idx: int, seq: int, device="cpu"):
        super().__init__(seed, round_idx, device)
        self.seq = int(seq)

    def _reseed(self, tag: int):
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
        mixed = np.random.SeedSequence(
            [self.seed, self.round_idx, self.seq, self._k, tag]).generate_state(1, np.uint64)[0]
        self._k += 1
        return self._generator.manual_seed(int(mixed))


class TreeMessage:
    """Tier-routing message surface: an edge's folded super-update travels
    upstream as a partial tally (f64 accumulator + weight sum), distinct
    from a client's model upload."""

    MSG_TYPE_T2S_SEND_PARTIAL = 4

    MSG_ARG_KEY_WEIGHT_SUM = Message.MSG_ARG_KEY_WEIGHT_SUM
    MSG_ARG_KEY_FOLD_COUNT = Message.MSG_ARG_KEY_FOLD_COUNT
    MSG_ARG_KEY_PARTIAL_SEQ = Message.MSG_ARG_KEY_PARTIAL_SEQ
    MSG_ARG_KEY_WINDOW_COMPLETE = Message.MSG_ARG_KEY_WINDOW_COMPLETE


@dataclasses.dataclass(frozen=True)
class TreeTopology:
    """Fan-in per tier, root downward; the last entry is clients per leaf
    edge. ``(2, 4)`` = root over 2 edges x 4 clients each (8 leaves);
    ``(1, N)`` is the 1-tier identity arm; ``(2, 2, 4)`` adds an inner
    edge tier. A flat (edge-less) server is ``run_distributed_fedavg``."""

    fan_ins: tuple[int, ...]

    def __post_init__(self):
        fan = tuple(int(f) for f in self.fan_ins)
        object.__setattr__(self, "fan_ins", fan)
        if len(fan) < 2:
            raise ValueError(
                f"a tree needs at least one edge tier (got fan_ins={fan}); "
                "an edge-less server is run_distributed_fedavg"
            )
        if any(f < 1 for f in fan):
            raise ValueError(f"every tier fan-in must be >= 1, got {fan}")

    @property
    def leaf_count(self) -> int:
        return math.prod(self.fan_ins)

    @property
    def tier_count(self) -> int:
        """Aggregation tiers between clients and root (edge tiers)."""
        return len(self.fan_ins) - 1


class TierAggregator(_AsyncTallyMixin, FedAvgDistAggregator):
    """Streaming tally that also folds CHILD-TIER partials (f64 raw sums)
    and exports its own tally as a partial instead of dividing — the
    aggregation primitive every tree tier shares (the root folds partials
    and inherits divide-at-close).

    Carries BOTH disciplines: the sync tree's first-wins flag barrier
    (``add_local_trained_result`` / ``add_partial_result`` / ``partial``)
    and the barrier-free fold-on-arrival surface (``fold_async`` from
    :class:`_AsyncTallyMixin`, ``fold_partial_weighted``,
    ``export_partial``) an async edge tier drives instead. ``tier_label``
    names the tier in diagnostics (EmptyRoundError must say WHICH edge of a
    thousand-cell hierarchy starved and which children went missing)."""

    def __init__(self, worker_num: int, tier_label: str | None = None):
        super().__init__(worker_num)
        self.tier_label = tier_label
        self._init_async()
        # indices with uncommitted (window-incomplete) partial mass this
        # round: their weight accumulates across emissions instead of the
        # legacy per-round assignment
        self._open_partials: set[int] = set()  # guarded-by: _lock

    def _empty_round_error(self) -> EmptyRoundError:  # lock-held: _lock
        if self.tier_label is None:
            return super()._empty_round_error()
        flags = self.flag_client_model_uploaded_dict
        missing = sorted(i + 1 for i, f in flags.items() if not f)
        msg = (
            f"edge tier {self.tier_label}: nothing to forward — no child "
            f"contribution folded this window (missing children {missing}"
        )
        if self._excluded:
            msg += (f"; children {sorted(i + 1 for i in self._excluded)} "
                    "already excluded")
        msg += ")"
        return EmptyRoundError(msg)

    def add_partial_result(self, index: int, payload: np.ndarray,
                           weight_sum: float, complete: bool = True) -> bool:
        """Fold a child tier's super-update: the payload is that tier's f64
        accumulator (already sample-weighted), so folding is a straight f64
        add — no re-weighting, no precision loss. ``complete=False`` folds
        a barrier-free tier's mid-window emission WITHOUT setting the
        first-wins flag — only the emission that closes the child's window
        counts toward the round barrier."""
        with self._lock:
            # child partials fold inline (they are already f64 sums, one
            # add apiece); with a fold plane attached, drain first so a
            # mixed schedule of plane-queued and inline folds still applies
            # in arrival order
            self._drain_locked()
            self._fold_epoch += 1
            flags = self.flag_client_model_uploaded_dict
            if index not in flags:
                return False
            if flags[index]:
                return all(flags.values())  # duplicate partial: first wins
            part = np.ascontiguousarray(payload).view(np.float64)
            if self._acc is None:
                # first partial is COPIED, not added onto zeros: 0.0 + -0.0
                # flips a sign bit, which would break the 1-tier
                # bit-identity contract for exactly-(-0.0) coordinates
                self._acc = np.array(part, np.float64)
            else:
                self._acc += part
            self._wsum += float(weight_sum)
            if index in self._open_partials:
                self.sample_num_dict[index] += float(weight_sum)
            else:
                self.sample_num_dict[index] = float(weight_sum)
                self._open_partials.add(index)
            if complete:
                flags[index] = True
                self._open_partials.discard(index)
            return all(flags.values())

    def fold_partial_weighted(self, payload: np.ndarray, weight_sum: float,
                              scale: float = 1.0) -> None:
        """Barrier-free partial fold for an ASYNC tier: no first-wins flag,
        no completion return — the manager's window accounting decides when
        to emit. ``scale`` down-weights a stale child window (the tier
        staleness family applied to a whole partial: both the accumulator
        mass and its weight scale together, so the final mean stays
        consistent). ``scale == 1.0`` skips the multiply entirely — the
        fresh path stays bit-identical to the sync tree's fold."""
        with self._lock:
            self._fold_epoch += 1
            if self._plane is not None:
                task = TierPartialFoldTask(payload, float(weight_sum),
                                           float(scale))
                if self._acc is None:
                    # the task ASSIGNS its first copy chunk-by-chunk (the
                    # serial copy-not-add discipline); the zeros are only a
                    # target buffer and are fully overwritten
                    self._acc = np.zeros(task.acc_elems, np.float64)
                    self._acc_provisional = True
                    task.first = True
                self._pending_finalize.append(task)
                self._plane.submit(task, self._acc)
                self.arrivals += 1
                return
            part = np.ascontiguousarray(payload).view(np.float64)
            if scale != 1.0:
                part = part * np.float64(scale)
                weight_sum = float(weight_sum) * float(scale)
            if self._acc is None:
                self._acc = np.array(part, np.float64)
            else:
                self._acc += part
            self._wsum += float(weight_sum)
            self.arrivals += 1

    def export_partial(self) -> tuple[np.ndarray, float]:
        """Drain the async window: return (f64 accumulator, weight sum) and
        reset the tally for the next emission. The caller OWNS the returned
        array (DP noise is added in place before framing). The first-wins
        flags are untouched — async windows never use them."""
        with self._lock:
            self._drain_locked()
            self._fold_epoch += 1
            if self._acc is None:
                raise self._empty_round_error()
            acc = np.ascontiguousarray(self._acc)
            wsum = self._wsum
            self._acc = None
            self._wsum = 0.0
            self.arrivals = 0
            return acc, wsum

    def aggregate(self) -> np.ndarray:
        out = super().aggregate()
        with self._lock:
            # a tier whose window never completed (root closed the round by
            # timeout) must not leak its open-partial weight into the next
            # round's sample_num bookkeeping
            self._open_partials.clear()
        return out

    def partial(self) -> tuple[np.ndarray, float, int]:
        """Export the raw tally for the parent tier — (f64 accumulator as a
        byte view, weight sum, folds) — and reset for the next round."""
        with self._lock:
            self._drain_locked()
            self._fold_epoch += 1
            flags = self.flag_client_model_uploaded_dict
            if self._acc is None:
                raise self._empty_round_error()
            out = np.ascontiguousarray(self._acc).view(np.uint8)
            wsum = self._wsum
            count = sum(1 for f in flags.values() if f)
            self._acc = None
            self._wsum = 0.0
            for i in flags:
                flags[i] = False
            return out, wsum, count

    def slot_complete(self, index: int) -> bool:
        """Whether this child's round window already closed (its first-wins
        flag is set) — parents of barrier-free tiers route post-complete
        straggler emissions through the flag-free fold instead."""
        with self._lock:
            return bool(self.flag_client_model_uploaded_dict.get(index))

    def state_bytes(self) -> int:
        """Resident tally bytes (the f64 accumulator) — O(model) by
        construction, whatever the fan-in or arrival count."""
        with self._lock:
            return 0 if self._acc is None else int(self._acc.nbytes)

    def discard_window(self) -> int:
        """Drop an unforwarded tally — the round moved on without this tier
        (a slow child kept the window open past the root's timeout). Returns
        the number of folds lost so the caller can account for them; mixing
        them into the next round's partial would silently corrupt it."""
        with self._lock:
            # drain rather than just dropping the pending tasks: a chunk
            # worker may be mid-fold into the accumulator we are about to
            # release, and an undrained task would otherwise finalize its
            # weight into the NEXT window's tally
            self._drain_locked()
            self._fold_epoch += 1
            flags = self.flag_client_model_uploaded_dict
            # sync windows count set flags; async windows count arrivals
            # (fold_async/fold_partial_weighted never set flags) — the two
            # disciplines are never mixed within one window
            lost = sum(1 for f in flags.values() if f) + self.arrivals
            self._acc = None
            self._wsum = 0.0
            self.arrivals = 0
            self.sample_num_dict.clear()
            self._open_partials.clear()
            for i in flags:
                flags[i] = False
            return lost


@dataclasses.dataclass(frozen=True)
class EdgeAsyncConfig:
    """Barrier-free discipline knobs shared by every edge tier of a run
    (resolved objects, not spec strings — ``run_tree_fedavg`` parses).

    ``buffer_goal`` is clamped to each edge's fan-in; ``None`` means
    fan-in, which makes the async discipline BIT-IDENTICAL to the sync
    barrier (the per-tier oracle arm). ``staleness_weight`` arms
    fold-don't-discard for stale child uploads; ``tier_timeout`` arms the
    elastic per-tier flush; ``uplink_codec`` frames the tier's partial as
    an EncodedUpdate; ``defense`` (mean-rule clip+DP) defends leaf-tier
    model folds; ``client_codec`` says leaf uploads arrive encoded."""

    buffer_goal: int | None = None
    staleness_weight: str | None = None
    tier_timeout: float | None = None
    uplink_codec: object = None
    defense: object = None
    client_codec: object = None

    @property
    def needs_base(self) -> bool:
        """True when the discipline must see the dense round global (clip
        reference / delta-domain reconstruction) — incompatible with
        downlink delta chains, which edges re-serve without decoding."""
        return (self.defense is not None
                or (self.client_codec is not None
                    and self.client_codec.delta_domain)
                or (self.uplink_codec is not None
                    and self.uplink_codec.delta_domain))


class EdgeAggregatorManager(DistributedManager):
    """One tree tier node: a streaming server to its children (model
    uploads OR child partials, over its own down fabric) and a client to
    its parent (one partial per round, over the up fabric). Observes BOTH
    comms — message types are disjoint, so one handler table routes them.

    ``leaf_base``/``leaf_total`` place this node's subtree in the global
    leaf numbering; leaf tiers use it to assign their clients the same
    cohort slots the flat server would.

    With ``async_config`` the tier is barrier-free: child contributions
    fold ON ARRIVAL (the ``_AsyncTallyMixin`` discipline, staleness-
    weighted when armed) and the tier forwards a partial per EMISSION —
    every ``buffer_goal`` arrivals, when all children complete, or when
    the elastic ``tier_timeout`` flushes a stalled window — instead of one
    partial per barrier. ``buffer_goal == fan-in`` degrades bit-identically
    to the sync barrier (tools/async_smoke.py)."""

    def __init__(self, up_comm, up_rank: int, down_comm, child_num: int,
                 leaf_base: int, leaf_total: int, client_num_in_total: int,
                 children_are_leaves: bool,
                 async_config: EdgeAsyncConfig | None = None,
                 model_desc: str | None = None,
                 fold_workers: int = 0, fold_chunk: int | None = None):
        super().__init__(down_comm, rank=0, size=child_num + 1)
        self.up_comm = up_comm
        self.up_rank = up_rank
        self.child_num = child_num
        self.leaf_base = leaf_base
        self.leaf_total = leaf_total
        self.client_num_in_total = client_num_in_total
        self.children_are_leaves = bool(children_are_leaves)
        self.aggregator = TierAggregator(
            child_num, tier_label=f"rank={up_rank} leaf_base={leaf_base}")
        if fold_workers > 0:
            # leaf uploads and barrier-free partials fold off this tier's
            # receive threads, chunk-parallel (algorithms/fold_plane.py)
            kw = {} if fold_chunk is None else {"chunk_elems": int(fold_chunk)}
            self.aggregator.attach_fold_plane(FoldPlane(int(fold_workers),
                                                        **kw))
        self._async = async_config
        if async_config is not None:
            self._buffer_goal = min(
                int(async_config.buffer_goal or child_num), child_num)
            if self._buffer_goal < 1:
                raise ValueError(
                    f"buffer_goal must be >= 1, got {self._buffer_goal}")
            self._staleness_fn = (
                memoize_staleness(
                    make_staleness_fn(async_config.staleness_weight))
                if async_config.staleness_weight is not None else None)
            self._norm_mask = None
            if async_config.defense is not None and model_desc is not None:
                from fedml_tpu_torch.algorithms.robust import flat_norm_mask

                self._norm_mask = flat_norm_mask(model_desc)
        # barrier-free window state (all guarded-by: _edge_lock)
        self._pending = 0          # arrivals since the last emission
        self._window_folds = 0     # leaf uploads the window represents
        self._window_seq = 0       # emissions this round
        self._completed: set[int] = set()  # children complete this round
        self._drained = False      # a complete=1 emission went out
        self._tier_timer: threading.Timer | None = None
        self._child_windows: dict[int, tuple[int, int]] = {}
        self._g32: np.ndarray | None = None   # round global (f32 view)
        self._g64: np.ndarray | None = None   # f64 cast (clip/delta base)
        self._model_size: int | None = None
        self._dp_counter = 0
        self.stale_uploads = 0  # guarded-by: _edge_lock
        self.duplicate_uploads = 0  # guarded-by: _edge_lock
        self.discarded_folds = 0  # guarded-by: _edge_lock
        self.stale_syncs = 0  # guarded-by: _edge_lock
        self.stale_folds = 0  # guarded-by: _edge_lock
        self.rejected_uploads = 0  # guarded-by: _edge_lock
        self.clipped_uploads = 0  # guarded-by: _edge_lock
        self.elastic_emissions = 0  # guarded-by: _edge_lock
        self.uplink_bytes = 0  # guarded-by: _edge_lock
        self.uplink_dense_bytes = 0  # guarded-by: _edge_lock
        self.heartbeats_seen = 0  # guarded-by: _edge_lock
        # fleet telemetry (obs/registry.py): cumulative folds forwarded and
        # the current window's fill-start time — the tier's "local step
        # time" is first-fold -> forward. Collected only when the runner
        # opted this tier in (fleet_telemetry, the same explicit switch as
        # FedAvgClientManager — a process registry installed for unrelated
        # gauges must never change what goes on the wire).
        self.fleet_telemetry = False
        self.total_folds = 0  # guarded-by: _edge_lock
        self._window_t0: float | None = None  # guarded-by: _edge_lock
        self._round = 0  # guarded-by: _edge_lock
        # the model version this tier last re-served downward (downlink
        # delta plane): echoed on the partial so the ROOT serves this
        # subtree the right delta base — the children are round-locked
        # with their tier, so the tier's version IS the subtree's
        self._model_version: int | None = None  # guarded-by: _edge_lock
        # per-child round of the last ACCEPTED contribution: the tally's
        # first-wins flags reset when the tier forwards its partial, but the
        # tier's round only advances on the next parent sync — a duplicated
        # leg landing in that window would otherwise fold as a phantom
        # first contribution of the NEXT window (and first-wins would then
        # drop the child's genuine next-round upload)
        self._last_child_round: dict[int, int] = {}  # guarded-by: _edge_lock
        # the up fabric (parent syncs) and down fabric (child uploads) run
        # handlers on DIFFERENT threads: round advance + window discard vs
        # guard + fold must not interleave (same discipline as the flat
        # server's _round_lock)
        self._edge_lock = threading.Lock()
        up_comm.add_observer(self)
        self._up_thread: threading.Thread | None = None

    # -- run loop: both fabrics ----------------------------------------------

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self._on_sync_from_parent)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
            self._on_sync_from_parent)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self._on_child_model)
        self.register_message_receive_handler(
            TreeMessage.MSG_TYPE_T2S_SEND_PARTIAL, self._on_child_partial)
        from fedml_tpu_torch.comm.status import ClientStatus

        self.register_message_receive_handler(
            ClientStatus.MSG_TYPE_CLIENT_STATUS, self._on_child_status)

    def _on_child_status(self, msg: Message) -> None:
        # child heartbeats ride the down fabric; liveness DECISIONS live at
        # the root (miss counts over partials) — the tier just counts
        # contact instead of letting DistributedManager warn per beat
        with self._edge_lock:
            self.heartbeats_seen += 1

    def run(self) -> None:
        self.register_message_receive_handlers()
        self._up_thread = threading.Thread(
            # the up-fabric loop inherits this tier's job/lane binding
            # (obs/jobscope.py) so parent-sync recv spans land in the SAME
            # per-tier tracer as the down-fabric folds
            target=jobscope.wrap_target(self.up_comm.handle_receive_message),
            daemon=True, name=f"edge-up-r{self.up_rank}",
        )
        self._up_thread.start()
        self.comm.handle_receive_message()  # down fabric, caller thread

    def finish(self) -> None:
        self.aggregator.close_fold_plane()
        self.comm.stop_receive_message()
        self.up_comm.stop_receive_message()

    def _send_up(self, msg: Message) -> None:
        policy = getattr(self.up_comm, "retry_policy", None)
        if policy is None:
            send = lambda: self.up_comm.send_message(msg)  # noqa: E731
        else:
            send = lambda: policy.run(  # noqa: E731
                lambda: self.up_comm.send_message(msg),
                on_retry=self._note_retry,
                dst=msg.get_receiver_id(), msg_type=msg.get_type())
        tracer = trace.get()
        if tracer is None:
            send()
            return
        # the uplink leg bypasses DistributedManager.send_message (that
        # layer is bound to the DOWN fabric), so it opens its own comm/send
        # span and stamps the trace context here — the wire hop the merged
        # trace walks from the root's fold back into this tier
        with tracer.span("comm/send", msg_type=msg.get_type(),
                         sender=self.up_rank,
                         receiver=msg.get_receiver_id(),
                         bytes=msg.payload_nbytes()):
            self.up_comm.stamp_trace_ctx(msg)
            send()

    # -- downlink: parent sync re-broadcast ----------------------------------

    def _on_sync_from_parent(self, msg: Message) -> None:
        if msg.get(Message.MSG_ARG_KEY_FINISHED):
            out = Message(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, 1)
            out.add_params(Message.MSG_ARG_KEY_FINISHED, 1)
            self.broadcast_message(out, list(range(1, self.child_num + 1)))
            self.finish()
            return
        ridx = msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
        with self._edge_lock:
            if ridx is not None:
                if int(ridx) < self._round:
                    # a replayed/reordered old downlink leg (dup faults,
                    # QoS re-delivery): adopting it would REGRESS the round,
                    # discard the live window, and wedge the tier against
                    # the root — drop the whole message (tree mode has no
                    # checkpoint plane, so a backward round is never a
                    # legitimate server restart)
                    self.stale_syncs += 1
                    logging.info(
                        "edge tier (leaf_base=%d): dropping replayed "
                        "round-%d sync (current=%d)",
                        self.leaf_base, int(ridx), self._round,
                    )
                    return
                if int(ridx) > self._round:
                    # the parent moved on (root round-timeout excluded this
                    # subtree mid-window): an unforwarded tally holds
                    # OLD-round folds and must not leak into the new
                    # window's partial
                    lost = self.aggregator.discard_window()
                    if lost:
                        self.discarded_folds += lost
                        logging.warning(
                            "edge tier (leaf_base=%d): parent advanced to "
                            "round %d with %d unforwarded round-%d fold(s) "
                            "in the tally — discarding the stale window",
                            self.leaf_base, int(ridx), lost, self._round,
                        )
                    self._round = int(ridx)
                    if self._async is not None:
                        self._async_reset_window_locked()
            version = msg.get(Message.MSG_ARG_KEY_MODEL_VERSION)
            if version is not None:
                self._model_version = int(version)
            if (self._async is not None
                    and msg.get(Message.MSG_ARG_KEY_ENCODED_UPDATE) is None):
                sync_payload = msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
                if sync_payload is not None:
                    # stash the round global: the clip reference, the
                    # delta-domain base for encoded uploads/partials, and
                    # the model size the elastic zero-marker needs
                    g32 = np.ascontiguousarray(
                        np.asarray(sync_payload)).view(np.float32)
                    self._model_size = int(g32.size)
                    if self._async.needs_base:
                        self._g32 = g32
                        self._g64 = g32.astype(np.float64)
            # snapshot under the lock; the re-broadcast below runs OUTSIDE
            # it (fedlint guarded-by — and a lock held across a fan-out is
            # the deadlock shape of a lock held across a fan-out)
            round_now = self._round
        out = Message(msg.get_type(), 0, 1)
        # encode-once per tier: the children share ONE re-framed payload —
        # the read-only view of the parent's frame, never a per-child copy.
        # A delta-coded sync (downlink plane) is re-served verbatim: the
        # edge never decodes — chain blob, descriptor, and base version
        # pass straight through to the subtree.
        chain = msg.get(Message.MSG_ARG_KEY_ENCODED_UPDATE)
        if chain is not None:
            out.add_params(Message.MSG_ARG_KEY_ENCODED_UPDATE,
                           np.asarray(chain))
            out.add_params(Message.MSG_ARG_KEY_ENCODED_DESC,
                           msg.get(Message.MSG_ARG_KEY_ENCODED_DESC))
            base = msg.get(Message.MSG_ARG_KEY_BASE_VERSION)
            if base is not None:
                out.add_params(Message.MSG_ARG_KEY_BASE_VERSION, int(base))
        else:
            payload = np.asarray(msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS))
            out.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, payload)
        out.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, round_now)
        if version is not None:
            out.add_params(Message.MSG_ARG_KEY_MODEL_VERSION, version)
        desc = msg.get(MyMessage.MSG_ARG_KEY_MODEL_DESC)
        if desc is not None:
            out.add_params(MyMessage.MSG_ARG_KEY_MODEL_DESC, desc)
        per_receiver = None
        if self.children_are_leaves:
            # the SAME cohort schedule as the flat server, indexed by this
            # subtree's global leaf numbers — no routing tables on the wire
            cohort = rnglib.sample_clients(
                round_now, self.client_num_in_total, self.leaf_total
            )
            per_receiver = {
                c: {MyMessage.MSG_ARG_KEY_CLIENT_INDEX:
                    int(cohort[self.leaf_base + c - 1])}
                for c in range(1, self.child_num + 1)
            }
        self.broadcast_message(out, list(range(1, self.child_num + 1)),
                               per_receiver=per_receiver)

    # -- uplink: fold children, forward one partial --------------------------

    def _guard_round(self, msg: Message, kind: str) -> bool:  # lock-held: _edge_lock
        sender = msg.get_sender_id()
        u = msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
        if u is not None and int(u) != self._round:
            self.stale_uploads += 1
            logging.info(
                "edge tier (leaf_base=%d): discarding stale %s from child %d "
                "(upload_round=%s, current=%d)",
                self.leaf_base, kind, sender, u, self._round,
            )
            return False
        if self._last_child_round.get(sender) == self._round:
            # replayed leg for a round this child already contributed to —
            # the tally may have been forwarded (flags reset) since, so the
            # first-wins flags alone cannot catch it
            self.duplicate_uploads += 1
            logging.info(
                "edge tier (leaf_base=%d): absorbed duplicate round-%d %s "
                "from child %d", self.leaf_base, self._round, kind, sender,
            )
            return False
        return True

    def _on_child_model(self, msg: Message) -> None:
        if self._async is not None:
            self._async_child_model(msg)
            return
        # guard + fold + record (+ forward) are one critical section
        # against the up thread's round advance: a straggler that passed
        # the guard for round r must fold into round r's tally or not at
        # all, never into a freshly discarded next window
        with self._edge_lock:
            if not self._guard_round(msg, "model upload"):
                return
            sender = msg.get_sender_id()
            flat = np.asarray(msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS))
            n = float(msg.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES))
            if self.fleet_telemetry and self._window_t0 is None:
                self._window_t0 = time.perf_counter()
            with trace.span("tree/fold", kind="model", sender=sender,
                            round=self._round):
                done = self.aggregator.add_local_trained_result(
                    sender - 1, flat, n)
            self._last_child_round[sender] = self._round
            out = self._build_partial_msg() if done else None
        # the upstream send runs OUTSIDE the critical section (fedlint
        # blocking-under-lock): a slow or retrying up fabric must not stall
        # child folds or the up thread's round advance — ordering is safe
        # because the next window cannot complete before the parent's next
        # sync, which needs this partial first
        if out is not None:
            self._send_up(out)

    def _on_child_partial(self, msg: Message) -> None:
        if self._async is not None:
            self._async_child_partial(msg)
            return
        with self._edge_lock:
            if not self._guard_round(msg, "partial"):
                return
            sender = msg.get_sender_id()
            part = np.asarray(msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS))
            wsum = float(msg.get(TreeMessage.MSG_ARG_KEY_WEIGHT_SUM))
            folds = msg.get(TreeMessage.MSG_ARG_KEY_FOLD_COUNT)
            if self.fleet_telemetry and self._window_t0 is None:
                self._window_t0 = time.perf_counter()
            with trace.span("tree/fold", kind="partial", sender=sender,
                            round=self._round,
                            child_folds=int(folds) if folds is not None
                            else -1):
                done = self.aggregator.add_partial_result(
                    sender - 1, part, wsum)
            self._last_child_round[sender] = self._round
            out = self._build_partial_msg() if done else None
        if out is not None:  # send outside the lock (see _on_child_model)
            self._send_up(out)

    def _build_partial_msg(self) -> Message:  # lock-held: _edge_lock
        """Snapshot the completed window into the upstream partial message.
        Caller sends it AFTER releasing ``_edge_lock`` — the build touches
        the tally and the telemetry counters (lock territory), the send is
        blocking I/O (never lock territory)."""
        partial, wsum, count = self.aggregator.partial()
        self.total_folds += int(count)
        self.uplink_bytes += int(partial.nbytes)
        self.uplink_dense_bytes += int(partial.nbytes)
        with trace.span("tree/forward", round=self._round, folds=count,
                        bytes=int(partial.nbytes)):
            out = Message(TreeMessage.MSG_TYPE_T2S_SEND_PARTIAL,
                          self.up_rank, 0)
            out.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, partial)
            out.add_params(TreeMessage.MSG_ARG_KEY_WEIGHT_SUM, float(wsum))
            out.add_params(TreeMessage.MSG_ARG_KEY_FOLD_COUNT, int(count))
            out.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self._round)
            if self._model_version is not None:
                # version echo (downlink delta plane): the root serves this
                # subtree's next sync as a delta against what the tier —
                # and therefore its round-locked children — actually holds
                out.add_params(Message.MSG_ARG_KEY_MODEL_VERSION,
                               self._model_version)
            if self.fleet_telemetry:
                # the tier's piggybacked health report (docs/OBSERVABILITY.md
                # "Fleet telemetry"): window fill time as the tier's step
                # time, send stamp for upload latency, and the cumulative
                # tier counters the root records as per-tier gauges
                tel: dict = {"sent_at": time.time(),
                             "retries": self.comm_retries,
                             "counts": {
                                 "folds_total": self.total_folds,
                                 "stale_uploads": self.stale_uploads,
                                 "dup_uploads": self.duplicate_uploads,
                                 "discarded_folds": self.discarded_folds,
                                 "stale_syncs": self.stale_syncs,
                             }}
                if self._window_t0 is not None:
                    tel["step_ms"] = round(
                        (time.perf_counter() - self._window_t0) * 1e3, 3)
                self._window_t0 = None
                out.add_params(Message.MSG_ARG_KEY_TELEMETRY, tel)
            return out

    # -- barrier-free tier discipline (async_config) -------------------------

    def _async_reset_window_locked(self) -> None:  # lock-held: _edge_lock
        """Round advance: open a fresh emission window. The tally itself was
        already reset by ``discard_window`` (or drained by the last
        emission) — this resets the MANAGER's window accounting."""
        self._pending = 0
        self._window_folds = 0
        self._window_seq = 0
        self._completed.clear()
        self._drained = False
        if self._tier_timer is not None:
            self._tier_timer.cancel()
            self._tier_timer = None

    def _child_upload_payload(self, msg: Message) -> np.ndarray:
        """Dense f32 model view of a child upload. Encoded (client-codec)
        uploads are decoded to MODEL domain here — one transient dense
        vector, exactly the RobustCompressedDistAggregator discipline — so
        the tier keeps a single model-domain accumulator and the plain
        async fold stays bit-identical to the sync tree's."""
        blob = msg.get(Message.MSG_ARG_KEY_ENCODED_UPDATE)
        if blob is None:
            return np.ascontiguousarray(
                np.asarray(msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS))
            ).view(np.float32)
        codec = self._async.client_codec
        if codec is None:
            raise ValueError(
                f"edge tier (leaf_base={self.leaf_base}) received an encoded "
                "upload but no client codec is configured"
            )
        from fedml_tpu_torch.compress.aggregate import _flat_leaves

        enc = unpack_encoded_update(
            np.asarray(blob), msg.get(Message.MSG_ARG_KEY_ENCODED_DESC))
        leaves = _flat_leaves(codec.decode(enc))
        dense = (np.asarray(leaves[0], np.float32) if len(leaves) == 1
                 else np.concatenate([l.astype(np.float32) for l in leaves]))
        if codec.delta_domain:
            dense = self._g32 + dense
        return dense

    # lock-held: _edge_lock
    def _defend_upload(self, x: np.ndarray) -> np.ndarray | None:
        """Clip-to-bound defense on one leaf upload.
        Numpy throughout — a jit dispatch per upload would dominate the
        fold at 10^6 uploads. Non-finite uploads are rejected (returns
        None); over-bound deltas are clipped on the MASKED norm (the same
        ``flat_norm_mask`` exemption the flat robust server applies) while
        the finite check stays full-vector."""
        cfg = self._async.defense
        delta = x.astype(np.float64) - self._g64
        full_norm = float(np.linalg.norm(delta))
        if not np.isfinite(full_norm):
            self.rejected_uploads += 1
            logging.warning(
                "edge tier (leaf_base=%d): rejecting non-finite upload "
                "(Robust/RejectedUploads=%d this tier)",
                self.leaf_base, self.rejected_uploads,
            )
            return None
        if cfg.norm_bound > 0:
            norm = (full_norm if self._norm_mask is None
                    else float(np.linalg.norm(delta[self._norm_mask])))
            if norm > cfg.norm_bound:
                self.clipped_uploads += 1
                x = (self._g64
                     + delta * (cfg.norm_bound / norm)).astype(np.float32)
        return x

    def _async_child_model(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        with self._edge_lock:
            u = msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
            u = self._round if u is None else min(int(u), self._round)
            staleness = self._round - u
            if staleness > 0 and self._staleness_fn is None:
                self.stale_uploads += 1
                logging.info(
                    "edge tier (leaf_base=%d): discarding stale model upload "
                    "from child %d (upload_round=%d, current=%d; no "
                    "staleness family armed)",
                    self.leaf_base, sender, u, self._round,
                )
                return
            x = self._child_upload_payload(msg)
            n = float(msg.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES))
            if self._async.defense is not None:
                x = self._defend_upload(x)
                if x is None:
                    return
            # s(0) == 1 for every family, but the fresh path multiplies by
            # NOTHING — bit-identity with the sync fold is structural, not
            # arithmetic luck
            weight = n if staleness == 0 else self._staleness_fn(staleness) * n
            if self.fleet_telemetry and self._window_t0 is None:
                self._window_t0 = time.perf_counter()
            with trace.span("tree/fold", kind="model", sender=sender,
                            round=self._round, staleness=staleness):
                folded = self.aggregator.fold_async(sender - 1, x, weight, u)
            if not folded:
                # fold_async's monotonic per-(child, round) guard: a
                # replayed leg, or a second upload for a round the child
                # already contributed to
                self.duplicate_uploads += 1
                logging.info(
                    "edge tier (leaf_base=%d): absorbed duplicate round-%d "
                    "model upload from child %d",
                    self.leaf_base, u, sender,
                )
                return
            self._pending += 1
            self._window_folds += 1
            if staleness > 0:
                self.stale_folds += 1
            else:
                self._completed.add(sender)
            out = self._async_maybe_emit_locked()
        if out is not None:  # send outside the lock (see _on_child_model)
            self._send_up(out)

    def _async_child_partial(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        with self._edge_lock:
            u = msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
            u = self._round if u is None else min(int(u), self._round)
            staleness = self._round - u
            seq = msg.get(TreeMessage.MSG_ARG_KEY_PARTIAL_SEQ)
            wkey = (u, int(seq) if seq is not None else 0)
            last = self._child_windows.get(sender)
            if last is not None and wkey <= last:
                self.duplicate_uploads += 1
                logging.info(
                    "edge tier (leaf_base=%d): absorbed replayed partial "
                    "from child %d (round=%d seq=%d, last=%s)",
                    self.leaf_base, sender, wkey[0], wkey[1], last,
                )
                return
            encoded = msg.get(Message.MSG_ARG_KEY_ENCODED_UPDATE) is not None
            if staleness > 0 and (self._staleness_fn is None
                                  or (encoded and
                                      self._async.uplink_codec.delta_domain)):
                # a delta-framed stale partial rode an OLD round's global
                # this tier no longer holds — not reconstructable, always
                # discarded; raw (and non-delta encoded) stale partials
                # fold down-weighted when a staleness family is armed
                self.stale_uploads += 1
                logging.info(
                    "edge tier (leaf_base=%d): discarding stale partial from "
                    "child %d (upload_round=%d, current=%d, encoded=%s)",
                    self.leaf_base, sender, u, self._round, encoded,
                )
                return
            self._child_windows[sender] = wkey
            wsum = float(msg.get(TreeMessage.MSG_ARG_KEY_WEIGHT_SUM))
            folds = msg.get(TreeMessage.MSG_ARG_KEY_FOLD_COUNT)
            part = self._child_partial_payload(msg, wsum)
            scale = 1.0 if staleness == 0 else self._staleness_fn(staleness)
            if self.fleet_telemetry and self._window_t0 is None:
                self._window_t0 = time.perf_counter()
            with trace.span("tree/fold", kind="partial", sender=sender,
                            round=self._round, staleness=staleness,
                            child_folds=int(folds) if folds is not None
                            else -1):
                self.aggregator.fold_partial_weighted(part, wsum, scale)
            self._pending += 1
            self._window_folds += int(folds or 0)
            if staleness > 0:
                self.stale_folds += 1
            complete = msg.get(TreeMessage.MSG_ARG_KEY_WINDOW_COMPLETE)
            if staleness == 0 and (complete is None or int(complete)):
                self._completed.add(sender)
            out = self._async_maybe_emit_locked()
        if out is not None:  # send outside the lock (see _on_child_model)
            self._send_up(out)

    def _child_partial_payload(self, msg: Message, wsum: float) -> np.ndarray:
        """f64 accumulator view of a child tier's partial (lock-held:
        _edge_lock); encoded partials decode through the uplink codec."""
        blob = msg.get(Message.MSG_ARG_KEY_ENCODED_UPDATE)
        if blob is None:
            return np.ascontiguousarray(
                np.asarray(msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS))
            ).view(np.float64)
        from fedml_tpu_torch.compress.aggregate import decode_partial

        codec = self._async.uplink_codec
        if codec is None:
            raise ValueError(
                f"edge tier (leaf_base={self.leaf_base}) received an encoded "
                "partial but no tier uplink codec is configured"
            )
        enc = unpack_encoded_update(
            np.asarray(blob), msg.get(Message.MSG_ARG_KEY_ENCODED_DESC))
        return decode_partial(
            enc, wsum, self._g64 if codec.delta_domain else None, codec)

    def _async_maybe_emit_locked(self) -> Message | None:  # lock-held: _edge_lock
        if self._pending <= 0:
            return None
        if self._drained or len(self._completed) >= self.child_num:
            # the window is (or was already declared) complete: this
            # emission closes the tier's round contribution — late async
            # stragglers after it ship as singleton complete emissions,
            # which the parent folds but does not re-count at its barrier
            out = self._build_async_partial_locked(complete=True)
            self._drained = True
            if self._tier_timer is not None:
                self._tier_timer.cancel()
                self._tier_timer = None
            return out
        if self._pending >= self._buffer_goal:
            out = self._build_async_partial_locked(complete=False)
            self._arm_tier_timer_locked()  # stragglers keep elastic cover
            return out
        self._arm_tier_timer_locked()
        return None

    def _arm_tier_timer_locked(self) -> None:  # lock-held: _edge_lock
        if (self._async.tier_timeout is None or self._drained
                or self._tier_timer is not None):
            return
        # timer fires on its own thread: inherit this tier's job/lane
        # binding so its flush spans land in the tier's tracer
        t = threading.Timer(self._async.tier_timeout,
                            jobscope.wrap_target(self._tier_timed_out),
                            args=(self._round,))
        t.daemon = True
        t.start()
        self._tier_timer = t

    def _tier_timed_out(self, expected_round: int) -> None:
        self.flush_window(expected_round)

    def flush_window(self, expected_round: int | None = None) -> None:
        """Elastic per-tier timeout: a tier whose children stall emits what
        it HAS — complete, so the parent's barrier closes over this subtree
        — instead of holding the window until the parent's round advance
        discards it (the old discard-and-warn path). Late mass still folds:
        post-flush arrivals ship as singleton complete emissions, and
        next-round stale legs fold down-weighted when a staleness family is
        armed. Callable directly (harnesses) or from the tier timer."""
        if self._async is None:
            return
        with self._edge_lock:
            if expected_round is not None and self._round != expected_round:
                return
            self._tier_timer = None
            if self._drained:
                return
            missing = sorted(set(range(1, self.child_num + 1))
                             - self._completed)
            if self._pending > 0:
                out = self._build_async_partial_locked(complete=True)
            elif self._window_seq > 0 and self._model_size is not None:
                # everything already forwarded mid-window: ship a zero
                # partial purely to carry the window-complete flag (weight
                # 0 folds as nothing at the parent)
                out = self._frame_async_partial_locked(
                    np.zeros(self._model_size, np.float64), 0.0,
                    complete=True)
            else:
                # nothing ever arrived: no mass to declare — the parent's
                # own round timeout is the backstop, exactly as for a dead
                # flat client
                return
            self._drained = True
            self.elastic_emissions += 1
            logging.warning(
                "edge tier (leaf_base=%d): elastic tier timeout — emitting "
                "the round-%d window early; children %s never completed",
                self.leaf_base, self._round, missing,
            )
        self._send_up(out)

    def _apply_dp_noise_locked(self, acc: np.ndarray, wsum: float) -> None:
        """Weak-DP noise on the OUTGOING partial (lock-held: _edge_lock) —
        once per emission at the leaf tier only, so a multi-tier hierarchy
        noises each leaf window exactly once. Scaled by the window's weight
        sum: the divide-at-close then leaves sigma on the mean, matching
        the flat robust server's post-mean noise scale."""
        cfg = self._async.defense
        # the JAX key's integers seed the port's own draw (ROADMAP §C)
        noise = rnglib.RoundNoise(cfg.dp_seed + self.leaf_base * 1_000_003,
                                  self._dp_counter, "cpu")
        self._dp_counter += 1
        noise = noise.normal((acc.size,), torch.float32).numpy().astype(np.float64)
        acc += noise * (float(cfg.dp_stddev) * float(wsum))

    def _build_async_partial_locked(self, complete: bool) -> Message:
        # lock-held: _edge_lock
        acc, wsum = self.aggregator.export_partial()
        if (self._async.defense is not None
                and self._async.defense.dp_stddev > 0
                and self.children_are_leaves):
            self._apply_dp_noise_locked(acc, wsum)
        return self._frame_async_partial_locked(acc, wsum, complete)

    # lock-held: _edge_lock
    def _frame_async_partial_locked(self, acc: np.ndarray, wsum: float,
                                    complete: bool) -> Message:
        """Frame one emission. With an uplink codec
        the partial ships as an EncodedUpdate (delta-domain codecs frame
        against the round global — the encoded uplink's delta framing applied to the
        accumulator); otherwise the raw f64 tally. Every emission carries
        (round, seq) so parents replay-guard legs, and the window-complete
        flag so only the closing emission counts at the parent's barrier."""
        folds = self._window_folds
        self.total_folds += folds
        self._window_folds = 0
        self._pending = 0
        seq = self._window_seq
        self._window_seq += 1
        with trace.span("tree/forward", round=self._round, folds=folds,
                        bytes=int(acc.nbytes), seq=seq):
            out = Message(TreeMessage.MSG_TYPE_T2S_SEND_PARTIAL,
                          self.up_rank, 0)
            codec = self._async.uplink_codec
            if codec is None:
                out.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS,
                               acc.view(np.uint8))
                self.uplink_bytes += int(acc.nbytes)
            else:
                from fedml_tpu_torch.compress.aggregate import encode_partial

                enc = encode_partial(
                    acc, wsum, self._g64 if codec.delta_domain else None,
                    codec, self.partial_noise(self._round, seq))
                blob, edesc = pack_encoded_update(enc)
                out.add_params(Message.MSG_ARG_KEY_ENCODED_UPDATE, blob)
                out.add_params(Message.MSG_ARG_KEY_ENCODED_DESC, edesc)
                self.uplink_bytes += int(blob.nbytes) + len(edesc)
            self.uplink_dense_bytes += int(acc.nbytes)
            out.add_params(TreeMessage.MSG_ARG_KEY_WEIGHT_SUM, float(wsum))
            out.add_params(TreeMessage.MSG_ARG_KEY_FOLD_COUNT, int(folds))
            out.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self._round)
            out.add_params(TreeMessage.MSG_ARG_KEY_PARTIAL_SEQ, int(seq))
            out.add_params(TreeMessage.MSG_ARG_KEY_WINDOW_COMPLETE,
                           int(bool(complete)))
            if self._model_version is not None:
                out.add_params(Message.MSG_ARG_KEY_MODEL_VERSION,
                               self._model_version)
            if self.fleet_telemetry:
                tel: dict = {"sent_at": time.time(),
                             "retries": self.comm_retries,
                             "counts": {
                                 "folds_total": self.total_folds,
                                 "stale_uploads": self.stale_uploads,
                                 "dup_uploads": self.duplicate_uploads,
                                 "discarded_folds": self.discarded_folds,
                                 "stale_syncs": self.stale_syncs,
                                 "stale_folds": self.stale_folds,
                                 "rejected_uploads": self.rejected_uploads,
                                 "clipped_uploads": self.clipped_uploads,
                                 "elastic_emissions": self.elastic_emissions,
                                 "heartbeats_seen": self.heartbeats_seen,
                                 "uplink_bytes": self.uplink_bytes,
                                 "uplink_dense_bytes":
                                     self.uplink_dense_bytes,
                             }}
                if self._window_t0 is not None:
                    tel["step_ms"] = round(
                        (time.perf_counter() - self._window_t0) * 1e3, 3)
                self._window_t0 = None
                out.add_params(Message.MSG_ARG_KEY_TELEMETRY, tel)
            return out

    def partial_noise(self, round_idx: int, seq: int):
        """The tier quantizer's uniforms for emission ``seq`` of
        ``round_idx``: a :class:`TierNoise` seeded with the JAX key's
        integers, ``fold_in(fold_in(key(0x7EE4 ^ leaf_base), round), seq)``
        (ROADMAP §C). Tests inject the JAX draws here."""
        return TierNoise(0x7EE4 ^ self.leaf_base, round_idx, seq)

    def tier_counters(self) -> dict:
        """Snapshot of this tier's counters (tier_stats reporting)."""
        with self._edge_lock:
            return {
                "leaf_base": self.leaf_base,
                "child_num": self.child_num,
                "folds_total": self.total_folds,
                "stale_uploads": self.stale_uploads,
                "duplicate_uploads": self.duplicate_uploads,
                "discarded_folds": self.discarded_folds,
                "stale_syncs": self.stale_syncs,
                "stale_folds": self.stale_folds,
                "rejected_uploads": self.rejected_uploads,
                "clipped_uploads": self.clipped_uploads,
                "elastic_emissions": self.elastic_emissions,
                "heartbeats_seen": self.heartbeats_seen,
                "emissions": self._window_seq,
                "uplink_bytes": self.uplink_bytes,
                "uplink_dense_bytes": self.uplink_dense_bytes,
            }

    def aggregation_state_bytes(self) -> int:
        """Resident aggregation state: the accumulator plus stashed round
        globals — O(model), independent of fan-in or upload count (the
        10^6-soak memory assertion reads this per tier)."""
        total = self.aggregator.state_bytes()
        with self._edge_lock:
            for g in (self._g32, self._g64):
                if g is not None:
                    total += g.nbytes
            return total


class TreeFedAvgServerManager(FedAvgServerManager):
    """Tree root: the ordinary round protocol, but its direct workers are
    edge tiers uploading partials — fold is a straight f64 add, close is
    the inherited divide. Cohort assignment is delegated to the leaf tiers
    (``_round_cohort`` is None: edges derive the same schedule locally).

    ``tier_uplink_codec`` decodes ENCODED tier partials (the same codec
    object the edges encode with). Barrier-free tiers emit SEVERAL partials
    per round: each carries (round, seq) — replay-guarded per tier — and a
    window-complete flag; only complete emissions count toward the round
    barrier (mid-window emissions fold mass without closing the tier's
    slot). Legacy single-partial tiers carry neither key and keep the
    first-wins discipline untouched."""

    def __init__(self, *args, tier_uplink_codec=None, **kwargs):
        # hoisted above super: the base __init__ finishes construction
        # (fedlint overwrite-after-super — nothing may be assigned after it
        # that a factory could have read)
        self.tier_uplink_codec = tier_uplink_codec
        self._tier_windows: dict[int, tuple[int, int]] = {}  # guarded-by: _round_lock
        super().__init__(*args, **kwargs)

    def _round_cohort(self):
        return None

    def register_message_receive_handlers(self) -> None:
        super().register_message_receive_handlers()
        self.register_message_receive_handler(
            TreeMessage.MSG_TYPE_T2S_SEND_PARTIAL, self._on_partial_from_tier)

    def _make_aggregator(self):
        # the base __init__'s single construction call (fedlint:
        # overwrite-after-super)
        if self.buffered_aggregation:
            raise ValueError(
                "the tree root folds tier partials — there is no buffered "
                "A/B arm (the flat server keeps the oracle)"
            )
        return TierAggregator(self.worker_num)

    def _decode_tier_partial(self, msg: Message,
                             wsum: float) -> np.ndarray:  # lock-held: _round_lock
        """Recover a tier's f64 accumulator from its uplink frame — raw
        payloads pass through, encoded ones decode via the tier uplink
        codec (delta-domain codecs reconstruct against the CURRENT round
        global, which sender and receiver hold in lockstep)."""
        blob = msg.get(Message.MSG_ARG_KEY_ENCODED_UPDATE)
        if blob is None:
            return np.asarray(msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS))
        if self.tier_uplink_codec is None:
            raise ValueError(
                "root received an encoded tier partial but no "
                "tier_uplink_codec is configured"
            )
        from fedml_tpu_torch.compress.aggregate import decode_partial

        enc = unpack_encoded_update(
            np.asarray(blob), msg.get(Message.MSG_ARG_KEY_ENCODED_DESC))
        base64 = None
        if self.tier_uplink_codec.delta_domain:
            base64 = np.ascontiguousarray(self.global_flat).view(
                np.float32).astype(np.float64)
        return decode_partial(enc, wsum, base64, self.tier_uplink_codec)

    def _on_partial_from_tier(self, msg: Message) -> None:
        from fedml_tpu_torch.comm.status import ClientStatus

        sender = msg.get_sender_id()
        wsum = float(msg.get(TreeMessage.MSG_ARG_KEY_WEIGHT_SUM))
        folds = msg.get(TreeMessage.MSG_ARG_KEY_FOLD_COUNT)
        upload_round = msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
        seq = msg.get(TreeMessage.MSG_ARG_KEY_PARTIAL_SEQ)
        complete = msg.get(TreeMessage.MSG_ARG_KEY_WINDOW_COMPLETE)
        tel = msg.get(Message.MSG_ARG_KEY_TELEMETRY)
        with self._round_lock:
            current = self.round_idx
            if seq is not None:
                # barrier-free tier: replay-guard the emission stream by
                # (round, seq) — a duplicated mid-window leg would otherwise
                # double-fold mass the first-wins flags cannot see
                wkey = (int(upload_round) if upload_round is not None else 0,
                        int(seq))
                last = self._tier_windows.get(sender)
                if last is not None and wkey <= last:
                    logging.info(
                        "absorbed replayed partial from tier %d (round=%d "
                        "seq=%d, last=%s)", sender, wkey[0], wkey[1], last,
                    )
                    return
                self._tier_windows[sender] = wkey
            # downlink delta plane: the tier's echoed version is the delta
            # base for its whole subtree (noted for stale partials too)
            self._note_version_echo(sender, msg)
            if not self.aggregator.is_live(sender - 1):
                if self.readmission:
                    # an excluded tier resurfaced WITH a partial: provably
                    # alive — queue readmission at the next round boundary,
                    # exactly like the flat server's excluded-upload branch
                    # (edges send no heartbeats, so the partial IS the
                    # contact signal; on readmit the next sync advances the
                    # tier's round and it discards its stale window)
                    self.status.update(sender, ClientStatus.ONLINE)
                    self._miss_counts.pop(sender - 1, None)
                    if sender - 1 not in self._pending_readmit:
                        logging.info(
                            "excluded tier %d reappeared (partial for round "
                            "%s); queueing readmission", sender, upload_round,
                        )
                    self._pending_readmit.add(sender - 1)
                else:
                    logging.info("ignoring partial from excluded tier %d",
                                 sender)
                return
            if upload_round is not None and int(upload_round) != current:
                self.stale_uploads += 1
                if self.fleet is not None:
                    self.fleet.counter(sender, "stale_uploads")
                    self.fleet.observe(sender, "staleness",
                                       current - int(upload_round))
                    self.fleet.merge_report(sender, tel)
                logging.info(
                    "discarding stale partial from tier %d (upload_round=%s, "
                    "current=%d; Comm/StaleUploads=%d this run)",
                    sender, upload_round, current, self.stale_uploads,
                )
                return
            self.status.update(sender, ClientStatus.ONLINE)
            part = self._decode_tier_partial(msg, wsum)
            with trace.span("tree/fold", kind="partial", sender=sender,
                            round=current,
                            child_folds=int(folds) if folds is not None
                            else -1):
                if (seq is not None
                        and self.aggregator.slot_complete(sender - 1)):
                    # post-complete straggler mass from a barrier-free tier
                    # (its elastic flush already closed the slot): fold it,
                    # barrier unchanged — the seq guard above already
                    # filtered replays, so this is genuinely new mass
                    self.aggregator.fold_partial_weighted(part, wsum)
                    all_received = False
                else:
                    # a missing flag is a legacy single-partial tier:
                    # complete by construction
                    all_received = self.aggregator.add_partial_result(
                        sender - 1, part, wsum,
                        complete=(complete is None or bool(int(complete))),
                    )
            if self.fleet is not None:
                # per-TIER health record: each partial is one upload; the
                # fold count is the number of client updates this tier's
                # super-update represents (the edge's cumulative counters
                # arrive as gauges through the piggybacked report)
                self.fleet.counter(sender, "uploads")
                if folds is not None:
                    self.fleet.observe(sender, "folds", int(folds))
                self.fleet.merge_report(sender, tel)
            self._miss_counts.pop(sender - 1, None)
            if not all_received and self.round_timeout is not None:
                if self._round_timer is None:
                    self._round_timer = threading.Timer(
                        self.round_timeout,
                        # inherit the root's job/lane binding (same
                        # discipline as the flat server's round timer)
                        jobscope.wrap_target(self._round_timed_out),
                        args=(current,),
                    )
                    self._round_timer.daemon = True
                    self._round_timer.start()
        if all_received:
            self._complete_round(current)


# ---------------------------------------------------------------------------
# Run harness: build the comm-fabric tree and drive the protocol
# ---------------------------------------------------------------------------


def _loopback_group_comm(path: tuple, world_size: int) -> Callable[[int], object]:
    from fedml_tpu_torch.comm.loopback import LoopbackCommManager, LoopbackFabric

    fabric = LoopbackFabric(world_size)
    return lambda r: LoopbackCommManager(fabric, r)


class ShmGroupComm:
    """``make_group_comm`` over the native shared-memory rings: one ring
    namespace per tree cell (``/<prefix>-<path>_r<rank>``), so every
    parent/children cell is an independent shm fabric. The default prefix
    is a fresh random name, as the flat shm runner's job names are: a pid
    can repeat across processes that share ``/dev/shm`` but not a pid
    namespace, and a ring's stale-segment recovery would then take over the
    other run's live segment. Call ``cleanup()`` after the run — rings are
    kernel objects, not process memory."""

    def __init__(self, prefix: str | None = None, capacity: int = 64 << 20):
        import uuid

        self.prefix = prefix or f"tree_{uuid.uuid4().hex[:8]}"
        self.capacity = int(capacity)
        self._comms: list = []

    def __call__(self, path: tuple, world_size: int) -> Callable[[int], object]:
        from fedml_tpu_torch.comm.shm import ShmCommManager

        job = (f"{self.prefix}-root" if not path
               else f"{self.prefix}-" + "-".join(str(i) for i in path))

        def make(rank: int, job=job, ws=world_size):
            c = ShmCommManager(job, rank, ws, capacity=self.capacity)
            self._comms.append(c)
            return c

        return make

    def cleanup(self) -> None:
        for c in self._comms:
            try:
                c.cleanup()
            except Exception:  # noqa: BLE001 — best-effort unlink
                pass
        self._comms.clear()


class GrpcGroupComm:
    """``make_group_comm`` over gRPC: each cell gets a contiguous block of
    localhost ports starting at ``base_port``. Raises at construction time
    when grpcio is absent (the backend itself enforces it per manager)."""

    def __init__(self, base_port: int, host: str = "127.0.0.1",
                 send_timeout: float = 600.0, send_workers: int = 4):
        self.host = host
        self.send_timeout = float(send_timeout)
        self.send_workers = int(send_workers)
        self._next_port = int(base_port)

    def __call__(self, path: tuple, world_size: int) -> Callable[[int], object]:
        from fedml_tpu_torch.comm.grpc_backend import GRPCCommManager

        ports = list(range(self._next_port, self._next_port + world_size))
        self._next_port += world_size
        ip_config = {r: (self.host, ports[r]) for r in range(world_size)}
        return lambda r: GRPCCommManager(
            r, ip_config, send_timeout=self.send_timeout,
            send_workers=self.send_workers)


def run_tree_fedavg(
    trainer,
    train_data,
    topology: TreeTopology | tuple,
    round_num: int,
    batch_size: int,
    seed: int = 0,
    on_round_done=None,
    init_overrides=None,
    make_group_comm: Callable[[tuple, int], Callable[[int], object]] | None = None,
    server_kwargs: dict | None = None,
    join_timeout: float = 30.0,
    fleet_stats: dict | None = None,
    downlink_codec=None,
    downlink_keyframe_every: int = 8,
    downlink_retention: int = 4,
    comm_stats: dict | None = None,
    buffer_goal: int | None = None,
    tier_staleness: str | None = None,
    tier_timeout: float | None = None,
    tier_uplink_codec=None,
    tier_defense=None,
    client_codec=None,
    client_error_feedback: bool = True,
    retry_policy=None,
    heartbeat_interval: float | None = None,
    population=None,
    fault_seed: int = 0,
    tier_stats: dict | None = None,
    trace_lanes: str | None = None,
    trace_wire: bool = False,
    tier_fold_workers: int = 0,
    tier_fold_chunk: int | None = None,
):
    """End-to-end hierarchical FedAvg: root -> edge tiers -> leaf clients,
    one comm group (fabric) per parent/children cell. ``make_group_comm
    (group_path, world_size)`` returns that cell's ``rank -> comm`` factory
    — the loopback default builds one in-process fabric per cell; any
    backend with the BaseCommunicationManager contract slots in (the cells
    are independent, so tiers can even mix transports). ``group_path`` is
    ``()`` for the root cell and the tuple of child indices below it.
    ``fleet_stats`` (a caller dict) switches on fleet telemetry keyed by
    TIER rank at the root — per-tier fold/discard counts, window fill
    times, upload latency (docs/OBSERVABILITY.md "Fleet telemetry") — with
    the same ``rounds``/``totals``/``registry`` shape as the flat runner.
    ``downlink_codec`` arms the downlink delta plane (compress/downlink.py):
    the ROOT encodes each round's global once and serves every tier a
    delta against its echoed version; edge tiers re-serve the chain blob
    verbatim to their subtree (encode-once per tier, never decoded
    mid-tree), and leaf clients reconstruct bitwise. ``comm_stats``
    receives the root accountant's per-round/total Comm/* byte records.

    The barrier-free tier knobs (``buffer_goal`` / ``tier_staleness`` /
    ``tier_timeout`` / ``tier_uplink_codec`` / ``tier_defense`` /
    ``client_codec`` — any one set arms ALL edge tiers with one shared
    :class:`EdgeAsyncConfig`), the uplink hardening knobs (``retry_policy``
    on every tier-to-parent send, ``heartbeat_interval`` > 0 beats each
    edge up its own fabric), and ``population`` (a spec string or
    :class:`~fedml_tpu_torch.population.wire.PopulationWireAdapter`; leaf
    transports wrap in the seeded fault machinery by GLOBAL leaf rank, so
    one churn trace drives the whole hierarchy) compose with everything
    above. ``tier_stats`` (a caller dict) receives per-edge counter dicts
    plus Comm/TierUplink* byte totals. ``trace_lanes`` (a directory path)
    installs one per-node tracer (lanes ``root`` / ``edge{i}`` (creation
    order) / ``leaf{r}`` (GLOBAL leaf rank)), exports each node's causal
    trace as ``trace_<lane>.jsonl``, and arms ``trace_wire`` on every cell
    comm so contexts propagate across the tiers; ``trace_wire`` alone
    stamps contexts without installing tracers.
    ``tier_fold_workers`` > 0 attaches a sharded fold plane
    (:mod:`fedml_tpu_torch.algorithms.fold_plane`) to EVERY edge tier's tally —
    chunk-parallel, bit-identical folding off the tier receive threads —
    with ``tier_fold_chunk`` elements per chunk; the ROOT takes the same
    knobs through ``server_kwargs`` (``fold_workers`` / ``fold_chunk``).
    Returns the final global variables (the flat server's return shape)."""
    topo = topology if isinstance(topology, TreeTopology) else TreeTopology(tuple(topology))
    if isinstance(tier_uplink_codec, str):
        from fedml_tpu_torch.compress.codec import make_codec

        tier_uplink_codec = make_codec(tier_uplink_codec)
    if isinstance(client_codec, str):
        from fedml_tpu_torch.compress.codec import make_codec

        client_codec = make_codec(client_codec)
    async_cfg = None
    if any(v is not None for v in (buffer_goal, tier_staleness, tier_timeout,
                                   tier_uplink_codec, tier_defense,
                                   client_codec)):
        if tier_defense is not None and (
                tier_defense.rule != "mean" or tier_defense.reservoir_k):
            raise ValueError(
                "edge tiers defend with the streaming mean rule only (clip "
                f"+ weak DP); got rule={tier_defense.rule!r}, reservoir_k="
                f"{tier_defense.reservoir_k} — rank-based rules need the "
                "per-client stack the root never sees"
            )
        async_cfg = EdgeAsyncConfig(
            buffer_goal=buffer_goal, staleness_weight=tier_staleness,
            tier_timeout=tier_timeout, uplink_codec=tier_uplink_codec,
            defense=tier_defense, client_codec=client_codec,
        )
        if downlink_codec is not None and async_cfg.needs_base:
            raise ValueError(
                "downlink delta coding serves tiers an encoded chain they "
                "never decode, but this tier discipline needs the dense "
                "round global (defense clip base / delta-domain codec) — "
                "drop downlink_codec or the delta-dependent tier knobs"
            )
    if downlink_codec is not None:
        from fedml_tpu_torch.compress.downlink import resolve_downlink_codec

        downlink_codec = resolve_downlink_codec(downlink_codec)
    if downlink_codec is not None:
        server_kwargs = {**(server_kwargs or {}),
                         "downlink_codec": downlink_codec,
                         "downlink_keyframe_every": downlink_keyframe_every,
                         "downlink_retention": downlink_retention}
    make_group = make_group_comm or _loopback_group_comm
    fan = topo.fan_ins
    leaf_total = topo.leaf_count
    if leaf_total > train_data.num_clients:
        raise ValueError(
            f"tree topology {fan} has {leaf_total} leaves but the population "
            f"only has {train_data.num_clients} clients"
        )
    if population is not None:
        if not hasattr(population, "spec_for"):
            from fedml_tpu_torch.population.wire import population_fault_specs

            population = population_fault_specs(population, leaf_total,
                                                seed=fault_seed)
        if not population.active:
            population = None  # identity spec: leave transports unwrapped
        elif (population.drops_uploads and tier_timeout is None
                and not (server_kwargs or {}).get("round_timeout")):
            raise ValueError(
                "this population drops uploads: a sync tree would wedge on "
                "the first lost leaf — set tier_timeout (elastic tiers) or "
                "a server round_timeout"
            )
    if tier_uplink_codec is not None:
        server_kwargs = {**(server_kwargs or {}),
                         "tier_uplink_codec": tier_uplink_codec}
    template, flat, desc = init_template(trainer, train_data.arrays,
                                         batch_size, seed,
                                         init_overrides=init_overrides)
    results: dict[str, np.ndarray] = {}

    fleet = None
    if fleet_stats is not None:
        from fedml_tpu_torch.obs.registry import FleetHealth

        fleet = FleetHealth()
        server_kwargs = {"fleet": fleet, **(server_kwargs or {})}

    def _done(r, f):
        results["final"] = f
        if comm_stats is not None and server.accountant is not None:
            comm_stats.setdefault("rounds", []).append(
                server.accountant.round_record(r)
            )
        if fleet_stats is not None:
            rec = server._fleet_round_record(r)
            if rec is not None:
                fleet_stats.setdefault("rounds", []).append(rec)
        if on_round_done is not None:
            on_round_done(r, unpack_state(f, desc))

    root_make = make_group((), fan[0] + 1)
    server = TreeFedAvgServerManager(
        root_make(0), fan[0], round_num, flat, desc,
        client_num_in_total=train_data.num_clients,
        on_round_done=_done, **(server_kwargs or {}),
    )
    managers: list = []

    def build(path: tuple, up_make, up_rank: int, level: int,
              leaf_base: int) -> int:
        """Create the edge at ``path`` and its subtree; returns its leaf
        count so sibling subtrees stack contiguously in the global leaf
        numbering."""
        child_num = fan[level]
        down_make = make_group(path, child_num + 1)
        leaves_here = 0
        is_leaf_tier = level == len(fan) - 1
        edge = EdgeAggregatorManager(
            up_comm=up_make(up_rank), up_rank=up_rank, down_comm=down_make(0),
            child_num=child_num, leaf_base=leaf_base, leaf_total=leaf_total,
            client_num_in_total=train_data.num_clients,
            children_are_leaves=is_leaf_tier,
            async_config=async_cfg, model_desc=desc,
            fold_workers=tier_fold_workers, fold_chunk=tier_fold_chunk,
        )
        if retry_policy is not None:
            # same attachment point as the flat runner: the retry policy
            # lives on the comm object, DistributedManager.send_message
            # discovers it — here on every tier-to-parent uplink
            edge.up_comm.retry_policy = retry_policy
        managers.append(edge)
        if is_leaf_tier:
            for r in range(1, child_num + 1):
                leaf_rank = leaf_base + r  # global leaf identity
                c_comm = down_make(r)
                if population is not None:
                    fs = population.spec_for(leaf_rank)
                    if fs is not None:
                        from fedml_tpu_torch.comm.faults import FaultyCommManager

                        c_comm = FaultyCommManager(
                            c_comm, fs, rank=leaf_rank, seed=fault_seed)
                if client_codec is not None:
                    c = CompressedFedAvgClientManager(
                        c_comm, r, child_num + 1, trainer, train_data,
                        batch_size, template, codec=client_codec,
                        error_feedback=client_error_feedback,
                    )
                else:
                    c = FedAvgClientManager(
                        c_comm, r, child_num + 1, trainer, train_data,
                        batch_size, template,
                    )
                # global leaf identity for the local-train rng chain: leaves
                # in different cells share fabric-local ranks, but their key
                # chains must not collide (and the 1-tier tree must chain
                # exactly like the flat server's rank w)
                c.rng_rank = leaf_rank
                managers.append(c)
            leaves_here = child_num
        else:
            for i in range(child_num):
                leaves_here += build(path + (i,), down_make, i + 1,
                                     level + 1, leaf_base + leaves_here)
        return leaves_here

    leaf_base = 0
    for i in range(fan[0]):
        leaf_base += build((i,), root_make, i + 1, 1, leaf_base)

    if fleet_stats is not None:
        # the reporting units are the TIERS (the root's fleet view is keyed
        # by tier rank and only reads telemetry off partials); opting leaf
        # clients in would spend timing + wire bytes on reports no edge
        # handler consumes
        for m in managers:
            if isinstance(m, EdgeAggregatorManager):
                m.fleet_telemetry = True
    if downlink_codec is not None:
        # every leaf decodes with the codec object the root encodes with
        # (edges pass the chain through untouched)
        for m in managers:
            if isinstance(m, FedAvgClientManager):
                m.downlink_codec = downlink_codec
    heartbeats: list = []
    if heartbeat_interval is not None and heartbeat_interval > 0:
        from fedml_tpu_torch.comm.status import HeartbeatSender

        # each edge beats UP its own fabric: the root's liveness plane sees
        # its direct tiers, every interior tier counts child contact
        heartbeats = [
            HeartbeatSender(m.up_comm, m.up_rank, heartbeat_interval)
            for m in managers if isinstance(m, EdgeAggregatorManager)
        ]
    # cross-rank causal tracing: one lane (one tracer, one JSONL) per tree
    # node; edge lanes number in creation (depth-first) order, leaf lanes
    # carry the GLOBAL leaf rank
    lane_of: dict[int, str] = {}
    if trace_lanes is not None:
        trace_wire = True
        edge_i = 0
        for m in managers:
            if isinstance(m, EdgeAggregatorManager):
                lane_of[id(m)] = f"edge{edge_i}"
                edge_i += 1
            else:
                lane_of[id(m)] = f"leaf{m.rng_rank}"
    if trace_wire:
        # every cell comm stamps outgoing headers
        server.comm.trace_wire = True
        for m in managers:
            m.comm.trace_wire = True
            if isinstance(m, EdgeAggregatorManager):
                m.up_comm.trace_wire = True
    lanes = None
    if trace_lanes is not None:
        lanes = trace.lane_traces(trace_lanes, ["root"] + [lane_of[id(m)] for m in managers])
        lanes.__enter__()
    threads = [threading.Thread(target=jobscope.wrap_target(m.run, job=lane_of.get(id(m))),
                                daemon=True) for m in managers]
    try:
        for t in threads:
            t.start()
        for hb in heartbeats:
            hb.start()
        server.register_message_receive_handlers()
        _installed_registry = None
        if fleet_stats is not None and registry.get() is None:
            _installed_registry = registry.install()
        try:
            with jobscope.bound("root" if trace_lanes is not None else None):
                server.send_init_msg()
                try:
                    server.comm.handle_receive_message()
                except BaseException:
                    for m in managers:
                        try:
                            m.finish()
                        except Exception:  # noqa: BLE001 — best-effort unblock
                            pass
                    raise
        finally:
            for hb in heartbeats:
                hb.stop()
            if fleet_stats is not None:
                if fleet is not None:
                    fleet_stats["totals"] = fleet.snapshot()
                reg = registry.get()
                if reg is not None:
                    fleet_stats["registry"] = reg.snapshot()
                if _installed_registry is not None \
                        and registry.get() is _installed_registry:
                    registry.uninstall()
        for t in threads:
            t.join(timeout=join_timeout)
    finally:
        if lanes is not None:
            lanes.__exit__(None, None, None)
    if comm_stats is not None and server.accountant is not None:
        comm_stats["totals"] = server.accountant.totals()
    if tier_stats is not None or comm_stats is not None:
        tiers = [m.tier_counters() for m in managers
                 if isinstance(m, EdgeAggregatorManager)]
        up_bytes = sum(t["uplink_bytes"] for t in tiers)
        up_dense = sum(t["uplink_dense_bytes"] for t in tiers)
        if tier_stats is not None:
            tier_stats["tiers"] = tiers
            tier_stats["totals"] = {
                metricslib.COMM_TIER_UPLINK_BYTES: up_bytes,
                metricslib.COMM_TIER_UPLINK_DENSE_BYTES: up_dense,
            }
        if comm_stats is not None and "totals" in comm_stats:
            comm_stats["totals"][metricslib.COMM_TIER_UPLINK_BYTES] = up_bytes
            comm_stats["totals"][
                metricslib.COMM_TIER_UPLINK_DENSE_BYTES] = up_dense
    return unpack_state(results["final"], desc)


def run_tree_fedavg_loopback(trainer, train_data, topology, round_num,
                             batch_size, **kwargs):
    """Hierarchical FedAvg with every tier cell on an in-process loopback
    fabric — the test/bench entry point."""
    return run_tree_fedavg(trainer, train_data, topology, round_num,
                           batch_size, **kwargs)


def run_tree_fedavg_shm(trainer, train_data, topology, round_num, batch_size,
                        shm_prefix: str | None = None,
                        shm_capacity: int = 64 << 20, **kwargs):
    """Hierarchical FedAvg with every tier cell on its own shared-memory
    ring fabric — the multi-process-shaped transport, rings unlinked on the
    way out whatever the run did."""
    group = ShmGroupComm(prefix=shm_prefix, capacity=shm_capacity)
    try:
        return run_tree_fedavg(trainer, train_data, topology, round_num,
                               batch_size, make_group_comm=group, **kwargs)
    finally:
        group.cleanup()
