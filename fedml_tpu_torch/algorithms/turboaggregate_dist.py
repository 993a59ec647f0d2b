"""TurboAggregate as a multi-party protocol over the comm layer, the port of
``fedml_tpu/algorithms/turboaggregate_dist.py``. The field math is
``turboaggregate.py``'s (host int64 numpy, a copy of the JAX package's);
the clients train with the port's ``make_local_train`` on the trainer's
device, and the model crosses the wire in the JAX layout as in
``fedavg_distributed``.

Reference: fedml_api/distributed/turboaggregate/ — TA_Aggregator.py:13 wires
the MPC library (mpc_function.py) into the aggregator/trainer/manager
triple, and TA_decentralized_worker_manager.py exchanges shares between
neighbor workers (message_define.py MSG_TYPE_SEND_MSG_TO_NEIGHBOR=2). The
reference never completes the loop — its aggregate() is plain FedAvg on
plaintext models. Here the secure path actually runs:

1. Server broadcasts the global model (S2C init); clients register their
   clear-text sample counts n_i; the server broadcasts the normalized
   weights p_i = n_i / sum(n) with the round sync. Entering the field with
   p_i * delta_i (|p_i| <= 1) keeps the share-sum bounded by
   scale * max|delta| — no overflow growth with client count or samples.
2. Each client trains locally, quantizes ``p_i * (local - global)``, and
   BGW-shares it: share j goes DIRECTLY to client j (client-to-client typed
   messages; the server never routes or sees a plaintext update).
3. Each client pointwise-sums the W shares it holds (one per peer) — by
   BGW linearity a share of ``sum_i p_i * delta_i`` — and uploads only that
   share-sum.
4. The server Lagrange-reconstructs the weighted-mean delta from
   threshold+1 share-sums and applies it to the global model. Every
   share-sum already contains its inclusion set's updates, so clients that
   die after the share-exchange leg but before uploading cost nothing: with
   ``round_timeout`` set, the server reconstructs the full aggregate from
   whichever >= threshold+1 share-sums arrived.
5. Pre-share dropout recovery (``share_timeout``): a client that dies
   BEFORE sending its peer shares would leave everyone waiting, so clients
   whose share wait times out report (clear metadata only) which peers'
   shares they hold; the server intersects the reports into an agreed
   inclusion set and broadcasts it to EVERY live worker — reporters AND
   clients that already submitted full-set share-sums. Reporters submit
   share-sums over exactly the agreed subset; a full-set holder (which
   necessarily holds every share of any agreed subset) RESUBMITS over the
   agreed subset, superseding its earlier full-set sum, so all live
   workers land in one same-set bucket and t+1 is reachable even when the
   dying client delivered shares to some-but-not-all peers. Share-sums
   carry their inclusion set and the server reconstructs only within the
   largest same-set bucket — sums over different subsets are shares of
   different polynomials and are never mixed — then renormalizes by the
   included weight mass. Two guards bound what recovery can reveal: a
   bucket that can already reconstruct (>= t+1 full-set sums) closes the
   round directly instead of starting subset recovery — otherwise the
   server could interpolate BOTH polynomials and their difference is the
   dead client's individual update — and an inclusion set smaller than
   t+1 (disjoint reports) is refused and the round skipped. This is
   subset consistency, not SecAgg mask recovery: simpler, and sufficient
   because BGW shares (unlike pairwise masks) need no per-dropout
   unmasking.

Privacy: the server sees only the aggregate; a coalition of <= threshold
clients learns nothing about another client's update (Shamir). Exactness:
the aggregate equals FedAvg up to 1/quantize-scale rounding.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg_distributed import (
    init_template,
    run_manager_protocol,
    train_wire_round,
    unpack_state,
    pack_state,
)
from fedml_tpu_torch.algorithms.turboaggregate import (
    DEFAULT_PRIME,
    bgw_decode,
    bgw_encode,
    dequantize,
    quantize,
)
from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.managers import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.core.trainer import ClientTrainer, make_local_train
from fedml_tpu_torch.sim.cohort import FederatedArrays


class TAMessage:
    """Message types (reference message_define.py:6-8, extended with the
    share-exchange legs the reference leaves unimplemented)."""

    MSG_TYPE_S2C_INIT = 1
    MSG_TYPE_S2C_SYNC = 2
    MSG_TYPE_C2S_REGISTER = 3      # clear-text sample count n_i
    MSG_TYPE_C2C_SHARE = 4         # BGW share leg: client -> client
    MSG_TYPE_C2S_SHARE_SUM = 5     # masked aggregate leg: client -> server
    # pre-share dropout recovery (subset consistency, see class docstring)
    MSG_TYPE_C2S_SHARE_REPORT = 6  # clear metadata: which peers' shares arrived
    MSG_TYPE_S2C_INCLUDE = 7       # server-agreed inclusion set

    KEY_MODEL = Message.MSG_ARG_KEY_MODEL_PARAMS
    KEY_DESC = Message.MSG_ARG_KEY_MODEL_DESC
    KEY_NUM_SAMPLES = Message.MSG_ARG_KEY_NUM_SAMPLES
    KEY_SHARE = "bgw_share"
    KEY_ROUND = Message.MSG_ARG_KEY_ROUND_IDX
    KEY_WEIGHT = "p_i"  # this client's normalized aggregation weight
    KEY_HOLDERS = "holders"        # share report: ranks whose shares I hold
    KEY_INCLUDE = "include_set"    # ranks whose updates a share-sum includes


def _check_threshold(threshold: int, worker_num: int) -> int:
    if not 1 <= threshold < worker_num:
        raise ValueError(
            f"privacy threshold must satisfy 1 <= t < worker_num "
            f"(got t={threshold}, workers={worker_num}): BGW needs t+1 of "
            f"the {worker_num} share points to interpolate a degree-t polynomial"
        )
    return threshold


class TAServerManager(ServerManager):
    """Receives only clear sample counts and share-sums; reconstructs only
    the aggregate."""

    def __init__(self, comm: BaseCommunicationManager, worker_num: int,
                 round_num: int, init_flat: np.ndarray, model_desc: str,
                 threshold: int | None = None, scale: float = 2**16,
                 prime: int = DEFAULT_PRIME,
                 round_timeout: float | None = None,
                 on_round_done: Callable[[int, np.ndarray], None] | None = None):
        super().__init__(comm, rank=0, size=worker_num + 1)
        self.worker_num = worker_num
        self.round_num = round_num
        self.round_idx = 0
        self.global_flat = np.asarray(init_flat)
        self.model_desc = model_desc
        self.threshold = _check_threshold(
            threshold if threshold is not None else max(1, (worker_num - 1) // 2),
            worker_num,
        )
        self.scale = scale
        self.prime = prime
        self.round_timeout = round_timeout
        self.on_round_done = on_round_done
        self._sample_nums: dict[int, float] = {}
        # sender -> (include_set_tuple, share_sum): share-sums over different
        # inclusion sets are shares of DIFFERENT polynomials and must never
        # be mixed in one reconstruction
        self._share_sums: dict[int, tuple[tuple[int, ...], np.ndarray]] = {}  # guarded-by: _lock
        self._reports: dict[int, tuple[int, ...]] = {}  # guarded-by: _lock
        self._include_sent = False  # guarded-by: _lock
        self._include_set: list[int] = []  # guarded-by: _lock
        self._timed_out = False  # guarded-by: _lock
        self._timer: threading.Timer | None = None  # guarded-by: _lock
        self._lock = threading.Lock()

    def send_init_msg(self) -> None:
        for w in range(1, self.worker_num + 1):
            msg = Message(TAMessage.MSG_TYPE_S2C_INIT, 0, w)
            msg.add_params(TAMessage.KEY_MODEL, self.global_flat)
            msg.add_params(TAMessage.KEY_DESC, self.model_desc)
            self.send_message(msg)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            TAMessage.MSG_TYPE_C2S_REGISTER, self._on_register
        )
        self.register_message_receive_handler(
            TAMessage.MSG_TYPE_C2S_SHARE_SUM, self._on_share_sum
        )
        self.register_message_receive_handler(
            TAMessage.MSG_TYPE_C2S_SHARE_REPORT, self._on_share_report
        )

    # -- registration: collect n_i, broadcast p_i ---------------------------

    def _on_register(self, msg: Message) -> None:
        with self._lock:
            self._sample_nums[msg.get_sender_id()] = float(
                msg.get(TAMessage.KEY_NUM_SAMPLES)
            )
            if len(self._sample_nums) < self.worker_num:
                return
        self._send_sync(finished=False)

    def _send_sync(self, finished: bool) -> None:
        total = sum(self._sample_nums.values())
        for w in range(1, self.worker_num + 1):
            sync = Message(TAMessage.MSG_TYPE_S2C_SYNC, 0, w)
            sync.add_params(TAMessage.KEY_MODEL, self.global_flat)
            sync.add_params(TAMessage.KEY_ROUND, self.round_idx)
            sync.add_params(TAMessage.KEY_WEIGHT, self._sample_nums[w] / total)
            if finished:
                sync.add_params(Message.MSG_ARG_KEY_FINISHED, 1)
            self.send_message(sync)

    # -- aggregation --------------------------------------------------------

    def _on_share_sum(self, msg: Message) -> None:
        resend_to = None
        with self._lock:
            if int(msg.get(TAMessage.KEY_ROUND)) != self.round_idx:
                return  # late arrival from a timed-out round
            include = msg.get(TAMessage.KEY_INCLUDE)
            include = (
                tuple(int(i) for i in include) if include is not None
                else tuple(range(1, self.worker_num + 1))
            )
            sender = msg.get_sender_id()
            if self._include_sent and include != tuple(self._include_set):
                # a share-sum arriving AFTER the inclusion-set decision with
                # a different set (e.g. a slow full-set holder) never saw the
                # broadcast — resend it so this sender can resubmit into the
                # agreed bucket, otherwise the round can stall with subset
                # sums and full sums that never reach t+1 in any one bucket.
                # The mismatched sum is NOT stored: once subset recovery is
                # active the privacy guard's invariant (full-set submissions
                # <= t while a t+1 subset bucket may form) must hold at
                # every instant, and storing a late full-set sum could
                # transiently give the server t+1 points on BOTH polynomials
                # — whose difference is the dead client's individual update
                resend_to = (sender, self._include_set, self.round_idx)
            else:
                self._share_sums[sender] = (
                    include, np.asarray(msg.get(TAMessage.KEY_SHARE))
                )
            got = len(self._share_sums)
            if (got == 1 and self.round_timeout is not None
                    and self._timer is None and not self._timed_out):
                # every share-sum carries its whole inclusion set's updates;
                # after the timeout any threshold+1 same-set share-sums
                # reconstruct the aggregate. Never re-arm (or reset
                # _timed_out) once a recovery timer already fired — the
                # post-include share-sums must close at t+1 immediately,
                # not after a second full round_timeout
                self._timer = threading.Timer(self.round_timeout, self._timeout)
                self._timer.daemon = True
                self._timer.start()
            closing = got >= self.worker_num or (
                self._timed_out and got >= self.threshold + 1
            )
        if resend_to is not None:
            sender, inc, rnd = resend_to
            self._send_include(inc, [sender], rnd)
        if closing:
            self._close_round()

    def _on_share_report(self, msg: Message) -> None:
        """Pre-share dropout recovery, leg 1: a client whose share wait timed
        out reports (clear metadata only) which peers' shares it holds. Once
        every live worker has either submitted or reported, broadcast the
        intersection as the agreed inclusion set — every reporter holds all
        of it, so all share-sums land in one reconstructable bucket."""
        with self._lock:
            if int(msg.get(TAMessage.KEY_ROUND)) != self.round_idx:
                return
            sender = msg.get_sender_id()
            self._reports[sender] = tuple(
                int(i) for i in msg.get(TAMessage.KEY_HOLDERS)
            )
            # capture the round INSIDE the lock: _close_round can advance
            # round_idx between lock release and the include send, and an
            # include stamped with the wrong round would make next round's
            # full-set holders submit over a stale subset, silently dropping
            # a live client's update
            rnd = self.round_idx
            if self._include_sent:
                # a reporter arriving after the decision still needs the set
                # (a lost reply would strand it mid-round forever); sound as
                # long as it holds every member, which the intersection rule
                # cannot guarantee for late reports — verify and fall back to
                # excluding its share-sum (it simply won't submit)
                action, include, recipients = (
                    "send", self._include_set,
                    [sender] if set(self._include_set)
                    <= set(self._reports[sender]) else [],
                )
            elif self._bucket_max_locked() >= self.threshold + 1:
                # PRIVACY GUARD: a reconstructable bucket already exists, so
                # close on it instead of starting subset recovery. The
                # full-set sums carry the dead client's delivered shares, so
                # nothing is lost — and crucially this keeps subset recovery
                # confined to the regime where full-set submissions <= t:
                # were both a reconstructable full-set bucket AND a t+1
                # subset bucket ever visible, the server could interpolate
                # both polynomials and their difference is the dead client's
                # individual (weighted) update — exactly the leak the
                # protocol exists to prevent.
                action, include, recipients = "close", None, []
            else:
                covered = set(self._reports) | set(self._share_sums)
                # decide as soon as every rank is accounted for, or — with
                # dead clients that will never speak — when the timer has
                # declared the silent ranks dead
                if len(covered) < self.worker_num and not (
                    len(self._reports) >= self.threshold + 1 and self._timed_out
                ):
                    # arm the dead-rank-declaring timer even when the caller
                    # set no round_timeout: a pre-share drop would otherwise
                    # wait forever for the dead rank's report (the exact
                    # stall the share_timeout feature exists to prevent)
                    if self._timer is None and not self._timed_out:
                        grace = (self.round_timeout
                                 if self.round_timeout is not None else 5.0)
                        self._timer = threading.Timer(grace, self._timeout)
                        self._timer.daemon = True
                        self._timer.start()
                    return
                action, include, recipients = self._decide_include_locked()
        self._dispatch_recovery(action, include, recipients, rnd)

    def _dispatch_recovery(self, action: str, include, recipients,
                           rnd: int) -> None:
        """Execute a recovery decision outside the lock."""
        if action == "close":
            self._close_round()
        elif action == "abort":
            self._abort_round(rnd)
        else:
            self._send_include(include, recipients, rnd)

    def _bucket_max_locked(self) -> int:  # lock-held: _lock
        """Size of the largest same-inclusion-set bucket (caller holds the
        lock)."""
        counts: dict[tuple[int, ...], int] = {}
        for include, _ in self._share_sums.values():
            counts[include] = counts.get(include, 0) + 1
        return max(counts.values(), default=0)

    def _decide_include_locked(self):  # lock-held: _lock
        """Intersect the reports into the agreed inclusion set (caller holds
        the lock). Returns an explicit ``(action, include, recipients)``
        triple: ``("send", set, live workers)`` normally, ``("abort", ...)``
        when the set is refused (smaller than t+1)."""
        include = sorted(set.intersection(
            *(set(h) for h in self._reports.values())
        ))
        if len(include) < self.threshold + 1:
            # disjoint reports can intersect to (near-)nothing; an aggregate
            # over < t+1 clients would reveal near-individual updates to the
            # server — and an empty set would np.stack([]) on the client.
            # Refuse and skip the round instead of broadcasting it (workers
            # learn of the skip via the next sync, so no recipients here).
            logging.error(
                "turboaggregate round %d: agreed inclusion set %s smaller "
                "than t+1=%d — refusing; round skipped (global unchanged)",
                self.round_idx, include, self.threshold + 1,
            )
            return "abort", None, []
        # every live worker gets the set: reporters submit over it, and
        # full-set submitters (who hold every share of any subset) RESUBMIT
        # over it so one same-set bucket can reach t+1 even when the dead
        # client's shares reached only some peers. Safe against the
        # full-minus-subset difference attack because this path only runs
        # when no bucket reached t+1 (see the privacy guard above): the
        # at-most-t full-set points expose the dead client's degree-t
        # sharing polynomial at at most t points — information-theoretically
        # nothing about its constant term (the update).
        recipients = sorted(set(self._reports) | set(self._share_sums))
        self._include_sent = True
        self._include_set = include
        logging.info(
            "turboaggregate round %d: share dropout — inclusion set %s "
            "agreed from %d reports; notifying %d live workers",
            self.round_idx, include, len(self._reports), len(recipients),
        )
        return "send", include, recipients

    def _abort_round(self, round_to_abort: int) -> None:
        """Skip round ``round_to_abort`` (unreconstructable inclusion set):
        clear state, advance the round counter, and sync clients on the
        UNCHANGED global model so the protocol continues. Idempotent — the
        timer thread and the receive thread can both reach the refusal
        decision for the same round; only the first abort acts."""
        with self._lock:
            if self.round_idx != round_to_abort:
                return  # already aborted/closed by the racing thread
            self._share_sums.clear()
            self._reports.clear()
            self._include_sent = False
            self._include_set = []
            self._timed_out = False
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            skipped = self.round_idx
            self.round_idx += 1
        # the round completed (as a no-op): report the unchanged global so
        # curve recorders and the run harness see every round
        self._finalize_round(skipped)

    def _finalize_round(self, closed_round: int) -> None:
        """Shared end-of-round tail for close and abort: report the round,
        sync clients on the (possibly updated) global, finish when done."""
        if self.on_round_done:
            self.on_round_done(closed_round, self.global_flat)
        finished = self.round_idx >= self.round_num
        self._send_sync(finished)
        if finished:
            self.finish()

    def _send_include(self, include: list[int], recipients: list[int],
                      round_idx: int) -> None:
        for w in recipients:
            m = Message(TAMessage.MSG_TYPE_S2C_INCLUDE, 0, w)
            m.add_params(TAMessage.KEY_ROUND, round_idx)
            m.add_params(TAMessage.KEY_INCLUDE, np.asarray(include, np.int64))
            self.send_message(m)

    def _timeout(self) -> None:
        # if clients reported a share dropout, the timer's job is to declare
        # the silent ranks dead and broadcast the inclusion set — the
        # incoming (re)submissions then close the round normally. A bucket
        # that can already reconstruct takes precedence over subset recovery
        # (privacy guard, see _on_share_report).
        with self._lock:
            self._timed_out = True
            rnd = self.round_idx
            if (self._reports and not self._include_sent
                    and self._bucket_max_locked() < self.threshold + 1):
                action, include, recipients = self._decide_include_locked()
            else:
                action, include, recipients = "close", None, []
        self._dispatch_recovery(action, include, recipients, rnd)

    def _close_round(self) -> None:
        with self._lock:
            if not self._share_sums:
                # benign double close (timer raced the full tally); a stale
                # timer's _timed_out flag must not leak into the next round
                self._timed_out = False
                return
            # share-sums over different inclusion sets are shares of
            # different polynomials: reconstruct from the largest same-set
            # bucket only
            buckets: dict[tuple[int, ...], list[int]] = {}
            for sender, (include, _) in self._share_sums.items():
                buckets.setdefault(include, []).append(sender)
            include, bucket = max(buckets.items(), key=lambda kv: len(kv[1]))
            if len(bucket) < self.threshold + 1:
                logging.error(
                    "turboaggregate round %d: largest same-set bucket has "
                    "%d/%d share-sums (< t+1=%d) — cannot reconstruct; waiting",
                    self.round_idx, len(bucket), self.worker_num,
                    self.threshold + 1,
                )
                return
            # snapshot AND advance the round inside one critical section:
            # a straggler's share-sum from the closed round must fail the
            # round check the moment we commit to reconstructing (the timer
            # thread and the receive thread race here when round_timeout is
            # set)
            share_sums = {s: self._share_sums[s][1] for s in bucket}
            self._share_sums.clear()
            self._reports.clear()
            self._include_sent = False
            self._include_set = []
            closed_round = self.round_idx
            self.round_idx += 1
            self._timed_out = False
            total = sum(self._sample_nums.values())
            # the bucket's aggregate is sum_{i in include} p_i * delta_i;
            # renormalize by the included weight mass so dropped clients
            # don't shrink the update (clear metadata, no privacy cost)
            w_mass = sum(
                self._sample_nums.get(i, 0.0) / total for i in include
            ) or 1.0
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
        senders = sorted(share_sums)[: self.threshold + 1]
        shares = np.stack([share_sums[s] for s in senders])
        share_idx = np.asarray(senders) - 1  # rank w holds eval point w
        summed = bgw_decode(shares, share_idx, self.prime)
        mean_delta = dequantize(summed, self.scale, self.prime) / w_mass
        new_flat = (
            self.global_flat.view(np.float32).astype(np.float64) + mean_delta
        ).astype(np.float32)
        self.global_flat = new_flat.view(np.uint8)
        self._finalize_round(closed_round)


class TAClientManager(ClientManager):
    """Local training + BGW share exchange with peers."""

    def __init__(self, comm: BaseCommunicationManager, rank: int, size: int,
                 trainer: ClientTrainer, train_data: FederatedArrays,
                 batch_size: int, threshold: int | None = None,
                 scale: float = 2**16, prime: int = DEFAULT_PRIME, seed: int = 0,
                 local_train_fn=None, share_timeout: float | None = None):
        super().__init__(comm, rank, size)
        self.worker_num = size - 1
        self.trainer = trainer
        self.train_data = train_data
        self.batch_size = batch_size
        self.threshold = _check_threshold(
            threshold if threshold is not None else max(1, (self.worker_num - 1) // 2),
            self.worker_num,
        )
        self.scale = scale
        self.prime = prime
        self.seed = seed
        # the local round program (the port's make_local_train unless
        # given), run under fedavg_distributed's TRAIN_LOCK
        self._local_train = local_train_fn or make_local_train(trainer)
        self._desc: str | None = None
        self._lock = threading.Lock()
        # shares can arrive before this client finishes its own training —
        # buffer per round
        self._peer_shares: dict[int, dict[int, np.ndarray]] = {}  # guarded-by: _lock
        # round -> inclusion set submitted (dict, not set: a resubmission is
        # warranted only when the agreed set differs from what went out)
        self._submitted: dict[int, tuple[int, ...]] = {}  # guarded-by: _lock
        self._p_i: float | None = None
        # pre-share dropout recovery: if a peer's share hasn't arrived
        # share_timeout seconds after our own shares went out, report the
        # holders we DO have and wait for the server's inclusion set
        self.share_timeout = share_timeout
        self._share_timers: dict[int, threading.Timer] = {}
        self._include: dict[int, tuple[int, ...]] = {}

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(TAMessage.MSG_TYPE_S2C_INIT, self._on_init)
        self.register_message_receive_handler(TAMessage.MSG_TYPE_S2C_SYNC, self._on_sync)
        self.register_message_receive_handler(TAMessage.MSG_TYPE_C2C_SHARE, self._on_peer_share)
        self.register_message_receive_handler(TAMessage.MSG_TYPE_S2C_INCLUDE, self._on_include)

    # -- round legs ----------------------------------------------------------

    def _client_index(self) -> int:
        return (self.rank - 1) % self.train_data.num_clients

    def _on_init(self, msg: Message) -> None:
        self._desc = msg.get(TAMessage.KEY_DESC)
        n_i = float(len(self.train_data.partition[self._client_index()]))
        out = Message(TAMessage.MSG_TYPE_C2S_REGISTER, self.rank, 0)
        out.add_params(TAMessage.KEY_NUM_SAMPLES, n_i)
        self.send_message(out)

    def _on_sync(self, msg: Message) -> None:
        if msg.get(Message.MSG_ARG_KEY_FINISHED):
            self.finish()
            return
        round_idx = int(msg.get(TAMessage.KEY_ROUND))
        with self._lock:
            # a new sync closes all earlier rounds: drop their buffered peer
            # shares / inclusion sets / timers (a round this client never
            # submitted — e.g. it was excluded from the inclusion set —
            # would otherwise leak one model-sized share per peer forever)
            for stale in [r for r in self._peer_shares if r < round_idx]:
                del self._peer_shares[stale]
            for stale in [r for r in self._include if r < round_idx]:
                del self._include[stale]
            for stale in [r for r in self._submitted if r < round_idx]:
                del self._submitted[stale]
            for stale in [r for r in self._share_timers if r < round_idx]:
                self._share_timers.pop(stale).cancel()
        self._p_i = float(msg.get(TAMessage.KEY_WEIGHT))
        flat = np.asarray(msg.get(TAMessage.KEY_MODEL))
        new_vars, _ = train_wire_round(
            self.trainer, self._local_train, self.train_data, self._client_index(),
            self.batch_size, round_idx, self.rank * 100003 + round_idx,
            unpack_state(flat, self._desc))
        new_flat = pack_state(new_vars)
        # weight-normalized update: |p_i * delta| <= |delta|, so the field
        # sum over all clients stays within scale * max|delta| (no overflow
        # growth with client count or dataset size)
        delta = (
            new_flat.view(np.float32).astype(np.float64)
            - flat.view(np.float32).astype(np.float64)
        ) * self._p_i
        shares = bgw_encode(
            quantize(delta, self.scale, self.prime),
            self.worker_num, self.threshold, self.prime,
            seed=self.seed * 7919 + self.rank * 104729 + round_idx,
        )
        with self._lock:
            # my own share (eval point = my rank) stays local
            self._stash_share(round_idx, self.rank, shares[self.rank - 1])
        for peer in range(1, self.worker_num + 1):
            if peer == self.rank:
                continue
            m = Message(TAMessage.MSG_TYPE_C2C_SHARE, self.rank, peer)
            m.add_params(TAMessage.KEY_SHARE, shares[peer - 1])
            m.add_params(TAMessage.KEY_ROUND, round_idx)
            self.send_message(m)
        if self.share_timeout is not None:
            t = threading.Timer(self.share_timeout,
                                self._report_holders, args=(round_idx,))
            t.daemon = True
            with self._lock:
                self._share_timers[round_idx] = t
            t.start()
        self._maybe_submit(round_idx)

    def _on_peer_share(self, msg: Message) -> None:
        round_idx = int(msg.get(TAMessage.KEY_ROUND))
        with self._lock:
            self._stash_share(
                round_idx, msg.get_sender_id(),
                np.asarray(msg.get(TAMessage.KEY_SHARE)),
            )
        self._maybe_submit(round_idx)

    def _on_include(self, msg: Message) -> None:
        round_idx = int(msg.get(TAMessage.KEY_ROUND))
        with self._lock:
            self._include[round_idx] = tuple(
                int(i) for i in msg.get(TAMessage.KEY_INCLUDE)
            )
        self._maybe_submit(round_idx)

    def _report_holders(self, round_idx: int) -> None:
        """Share wait timed out: report (clear metadata) which peers' shares
        arrived; the server intersects reports into an inclusion set."""
        with self._lock:
            if round_idx in self._submitted:
                return
            holders = sorted(self._peer_shares.get(round_idx, {}))
        out = Message(TAMessage.MSG_TYPE_C2S_SHARE_REPORT, self.rank, 0)
        out.add_params(TAMessage.KEY_HOLDERS, np.asarray(holders, np.int64))
        out.add_params(TAMessage.KEY_ROUND, round_idx)
        self.send_message(out)

    # lock-held: _lock
    def _stash_share(self, round_idx: int, sender: int, share: np.ndarray) -> None:
        self._peer_shares.setdefault(round_idx, {})[sender] = share

    def _maybe_submit(self, round_idx: int) -> None:
        with self._lock:
            got = self._peer_shares.get(round_idx, {})
            agreed = self._include.get(round_idx)
            prev = self._submitted.get(round_idx)
            if prev is not None:
                # already submitted: only a server-agreed subset DIFFERENT
                # from what we sent warrants a RESUBMISSION. A full-set
                # holder necessarily holds every share of any agreed subset;
                # its subset sum supersedes the full-set one on the server,
                # putting all live workers in one reconstructable bucket
                # (pre-share dropout recovery, class docstring step 5).
                if (agreed is None or tuple(agreed) == prev
                        or not set(agreed) <= set(got)):
                    return
                include = tuple(agreed)
            elif len(got) >= self.worker_num:
                # full set — but an already-agreed subset takes precedence
                # so the server's same-set bucket forms without a resubmit
                include = tuple(range(1, self.worker_num + 1))
                if agreed is not None and set(agreed) <= set(got):
                    include = tuple(agreed)
            else:
                # partial shares: only submit once the server has fixed the
                # inclusion set and we hold every share in it
                if agreed is None or not set(agreed) <= set(got):
                    return
                include = tuple(agreed)
            if not include:
                # the server refuses to broadcast an empty set; guard anyway
                # so a malformed message can't np.stack([]) and kill the
                # receive thread
                return
            self._submitted[round_idx] = include
            stack = np.stack([got[s] for s in include])
            # keep _peer_shares/_include until the next sync's stale-round
            # sweep: a later inclusion-set broadcast may require resubmitting
            timer = self._share_timers.pop(round_idx, None)
        if timer is not None:
            timer.cancel()
        share_sum = stack.sum(axis=0) % self.prime
        out = Message(TAMessage.MSG_TYPE_C2S_SHARE_SUM, self.rank, 0)
        out.add_params(TAMessage.KEY_SHARE, share_sum)
        out.add_params(TAMessage.KEY_ROUND, round_idx)
        out.add_params(TAMessage.KEY_INCLUDE, np.asarray(include, np.int64))
        self.send_message(out)


def run_turboaggregate(
    trainer: ClientTrainer,
    train_data: FederatedArrays,
    worker_num: int,
    round_num: int,
    batch_size: int,
    make_comm: Callable[[int], BaseCommunicationManager],
    threshold: int | None = None,
    scale: float = 2**16,
    seed: int = 0,
    round_timeout: float | None = None,
    share_timeout: float | None = None,
    on_round_done: Callable[[int, Any], None] | None = None,
):
    """End-to-end secure aggregation over any comm fabric (same harness
    shape as run_distributed_fedavg). Returns the final global variables."""
    template, flat, desc = init_template(trainer, train_data.arrays, batch_size, seed)
    non_f32 = [str(v.dtype) for v in template.values() if v.dtype != torch.float32]
    if non_f32:
        raise ValueError(f"secure aggregation requires float32 leaves; got {non_f32}")

    results: dict[str, np.ndarray] = {}

    def _done(r, f):
        results["final"] = f
        if on_round_done is not None:
            on_round_done(r, unpack_state(f, desc))

    server = TAServerManager(
        make_comm(0), worker_num, round_num, flat, desc,
        threshold=threshold, scale=scale, round_timeout=round_timeout,
        on_round_done=_done,
    )
    shared_local_train = make_local_train(trainer)
    clients = [
        TAClientManager(
            make_comm(r), r, worker_num + 1, trainer, train_data, batch_size,
            threshold=threshold, scale=scale, seed=seed,
            local_train_fn=shared_local_train, share_timeout=share_timeout,
        )
        for r in range(1, worker_num + 1)
    ]
    run_manager_protocol(server, clients)
    if "final" not in results:
        raise RuntimeError("turboaggregate run produced no final model")
    logging.info("turboaggregate: %d rounds complete", round_num)
    return unpack_state(results["final"], desc)
