"""FedGKT over the message-passing comm layer, the port of
``fedml_tpu/algorithms/fedgkt_dist.py``.

Reference: fedml_api/distributed/fedgkt/ — GKTServerManager.py:8 and
GKTClientManager run server and clients as separate processes; each round a
client uploads its extracted feature maps, local logits, and labels
(GKTClientTrainer.py:49 train -> extracted_feature_dict/logits_dict/
labels_dict), the server trains the big model on them with bidirectional KL
(GKTServerTrainer.train_and_eval) and sends its logits back per client.
Features, logits and labels are typed array payloads over any comm backend;
the raw images never leave the client.

Numerics contract: both sides call the SAME phase programs as the in-process
``run_fedgkt`` (``FedGKT.client_train`` / ``server_train``), so a loopback
run is bitwise equal to it. The exchange is per round (one upload and one
feedback per client per round), as in the reference.

The wire is the JAX package's, so JAX and port parties mix in one
federation:

- INIT and FINAL_VARS carry the client model as ``pack_pytree`` bytes of its
  JAX layout (``convert.to_flax`` / ``convert.from_flax``: HWIO kernels and
  the BatchNorm statistics);
- features cross in the JAX layout ``[S, B, H, W, F]``: a port client moves
  its ``[S, B, F, H, W]`` stack to it before the upload, a port server moves
  each upload back (contiguous, as ``run_fedgkt`` concatenates them) after
  the receive; the logits are ``[S, B, C]`` in both packages;
- ROUND carries ``round_key``, JAX key data (``uint32[2]``) that a JAX client
  wraps as a key. The port's phases draw nothing: a port server draws the
  keys from ``RandomState(key_seed)`` (the seed integer of the JAX run,
  other numbers) and a port client ignores them (ROADMAP §C).

Every port party runs its device work under ``fedavg_distributed.TRAIN_LOCK``,
its host-to-device and device-to-host copies included: the clients of a
process share ``gkt.client_module`` (``FedGKT._train`` loads each client's
variables into it), and on the card a phase's steps are replays of a CUDA
graph captured on a side stream, which another thread's launches would
corrupt. The server records each round's seconds, the feature bytes it
received and the seconds spent moving them (``round_stats``).
"""

from __future__ import annotations

import logging
import time
from typing import Callable

import numpy as np
import torch

from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms.fedavg_distributed import (
    TRAIN_LOCK,
    pack_state,
    run_manager_protocol,
)
from fedml_tpu_torch.algorithms.fedgkt import FedGKT
from fedml_tpu_torch.algorithms.splitnn_dist import draw_key, state_on, to_device
from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.managers import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message, pack_pytree

StateDict = dict[str, torch.Tensor]


class GKTMsg:
    MSG_TYPE_S2C_INIT = 1
    MSG_TYPE_S2C_ROUND = 2      # round key (+ server logits after round 0)
    MSG_TYPE_C2S_FEATURES = 3   # feats, client logits, labels, masks
    MSG_TYPE_S2C_FINISHED = 4
    MSG_TYPE_C2S_FINAL_VARS = 5

    KEY_MODEL = Message.MSG_ARG_KEY_MODEL_PARAMS
    KEY_DESC = Message.MSG_ARG_KEY_MODEL_DESC
    KEY_ROUND = Message.MSG_ARG_KEY_ROUND_IDX
    KEY_ROUND_KEY = "round_key"
    KEY_SERVER_LOGITS = "server_logits"
    KEY_FEATS = "extracted_features"
    KEY_LOGITS = "client_logits"
    KEY_Y = "labels"
    KEY_MASK = "masks"


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GKTServerManager(ServerManager):
    """Holds the big server model; trains on uploaded features each round
    (GKTServerManager.py:8 role)."""

    def __init__(self, comm: BaseCommunicationManager, gkt: FedGKT, n_clients: int,
                 rounds: int, server_epochs: int, key_seed: int, cvars0: StateDict,
                 svars: StateDict):
        super().__init__(comm, rank=0, size=n_clients + 1)
        # send_init_msg unconditionally starts round 0, so rounds=0 would
        # still run one full round — reject it up front
        if rounds < 1:
            raise ValueError(f"FedGKT needs rounds >= 1, got {rounds}")
        self.gkt = gkt
        self.n_clients = n_clients
        self.rounds = rounds
        self.server_epochs = server_epochs
        self.svars = svars
        self.device = next(iter(svars.values())).device
        self.keys = np.random.RandomState(key_seed)
        self.round_idx = 0
        self._uploads: dict[int, dict[str, np.ndarray]] = {}
        self.final_cvars: dict[int, StateDict] = {}
        with TRAIN_LOCK:
            self._flat0, self._desc = pack_pytree(convert.to_flax(cvars0))
        self.round_stats: list[dict] = []
        self._round_t0 = 0.0

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(GKTMsg.MSG_TYPE_C2S_FEATURES, self._on_features)
        self.register_message_receive_handler(GKTMsg.MSG_TYPE_C2S_FINAL_VARS,
                                              self._on_final_vars)

    def send_init_msg(self) -> None:
        for w in range(1, self.n_clients + 1):
            msg = Message(GKTMsg.MSG_TYPE_S2C_INIT, 0, w)
            msg.add_params(GKTMsg.KEY_MODEL, self._flat0)
            msg.add_params(GKTMsg.KEY_DESC, self._desc)
            self.send_message(msg)
        self._start_round(None)

    def _start_round(self, per_client_logits: list[np.ndarray] | None) -> None:
        # one key per (round, client) in client order; round 0 sends no
        # logits (clients use zeros — the reference warm-up)
        self._round_t0 = time.perf_counter()
        for w in range(1, self.n_clients + 1):
            msg = Message(GKTMsg.MSG_TYPE_S2C_ROUND, 0, w)
            msg.add_params(GKTMsg.KEY_ROUND, self.round_idx)
            msg.add_params(GKTMsg.KEY_ROUND_KEY, draw_key(self.keys))
            if per_client_logits is not None:
                msg.add_params(GKTMsg.KEY_SERVER_LOGITS, per_client_logits[w - 1])
            self.send_message(msg)

    def _on_features(self, msg: Message) -> None:
        self._uploads[msg.get_sender_id()] = {
            "feats": msg.get(GKTMsg.KEY_FEATS), "logits": msg.get(GKTMsg.KEY_LOGITS),
            "y": msg.get(GKTMsg.KEY_Y), "mask": msg.get(GKTMsg.KEY_MASK)}
        if len(self._uploads) < self.n_clients:
            return
        # concatenate in client order (run_fedgkt oracle order)
        ups = [self._uploads[w] for w in range(1, self.n_clients + 1)]
        self._uploads = {}
        sizes = [u["y"].shape[0] for u in ups]
        with TRAIN_LOCK:
            t0 = time.perf_counter()
            # the JAX layout [S, B, H, W, F] back to the port's [S, B, F, H, W]
            feats = torch.cat([to_device(u["feats"], self.device).permute(0, 1, 4, 2, 3)
                               .contiguous() for u in ups])
            _synchronize(self.device)
            moved = time.perf_counter() - t0
            clog = torch.cat([to_device(u["logits"], self.device) for u in ups])
            ys = torch.cat([to_device(u["y"], self.device) for u in ups])
            ms = torch.cat([to_device(u["mask"], self.device) for u in ups])
            self.svars, slog = self.gkt.server_train(self.svars, feats, clog, ys, ms,
                                                     self.server_epochs)
            nbytes = feats.numel() * feats.element_size()
            del feats
            slog = slog.cpu().numpy()
        per_client, off = [], 0
        for s in sizes:
            per_client.append(slog[off:off + s])
            off += s
        self.round_stats.append({"round": self.round_idx,
                                 "seconds": time.perf_counter() - self._round_t0,
                                 "feature_bytes": nbytes, "server_move_seconds": moved})
        logging.info("fedgkt round %d: %.3f s, %d feature bytes uploaded, %.3f s moving them "
                     "to the server's device", self.round_idx,
                     self.round_stats[-1]["seconds"], nbytes, moved)
        self.round_idx += 1
        if self.round_idx >= self.rounds:
            for w in range(1, self.n_clients + 1):
                self.send_message(Message(GKTMsg.MSG_TYPE_S2C_FINISHED, 0, w))
        else:
            self._start_round(per_client)

    def _on_final_vars(self, msg: Message) -> None:
        with TRAIN_LOCK:
            self.final_cvars[msg.get_sender_id()] = state_on(
                msg.get(GKTMsg.KEY_MODEL), self._desc, self.device)
        if len(self.final_cvars) == self.n_clients:
            self.finish()


class GKTClientManager(ClientManager):
    """Holds the small edge model and its ``[S, B, ...]`` batch stack (on
    the device the model runs on); uploads features per round
    (GKTClientManager role). ``move_seconds`` sums the seconds its
    uploads' features took to reach the host in the JAX layout."""

    def __init__(self, comm: BaseCommunicationManager, rank: int, size: int, gkt: FedGKT,
                 batches: dict[str, torch.Tensor], client_epochs: int):
        super().__init__(comm, rank, size)
        self.gkt = gkt
        self.batches = batches
        self.device = batches["x"].device
        self.client_epochs = client_epochs
        self.n_classes = gkt.client_module.head.weight.shape[0]
        self.cvars: StateDict | None = None
        self.move_seconds = 0.0

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(GKTMsg.MSG_TYPE_S2C_INIT, self._on_init)
        self.register_message_receive_handler(GKTMsg.MSG_TYPE_S2C_ROUND, self._on_round)
        self.register_message_receive_handler(GKTMsg.MSG_TYPE_S2C_FINISHED, self._on_finished)

    def _on_init(self, msg: Message) -> None:
        with TRAIN_LOCK:
            self.cvars = state_on(msg.get(GKTMsg.KEY_MODEL), msg.get(GKTMsg.KEY_DESC),
                                  self.device)

    def _on_round(self, msg: Message) -> None:
        raw = msg.get(GKTMsg.KEY_SERVER_LOGITS)
        with TRAIN_LOCK:
            if raw is None:  # round 0: the reference's zero-logit warm-up
                s_logits = torch.zeros(tuple(self.batches["y"].shape) + (self.n_classes,),
                                       device=self.device)
            else:
                s_logits = to_device(raw, self.device)
            self.cvars, feats, logits = self.gkt.client_train(self.cvars, self.batches,
                                                              s_logits, self.client_epochs)
            t0 = time.perf_counter()
            # the JAX layout on the wire: [S, B, F, H, W] -> [S, B, H, W, F]
            feats = feats.permute(0, 1, 3, 4, 2).contiguous().cpu().numpy()
            self.move_seconds += time.perf_counter() - t0
            logits = logits.cpu().numpy()
            y = self.batches["y"].cpu().numpy()
            mask = self.batches["mask"].cpu().numpy()
        out = Message(GKTMsg.MSG_TYPE_C2S_FEATURES, self.rank, 0)
        out.add_params(GKTMsg.KEY_FEATS, feats)
        out.add_params(GKTMsg.KEY_LOGITS, logits)
        out.add_params(GKTMsg.KEY_Y, y)
        out.add_params(GKTMsg.KEY_MASK, mask)
        self.send_message(out)

    def _on_finished(self, msg: Message) -> None:
        out = Message(GKTMsg.MSG_TYPE_C2S_FINAL_VARS, self.rank, 0)
        with TRAIN_LOCK:
            out.add_params(GKTMsg.KEY_MODEL, pack_state(self.cvars))
        self.send_message(out)
        self.finish()


def run_distributed_fedgkt(gkt: FedGKT, client_batches: list[dict], rounds: int,
                           client_epochs: int, server_epochs: int,
                           generator: torch.Generator | None,
                           make_comm: Callable[[int], BaseCommunicationManager],
                           key_seed: int = 0, stats: dict | None = None):
    """FedGKT over any comm fabric, the start drawn from ``generator``
    (``FedGKT.init``). Returns ``(client variables per client, server
    variables)``, the JAX runner's contract. ``stats``, when given, gets the
    server's ``round_stats`` and the clients' device-to-host seconds
    (``client_move_seconds``)."""
    cvars0, svars = gkt.init(generator)
    server = GKTServerManager(make_comm(0), gkt, len(client_batches), rounds, server_epochs,
                              key_seed, cvars0, svars)
    clients = [GKTClientManager(make_comm(r), r, len(client_batches) + 1, gkt, b,
                                client_epochs)
               for r, b in enumerate(client_batches, start=1)]
    run_manager_protocol(server, clients)
    if stats is not None:
        stats["rounds"] = server.round_stats
        stats["client_move_seconds"] = sum(c.move_seconds for c in clients)
    cvars = [server.final_cvars[r] for r in range(1, len(client_batches) + 1)]
    return cvars, server.svars


def run_distributed_fedgkt_loopback(gkt, client_batches, rounds, client_epochs, server_epochs,
                                    generator, key_seed=0, stats=None):
    """FedGKT on the in-process loopback fabric."""
    from fedml_tpu_torch.comm.loopback import LoopbackCommManager, LoopbackFabric

    fabric = LoopbackFabric(len(client_batches) + 1)
    return run_distributed_fedgkt(gkt, client_batches, rounds, client_epochs, server_epochs,
                                  generator, lambda r: LoopbackCommManager(fabric, r),
                                  key_seed, stats)
