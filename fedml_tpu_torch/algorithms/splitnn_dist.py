"""SplitNN over the message-passing comm layer, the port of
``fedml_tpu/algorithms/splitnn_dist.py``.

Reference: fedml_api/distributed/split_nn/ — the SERVER process holds the top
half and the active client streams per-step activations to it
(client.py:24-34 forward_pass/backward_pass over comm), the server finishes
the forward, backprops and returns the activation gradient (server.py:40-60),
and clients take turns in a relay ring (server.py:62-72 active-node
rotation). Server and clients are separate managers on any comm backend
(loopback, the shm rings, gRPC), and the activation and gradient arrays are
the wire payloads.

Numerics contract: the per-step compute is factored into three programs
(:func:`make_split_steps`) that the wire path and the in-process stepwise
oracle :func:`run_splitnn_relay_stepwise` both call, so a loopback run is
bitwise equal to the oracle; the oracle is held to the fused
``SplitNN.train_step`` relay (``algorithms/splitnn.py``). A turn's loss is
the mean of its stacked f32 step losses, as in the JAX package.

What crosses the wire is the JAX package's, so a JAX server drives port
clients and a port server drives JAX clients in one federation:

- INIT and FINAL_VARS carry the client half as ``pack_pytree`` bytes of its
  JAX layout (``convert.to_flax`` / ``convert.from_flax``);
- START_TURN carries ``turn_key`` and ACTS ``step_key``, JAX key data
  (``uint32[2]``) that a JAX party wraps as a key. The port's halves draw
  nothing, so the keys feed no port computation: a port server draws its
  turn keys from ``RandomState(key_seed)`` (the seed integer the JAX run
  gives ``jax.random.key``, other numbers), and a port client derives a
  step's key from its turn key and the step index (:func:`step_key`);
  ROADMAP §C.

Every port party runs its device work, the copies to and from the host
included, under ``fedavg_distributed.TRAIN_LOCK``: the client ranks of a
process share ``split.client_module`` (``functional_call`` swaps its
parameters in place), and one card runs one party at a time anyway.

Protocol state machines (handlers never block their receive loop):
  server: INIT cvars0 -> START_TURN(key) -> [ACTS -> GRADS]* -> next turn
          ... -> FINISHED -> collect FINAL_VARS -> stop
  client: on START_TURN re-init the local optimizer (one relay turn = a
          fresh client optimizer, matching run_splitnn_relay), then drive
          step i from the GRADS handler for step i-1.
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence

import numpy as np
import torch

from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms.fedavg_distributed import (
    TRAIN_LOCK,
    pack_state,
    run_manager_protocol,
    unpack_state,
)
from fedml_tpu_torch.algorithms.splitnn import SplitNN, _split
from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.managers import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message, pack_pytree
from fedml_tpu_torch.core.trainer import _cross_entropy, _masked_mean

StateDict = dict[str, torch.Tensor]


class SplitMsg:
    """Message types (reference split_nn/message_define.py role)."""

    MSG_TYPE_S2C_INIT = 1
    MSG_TYPE_S2C_START_TURN = 2
    MSG_TYPE_C2S_ACTS = 3
    MSG_TYPE_S2C_GRADS = 4
    MSG_TYPE_S2C_FINISHED = 5
    MSG_TYPE_C2S_FINAL_VARS = 6

    KEY_MODEL = Message.MSG_ARG_KEY_MODEL_PARAMS
    KEY_DESC = Message.MSG_ARG_KEY_MODEL_DESC
    KEY_ACTS = "acts"
    KEY_GRADS = "acts_grad"
    KEY_STEP_KEY = "step_key"
    KEY_TURN_KEY = "turn_key"
    KEY_Y = "y"
    KEY_MASK = "mask"
    KEY_LAST = "last_step"


def draw_key(keys: np.random.RandomState) -> np.ndarray:
    """One ``uint32[2]`` key field for a JAX peer, drawn from ``keys``."""
    return keys.randint(0, 1 << 32, size=2, dtype=np.uint64).astype(np.uint32)


def step_key(turn_key: np.ndarray, step: int) -> np.ndarray:
    """The ``uint32[2]`` key field of a turn's step ``step``: the turn key
    with ``step + 1`` added to its second word (a JAX client splits its turn
    key instead; either is opaque to a JAX server without dropout)."""
    key = np.asarray(turn_key, np.uint32).copy()
    key[1] = np.uint32((int(key[1]) + step + 1) & 0xFFFFFFFF)
    return key


def to_device(a, device: torch.device) -> torch.Tensor:
    """A wire array (a read-only view) as a tensor of its own on ``device``."""
    return torch.from_numpy(np.array(a)).to(device)


def state_on(flat, desc: str, device: torch.device) -> StateDict:
    """Model bytes of the JAX layout (``fedavg_distributed.unpack_state``)
    as the port's state dict on ``device``."""
    return {k: v.to(device) for k, v in unpack_state(flat, desc).items()}


def make_split_steps(split: SplitNN):
    """The three per-step programs of the split protocol,
    ``(client_forward, server_step, client_backward)``. The wire path and
    the in-process stepwise oracle call EXACTLY these, so the wire adds
    serialization only (f32 arrays cross bit-exactly).

    ``client_backward`` recomputes the cut-layer forward under autograd (the
    same inputs through the same program give the same bits as
    ``client_forward``): no autograd state crosses the wire, the standard
    split-learning recompute."""

    def client_forward(cvars: StateDict, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return torch.func.functional_call(split.client_module, cvars, (x,),
                                              {"train": True})

    def server_step(svars: StateDict, s_opt_state, acts, y, mask):
        # server.py:40-60 — finish forward, loss, backprop, return acts grad
        sp, ss = _split(split.server_module, svars)
        with torch.enable_grad():
            acts_in = acts.detach().requires_grad_()
            sp_ = {k: v.detach().requires_grad_() for k, v in sp.items()}
            logits = torch.func.functional_call(split.server_module, {**sp_, **ss},
                                                (acts_in,), {"train": True})
            loss = _masked_mean(_cross_entropy(logits, y), mask)
            *s_grads, acts_grad = torch.autograd.grad(loss, [*sp_.values(), acts_in])
        sp, s_opt_state = split.server_opt.update(dict(zip(sp, s_grads)), s_opt_state, sp)
        return {**sp, **ss}, s_opt_state, acts_grad, loss.detach()

    def client_backward(cvars: StateDict, c_opt_state, x, acts_grad):
        # client.py:32-34 — the returned grad flows through the local half
        cp, cs = _split(split.client_module, cvars)
        with torch.enable_grad():
            cp_ = {k: v.detach().requires_grad_() for k, v in cp.items()}
            acts = torch.func.functional_call(split.client_module, {**cp_, **cs}, (x,),
                                              {"train": True})
            c_grads = torch.autograd.grad(acts, list(cp_.values()), acts_grad)
        cp, c_opt_state = split.client_opt.update(dict(zip(cp, c_grads)), c_opt_state, cp)
        return {**cp, **cs}, c_opt_state

    return client_forward, server_step, client_backward


def _turn_loss(losses: list[torch.Tensor]) -> float:
    """A turn's loss: the mean of its stacked f32 step losses
    (``splitnn_dist.py:189``)."""
    return float(torch.stack(losses).mean())


class SplitNNServerManager(ServerManager):
    """Holds the top half; runs the relay rotation (server.py:62-72)."""

    def __init__(self, comm: BaseCommunicationManager, split: SplitNN, n_clients: int,
                 epochs: int, key_seed: int, cvars0: StateDict, svars: StateDict):
        super().__init__(comm, rank=0, size=n_clients + 1)
        # send_init_msg unconditionally starts the first relay turn, so an
        # empty schedule would still run one full turn — reject it up front
        if epochs < 1:
            raise ValueError(f"SplitNN relay needs epochs >= 1, got {epochs}")
        self.split = split
        self.n_clients = n_clients
        self.total_turns = epochs * n_clients
        _, self.server_step, _ = make_split_steps(split)
        self.svars = svars
        self.device = next(iter(svars.values())).device
        self.s_opt_state = split.server_opt.init(_split(split.server_module, svars)[0])
        self.keys = np.random.RandomState(key_seed)
        self.turn = 0
        self.losses: list[float] = []
        self._turn_losses: list[torch.Tensor] = []
        self.final_cvars: dict[int, StateDict] = {}  # guarded-by: _lock
        self._flat0, self._desc = pack_pytree(convert.to_flax(cvars0))
        self._lock = threading.Lock()

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(SplitMsg.MSG_TYPE_C2S_ACTS, self._on_acts)
        self.register_message_receive_handler(SplitMsg.MSG_TYPE_C2S_FINAL_VARS,
                                              self._on_final_vars)

    def send_init_msg(self) -> None:
        for w in range(1, self.n_clients + 1):
            msg = Message(SplitMsg.MSG_TYPE_S2C_INIT, 0, w)
            msg.add_params(SplitMsg.KEY_MODEL, self._flat0)
            msg.add_params(SplitMsg.KEY_DESC, self._desc)
            self.send_message(msg)
        self._start_turn()

    def _start_turn(self) -> None:
        active = (self.turn % self.n_clients) + 1
        msg = Message(SplitMsg.MSG_TYPE_S2C_START_TURN, 0, active)
        msg.add_params(SplitMsg.KEY_TURN_KEY, draw_key(self.keys))
        self.send_message(msg)

    def _on_acts(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        with TRAIN_LOCK:
            acts = to_device(msg.get(SplitMsg.KEY_ACTS), self.device)
            y = to_device(msg.get(SplitMsg.KEY_Y), self.device)
            mask = to_device(msg.get(SplitMsg.KEY_MASK), self.device)
            self.svars, self.s_opt_state, acts_grad, loss = self.server_step(
                self.svars, self.s_opt_state, acts, y, mask)
            self._turn_losses.append(loss)
            acts_grad = acts_grad.cpu().numpy()
        out = Message(SplitMsg.MSG_TYPE_S2C_GRADS, 0, sender)
        out.add_params(SplitMsg.KEY_GRADS, acts_grad)
        self.send_message(out)
        if msg.get(SplitMsg.KEY_LAST):
            with TRAIN_LOCK:
                self.losses.append(_turn_loss(self._turn_losses))
            self._turn_losses = []
            self.turn += 1
            if self.turn >= self.total_turns:
                for w in range(1, self.n_clients + 1):
                    self.send_message(Message(SplitMsg.MSG_TYPE_S2C_FINISHED, 0, w))
            else:
                self._start_turn()

    def _on_final_vars(self, msg: Message) -> None:
        with TRAIN_LOCK:
            cvars = state_on(msg.get(SplitMsg.KEY_MODEL), self._desc, self.device)
        with self._lock:
            self.final_cvars[msg.get_sender_id()] = cvars
            done = len(self.final_cvars) == self.n_clients
        if done:
            self.finish()


class SplitNNClientManager(ClientManager):
    """Holds the bottom half and its ``[S, B, ...]`` batch stack (on the
    device the client half runs on); streams per-step activations."""

    def __init__(self, comm: BaseCommunicationManager, rank: int, size: int, split: SplitNN,
                 batches: dict[str, torch.Tensor]):
        super().__init__(comm, rank, size)
        self.split = split
        self.batches = batches
        self.device = batches["x"].device
        self.n_steps = int(batches["x"].shape[0])
        self.client_forward, _, self.client_backward = make_split_steps(split)
        self.cvars: StateDict | None = None
        self.c_opt_state = None
        self.turn_key: np.ndarray | None = None
        self._step_i = 0

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(SplitMsg.MSG_TYPE_S2C_INIT, self._on_init)
        self.register_message_receive_handler(SplitMsg.MSG_TYPE_S2C_START_TURN,
                                              self._on_start_turn)
        self.register_message_receive_handler(SplitMsg.MSG_TYPE_S2C_GRADS, self._on_grads)
        self.register_message_receive_handler(SplitMsg.MSG_TYPE_S2C_FINISHED,
                                              self._on_finished)

    def _on_init(self, msg: Message) -> None:
        with TRAIN_LOCK:
            self.cvars = state_on(msg.get(SplitMsg.KEY_MODEL), msg.get(SplitMsg.KEY_DESC),
                                  self.device)

    def _on_start_turn(self, msg: Message) -> None:
        # a relay turn re-inits the local optimizer (run_splitnn_relay
        # relay_turn: client_opt.init per turn)
        self.c_opt_state = self.split.client_opt.init(
            _split(self.split.client_module, self.cvars)[0])
        self.turn_key = np.array(msg.get(SplitMsg.KEY_TURN_KEY), np.uint32)
        self._step_i = 0
        self._send_acts()

    def _send_acts(self) -> None:
        i = self._step_i
        with TRAIN_LOCK:
            acts = self.client_forward(self.cvars, self.batches["x"][i]).cpu().numpy()
            y = self.batches["y"][i].cpu().numpy()
            mask = self.batches["mask"][i].cpu().numpy()
        msg = Message(SplitMsg.MSG_TYPE_C2S_ACTS, self.rank, 0)
        msg.add_params(SplitMsg.KEY_ACTS, acts)
        msg.add_params(SplitMsg.KEY_STEP_KEY, step_key(self.turn_key, i))
        msg.add_params(SplitMsg.KEY_Y, y)
        msg.add_params(SplitMsg.KEY_MASK, mask)
        msg.add_params(SplitMsg.KEY_LAST, int(i == self.n_steps - 1))
        self.send_message(msg)

    def _on_grads(self, msg: Message) -> None:
        with TRAIN_LOCK:
            acts_grad = to_device(msg.get(SplitMsg.KEY_GRADS), self.device)
            self.cvars, self.c_opt_state = self.client_backward(
                self.cvars, self.c_opt_state, self.batches["x"][self._step_i], acts_grad)
        self._step_i += 1
        if self._step_i < self.n_steps:
            self._send_acts()
        # else: turn over — wait for the next START_TURN or FINISHED

    def _on_finished(self, msg: Message) -> None:
        out = Message(SplitMsg.MSG_TYPE_C2S_FINAL_VARS, self.rank, 0)
        with TRAIN_LOCK:
            out.add_params(SplitMsg.KEY_MODEL, pack_state(self.cvars))
        self.send_message(out)
        self.finish()


def run_distributed_splitnn(split: SplitNN, client_batches: Sequence[dict[str, torch.Tensor]],
                            epochs: int, generator: torch.Generator | None,
                            make_comm: Callable[[int], BaseCommunicationManager],
                            key_seed: int = 0):
    """SplitNN relay over any comm fabric, the start drawn from
    ``generator`` (``SplitNN.init``), the turn keys from ``key_seed``.
    Returns ``(client variables per client, server variables, per-turn
    losses)``, the contract of ``run_splitnn_relay``."""
    cvars0, svars = split.init(generator)
    server = SplitNNServerManager(make_comm(0), split, len(client_batches), epochs, key_seed,
                                  cvars0, svars)
    clients = [SplitNNClientManager(make_comm(r), r, len(client_batches) + 1, split, b)
               for r, b in enumerate(client_batches, start=1)]
    run_manager_protocol(server, clients)
    cvars = [server.final_cvars[r] for r in range(1, len(client_batches) + 1)]
    return cvars, server.svars, server.losses


def run_distributed_splitnn_loopback(split, client_batches, epochs, generator, key_seed=0):
    """SplitNN relay on the in-process loopback fabric."""
    from fedml_tpu_torch.comm.loopback import LoopbackCommManager, LoopbackFabric

    fabric = LoopbackFabric(len(client_batches) + 1)
    return run_distributed_splitnn(split, client_batches, epochs, generator,
                                   lambda r: LoopbackCommManager(fabric, r), key_seed)


def run_distributed_splitnn_shm(split, client_batches, epochs, generator, key_seed=0,
                                job: str | None = None):
    """SplitNN relay over the native shared-memory rings (``comm/shm.py``),
    every ring cleaned up afterwards."""
    import uuid

    from fedml_tpu_torch.comm.shm import ShmCommManager

    job = job or f"splitnn_{uuid.uuid4().hex[:8]}"
    mgrs = {r: ShmCommManager(job, r, len(client_batches) + 1)
            for r in range(len(client_batches) + 1)}
    try:
        return run_distributed_splitnn(split, client_batches, epochs, generator,
                                       lambda r: mgrs[r], key_seed)
    finally:
        for m in mgrs.values():
            m.cleanup()


def run_splitnn_relay_stepwise(split: SplitNN, client_batches: Sequence[dict[str, torch.Tensor]],
                               epochs: int, generator: torch.Generator | None):
    """In-process oracle: the SAME per-step programs as the wire path,
    driven in turn with no comm layer. Bitwise equal to
    :func:`run_distributed_splitnn` by construction; held to the fused
    ``run_splitnn_relay`` in tests."""
    client_forward, server_step, client_backward = make_split_steps(split)
    cvars0, svars = split.init(generator)
    cvars = [{k: v.clone() for k, v in cvars0.items()} for _ in client_batches]
    s_opt_state = split.server_opt.init(_split(split.server_module, svars)[0])
    losses = []
    for _ in range(epochs):
        for ci, batches in enumerate(client_batches):  # relay ring
            c_opt_state = split.client_opt.init(_split(split.client_module, cvars[ci])[0])
            turn_losses = []
            for i in range(int(batches["x"].shape[0])):
                x, y, mask = batches["x"][i], batches["y"][i], batches["mask"][i]
                acts = client_forward(cvars[ci], x)
                svars, s_opt_state, acts_grad, loss = server_step(svars, s_opt_state, acts, y,
                                                                  mask)
                turn_losses.append(loss)
                cvars[ci], c_opt_state = client_backward(cvars[ci], c_opt_state, x, acts_grad)
            losses.append(_turn_loss(turn_losses))
    return cvars, svars, losses
