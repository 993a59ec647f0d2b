"""Classical vertical FL over the message-passing comm layer, the port of
``fedml_tpu/algorithms/vertical_dist.py``.

Reference: fedml_api/distributed/classical_vertical_fl/ — guest_manager.py:6 /
host_manager.py:6 run the two roles as separate processes; per batch, hosts
send their logit contributions to the guest, the guest sums them, computes
BCE loss, and returns the logit gradient to every host
(guest_trainer.py:73-120, host_trainer.py:37-60). The guest (rank 0, the
labels and its feature columns) and the hosts (ranks 1..N-1, each its own
columns) exchange logit and gradient arrays as typed wire payloads; raw
features never leave a party.

Numerics contract: per-batch compute is factored into per-party forward and
backward programs plus the guest's loss-gradient program
(:func:`make_vfl_steps`), used alike by the wire path and the in-process
stepwise oracle :func:`run_vfl_stepwise`; a loopback run is bitwise equal to
the oracle and the oracle to the single-program ``run_vfl``
(``algorithms/vertical.py``). The guest sums the contributions in party
order with an all-ones mask, as the single program does.

The wire is the JAX package's: INIT and FINAL_VARS carry a host's model as
``pack_pytree`` bytes of its JAX layout (``convert.to_flax`` /
``convert.from_flax``), so JAX and port parties mix in one federation. Every
port party runs its device work under ``fedavg_distributed.TRAIN_LOCK``.

Protocol (handlers never block): guest announces a step, hosts answer with
logits, guest answers with the shared logit gradient; both sides apply their
local update and the guest announces the next step. Batch slicing is a
deterministic schedule both sides compute locally — only step indices,
logits, and gradients cross the wire.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms.fedavg_distributed import (
    TRAIN_LOCK,
    pack_state,
    run_manager_protocol,
)
from fedml_tpu_torch.algorithms.splitnn_dist import state_on, to_device
from fedml_tpu_torch.algorithms.vertical import VerticalFL
from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.managers import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message, pack_pytree
from fedml_tpu_torch.core.trainer import _sigmoid_bce

StateDict = dict[str, torch.Tensor]


class VFLMsg:
    MSG_TYPE_G2H_INIT = 1
    MSG_TYPE_G2H_STEP = 2
    MSG_TYPE_H2G_LOGITS = 3
    MSG_TYPE_G2H_GRAD = 4
    MSG_TYPE_G2H_FINISHED = 5
    MSG_TYPE_H2G_FINAL_VARS = 6

    KEY_MODEL = Message.MSG_ARG_KEY_MODEL_PARAMS
    KEY_DESC = Message.MSG_ARG_KEY_MODEL_DESC
    KEY_STEP = "step"
    KEY_LOGITS = "logits"
    KEY_GRAD = "logit_grad"


def make_vfl_steps(vfl: VerticalFL):
    """Per-party forward and backward programs and the guest's loss-gradient
    program, ``(forwards, backwards, guest_grad)``. ``backwards[i]``
    recomputes the forward inside ``torch.func.vjp`` (no autograd state
    crosses the wire, the splitnn_dist recompute)."""
    forwards, backwards = [], []
    for m in vfl.party_modules:
        def forward(v, x, m=m):
            with torch.no_grad():
                return torch.func.functional_call(m, v, (x,), {"train": True})

        def backward(v, opt_state, x, dz, m=m):
            _, vjp = torch.func.vjp(
                lambda p: torch.func.functional_call(m, p, (x,), {"train": True}), v)
            (g,) = vjp(dz)  # the guest-returned gradient (host_trainer.py:49)
            return vfl.optimizer.update(g, opt_state, v)

        forwards.append(forward)
        backwards.append(backward)

    def guest_grad(total_logit, y, mask):
        # guest_trainer.py:95-110 — BCE on the summed logit, grad w.r.t. it
        def loss_fn(z):
            bce = _sigmoid_bce(z, y.to(torch.float32))
            return torch.sum(bce * mask) / torch.clamp(torch.sum(mask), min=1.0)

        dz, loss = torch.func.grad_and_value(loss_fn)(total_logit)
        return loss, dz

    return forwards, backwards, guest_grad


def _step_schedule(n: int, batch_size: int, epochs: int) -> list[slice]:
    """The deterministic batch schedule every party derives locally
    (run_vfl's slicing: ``steps`` contiguous slices per epoch)."""
    steps = max(1, n // batch_size)
    return [slice(s * batch_size, (s + 1) * batch_size)
            for _ in range(epochs) for s in range(steps)]


class VFLGuestManager(ServerManager):
    """Rank 0: labels and its own columns (on the device its model runs
    on); orchestrates the two-phase protocol."""

    def __init__(self, comm: BaseCommunicationManager, vfl: VerticalFL, pvars: list[StateDict],
                 features: torch.Tensor, y: torch.Tensor, batch_size: int, epochs: int):
        n_hosts = len(vfl.party_modules) - 1
        super().__init__(comm, rank=0, size=n_hosts + 1)
        self.vfl = vfl
        self.n_hosts = n_hosts
        forwards, backwards, self.guest_grad = make_vfl_steps(vfl)
        self.forward, self.backward = forwards[0], backwards[0]
        self.pvars0 = pvars  # full init list; hosts get theirs in INIT
        self.gvars = pvars[0]
        self.g_opt_state = vfl.optimizer.init(self.gvars)
        self.features = features
        self.y = y
        self.device = features.device
        # send_init_msg unconditionally announces step 0, so an empty
        # schedule would IndexError — reject it up front
        if epochs < 1:
            raise ValueError(f"vertical FL needs epochs >= 1, got {epochs}")
        self.schedule = _step_schedule(len(y), batch_size, epochs)
        self.step = 0
        self._step_logits: dict[int, torch.Tensor] = {}
        self._host_acked: dict[int, int] = {}  # last step accepted per host
        self._my_logit: torch.Tensor | None = None
        self.losses: list[float] = []
        self.final_pvars: dict[int, StateDict] = {}
        self._descs: dict[int, str] = {}

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(VFLMsg.MSG_TYPE_H2G_LOGITS, self._on_logits)
        self.register_message_receive_handler(VFLMsg.MSG_TYPE_H2G_FINAL_VARS,
                                              self._on_final_vars)

    def send_init_msg(self) -> None:
        for h in range(1, self.n_hosts + 1):
            with TRAIN_LOCK:
                flat, desc = pack_pytree(convert.to_flax(self.pvars0[h]))
            self._descs[h] = desc
            msg = Message(VFLMsg.MSG_TYPE_G2H_INIT, 0, h)
            msg.add_params(VFLMsg.KEY_MODEL, flat)
            msg.add_params(VFLMsg.KEY_DESC, desc)
            self.send_message(msg)
        self._announce_step()

    def _announce_step(self) -> None:
        for h in range(1, self.n_hosts + 1):
            msg = Message(VFLMsg.MSG_TYPE_G2H_STEP, 0, h)
            msg.add_params(VFLMsg.KEY_STEP, self.step)
            self.send_message(msg)
        with TRAIN_LOCK:
            self._my_logit = self.forward(self.gvars, self.features[self.schedule[self.step]])
        self._maybe_complete_step()

    def _on_logits(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        if int(msg.get(VFLMsg.KEY_STEP)) != self.step:
            # stale (cannot happen on FIFO transports; guards WAN reorder):
            # re-announce the CURRENT step to that host while its answer is
            # outstanding (dropping it would deadlock: the host thinks it
            # answered); a stale answer stamped at or below the sender's
            # last ACCEPTED step is a late duplicate, dropped (resending on
            # it would echo a (resend, late-reply) pair every step)
            if (self.step < len(self.schedule)
                    and sender not in self._step_logits
                    and int(msg.get(VFLMsg.KEY_STEP)) > self._host_acked.get(sender, -1)):
                resend = Message(VFLMsg.MSG_TYPE_G2H_STEP, 0, sender)
                resend.add_params(VFLMsg.KEY_STEP, self.step)
                self.send_message(resend)
            return
        self._host_acked[sender] = self.step
        with TRAIN_LOCK:
            self._step_logits[sender] = to_device(msg.get(VFLMsg.KEY_LOGITS), self.device)
        self._maybe_complete_step()

    def _maybe_complete_step(self) -> None:
        if self._my_logit is None or len(self._step_logits) < self.n_hosts:
            return
        sl = self.schedule[self.step]
        with TRAIN_LOCK:
            # the guest sums contributions in party order (vertical.py
            # train_step: ``sum(logits)`` over parties 0..N-1)
            total = sum([self._my_logit] + [self._step_logits[h]
                                            for h in range(1, self.n_hosts + 1)])
            y = self.y[sl]
            mask = torch.ones(y.shape[0], dtype=torch.float32, device=self.device)
            loss, dz = self.guest_grad(total, y, mask)
            self.losses.append(float(loss))
            dz_host = dz.cpu().numpy()
        for h in range(1, self.n_hosts + 1):
            out = Message(VFLMsg.MSG_TYPE_G2H_GRAD, 0, h)
            out.add_params(VFLMsg.KEY_STEP, self.step)
            out.add_params(VFLMsg.KEY_GRAD, dz_host)
            self.send_message(out)
        with TRAIN_LOCK:
            self.gvars, self.g_opt_state = self.backward(self.gvars, self.g_opt_state,
                                                         self.features[sl], dz)
        self._step_logits = {}
        self._my_logit = None
        self.step += 1
        if self.step >= len(self.schedule):
            for h in range(1, self.n_hosts + 1):
                self.send_message(Message(VFLMsg.MSG_TYPE_G2H_FINISHED, 0, h))
        else:
            self._announce_step()

    def _on_final_vars(self, msg: Message) -> None:
        h = msg.get_sender_id()
        with TRAIN_LOCK:
            self.final_pvars[h] = state_on(msg.get(VFLMsg.KEY_MODEL), self._descs[h],
                                           self.device)
        if len(self.final_pvars) == self.n_hosts:
            self.finish()


class VFLHostManager(ClientManager):
    """Rank h: its own feature columns; answers steps, applies grads."""

    def __init__(self, comm: BaseCommunicationManager, rank: int, size: int, vfl: VerticalFL,
                 features: torch.Tensor, batch_size: int, epochs: int):
        super().__init__(comm, rank, size)
        forwards, backwards, _ = make_vfl_steps(vfl)
        self.forward, self.backward = forwards[rank], backwards[rank]
        self.vfl = vfl
        self.features = features
        self.device = features.device
        self.schedule = _step_schedule(len(features), batch_size, epochs)
        self.pvars: StateDict | None = None
        self.opt_state = None

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(VFLMsg.MSG_TYPE_G2H_INIT, self._on_init)
        self.register_message_receive_handler(VFLMsg.MSG_TYPE_G2H_STEP, self._on_step)
        self.register_message_receive_handler(VFLMsg.MSG_TYPE_G2H_GRAD, self._on_grad)
        self.register_message_receive_handler(VFLMsg.MSG_TYPE_G2H_FINISHED, self._on_finished)

    def _on_init(self, msg: Message) -> None:
        with TRAIN_LOCK:
            self.pvars = state_on(msg.get(VFLMsg.KEY_MODEL), msg.get(VFLMsg.KEY_DESC),
                                  self.device)
        self.opt_state = self.vfl.optimizer.init(self.pvars)

    def _on_step(self, msg: Message) -> None:
        step = int(msg.get(VFLMsg.KEY_STEP))
        with TRAIN_LOCK:
            logit = self.forward(self.pvars, self.features[self.schedule[step]]).cpu().numpy()
        out = Message(VFLMsg.MSG_TYPE_H2G_LOGITS, self.rank, 0)
        out.add_params(VFLMsg.KEY_STEP, step)
        out.add_params(VFLMsg.KEY_LOGITS, logit)
        self.send_message(out)

    def _on_grad(self, msg: Message) -> None:
        step = int(msg.get(VFLMsg.KEY_STEP))
        with TRAIN_LOCK:
            dz = to_device(msg.get(VFLMsg.KEY_GRAD), self.device)
            self.pvars, self.opt_state = self.backward(
                self.pvars, self.opt_state, self.features[self.schedule[step]], dz)

    def _on_finished(self, msg: Message) -> None:
        out = Message(VFLMsg.MSG_TYPE_H2G_FINAL_VARS, self.rank, 0)
        with TRAIN_LOCK:
            out.add_params(VFLMsg.KEY_MODEL, pack_state(self.pvars))
        self.send_message(out)
        self.finish()


def run_distributed_vfl(vfl: VerticalFL, feature_splits: Sequence[torch.Tensor], y: torch.Tensor,
                        epochs: int, batch_size: int, generator: torch.Generator | None,
                        make_comm: Callable[[int], BaseCommunicationManager]):
    """VFL over any comm fabric, the parties' start drawn from ``generator``
    (``VerticalFL.init``). Returns ``(party variables, losses)``, the
    contract of ``run_vfl``'s last two."""
    pvars = vfl.init(generator)
    n_parties = len(vfl.party_modules)
    guest = VFLGuestManager(make_comm(0), vfl, pvars, feature_splits[0], y, batch_size, epochs)
    hosts = [VFLHostManager(make_comm(h), h, n_parties, vfl, feature_splits[h], batch_size,
                            epochs)
             for h in range(1, n_parties)]
    run_manager_protocol(guest, hosts)
    final = [guest.gvars] + [guest.final_pvars[h] for h in range(1, n_parties)]
    return final, guest.losses


def run_distributed_vfl_loopback(vfl, feature_splits, y, epochs, batch_size, generator):
    """VFL on the in-process loopback fabric."""
    from fedml_tpu_torch.comm.loopback import LoopbackCommManager, LoopbackFabric

    fabric = LoopbackFabric(len(vfl.party_modules))
    return run_distributed_vfl(vfl, feature_splits, y, epochs, batch_size, generator,
                               lambda r: LoopbackCommManager(fabric, r))


def run_vfl_stepwise(vfl: VerticalFL, feature_splits: Sequence[torch.Tensor], y: torch.Tensor,
                     epochs: int, batch_size: int, generator: torch.Generator | None):
    """In-process oracle: the SAME per-party programs as the wire path,
    driven in turn. Held to the single-program ``run_vfl`` in tests."""
    forwards, backwards, guest_grad = make_vfl_steps(vfl)
    pvars = vfl.init(generator)
    opts = [vfl.optimizer.init(v) for v in pvars]
    losses = []
    for sl in _step_schedule(len(y), batch_size, epochs):
        fs = [x[sl] for x in feature_splits]
        total = sum([f(v, x) for f, v, x in zip(forwards, pvars, fs)])
        yb = y[sl]
        mask = torch.ones(yb.shape[0], dtype=torch.float32, device=yb.device)
        loss, dz = guest_grad(total, yb, mask)
        losses.append(float(loss))
        for i in range(len(pvars)):
            pvars[i], opts[i] = backwards[i](pvars[i], opts[i], fs[i], dz)
    return pvars, losses
