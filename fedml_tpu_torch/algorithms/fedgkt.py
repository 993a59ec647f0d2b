"""FedGKT (Group Knowledge Transfer), the port of
``fedml_tpu/algorithms/fedgkt.py``.

Clients train a small feature extractor locally against the server's logits
of the last round (cross entropy plus a temperature-scaled KL term), then
extract each batch's features and logits; the server trains the large model
on the clients' features against their logits, and sends its logits on
those features back. Round 0's server logits are zeros.

Each phase is a plain loop of steps on the module loaded with the
variables, with a fresh ``torch.optim`` form of the port's optimizer, as
the JAX package's scans are: every step runs, a fully padded batch
included (its loss is 0, so plain SGD leaves the weights, and its BatchNorm
statistics enter the running average, as in the JAX package). On the card,
with the port's SGD, a phase's steps after its first are replays of one
CUDA graph of the step (:class:`_Replay`): the server's step is ~2,000
small kernels, which the host would otherwise launch one by one. Features stay
on the device they were made on: the server's phase reads the clients'
stacks there, concatenated in client order. The features are NCHW (the port's
ResNet layout, :mod:`fedml_tpu_torch.models.resnet_gkt`). ``fedgkt_dist.py``
runs the same exchange over the comm layer, the features in the JAX layout
on the wire.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from fedml_tpu_torch.core.trainer import SGD, _cross_entropy, _masked_mean

StateDict = dict[str, torch.Tensor]


class _Replay:
    """``fn(*args)`` (CUDA tensors) as replays of one CUDA graph. The first
    call runs ``fn`` eagerly on a side stream (the warm-up, itself a real
    call); the graph is then captured from copies of its arguments, and
    each later call copies its arguments in and replays. ``fn`` reads and
    writes only its arguments and state that keeps its storage (parameters,
    buffers, gradients, optimizer state), and returns nothing."""

    def __init__(self, fn):
        self.fn, self.graph, self.static = fn, None, None

    def __call__(self, *args):
        if self.graph is not None:
            for slot, a in zip(self.static, args):
                slot.copy_(a)
            self.graph.replay()
            return
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        self.static = [a.clone() for a in args]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.fn(*self.static)


def _replayed(fn, like: torch.Tensor, opt):
    """``fn`` as a :class:`_Replay` where ``like`` lies on the card and the
    optimizer form is the port's SGD (its step holds no host state), else
    ``fn``."""
    return _Replay(fn) if like.is_cuda and isinstance(opt, SGD) else fn


def kl_loss(student_logits, teacher_logits, temperature: float):
    """Per example ``T^2 * sum softmax(t / T) * (log_softmax(t / T) -
    log_softmax(s / T))`` (``fedgkt.py:30-37``, the reference's
    ``utils.py:75-90``)."""
    t = temperature
    log_p_teacher = F.log_softmax(teacher_logits / t, dim=-1)
    p_teacher = F.softmax(teacher_logits / t, dim=-1)
    log_p_student = F.log_softmax(student_logits / t, dim=-1)
    return (t * t) * torch.sum(p_teacher * (log_p_teacher - log_p_student), dim=-1)


@dataclasses.dataclass
class FedGKT:
    """The client and server modules (``models/resnet_gkt.py``), their
    optimizers (the port's functional ones), the distillation temperature
    and weight, the JAX fields in their order."""

    client_module: Any
    server_module: Any
    client_opt: Any
    server_opt: Any
    temperature: float = 3.0
    alpha: float = 1.0

    def init(self, generator: torch.Generator) -> tuple[StateDict, StateDict]:
        """Fresh ``(client, server)`` variables drawn from ``generator``,
        the client's first."""
        out = []
        for module in (self.client_module, self.server_module):
            module.reset_parameters(generator)
            out.append({k: v.detach().clone() for k, v in module.state_dict().items()})
        return out[0], out[1]

    def _loss(self, logits, y, teacher, mask):
        ce = _cross_entropy(logits, y)
        return _masked_mean(ce + self.alpha * kl_loss(logits, teacher, self.temperature), mask)

    def _train(self, module, opt, variables: StateDict, inputs, teachers, labels, masks,
               epochs: int, out_of):
        """``epochs`` passes of steps over the leading axis of ``inputs`` on
        ``module`` loaded with ``variables``, with a fresh optimizer;
        ``out_of`` picks the logits out of the module's output. The new
        BatchNorm statistics of each step replace the buffers. Returns a copy
        of the trained variables."""
        module.load_state_dict(variables)
        module.train()
        optimizer = opt(module.parameters())
        buffers = dict(module.named_buffers())

        def step(x, teacher, y, mask):
            optimizer.zero_grad(set_to_none=True)
            out = module(x, train=True)
            out, new_state = out if buffers else (out, {})  # GroupNorm keeps no state
            self._loss(out_of(out), y, teacher, mask).backward()
            optimizer.step()
            with torch.no_grad():
                for k, v in new_state.items():
                    buffers[k].copy_(v)

        step = _replayed(step, inputs, opt)
        for _ in range(epochs):
            for s in range(inputs.shape[0]):
                step(inputs[s], teachers[s], labels[s], masks[s])
        del step
        module.zero_grad(set_to_none=True)
        return {k: v.detach().clone() for k, v in module.state_dict().items()}

    @staticmethod
    @torch.no_grad()
    def _evaluate(module, variables: StateDict, inputs) -> list:
        """``module`` loaded with ``variables``, in evaluation, on each
        batch of ``inputs``."""
        module.load_state_dict(variables)
        module.eval()
        return [module(x) for x in inputs]

    def client_train(self, cvars: StateDict, batches: dict, server_logits: torch.Tensor,
                     epochs: int):
        """One client's phase (``fedgkt.py:57-105``) on its ``[S, B, ...]``
        batches against ``server_logits`` ``[S, B, C]``: a fresh optimizer,
        the BatchNorm state carried, then an extraction pass in evaluation.
        Returns ``(cvars, features [S, B, 16, H, W], logits [S, B, C])``."""
        cvars = self._train(self.client_module, self.client_opt, cvars, batches["x"],
                            server_logits, batches["y"], batches["mask"], epochs,
                            lambda out: out[1])
        outs = self._evaluate(self.client_module, cvars, batches["x"])
        return cvars, torch.stack([f for f, _ in outs]), torch.stack([lg for _, lg in outs])

    def server_train(self, svars: StateDict, feats, client_logits, labels, masks, epochs: int):
        """The server's phase (``fedgkt.py:108-152``) on the clients'
        ``[N, B, ...]`` stacks against their logits: a fresh optimizer, then
        the feedback logits ``[N, B, C]`` in evaluation. Returns ``(svars,
        server logits)``."""
        svars = self._train(self.server_module, self.server_opt, svars, feats, client_logits,
                            labels, masks, epochs, lambda out: out)
        return svars, torch.stack(self._evaluate(self.server_module, svars, feats))


def run_fedgkt(gkt: FedGKT, client_batches: list[dict], rounds: int, client_epochs: int,
               server_epochs: int, generator: torch.Generator):
    """In-process GKT (``fedgkt.py:155-204``): each round every client
    trains against its server logits of the last round (zeros in round 0),
    the server trains on the clients' stacks concatenated in client order,
    and its logits are split back per client. ``client_batches[i]`` is
    client i's ``[S, B, ...]`` stack; the start is drawn from ``generator``.
    Returns ``(client variables per client, server variables, server logits
    per client)``."""
    cvars0, svars = gkt.init(generator)
    cvars = [{k: v.clone() for k, v in cvars0.items()} for _ in client_batches]
    n_classes = gkt.client_module.head.weight.shape[0]
    server_logits = [torch.zeros(tuple(b["y"].shape) + (n_classes,), device=b["y"].device)
                     for b in client_batches]
    for _ in range(rounds):
        feats_l, clog_l = [], []
        for ci, batches in enumerate(client_batches):
            cvars[ci], f, cl = gkt.client_train(cvars[ci], batches, server_logits[ci],
                                                client_epochs)
            feats_l.append(f)
            clog_l.append(cl)
        feats = torch.cat(feats_l)
        del feats_l
        clog = torch.cat(clog_l)
        ys = torch.cat([b["y"] for b in client_batches])
        ms = torch.cat([b["mask"] for b in client_batches])
        svars, slog = gkt.server_train(svars, feats, clog, ys, ms, server_epochs)
        del feats
        off = 0
        for ci, b in enumerate(client_batches):
            s = b["y"].shape[0]
            server_logits[ci] = slog[off:off + s]
            off += s
    return cvars, svars, server_logits
