"""Collectives over a mesh axis's process group, the port's own module.

The JAX package never names a collective outside its round program: XLA
inserts the all-gather of the cohort stack and the silo's all-reduces where
the shardings call for them. The port runs one process per device, so it
calls them, over the group of a :class:`~fedml_tpu_torch.parallel.mesh.RankMesh`
axis:

- :func:`all_gather` concatenates each rank's tensor along dim 0 in the
  group's rank order, :func:`all_reduce` sums, :func:`broadcast` copies one
  group rank's tensor to all;
- :func:`axis_sum` is the sum over a *bound* axis (:func:`bind`), the one a
  training step reduces over: differentiable (the backward of a sum over
  ranks is a sum over ranks of the gradients) and batched under
  ``torch.func.vmap`` (the whole ``[C_local, ...]`` batch in one call, c10d
  ops having no batching rule). It is the identity where no group is bound;
- :func:`ring_shift` is JAX's ``ppermute`` around the group's ring (ring
  attention's hop);
- tensor parallelism's autograd pairs, each with a vmap rule:
  :func:`gather_axis` (concatenate along a dimension forward, this rank's
  block of the gradient backward), its transpose :func:`scatter_axis`,
  :func:`copy_to_axis` (identity forward, sum backward: a column-parallel
  layer's input) and :func:`reduce_from_axis` (sum forward, identity
  backward: a row-parallel layer's output).

The backend is the world's, which the caller named when it formed it
(``parallel/multihost.py``): NCCL moves CUDA tensors in place; gloo moves
host tensors, and a CUDA tensor is copied to the host and back, explicitly,
its bytes counted in :data:`TRAFFIC` as host-staged. A CPU tensor over NCCL
raises: no backend is switched for another. A group of one rank (None) is
the identity and moves nothing.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars

import torch
import torch.distributed as dist


class Traffic:
    """What the collectives moved since :meth:`reset`, per operation name:
    ``calls``, ``bytes`` (this rank's payload) and ``host_staged`` (bytes of
    CUDA tensors copied to the host and back for gloo)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()
        self.host_staged: collections.Counter = collections.Counter()

    def snapshot(self) -> dict:
        return {op: {"calls": self.calls[op], "bytes": self.bytes[op],
                     "host_staged": self.host_staged[op]} for op in sorted(self.calls)}


TRAFFIC = Traffic()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _to_wire(op: str, t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``t`` the group's backend can move, counted."""
    t = t.detach()
    backend = dist.get_backend(group)
    TRAFFIC.calls[op] += 1
    TRAFFIC.bytes[op] += t.numel() * t.element_size()
    if backend == "nccl" and not t.is_cuda:
        raise ValueError(f"{op}: the NCCL group moves CUDA tensors, not a {t.device} tensor")
    if backend == "gloo" and t.is_cuda:
        TRAFFIC.host_staged[op] += t.numel() * t.element_size()
        return t.to("cpu", copy=True).contiguous()
    return t.clone(memory_format=torch.contiguous_format)


def _from_wire(op: str, out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``out`` back on ``like``'s device (a staged gloo result), counted."""
    if out.device == like.device:
        return out
    TRAFFIC.host_staged[op] += out.numel() * out.element_size()
    return out.to(like.device)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``'s ranks (a new tensor; ``t`` itself
    for a group of one)."""
    if group_size(group) == 1:
        return t
    buf = _to_wire("all_reduce", t, group)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return _from_wire("all_reduce", buf, t)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in the group's rank order
    (JAX's tiled ``all_gather``; ``t`` itself for a group of one)."""
    if group_size(group) == 1:
        return t
    buf = _to_wire("all_gather", t, group)
    parts = [torch.empty_like(buf) for _ in range(group_size(group))]
    dist.all_gather(parts, buf, group=group)
    return _from_wire("all_gather", torch.cat(parts), t)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s ``t`` on every rank of ``group``."""
    if group_size(group) == 1:
        return t
    buf = _to_wire("broadcast", t, group)
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return _from_wire("broadcast", buf, t)


class _AxisSum(torch.autograd.Function):
    """:func:`all_reduce` as a differentiable op with a batching rule."""

    @staticmethod
    def forward(x, group):
        return all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        # d(sum_r x_r)/dx_r' = 1 for every r: rank r' gets every rank's grad
        return _AxisSum.apply(grad, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        # the mapped dim rides along: one reduce of the whole batch
        return _AxisSum.apply(x, group), in_dims[0]


_BOUND: contextvars.ContextVar[dict] = contextvars.ContextVar("fedml_tpu_torch_bound_axes",
                                                              default={})


@contextlib.contextmanager
def bind(axis: str, group):
    """Bind ``axis`` to ``group`` for the code in the block (this thread's
    context only): :func:`bound` returns it and :func:`axis_sum` reduces over
    it. A group of one rank binds nothing."""
    if group_size(group) == 1:
        yield
        return
    token = _BOUND.set({**_BOUND.get(), axis: group})
    try:
        yield
    finally:
        _BOUND.reset(token)


def bound(axis: str):
    """The group bound to ``axis``, or None (JAX's unbound axis name)."""
    return _BOUND.get().get(axis)


def axis_sum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of the group bound to ``axis``; ``x``
    itself where none is bound."""
    group = bound(axis)
    return x if group is None else _AxisSum.apply(x, group)


def ring_shift(t: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """JAX's ``ppermute`` over the ring of ``group``'s ranks: group rank r's
    ``t`` lands on rank ``(r + shift) % n``, so each rank returns the tensor of
    rank ``(r - shift) % n`` (one send and one receive a rank, batched with
    ``dist.batch_isend_irecv``). ``t`` itself for a group of one."""
    n = group_size(group)
    if n == 1:
        return t
    buf = _to_wire("ppermute", t, group)
    out = torch.empty_like(buf)
    me = dist.get_rank(group)
    ops = [dist.P2POp(dist.isend, buf, dist.get_global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (me - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _from_wire("ppermute", out, t)


def _own_block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (``n`` equal blocks in group
    rank order)."""
    n = group_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size)


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group rank order."""
    full = all_gather(x.movedim(dim, 0), group)
    return full.movedim(0, dim)


class _GatherAxis(torch.autograd.Function):
    """Concatenate over the group along ``dim`` forward; this rank's block of
    the gradient backward (Megatron's gather of a column-parallel output)."""

    @staticmethod
    def forward(x, dim, group):
        return _gather_dim(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _ScatterAxis.apply(grad, ctx.dim, ctx.group), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, group):
        x = x.movedim(in_dims[0], 0)
        return _GatherAxis.apply(x, dim % (x.dim() - 1) + 1, group), 0


class _ScatterAxis(torch.autograd.Function):
    """This rank's block along ``dim`` forward; the blocks concatenated over
    the group backward (the transpose of :class:`_GatherAxis`)."""

    @staticmethod
    def forward(x, dim, group):
        return _own_block(x, dim, group).clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _GatherAxis.apply(grad, ctx.dim, ctx.group), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, group):
        x = x.movedim(in_dims[0], 0)
        return _ScatterAxis.apply(x, dim % (x.dim() - 1) + 1, group), 0


class _CopyToAxis(torch.autograd.Function):
    """The identity forward, a sum over the group backward: the input of a
    column-parallel layer (Megatron's ``f``), whose every rank's partial
    input gradient adds up to the whole."""

    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _ReduceFromAxis.apply(grad, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _CopyToAxis.apply(x, group), in_dims[0]


class _ReduceFromAxis(torch.autograd.Function):
    """A sum over the group forward, the identity backward: the output of a
    row-parallel layer (Megatron's ``g``)."""

    @staticmethod
    def forward(x, group):
        return all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _CopyToAxis.apply(grad, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _ReduceFromAxis.apply(x, group), in_dims[0]


def gather_axis(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Differentiable all-gather along ``dim`` (concatenation forward, this
    rank's block of the gradient backward); ``x`` itself for a group of
    one."""
    return x if group_size(group) == 1 else _GatherAxis.apply(x, dim, group)


def scatter_axis(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Differentiable cut of a replicated ``x`` to this rank's block along
    ``dim`` (the blocks' gradients concatenated backward)."""
    return x if group_size(group) == 1 else _ScatterAxis.apply(x, dim, group)


def copy_to_axis(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, gradient summed over ``group`` backward."""
    return x if group_size(group) == 1 else _CopyToAxis.apply(x, group)


def reduce_from_axis(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward, identity backward."""
    return x if group_size(group) == 1 else _ReduceFromAxis.apply(x, group)
