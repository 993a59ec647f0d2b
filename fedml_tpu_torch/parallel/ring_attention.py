"""Ring attention: exact attention over a sequence-parallel axis, the port of
``fedml_tpu/parallel/ring_attention.py``.

Sequences are sharded over the ``sp`` axis: each rank holds its local Q/K/V
chunk ``[..., H, T/P, D]``, and the K/V chunks travel the ring of the axis's
ranks (``collectives.ring_shift``, JAX's ``ppermute``) while every rank
accumulates its queries' attention with the online-softmax update of the
flash kernel, in f32, causal by global position. After P steps every query
has seen every key: exact attention in O(T/P) memory a rank. The last
step's rotation would be discarded, so it is skipped (P - 1 hops).

The JAX function is differentiated by XLA through its scan and its
``ppermute``s; here it is a ``torch.autograd.Function`` whose backward is
written out: the forward keeps its output and each row's log-sum-exp, and
the backward sends K and V round the ring again, each block's dK and dV
accumulators travelling with it (each rank adding its queries' share as the
block passes), and one last hop of the accumulators returns them to the
rank that owns the block. The per-step products are ``torch.einsum`` in
f32, as the JAX ones are XLA einsums (there is no kernel to port here).

The axis is a bound group (``collectives.bind(SP_AXIS, group)``,
``parallel/sequence.py``); with none bound it is a ring of one rank: plain
exact attention. :class:`~fedml_tpu_torch.models.transformer.TransformerLM`
takes it with ``attn_impl="ring"``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from fedml_tpu_torch.parallel import collectives

NEG_INF = -1e30


def _place(group) -> tuple[int, int]:
    """``(ranks, this rank's index)`` on the ring."""
    n = collectives.group_size(group)
    return n, (dist.get_rank(group) if n > 1 else 0)


def _scores(qf, kf, me: int, blk: int, causal: bool):
    """``q . k`` of this rank's queries against key block ``blk``, masked
    by global position under ``causal``."""
    s = torch.einsum("...qd,...kd->...qk", qf, kf)
    if causal:
        t = qf.shape[-2]
        pos = torch.arange(t, device=qf.device)
        s = torch.where((blk * t + pos)[None, :] <= (me * t + pos)[:, None], s, NEG_INF)
    return s


def _shift(tensors, group):
    """The tensors' ring hop, in one message (stacked)."""
    moved = collectives.ring_shift(torch.stack(tensors), group)
    return list(moved.unbind(0))


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, group, causal, sm_scale):
        n, me = _place(group)
        qf = q.float() * sm_scale
        shape = q.shape[:-1]
        o = torch.zeros(shape + (v.shape[-1],), dtype=torch.float32, device=q.device)
        l = torch.zeros(shape + (1,), dtype=torch.float32, device=q.device)
        m = torch.full(shape + (1,), NEG_INF, dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        for i in range(n):
            # after i hops this rank holds the block first on rank me - i
            s = _scores(qf, k_cur.float(), me, (me - i) % n, causal)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            if causal:
                p = torch.where(s <= NEG_INF / 2, 0.0, p)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + torch.einsum("...qk,...kd->...qd", p, v_cur.float())
            m = m_new
            if i < n - 1:  # the last hop's blocks would be discarded
                k_cur, v_cur = _shift([k_cur, v_cur], group)
        lse = m + torch.log(torch.clamp(l, min=1e-20))
        return (o / torch.clamp(l, min=1e-20)).to(q.dtype), lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, group, causal, sm_scale = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.sm_scale = group, causal, sm_scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, g, _):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.sm_scale
        n, me = _place(group)
        gf = g.float()
        delta = (gf * out.float()).sum(-1, keepdim=True)
        qf = q.float()
        dq = torch.zeros_like(qf)
        k_cur, v_cur = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for i in range(n):
            kf, vf = k_cur.float(), v_cur.float()
            s = _scores(qf * scale, kf, me, (me - i) % n, causal)
            p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - lse))
            dv = dv + torch.einsum("...qk,...qd->...kd", p, gf)
            ds = p * (torch.einsum("...qd,...kd->...qk", gf, vf) - delta) * scale
            dq = dq + torch.einsum("...qk,...kd->...qd", ds, kf)
            dk = dk + torch.einsum("...qk,...qd->...kd", ds, qf)
            if i < n - 1:  # the block moves on with its accumulators
                k_cur, v_cur, dk, dv = _shift([k_cur.float(), v_cur.float(), dk, dv], group)
                k_cur, v_cur = k_cur.to(k.dtype), v_cur.to(v.dtype)
            else:  # the accumulators' last hop home
                dk, dv = _shift([dk, dv], group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, group, causal, sm_scale):
        n = info.batch_size

        def front(t, dim):
            return t.unsqueeze(0).expand((n,) + t.shape) if dim is None else t.movedim(dim, 0)

        q, k, v = (front(t, d) for t, d in zip((q, k, v), in_dims[:3]))
        return _RingAttention.apply(q, k, v, group, causal, sm_scale), (0, 0)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis_name: str,
                   causal: bool = False, sm_scale: float | None = None) -> torch.Tensor:
    """Exact attention with K/V rotating around the ring of the group bound
    to ``axis_name``.

    q, k, v: local chunks ``[B, H, T_local, D]`` of a sequence sharded over
    the axis, rank i holding positions ``[i * T_local, (i + 1) * T_local)``.
    Returns the local output chunk ``[B, H, T_local, D]``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    out, _ = _RingAttention.apply(q, k, v, collectives.bound(axis_name), causal, sm_scale)
    return out
