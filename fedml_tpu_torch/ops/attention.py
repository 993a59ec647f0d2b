"""Blockwise (flash) attention, the port of ``fedml_tpu/ops/attention.py``.

Layout ``[B, H, T, D]``. :func:`flash_attention` is a
``torch.autograd.Function``:

- forward on CUDA tensors launches a hand-written kernel
  (:func:`flash_fwd_cuda`) that replaces the Pallas kernel
  ``_flash_fwd_kernel``, chosen by dtype alone, both on the tensor cores:
  bf16 goes to ``csrc/flash_fwd_sm90.cu`` (wgmma, TMA-fed tiles), f32 to
  ``csrc/flash_fwd_f32_sm90.cu`` (mma.sync TF32 in three passes, 3xTF32,
  which holds the f32 parity a single TF32 product would not; cp.async-fed
  tiles). On CPU tensors it runs :func:`flash_attention_plain`, the same
  math in torch ops. Any other device raises; a failed build or launch
  raises.
- q, k, v that the kernels can take as they are (:func:`tma_compatible`),
  such as the heads of a fused qkv projection, reach either kernel without a
  copy; other inputs are copied into fresh contiguous tensors.
- backward is :func:`_blockwise_bwd`, the torch port of the JAX package's
  plain-XLA blockwise backward, on either device.
- under ``torch.func.vmap`` (the engine's vmap mode) a vmap rule folds the
  mapped axis into the batch axis: one launch serves every client, and
  the launch counters count it once.

The kernels pick their own tiles (128 queries x 128 keys for bf16, 128 x 64
for f32); ``block_q`` and ``block_k`` steer the plain version's blocking and
the backward's key blocks, as they steer the Pallas kernel's grid and the
JAX backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = -1e30

# Launches of each CUDA kernel on the device, and their sum: counted where it
# is launched and, for a launch recorded into a CUDA graph, at each replay of
# the graph (count_replay) instead of at the capture, which launches nothing.
FLASH_FWD_BF16_LAUNCHES = 0  # csrc/flash_fwd_sm90.cu
FLASH_FWD_F32_LAUNCHES = 0   # csrc/flash_fwd_f32_sm90.cu
FLASH_FWD_LAUNCHES = 0
# launches recorded into CUDA graphs while they were captured, by dtype
_CAPTURED = {"bfloat16": 0, "float32": 0}


def captured_launches() -> dict[str, int]:
    """The launches recorded into CUDA graphs so far, by dtype: a graph's
    own are the difference across its capture."""
    return dict(_CAPTURED)


def count_replay(launches: dict[str, int]) -> None:
    """Count one replay of a CUDA graph that recorded ``launches`` (by
    dtype, as :func:`captured_launches` gives them)."""
    global FLASH_FWD_BF16_LAUNCHES, FLASH_FWD_F32_LAUNCHES, FLASH_FWD_LAUNCHES
    FLASH_FWD_BF16_LAUNCHES += launches["bfloat16"]
    FLASH_FWD_F32_LAUNCHES += launches["float32"]
    FLASH_FWD_LAUNCHES += launches["bfloat16"] + launches["float32"]


def _pick_block(t: int, preferred: int) -> int:
    b = min(preferred, t)
    while t % b:
        b -= 1
    return b


def attention_reference(q, k, v, causal: bool = False, sm_scale: float | None = None):
    """Plain materialised attention, the numerical oracle (``attn_impl="xla"``).

    Query i attends to keys j <= i + (t_k - t_q) under ``causal``. A fully
    masked row softmaxes over a row of NEG_INF and so returns the mean of
    ``v``; the flash kernel returns 0 there. ``p`` is cast to ``v``'s type
    before the P.V product, as in the JAX oracle."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones(tq, tk, dtype=torch.bool, device=s.device).tril(tk - tq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def flash_attention_plain(q, k, v, causal: bool = False, sm_scale: float | None = None,
                          block_q: int = 128, block_k: int = 128):
    """The Pallas kernel's math in torch ops: per query block, a loop over the
    key blocks it can see (causal blocks past its last query are skipped),
    running ``m``/``l``/``o`` in f32, masked probabilities forced to 0, ``p``
    kept in f32 for P.V, output ``o / max(l, 1e-20)`` in the input type. The
    CPU path of :func:`flash_attention` and the reference the kernel is held
    to on the card."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    bq = _pick_block(t_q, block_q)
    bk = _pick_block(t_k, block_k)
    off = t_k - t_q
    dev = q.device
    qf = q.float() * sm_scale
    kf, vf = k.float(), v.float()
    num_kb = t_k // bk
    out = []
    for iq in range(t_q // bq):
        qb = qf[:, :, iq * bq:(iq + 1) * bq]
        q_pos = off + iq * bq + torch.arange(bq, device=dev)[:, None]
        o = torch.zeros(b, h, bq, d, dtype=torch.float32, device=dev)
        l = torch.zeros(b, h, bq, 1, dtype=torch.float32, device=dev)
        m = torch.full((b, h, bq, 1), NEG_INF, dtype=torch.float32, device=dev)
        n_kb = num_kb
        if causal:
            last_q_pos = off + (iq + 1) * bq - 1
            n_kb = min(max(last_q_pos // bk + 1, 0), num_kb)
        for j in range(n_kb):
            kb = kf[:, :, j * bk:(j + 1) * bk]
            vb = vf[:, :, j * bk:(j + 1) * bk]
            s = qb @ kb.transpose(-1, -2)
            if causal:
                k_pos = j * bk + torch.arange(bk, device=dev)[None, :]
                s = torch.where(k_pos <= q_pos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            if causal:
                p = torch.where(s <= NEG_INF / 2, 0.0, p)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + p @ vb
            m = m_new
        out.append(o / torch.clamp(l, min=1e-20))
    return torch.cat(out, dim=2).to(q.dtype)


@functools.cache
def _kernel(name: str):
    """The C entry point ``name`` of the built library ``csrc/<name>.cu``,
    with its signature declared."""
    from fedml_tpu_torch.ops import _build

    fn = getattr(_build.load(name), name)
    # q, k, v, o (and for bf16 next_tile); b, h, tq, tk, d; (batch, head, token)
    # strides of q, k, v; sm_scale, causal, stream
    pointers = 5 if name == "flash_fwd_sm90" else 4
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _is_cuda(t) -> bool:
    return t.device.type == "cuda"


def tma_compatible(t) -> bool:
    """Whether a TMA tensor map (bf16) or 16-byte cp.async copies (f32) can
    take the ``[B, H, T, D]`` view ``t`` as it is: a 16-byte-aligned base,
    unit stride along D, and the other strides positive multiples of 16
    bytes."""
    size = t.element_size()
    return (t.dim() == 4 and t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st > 0 and st * size % 16 == 0 for st in t.stride()[:-1]))


def flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float):
    """Launch the forward kernel for q's dtype on the current stream:
    ``q [B,H,Tq,D]``, ``k``/``v`` ``[B,H,Tk,D]`` CUDA tensors of one type, D a
    multiple of 8 up to 128, each a view that :func:`tma_compatible`
    accepts (strided views such as the heads of a fused qkv projection
    included). bf16 goes to ``csrc/flash_fwd_sm90.cu`` (wgmma + TMA), f32 to
    ``csrc/flash_fwd_f32_sm90.cu`` (3xTF32 mma.sync + cp.async). Returns a
    fresh contiguous ``[B,H,Tq,D]``. Counts the launch in that kernel's
    counter and in ``FLASH_FWD_LAUNCHES``, or, while a CUDA graph is captured
    on the current stream, in the tally each replay counts
    (:func:`count_replay`). Runs under a capture: the tile counter is a
    tensor of the graph's pool, zeroed by a captured memset at each replay,
    and the TMA maps carry the pool's fixed addresses. Raises on anything
    the kernel does not take and on a refused launch."""
    global FLASH_FWD_BF16_LAUNCHES, FLASH_FWD_F32_LAUNCHES, FLASH_FWD_LAUNCHES
    bf16 = q.dtype == torch.bfloat16
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _is_cuda(t):
            raise ValueError(f"flash_fwd_cuda: {name} is on {t.device}, not a CUDA device")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise ValueError(
                f"flash_fwd_cuda: {name} is {t.dtype}; q, k, v must share one of "
                "float32, bfloat16"
            )
        if t.dim() != 4:
            raise ValueError(f"flash_fwd_cuda: {name} must be a [B, H, T, D] tensor")
        if not tma_compatible(t):
            raise ValueError(f"flash_fwd_cuda: {name} with strides {t.stride()} is not a "
                             "view the kernel takes (see tma_compatible)")
        if t.device != q.device:
            raise ValueError("flash_fwd_cuda: q, k, v must be on one device")
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if k.shape != (b, h, t_k, d) or v.shape != k.shape:
        raise ValueError(f"flash_fwd_cuda: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"flash_fwd_cuda: head dim {d} must be a multiple of 8 up to 128")
    # both kernels number the (head, 128-query) tiles with one int on grid.x
    if b * h == 0 or t_q == 0 or t_k == 0 or b * h * -(-t_q // 128) >= 2 ** 31:
        raise ValueError(f"flash_fwd_cuda: B*H={b * h}, Tq={t_q}, Tk={t_k} out of range")
    out = torch.empty((b, h, t_q, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    tail = (b, h, t_q, t_k, d, *strides, float(sm_scale), int(bool(causal)), stream)
    if bf16:
        next_tile = torch.zeros(1, dtype=torch.int32, device=q.device)  # the blocks' tile counter
        err = _kernel("flash_fwd_sm90")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), next_tile.data_ptr(), *tail)
    else:
        err = _kernel("flash_fwd_f32_sm90")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: error {err} (a cudaError_t; "
                           "10000 + a CUresult where a TMA tensor map was refused)")
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        _CAPTURED["bfloat16" if bf16 else "float32"] += 1  # each replay counts it
    elif bf16:
        FLASH_FWD_BF16_LAUNCHES += 1
        FLASH_FWD_LAUNCHES += 1
    else:
        FLASH_FWD_F32_LAUNCHES += 1
        FLASH_FWD_LAUNCHES += 1
    return out


def _flash_fwd(q, k, v, causal, sm_scale, block_q, block_k):
    if _is_cuda(q):
        # a fresh copy also fixes a misaligned contiguous view
        q, k, v = (t if tma_compatible(t) else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
        return flash_fwd_cuda(q, k, v, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, sm_scale, block_q, block_k)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def _blockwise_bwd(q, k, v, out, g, causal, sm_scale, block_k):
    """Port of the JAX package's ``_blockwise_bwd``: an LSE pass over key
    blocks, ``delta = rowsum(dO * O)``, then dq/dk/dv per key block, with
    masked (and fully masked) rows' probabilities forced to 0. O(T * block)
    memory; the [T, T] score matrix is never formed whole."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    bk = _pick_block(t_k, block_k)
    nkb = t_k // bk
    dev = q.device
    qf = q.float()
    gf = g.float()
    q_pos = (t_k - t_q) + torch.arange(t_q, device=dev)

    def block(j):
        k_blk = k[:, :, j * bk:(j + 1) * bk].float()
        v_blk = v[:, :, j * bk:(j + 1) * bk].float()
        s = (qf @ k_blk.transpose(-1, -2)) * sm_scale
        if causal:
            k_pos = j * bk + torch.arange(bk, device=dev)
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, NEG_INF)
        return k_blk, v_blk, s

    m = torch.full((b, h, t_q, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(b, h, t_q, 1, dtype=torch.float32, device=dev)
    for j in range(nkb):
        _, _, s = block(j)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        # masked entries contribute 0, not exp(NEG_INF - NEG_INF) = 1
        e = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m_new))
        l = l * torch.exp(m - m_new) + e.sum(-1, keepdim=True)
        m = m_new
    lse = m + torch.log(torch.clamp(l, min=1e-20))
    delta = (gf * out.float()).sum(-1, keepdim=True)

    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j in range(nkb):
        k_blk, v_blk, s = block(j)
        p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - lse))
        dp = gf @ v_blk.transpose(-1, -2)
        ds = p * (dp - delta) * sm_scale
        dq = dq + ds @ k_blk
        dks.append(ds.transpose(-1, -2) @ qf)
        dvs.append(p.transpose(-1, -2) @ gf)
    dk = torch.cat(dks, dim=2)
    dv = torch.cat(dvs, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The forward of :func:`_flash_fwd`, the backward of
    :func:`_blockwise_bwd`, and a vmap rule, so that the function runs under
    ``torch.func.vmap`` and ``torch.func.grad`` (the engine's vmap mode)."""

    @staticmethod
    def forward(q, k, v, causal, sm_scale, block_q, block_k):
        return _flash_fwd(q, k, v, causal, sm_scale, block_q, block_k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, sm_scale, _, block_k = inputs
        ctx.save_for_backward(q, k, v, output)
        ctx.causal, ctx.sm_scale, ctx.block_k = causal, sm_scale, block_k

    @staticmethod
    def backward(ctx, g):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = _blockwise_bwd(q, k, v, out, g, ctx.causal, ctx.sm_scale, ctx.block_k)
        return dq, dk, dv, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, sm_scale, block_q, block_k):
        """The mapped axis (the cohort's clients) folded into the batch axis:
        one launch of the same kernel (or the plain version on CPU tensors)
        for every client at once, as ``pallas_call`` under ``jax.vmap`` adds
        a grid dimension. A view whose two leading axes merge stays a view."""
        n = info.batch_size

        def fold(t, dim):
            t = t.unsqueeze(0).expand((n,) + t.shape) if dim is None else t.movedim(dim, 0)
            return t.reshape((n * t.shape[1],) + t.shape[2:])

        q, k, v = (fold(t, d) for t, d in zip((q, k, v), in_dims[:3]))
        out = _FlashAttention.apply(q, k, v, causal, sm_scale, block_q, block_k)
        return out.reshape((n, -1) + out.shape[1:]), 0


def flash_attention(q, k, v, causal: bool = False, sm_scale: float | None = None,
                    block_q: int = 128, block_k: int = 128):
    """Blockwise fused attention for ``[B, H, T, D]`` inputs: the CUDA kernel
    forward on the card, the plain version on CPU tensors, and the blockwise
    torch backward on both."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, T, D]")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, sm_scale, block_q, block_k)


def _head_parallel(attend, q, k, v, axis, num_heads, warn):
    """``attend`` over this rank's heads of a tensor-parallel attention.

    ``q``, ``k``, ``v`` are this rank's ``[B, T, C/M]`` blocks of the
    projected features (the column-parallel qkv output, whole heads when
    the heads divide the ``M``-way ``axis``); the result is this rank's
    ``[B, T, C/M]`` block of the attention output, the row-parallel proj's
    input. Resolution: ``axis`` None or not bound to a group of more than
    one rank (``collectives.bind``) -> all ``num_heads`` heads here; heads
    that divide the axis -> ``attend`` on this rank's ``num_heads / M``
    heads ``[B, H/M, T, D]``; else the blocks gathered to every head,
    :func:`attention_reference` on them and this rank's block of its
    output (with JAX's warning when ``warn``)."""
    from fedml_tpu_torch.parallel import collectives

    group = None if axis is None else collectives.bound(axis)
    n = collectives.group_size(group)
    b, t, c_local = q.shape
    head_dim = c_local * n // num_heads

    def heads(a, h):  # [B, T, h * D] -> [B, h, T, D]
        return a.reshape(b, t, h, head_dim).transpose(1, 2)

    if num_heads % n == 0:
        h = num_heads // n
        o = attend(heads(q, h), heads(k, h), heads(v, h))
        return o.transpose(1, 2).reshape(b, t, c_local)
    if warn:
        import logging

        logging.getLogger(__name__).warning(
            "flash attention under a %d-way %r model axis: %d heads do not "
            "divide the axis, so the pallas kernel cannot run per-rank — "
            "falling back to gathered xla attention for this program; pick "
            "num_heads divisible by the model axis to keep the kernel on "
            "the sharded path",
            n, axis, num_heads,
        )
    q, k, v = (heads(collectives.gather_axis(a, -1, group), num_heads) for a in (q, k, v))
    o = attention_reference(q, k, v, causal=attend.keywords["causal"],
                            sm_scale=attend.keywords["sm_scale"])
    return collectives.scatter_axis(o.transpose(1, 2).reshape(b, t, c_local * n), -1, group)


def flash_attention_head_parallel(q, k, v, *, axis: str | None, num_heads: int,
                                  causal: bool = False, sm_scale: float | None = None,
                                  block_q: int = 128, block_k: int = 128):
    """:func:`flash_attention` on a tensor-parallel plan: each ``axis`` rank
    runs the kernel on its LOCAL heads (``fedml_tpu/ops/attention.py:230``).

    The port's tensor parallelism is explicit, so the inputs are this rank's
    ``[B, T, C/M]`` blocks of the projected q, k and v features and the
    output is its block of the attention output (the JAX function takes and
    gives the global ``[B, H, T, D]`` view, which GSPMD lays out). Resolution
    order, JAX's:

    - no ``axis``, no world, ``axis`` not bound (``collectives.bind``), or a
      1-way axis -> the kernel on all ``num_heads`` heads (the unsharded
      module's bits);
    - heads divide the axis -> the kernel on this rank's ``[B, H/M, T, D]``
      heads (attention is head-local: the same bits as the full-head kernel
      on those heads), one launch a rank;
    - heads do NOT divide the axis -> JAX's warning, and
      :func:`attention_reference` over the gathered heads (no launch).

    The last is chosen by shape alone; a kernel that fails to build or to
    launch raises, on every path. The backward is :func:`_blockwise_bwd`
    per rank."""
    attend = functools.partial(flash_attention, causal=causal, sm_scale=sm_scale,
                               block_q=block_q, block_k=block_k)
    return _head_parallel(attend, q, k, v, axis, num_heads, warn=True)


def attention_head_parallel(q, k, v, *, axis: str | None, num_heads: int,
                            causal: bool = False, sm_scale: float | None = None):
    """:func:`flash_attention_head_parallel`'s resolution for the plain
    materialised attention (``attn_impl="xla"``), which gathers the heads
    without a warning where they do not divide the axis (GSPMD partitions
    the JAX einsums on any split)."""
    attend = functools.partial(attention_reference, causal=causal, sm_scale=sm_scale)
    return _head_parallel(attend, q, k, v, axis, num_heads, warn=False)
