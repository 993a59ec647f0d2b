"""Decoder-only transformer LM, the port of ``fedml_tpu/models/transformer.py``.

Int tokens ``[B, T]`` in, f32 logits ``[B, T, V]`` out. Two attention paths:

- ``attn_impl="xla"``: plain materialised attention
  (:func:`~fedml_tpu_torch.ops.attention.attention_reference`);
- ``attn_impl="flash"``: :func:`~fedml_tpu_torch.ops.attention.flash_attention`,
  the hand-written CUDA kernel on the card.

Flax's ``dtype`` semantics are mirrored with explicit casts: parameters stay
f32, each Dense/Embed casts its parameters and input to the compute
``dtype``, LayerNorm takes its statistics in f32 and returns ``dtype``, and
the head runs in ``head_dtype`` with logits upcast to f32. Flax's defaults
that differ from torch's are kept: LayerNorm eps 1e-6 with the fast variance
E[x^2] - E[x]^2, and the tanh approximation of GELU.

Dropout (``dropout_rate`` > 0) masks the attention output and the MLP
output of each block in training, as flax's ``Dropout`` does (a kept
element is ``x / keep``, a dropped one 0). The masks are not drawn here:
the module names its sites in ``dropout_sites`` (``blocks.<i>.attn`` and
``blocks.<i>.mlp``, one example's ``[max_len, embed_dim]`` each, cut to the
sequence's T) and takes them as ``forward(x, train=True, dropout=masks)``,
from the trainer's seeded round stream
(:class:`~fedml_tpu_torch.core.trainer.DropoutStream`).

``remat=True`` keeps only each block's input in training and reruns the
block's forward in the backward (JAX's ``nn.remat(Block)``) through
:class:`_RematBlock`, an ``autograd.Function`` whose backward replays the
block under ``torch.func.vjp``; it serves the eager step and the vmapped
cohort alike. The dropout masks are the block's inputs, so the replay
applies the same masks as the forward. With ``attn_impl="flash"``
the replay launches the flash forward again: 2L launches a training step in
place of L.

Not ported here: ``attn_impl="ring"`` and ``mp_axis`` (multi-GPU, ROADMAP
§A12); each raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.ops.attention import attention_reference, flash_attention

_LECUN_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


class Dense(nn.Module):
    """Flax ``Dense(dtype=...)`` as a torch layer: ``weight [out, in]`` (the
    transpose of flax's kernel) and optional ``bias``, both cast with the
    input to the compute ``dtype`` before the product."""

    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) if bias else None
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)

    def reset_parameters(self, generator: torch.Generator | None = None):
        # flax lecun_normal: truncated normal, variance 1 / fan_in; zero bias
        std = math.sqrt(1.0 / self.weight.shape[1]) / _LECUN_STD
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class LayerNorm(nn.Module):
    """Flax ``LayerNorm``: statistics in f32 with the fast variance
    ``max(E[x^2] - E[x]^2, 0)``, eps 1e-6, f32 scale and bias, output in
    the compute ``dtype``."""

    def __init__(self, features, dtype=torch.float32, eps=1e-6, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.dtype, self.eps = dtype, eps

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        mu2 = (xf * xf).mean(-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(self.dtype)

    def reset_parameters(self, generator: torch.Generator | None = None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, attn_impl="xla", dtype=torch.float32,
                 block_q=256, block_k=1024, device=None, dropout_rate=0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        if attn_impl not in ("xla", "flash"):
            if attn_impl == "ring":
                raise NotImplementedError(
                    "attn_impl='ring' (ring attention over a sequence-parallel "
                    "mesh) is multi-GPU work, ROADMAP §A12")
            raise ValueError(f"unknown attn_impl {attn_impl!r} (expected 'xla' or 'flash')")
        self.num_heads, self.attn_impl = num_heads, attn_impl
        # tiles of the plain version and the backward's key blocks; the CUDA
        # kernel picks its own (ops/attention.py)
        self.block_q, self.block_k = block_q, block_k
        self.qkv = Dense(embed_dim, 3 * embed_dim, bias=False, dtype=dtype, device=device)
        self.proj = Dense(embed_dim, embed_dim, bias=False, dtype=dtype, device=device)

    def forward(self, x, keep=None):
        b, t, c = x.shape
        head_dim = c // self.num_heads
        q, k, v = self.qkv(x).split(c, dim=-1)

        def heads(a):  # [B, T, C] -> [B, H, T, D]
            return a.reshape(b, t, self.num_heads, head_dim).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        if self.attn_impl == "flash":
            o = flash_attention(q, k, v, True, None, self.block_q, self.block_k)
        else:
            o = attention_reference(q, k, v, causal=True)
        return _dropout(self.proj(o.transpose(1, 2).reshape(b, t, c)), keep, self.dropout_rate)


def _dropout(x, keep, rate: float):
    """flax ``Dropout`` given its keep mask (None: the identity)."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0)


class Block(nn.Module):
    """``forward(x, attn_keep=None, mlp_keep=None)``: the keep masks of the
    attention and MLP outputs (``[B, T, C]`` bools) in training with
    dropout, None otherwise."""

    def __init__(self, embed_dim, num_heads, mlp_ratio=4, attn_impl="xla",
                 dtype=torch.float32, block_q=256, block_k=1024, device=None,
                 dropout_rate=0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.ln_0 = LayerNorm(embed_dim, dtype=dtype, device=device)
        self.attn = MultiHeadSelfAttention(embed_dim, num_heads, attn_impl, dtype,
                                           block_q, block_k, device=device,
                                           dropout_rate=dropout_rate)
        self.ln_1 = LayerNorm(embed_dim, dtype=dtype, device=device)
        self.fc_0 = Dense(embed_dim, mlp_ratio * embed_dim, dtype=dtype, device=device)
        self.fc_1 = Dense(mlp_ratio * embed_dim, embed_dim, dtype=dtype, device=device)

    def forward(self, x, attn_keep=None, mlp_keep=None):
        x = x + self.attn(self.ln_0(x), attn_keep)
        m = F.gelu(self.fc_0(self.ln_1(x)), approximate="tanh")
        return x + _dropout(self.fc_1(m), mlp_keep, self.dropout_rate)


class _RematBlock(torch.autograd.Function):
    """A block's forward that keeps only its inputs, and whose backward
    reruns it under ``torch.func.vjp``. ``fn(x, masks, params)`` is the block
    as a pure function; the masks and the parameters are tensor inputs, so
    ``torch.func.vmap`` maps them (the generated vmap rule) in the vmapped
    cohort's ``grad_and_value``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, n_masks, x, *rest):
        return fn(x, rest[:n_masks], rest[n_masks:])

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, n_masks, x, *rest = inputs
        ctx.fn, ctx.n_masks = fn, n_masks
        ctx.save_for_backward(x, *rest)

    @staticmethod
    def backward(ctx, grad):
        x, *rest = ctx.saved_tensors
        masks, params = tuple(rest[:ctx.n_masks]), rest[ctx.n_masks:]
        _, vjp = torch.func.vjp(lambda x, *ps: ctx.fn(x, masks, ps), x, *params)
        grads = vjp(grad)
        return (None, None, grads[0]) + (None,) * ctx.n_masks + tuple(grads[1:])


def _remat(block: Block, x, masks: tuple):
    """``block(x, *masks)`` with its activations recomputed in the
    backward."""
    names, params = zip(*block.named_parameters())

    def fn(x, masks, params):
        return torch.func.functional_call(block, dict(zip(names, params)), (x, *masks))

    return _RematBlock.apply(fn, len(masks), x, *masks, *params)


class TransformerLM(nn.Module):
    """Causal LM. ``pos_offset`` shifts the position-embedding lookup to the
    global token position (sequence-parallel shards)."""

    def __init__(self, vocab_size=90, embed_dim=128, num_layers=2, num_heads=4,
                 max_len=4096, attn_impl="xla", dropout_rate=0.0, dtype=torch.float32,
                 head_dtype=torch.float32, block_q=256, block_k=1024, remat=False,
                 mp_axis=None, device="cuda"):
        super().__init__()
        if mp_axis is not None:
            raise NotImplementedError("mp_axis (tensor-parallel plans) is multi-GPU work, "
                                      "ROADMAP §A12")
        device = resolve_device(device)
        self.dtype, self.head_dtype, self.remat = dtype, head_dtype, remat
        self.dropout_rate = dropout_rate
        # the keep masks the trainer draws: per layer and position
        self.dropout_sites = {f"blocks.{i}.{site}": ((max_len, embed_dim), float(dropout_rate))
                              for i in range(num_layers) for site in ("attn", "mlp")
                              } if dropout_rate else {}
        self.tok_embed = nn.Embedding(vocab_size, embed_dim,
                                      _weight=torch.empty(vocab_size, embed_dim, device=device))
        self.pos_embed = nn.Parameter(torch.empty(max_len, embed_dim, device=device))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, attn_impl=attn_impl, dtype=dtype, block_q=block_q,
                  block_k=block_k, device=device, dropout_rate=dropout_rate)
            for _ in range(num_layers)
        )
        self.ln_f = LayerNorm(embed_dim, dtype=dtype, device=device)
        self.head = Dense(embed_dim, vocab_size, dtype=head_dtype, device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Flax's initialisers from ``generator``: embeddings normal with
        variance 1 / embed_dim, positions normal(0.02), Dense lecun-normal
        with zero bias, LayerNorm ones and zeros."""
        d = self.tok_embed.embedding_dim
        nn.init.normal_(self.tok_embed.weight, std=d ** -0.5, generator=generator)
        nn.init.normal_(self.pos_embed, std=0.02, generator=generator)
        for mod in self.modules():
            if isinstance(mod, (Dense, LayerNorm)):
                mod.reset_parameters(generator)

    def forward(self, x, pos_offset=0, train: bool = False, dropout=None):
        """``dropout``: the keep masks of :attr:`dropout_sites`, ``[B,
        max_len, C]`` each, needed in training (``train``) with dropout."""
        b, t = x.shape
        tok = F.embedding(x, self.tok_embed.weight.to(self.dtype))
        pos_idx = pos_offset + torch.arange(t, device=x.device)
        h = tok + self.pos_embed.index_select(0, pos_idx)[None].to(self.dtype)
        use_masks = train and bool(self.dropout_sites)
        if use_masks and dropout is None:
            raise ValueError("TransformerLM in training with dropout needs its keep masks "
                             "(fedml_tpu_torch.core.trainer.draw_dropout_masks)")
        for i, block in enumerate(self.blocks):
            masks = (tuple(dropout[f"blocks.{i}.{site}"][:, :t] for site in ("attn", "mlp"))
                     if use_masks else ())
            if self.remat and torch.is_grad_enabled():
                h = _remat(block, h, masks)
            else:
                h = block(h, *masks)
        return self.head(self.ln_f(h)).float()
