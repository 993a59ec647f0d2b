"""The DARTS search space for federated NAS, the port of
``fedml_tpu/models/darts.py`` (``PRIMITIVES``, ``_Op``, ``MixedOp``,
``Cell``, ``num_edges``, ``gumbel_hard_weights``, ``DARTSNetwork``,
``Genotype``, ``steps_from_edges``, ``decode_genotype``).

The JAX package's search space is kept exactly: six primitives, one
depthwise-separable block in ``sep_conv_3x3``, and ``skip_connect`` at
stride 2 as one 1x1 stride-2 conv. Images come in NHWC ``[N, H, W, 3]`` as
the datasets hold them; the network computes in NCHW. Every mixed op runs
all of its branches and sums them weighted by the edge weights, which are
computed once per forward for each cell type and shared by all cells of
that type: a softmax of the edge's α (``search_mode="darts"``), or for
``"gdas"`` a straight-through hard Gumbel sample in training and the argmax
one-hot in evaluation.

Flax's semantics are kept where they differ from torch's:

- ``padding="SAME"`` pads explicitly (``resnet.same_padding``): (0, 1) for
  a 3x3 window at stride 2 on an even size. ``avg_pool`` pads with zeros and
  divides by 9 everywhere (flax counts the padding); ``max_pool`` pads with
  -inf. The cell's reduce-previous ``avg_pool`` is 2x2, stride 2, VALID.
- BatchNorm is flax's, written functionally (``resnet.BatchNorm``) with
  flax's default momentum 0.99, eps 1e-5, scale and bias: in training it
  normalises with the batch statistics and returns the new running
  statistics instead of writing its buffers.
- The depthwise kernel ``[3, 3, 1, C]`` is the torch weight ``[C, 1, 3, 3]``
  with ``groups=C``.
- ``none`` is zeros in the strided shape at the op's channel count.
- ``dtype`` (default f32) is the compute type of every layer; the JAX
  network computes in its parameters' type, so float64 variables make an
  f64 network there, and ``dtype=torch.float64`` here.

Variables: α is the parameters ``alphas_normal`` and ``alphas_reduce``
(``[E, 6]`` each; the JAX package's ``arch`` collection, :data:`ARCH`), the
other parameters are the weights, and the buffers are the BN statistics.
``forward(x, train=False, noise=None)`` returns logits, or with
``train=True`` ``(logits, new_state)`` where ``new_state`` maps every BN
buffer name to its new value; ``gdas`` training takes the forward's Gumbel
noise ``[2, E, 6]`` (normal, reduce), drawn by :meth:`gumbel_noise`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.models.resnet import BatchNorm, Conv, same_padding
from fedml_tpu_torch.models.transformer import Dense

PRIMITIVES = ("none", "skip_connect", "conv_3x3", "sep_conv_3x3", "avg_pool_3x3", "max_pool_3x3")
ARCH = ("alphas_normal", "alphas_reduce")
BN_MOMENTUM = 0.99  # flax BatchNorm's default, which the JAX network keeps



def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float) -> torch.Tensor:
    (top, bottom), (left, right) = (same_padding(n, kernel, stride) for n in x.shape[-2:])
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def _normed(bn: BatchNorm, x: torch.Tensor, train: bool, stats: dict) -> torch.Tensor:
    """``bn(x)``, its new statistics kept in ``stats`` under the module."""
    y, new = bn(x, train)
    if new is not None:
        stats[bn] = new
    return y


class _Op(nn.Module):
    """One candidate op of an edge on NCHW input; ``forward(x, train, stats)``.
    Submodules are named as flax names them inside ``_Op_i``."""

    def __init__(self, kind: str, in_channels: int, channels: int, stride: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        if kind not in PRIMITIVES:
            raise ValueError(kind)
        self.kind, self.channels, self.stride = kind, channels, stride
        if kind == "skip_connect" and not (stride == 1 and in_channels == channels):
            self.conv_0 = Conv(in_channels, channels, 1, stride, dtype, device)
        elif kind == "conv_3x3":
            self.conv_0 = Conv(in_channels, channels, 3, stride, dtype, device)
            self.bn_0 = BatchNorm(channels, dtype, BN_MOMENTUM, device=device)
        elif kind == "sep_conv_3x3":
            self.conv_0 = Conv(in_channels, in_channels, 3, stride, dtype, device,
                               groups=in_channels)
            self.conv_1 = Conv(in_channels, channels, 1, 1, dtype, device)
            self.bn_0 = BatchNorm(channels, dtype, BN_MOMENTUM, device=device)
        elif kind in ("avg_pool_3x3", "max_pool_3x3") and in_channels != channels:
            self.conv_0 = Conv(in_channels, channels, 1, 1, dtype, device)

    def forward(self, x: torch.Tensor, train: bool, stats: dict) -> torch.Tensor:
        k, s = self.kind, self.stride
        if k == "none":
            n, _, h, w = x[:, :, ::s, ::s].shape
            return x.new_zeros((n, self.channels, h, w))
        if k == "skip_connect":
            return self.conv_0(x) if hasattr(self, "conv_0") else x
        if k == "conv_3x3":
            return _normed(self.bn_0, self.conv_0(F.relu(x)), train, stats)
        if k == "sep_conv_3x3":
            h = self.conv_1(self.conv_0(F.relu(x)))
            return _normed(self.bn_0, h, train, stats)
        if k == "avg_pool_3x3":
            h = F.avg_pool2d(_pad_same(x, 3, s, 0.0), 3, s)
        else:
            h = F.max_pool2d(_pad_same(x, 3, s, float("-inf")), 3, s)
        return self.conv_0(h) if hasattr(self, "conv_0") else h


class MixedOp(nn.Module):
    """All six ops of one edge, summed with the edge's weights in
    ``PRIMITIVES`` order. ``none`` adds exact zeros, so its term is left
    out of the sum (its weight's gradient is 0 either way)."""

    def __init__(self, channels: int, stride: int, dtype=torch.float32, device=None):
        super().__init__()
        self.ops = nn.ModuleList(_Op(p, channels, channels, stride, dtype, device)
                                 for p in PRIMITIVES)

    def forward(self, x, weights, train: bool, stats: dict):
        acc = None
        for w, op in zip(weights.unbind(0), self.ops):
            if op.kind == "none":
                continue
            term = w * op(x, train, stats)
            acc = term if acc is None else acc + term
        return acc


class Cell(nn.Module):
    """DAG cell: ``steps`` intermediate nodes, each the sum of the mixed ops
    over all previous states; the output concatenates the last ``steps``
    states on channels."""

    def __init__(self, c_prev_prev: int, c_prev: int, channels: int, steps: int,
                 reduction: bool, dtype=torch.float32, device=None):
        super().__init__()
        self.steps, self.reduction = steps, reduction
        self.conv_0 = Conv(c_prev_prev, channels, 1, 1, dtype, device)
        self.conv_1 = Conv(c_prev, channels, 1, 1, dtype, device)
        self.edges = nn.ModuleList(
            MixedOp(channels, 2 if reduction and j < 2 else 1, dtype, device)
            for i in range(steps) for j in range(2 + i))

    def forward(self, s0, s1, weights, train: bool, stats: dict):
        s0 = self.conv_0(F.relu(s0))
        if s1.shape[2] != s0.shape[2]:  # the previous cell reduced: NCHW height
            s0 = F.avg_pool2d(s0, 2, 2)
        s1 = self.conv_1(F.relu(s1))
        states = [s0, s1]
        rows = weights.unbind(0)
        offset = 0
        for _ in range(self.steps):
            acc = None
            for j, h in enumerate(states):
                out = self.edges[offset + j](h, rows[offset + j], train, stats)
                acc = out if acc is None else acc + out
            offset += len(states)
            states.append(acc)
        return torch.cat(states[-self.steps:], dim=1)


def num_edges(steps: int) -> int:
    return sum(2 + i for i in range(steps))


def gumbel_hard_weights(alphas: torch.Tensor, noise: torch.Tensor, tau: float) -> torch.Tensor:
    """Straight-through Gumbel-softmax over the op axis, given the Gumbel
    ``noise`` (the shape of ``alphas``): the hard one-hot forward, the soft
    gradient."""
    soft = torch.softmax((alphas + noise) / tau, dim=-1)
    hard = F.one_hot(torch.argmax(soft, dim=-1), alphas.shape[-1]).to(soft.dtype)
    return hard + soft - soft.detach()


class DARTSNetwork(nn.Module):
    """The searchable network: a 3x3 stem conv with BN to ``3 * channels``,
    ``layers`` cells (reductions at ``layers // 3`` and ``2 * layers // 3``
    when ``layers >= 3``, each doubling the channels), a spatial mean and a
    Dense head."""

    def __init__(self, num_classes: int = 10, channels: int = 8, layers: int = 4,
                 steps: int = 3, search_mode: str = "darts", tau: float = 5.0,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        if search_mode not in ("darts", "gdas"):
            raise ValueError(f"search_mode must be 'darts' or 'gdas', got {search_mode!r}")
        device = resolve_device(device)
        self.search_mode, self.tau, self.steps, self.dtype = search_mode, tau, steps, dtype
        E = num_edges(steps)
        self.alphas_normal = nn.Parameter(torch.zeros(E, len(PRIMITIVES), device=device))
        self.alphas_reduce = nn.Parameter(torch.zeros(E, len(PRIMITIVES), device=device))
        self.conv_0 = Conv(3, channels * 3, 3, 1, dtype, device)
        self.bn_0 = BatchNorm(channels * 3, dtype, BN_MOMENTUM, device=device)
        cells, c_pp, c_p, c = [], channels * 3, channels * 3, channels
        for layer in range(layers):
            reduction = layer in (layers // 3, 2 * layers // 3) and layers >= 3
            if reduction:
                c *= 2
            cells.append(Cell(c_pp, c_p, c, steps, reduction, dtype, device))
            c_pp, c_p = c_p, steps * c
        self.cells = nn.ModuleList(cells)
        self.dense_0 = Dense(c_p, num_classes, dtype=dtype, device=device)
        # (buffer name prefix, BatchNorm) of every BN, to name the new statistics
        self._norms = [(name, m) for name, m in self.named_modules() if isinstance(m, BatchNorm)]
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Flax's initialisers from ``generator``: convs and the head
        lecun-normal (zero head bias), BN scale 1 and bias 0, running mean 0
        and variance 1; then α ``1e-3 * N(0, 1)``, normal then reduce."""
        for mod in self.modules():
            if isinstance(mod, (Conv, BatchNorm, Dense)):
                mod.reset_parameters(generator)
        with torch.no_grad():
            for name in ARCH:
                alphas = getattr(self, name)
                alphas.copy_(1e-3 * torch.randn(alphas.shape, generator=generator,
                                                device=alphas.device))

    def gumbel_noise(self, generator: torch.Generator) -> torch.Tensor | None:
        """One forward's Gumbel noise ``[2, E, 6]`` (normal, reduce), drawn on
        ``generator``'s device and moved to the model's; None for ``darts``."""
        if self.search_mode != "gdas":
            return None
        u = torch.rand((2,) + tuple(self.alphas_normal.shape), generator=generator,
                       device=generator.device)
        u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
        return (-torch.log(-torch.log(u))).to(self.alphas_normal.device)

    def _edge_weights(self, alphas, train: bool, noise):
        if self.search_mode == "gdas":
            if train:
                return gumbel_hard_weights(alphas, noise, self.tau)
            return F.one_hot(torch.argmax(alphas, dim=-1), alphas.shape[-1]).to(alphas.dtype)
        return torch.softmax(alphas, dim=-1)

    def forward(self, x, train: bool = False, noise: torch.Tensor | None = None):
        if self.search_mode == "gdas" and train and noise is None:
            raise ValueError("gdas training needs the forward's Gumbel noise (gumbel_noise)")
        w_n = self._edge_weights(self.alphas_normal, train, None if noise is None else noise[0])
        w_r = self._edge_weights(self.alphas_reduce, train, None if noise is None else noise[1])
        stats: dict = {}
        h = self.conv_0(x.to(self.dtype).permute(0, 3, 1, 2))
        s0 = s1 = _normed(self.bn_0, h, train, stats)
        for cell in self.cells:
            s0, s1 = s1, cell(s0, s1, w_r if cell.reduction else w_n, train, stats)
        logits = self.dense_0(s1.mean((2, 3)))
        if not train:
            return logits
        new_state = {}
        for name, bn in self._norms:
            new_state[f"{name}.running_mean"], new_state[f"{name}.running_var"] = stats[bn]
        return logits, new_state


@dataclasses.dataclass
class Genotype:
    normal: list[tuple[str, int]]
    reduce: list[tuple[str, int]]


def steps_from_edges(num_edges_: int) -> int:
    """Invert num_edges: E = steps*(steps+3)/2."""
    steps = int((np.sqrt(9 + 8 * num_edges_) - 3) / 2)
    if num_edges(steps) != num_edges_:
        raise ValueError(f"{num_edges_} is not a valid DARTS edge count")
    return steps


def _softmax_f32(alphas) -> np.ndarray:
    a = np.asarray(alphas, dtype=np.float32)
    e = np.exp(a - a.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def decode_genotype(alphas_normal: np.ndarray, alphas_reduce: np.ndarray,
                    steps: int | None = None) -> Genotype:
    """Argmax decode: per node keep the 2 strongest non-'none' incoming
    edges, by the f32 softmax of α. ``steps`` is inferred from the alpha row
    count by default."""
    if steps is None:
        steps = steps_from_edges(len(np.asarray(alphas_normal)))

    def _decode(alphas):
        gene = []
        offset = 0
        none_idx = PRIMITIVES.index("none")
        w = _softmax_f32(alphas)
        for i in range(steps):
            n_in = 2 + i
            edges = w[offset : offset + n_in].copy()
            edges[:, none_idx] = -1
            strength = edges.max(axis=1)
            top2 = np.argsort(-strength)[:2]
            for j in sorted(top2):
                gene.append((PRIMITIVES[int(np.argmax(edges[j]))], int(j)))
            offset += n_in
        return gene

    return Genotype(_decode(alphas_normal), _decode(alphas_reduce))
