"""Recurrent language models, the port of ``fedml_tpu/models/rnn.py``.

- ``RNNOriginalFedAvg``: embedding(8) -> 2 x LSTM(256) -> dense(V), the
  Shakespeare next-char model (McMahan 2017), vocab 90;
- ``RNNStackOverflow``: embedding(96) -> LSTM(670) -> dense(96) ->
  dense(V), StackOverflow next-word, vocab 10000 words + pad/bos/eos/oov.

Int token ids ``[B, T]`` in, f32 logits ``[B, T, V]`` out. The JAX modules
have no ``dtype`` field, so these run in f32 only.

The recurrence is flax's ``nn.RNN(nn.OptimizedLSTMCell(H))`` written as
explicit tensor ops (:class:`LSTM`), not ``nn.LSTM``: neither ``nn.LSTM``,
``torch._VF.lstm`` nor cuDNN's RNN has a batching rule under
``torch.func.vmap``, so the vmapped cohort would fall back to one client at
a time. Each step keeps the flax cell's arithmetic and gate order (i, f, g,
o): ``z = (h @ W_h + b_h) + x_t @ W_i`` (the input kernels have no bias,
the recurrent ones carry it), ``i, f, o = sigmoid``, ``g = tanh``,
``c' = f * c + i * g``, ``h' = o * tanh(c')``, from a zero carry over the
full sequence. The input products of all steps are one ``[B * T, in] x
[in, 4H]`` product per layer, taken before the time loop.

flax's ``Embed_0`` / ``OptimizedLSTMCell_n`` / ``Dense_i`` are ``embed`` /
``lstm_n`` / ``dense_i`` here (``fedml_tpu_torch/convert.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.models.transformer import _LECUN_STD, Dense


class Embed(nn.Module):
    """flax ``Embed(num, features)``: ``weight [num, features]``."""

    def __init__(self, num_embeddings, features, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features, device=device))

    def forward(self, x):
        return F.embedding(x, self.weight)

    def reset_parameters(self, generator: torch.Generator | None = None):
        # flax variance_scaling(1.0, "fan_in", "normal", out_axis=0): a
        # truncated normal of variance 1 / features
        std = math.sqrt(1.0 / self.weight.shape[1]) / _LECUN_STD
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std, generator=generator)


def lstm_cell(xw_t, h, c, weight_hh, bias_hh):
    """One step of flax's ``OptimizedLSTMCell`` given the step's input
    product ``xw_t = x_t @ W_i`` (``[..., 4H]``) and the carry: ``(h', c')``."""
    z = F.linear(h, weight_hh, bias_hh) + xw_t
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


class LSTM(nn.Module):
    """flax ``nn.RNN(nn.OptimizedLSTMCell(hidden))`` over batch-first input
    ``[B, T, in]`` -> ``[B, T, hidden]``. ``weight_ih [4H, in]`` stacks the
    transposes of flax's ``ii, if, ig, io`` kernels, ``weight_hh [4H, H]``
    and ``bias_hh [4H]`` those of ``hi, hf, hg, ho``."""

    def __init__(self, in_features, hidden, device=None):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_features, device=device))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden, device=device))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden, device=device))

    def forward(self, x):
        b, t, _ = x.shape
        xw = F.linear(x, self.weight_ih)  # every step's input product at once
        h = c = torch.zeros(b, self.hidden, dtype=x.dtype, device=x.device)
        outs = []
        for s in range(t):
            h, c = lstm_cell(xw[:, s], h, c, self.weight_hh, self.bias_hh)
            outs.append(h)
        return torch.stack(outs, dim=1)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initialisers: lecun-normal input kernels (fan-in ``in``),
        each recurrent gate kernel orthogonal, zero bias."""
        std = math.sqrt(1.0 / self.weight_ih.shape[1]) / _LECUN_STD
        nn.init.trunc_normal_(self.weight_ih, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        with torch.no_grad():
            for gate in self.weight_hh.split(self.hidden, dim=0):
                nn.init.orthogonal_(gate, generator=generator)
        nn.init.zeros_(self.bias_hh)


class _RNN(nn.Module):
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initialisers from ``generator``, module by module."""
        for mod in self.modules():
            if isinstance(mod, (Embed, LSTM, Dense)):
                mod.reset_parameters(generator)


class RNNOriginalFedAvg(_RNN):
    def __init__(self, vocab_size=90, embedding_dim=8, hidden_size=256, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.embed = Embed(vocab_size, embedding_dim, device=device)
        self.lstm_0 = LSTM(embedding_dim, hidden_size, device=device)
        self.lstm_1 = LSTM(hidden_size, hidden_size, device=device)
        self.dense_0 = Dense(hidden_size, vocab_size, device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def forward(self, x, train: bool = False):
        return self.dense_0(self.lstm_1(self.lstm_0(self.embed(x))))


class RNNStackOverflow(_RNN):
    """1 LSTM + 2 Dense. vocab = 10000 words + pad/bos/eos/oov."""

    def __init__(self, vocab_size=10004, embedding_dim=96, hidden_size=670, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.embed = Embed(vocab_size, embedding_dim, device=device)
        self.lstm_0 = LSTM(embedding_dim, hidden_size, device=device)
        self.dense_0 = Dense(hidden_size, embedding_dim, device=device)
        self.dense_1 = Dense(embedding_dim, vocab_size, device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    def forward(self, x, train: bool = False):
        return self.dense_1(self.dense_0(self.lstm_0(self.embed(x))))
