"""Character-level LSTM — baseline config #3 (LEAF-Shakespeare shaped).

Port of ``xaynet_tpu/models/lstm.py``: next-character prediction over an
80-symbol vocabulary, embedding 8 -> two LSTM layers -> projection.

The cell is written here, not ``nn.LSTM``: flax's ``OptimizedLSTMCell``
has input kernels ``ii/if/ig/io`` without bias and hidden kernels
``hi/hf/hg/ho`` with one bias, where ``nn.LSTM`` keeps two biases per
layer, so its parameters would not be flax's leaves. Each layer keeps the
four input kernels as one ``[in, 4H]`` matrix (gate order i, f, g, o),
applied to all T steps in one product, then runs the recurrence with the
``[H, 4H]`` hidden matrix and its bias; the carry starts at zero.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .layers import adam, cross_entropy, dense_leaves, init_dense_, lecun_normal_
from .layers import make_step, orthogonal_

VOCAB_SIZE = 80  # LEAF Shakespeare symbol count
GATES = ("i", "f", "g", "o")


class LSTMLayer(nn.Module):
    """flax's ``nn.RNN(nn.OptimizedLSTMCell(hidden))`` over ``[B, T, in]``."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.w_i = nn.Parameter(torch.zeros(in_features, 4 * hidden))
        self.w_h = nn.Parameter(torch.zeros(hidden, 4 * hidden))
        self.b_h = nn.Parameter(torch.zeros(4 * hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        xi = x @ self.w_i  # [B, T, 4H]: the input projection of every step
        h = x.new_zeros(b, self.hidden)
        c = x.new_zeros(b, self.hidden)
        out = []
        for step in range(t):
            i, f, g, o = (xi[:, step] + h @ self.w_h + self.b_h).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)

    def flax_leaves(self, name: str) -> dict:
        out = {}
        for k, gate in enumerate(GATES):
            cols = slice(k * self.hidden, (k + 1) * self.hidden)
            out[(name, f"i{gate}", "kernel")] = self.w_i[:, cols]
            out[(name, f"h{gate}", "kernel")] = self.w_h[:, cols]
            out[(name, f"h{gate}", "bias")] = self.b_h[cols]
        return out


class CharLSTM(nn.Module):
    def __init__(self, vocab_size: int = VOCAB_SIZE, hidden: int = 256, embed: int = 8):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, embed)
        self.lstm = nn.ModuleList([LSTMLayer(embed, hidden), LSTMLayer(hidden, hidden)])
        self.dense = nn.Linear(hidden, vocab_size)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:  # [B, T] int
        x = self.embed(tokens.long())
        for layer in self.lstm:
            x = layer(x)
        return self.dense(x)  # [B, T, V]

    def flax_leaves(self) -> dict:
        out = {("Embed_0", "embedding"): self.embed.weight, **dense_leaves((), [self.dense])}
        for i, layer in enumerate(self.lstm):
            out.update(layer.flax_leaves(f"lstm{i}"))
        return out


def init_params(
    generator: torch.Generator, vocab_size: int = VOCAB_SIZE, hidden: int = 256, device=None
) -> CharLSTM:
    """A fresh ``CharLSTM`` with flax's initializers, drawn from
    ``generator``, on ``device`` (None: CUDA): embedding N(0, 1/8), input
    kernels lecun_normal, hidden kernels orthogonal, zero biases. (The JAX
    ``init_params`` also takes ``seq_len``, which only shapes its dummy
    input; the parameters do not depend on it.)"""
    model = CharLSTM(vocab_size, hidden)
    with torch.no_grad():
        model.embed.weight.normal_(0.0, model.embed.embedding_dim**-0.5, generator=generator)
    for layer in model.lstm:
        leaves = layer.flax_leaves("")
        for gate in GATES:
            lecun_normal_(leaves[("", f"i{gate}", "kernel")], layer.w_i.shape[0], generator)
            orthogonal_(leaves[("", f"h{gate}", "kernel")], generator)
    init_dense_(model.dense, generator)
    return model.to(resolve_device(device))


def _loss(module: nn.Module, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return cross_entropy(module(tokens), targets)


def make_train_step(learning_rate: float = 1e-3):
    """``(loss_fn, optimizer_fn, step)``: cross-entropy over every position, Adam."""
    return make_step(_loss, adam(learning_rate))
