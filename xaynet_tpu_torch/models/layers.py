"""Building blocks the model families share: flax's initializers and
padding, and the one train step every family runs.

The port's modules keep torch's parameter layouts (``nn.Linear.weight`` is
``[out, in]``, a conv weight is OIHW) and name each parameter by its flax
path through ``flax_leaves()`` (``models/mlp.py``: the layout contract).
The initializers below draw flax's distributions from an explicit
``torch.Generator``; they match the JAX package's in law, not in bits, so
tests carry weights across with ``convert.load_flax_params``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated normal (variance_scaling, "truncated_normal"): a unit
# normal cut at +-2 has this standard deviation, so samples are divided by it
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal cut at two standard deviations,
    scaled to variance ``1 / fan_in``."""
    with torch.no_grad():
        draw = torch.empty(t.shape, dtype=t.dtype)
        nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.copy_(draw * (math.sqrt(1.0 / fan_in) / _TRUNCATED_STD))
    return t


def orthogonal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``orthogonal`` initializer (the LSTM's recurrent kernels)."""
    with torch.no_grad():
        draw = torch.empty(t.shape, dtype=t.dtype)
        nn.init.orthogonal_(draw, generator=generator)
        t.copy_(draw)
    return t


def dense_leaves(prefix: tuple, layers) -> dict:
    """The flax leaves of ``nn.Linear`` layers named ``Dense_0``, ``Dense_1``,
    ...: the kernel as flax's ``[in, out]`` (a transposed view) and the bias."""
    out = {}
    for i, layer in enumerate(layers):
        out[(*prefix, f"Dense_{i}", "kernel")] = layer.weight.t()
        out[(*prefix, f"Dense_{i}", "bias")] = layer.bias
    return out


def init_dense_(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax ``nn.Dense`` defaults: lecun_normal kernel, zero bias."""
    lecun_normal_(layer.weight, layer.in_features, generator)
    with torch.no_grad():
        layer.bias.zero_()


def conv_kernel(weight: torch.Tensor) -> torch.Tensor:
    """A torch OIHW conv weight as flax's HWIO kernel (a view)."""
    return weight.permute(2, 3, 1, 0)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial side: the output has
    ``ceil(size / stride)`` positions, and an odd total pads one more at
    the end (a 3x3/2 conv on an even side pads ``(0, 1)``)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0):
    """``x`` (NCHW) padded as flax's ``"SAME"``, and the symmetric padding
    left for the conv itself: ``(x, (ph, pw))``. A symmetric padding is left
    to the conv (no copy); an asymmetric one is applied here with ``value``."""
    (top, bottom), (left, right) = (same_padding(x.shape[2], kernel, stride),
                                    same_padding(x.shape[3], kernel, stride))  # fmt: skip
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


def make_step(loss_fn: Callable, optimizer_fn: Callable):
    """``(loss_fn, optimizer_fn, step)``: the port's form of the JAX
    package's ``(model, tx, step)``. ``optimizer_fn(params)`` builds fresh
    optimizer state (``tx.init``); ``step(module, optimizer, x, y)`` runs one
    forward, backward and update on the module's device and returns the
    loss as a tensor (no host sync)."""

    def step(module: nn.Module, optimizer: torch.optim.Optimizer, x, y) -> torch.Tensor:
        device = next(module.parameters()).device
        x, y = torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(module, x, y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return loss_fn, optimizer_fn, step


def adam(learning_rate: float) -> Callable:
    """``optax.adam(learning_rate)``: the same update rule (b1 0.9, b2
    0.999, eps 1e-8 outside the square root, bias-corrected)."""
    return lambda params: torch.optim.Adam(params, lr=learning_rate, eps=1e-8)


def sgd_momentum(learning_rate: float) -> Callable:
    """``optax.sgd(learning_rate, momentum=0.9)``: heavy-ball momentum with
    the trace starting at the first gradient (``dampening=0``)."""
    return lambda params: torch.optim.SGD(params, lr=learning_rate, momentum=0.9, dampening=0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy_with_integer_labels(...).mean()`` over
    every leading axis."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(), labels.reshape(-1).long())
