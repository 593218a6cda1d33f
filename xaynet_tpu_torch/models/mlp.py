"""Regression MLP — baseline config #1 (keras house-prices analogue) — and
the layout contract of every model family's masked vector.

Port of ``xaynet_tpu/models/mlp.py``. The reference ships a 2-layer Keras
MLP trained by 10 federated participants (reference:
bindings/python/examples/keras_house_prices/); participants run the train
step inside ``train_round`` and hand the flattened weight vector to the
masking pipeline.

**The layout contract.** ``flatten_params`` defines the order of the masked
vector, so a torch participant and a JAX participant in one federation read
the global model the same way. Every model of the port names its
parameters by their flax paths (``flax_leaves()``: views of its parameters
in flax's layouts), and the vector is those leaves in the order
``jax.tree_util.tree_leaves`` gives the flax parameters:

- **sorted keys, not module order**: ``Bottleneck_10`` comes before
  ``Bottleneck_2``, ``Conv_*`` before ``GroupNorm_*``, ``bias`` before
  ``kernel`` and ``scale``;
- **flax's layouts**: a Dense kernel is ``[in, out]`` (``nn.Linear.weight``
  transposed), a conv kernel is HWIO (torch's OIHW permuted).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import adam, dense_leaves, init_dense_, make_step


class MLP(nn.Module):
    """2-hidden-layer regression MLP (house-prices baseline)."""

    def __init__(self, input_dim: int, features: Sequence[int] = (64, 32)):
        super().__init__()
        dims = [input_dim, *features, 1]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.dense[:-1]:
            x = F.relu(layer(x))
        return self.dense[-1](x)

    def flax_leaves(self) -> dict:
        return dense_leaves((), self.dense)


def init_params(
    generator: torch.Generator, input_dim: int, features: Sequence[int] = (64, 32), device=None
) -> MLP:
    """A fresh ``MLP`` with flax's initializers, drawn from ``generator``,
    on ``device`` (None: CUDA)."""
    model = MLP(input_dim, features)
    for layer in model.dense:
        init_dense_(layer, generator)
    return model.to(resolve_device(device))


def _mse(module: nn.Module, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((module(x).squeeze(-1) - y) ** 2)


def make_train_step(learning_rate: float = 1e-3):
    """``(loss_fn, optimizer_fn, step)``: MSE, Adam (``layers.make_step``)."""
    return make_step(_mse, adam(learning_rate))


def leaves(module: nn.Module) -> list[tuple[tuple, torch.Tensor]]:
    """The module's flax leaves in ``tree_leaves`` order (sorted paths)."""
    return sorted(module.flax_leaves().items(), key=lambda kv: kv[0])


def flatten_params(module: nn.Module) -> np.ndarray:
    """One f32 vector of the weights, in the masking order (module docstring)."""
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for _, t in leaves(module)])
    return flat.to("cpu", torch.float32).numpy()


def unflatten_params(module: nn.Module, flat) -> nn.Module:
    """Inverse of ``flatten_params``: writes ``flat`` (either package's
    vector) into the module's parameters, in place; returns the module."""
    flat = np.asarray(flat, dtype=np.float32).reshape(-1)
    views = leaves(module)
    total = sum(t.numel() for _, t in views)
    if flat.size != total:
        raise ValueError(f"vector of {flat.size} values for a model of {total} parameters")
    src = torch.from_numpy(flat).to(views[0][1].device)
    pos = 0
    with torch.no_grad():
        for _, t in views:
            t.copy_(src[pos : pos + t.numel()].view(t.shape))
            pos += t.numel()
    return module
