"""LeNet-style CNN — baseline config #2 (CIFAR-10, 100 participants).

Port of ``xaynet_tpu/models/lenet.py``. Inputs stay NHWC (the bytes the
JAX examples make); the module permutes them to NCHW for the convolutions
and back before the first Dense, so ``Dense_0`` reads the activations
flattened in h, w, c order as flax's does (its ``[1024, 120]`` kernel rows
are in that order). flax's ``nn.Conv`` pads ``"SAME"``: ``padding=2`` for a
5x5 kernel at stride 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import conv_kernel, cross_entropy, dense_leaves, init_dense_, lecun_normal_
from .layers import make_step, sgd_momentum


class LeNet(nn.Module):
    """Classic conv-conv-dense classifier (CIFAR-10 shapes)."""

    def __init__(self, num_classes: int = 10, image_shape=(32, 32, 3)):
        super().__init__()
        h, w, c = image_shape
        self.conv = nn.ModuleList([nn.Conv2d(c, 6, 5, padding=2), nn.Conv2d(6, 16, 5, padding=2)])
        flat = (h // 4) * (w // 4) * 16
        self.dense = nn.ModuleList(
            [nn.Linear(flat, 120), nn.Linear(120, 84), nn.Linear(84, num_classes)]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x: [B, H, W, C]
        x = x.permute(0, 3, 1, 2)
        for conv in self.conv:
            x = F.avg_pool2d(F.relu(conv(x)), 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's NHWC flatten
        for layer in self.dense[:-1]:
            x = F.relu(layer(x))
        return self.dense[-1](x)

    def flax_leaves(self) -> dict:
        out = dense_leaves((), self.dense)
        for i, conv in enumerate(self.conv):
            out[(f"Conv_{i}", "kernel")] = conv_kernel(conv.weight)
            out[(f"Conv_{i}", "bias")] = conv.bias
        return out


def init_params(
    generator: torch.Generator, image_shape=(32, 32, 3), num_classes: int = 10, device=None
) -> LeNet:
    """A fresh ``LeNet`` with flax's initializers (lecun_normal kernels,
    zero biases), drawn from ``generator``, on ``device`` (None: CUDA)."""
    model = LeNet(num_classes, image_shape)
    for conv in model.conv:
        lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
        with torch.no_grad():
            conv.bias.zero_()
    for layer in model.dense:
        init_dense_(layer, generator)
    return model.to(resolve_device(device))


def _loss(module: nn.Module, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return cross_entropy(module(x), y)


def make_train_step(learning_rate: float = 1e-3):
    """``(loss_fn, optimizer_fn, step)``: cross-entropy, SGD with momentum 0.9."""
    return make_step(_loss, sgd_momentum(learning_rate))
