"""ResNet-50 — baseline config #4 (the ~25M-parameter aggregation stress).

Port of ``xaynet_tpu/models/resnet.py``: bottleneck ResNet with
GroupNorm(32), inputs NHWC (permuted to NCHW inside).

**bf16 as flax's ``dtype=``, by explicit casts, not autocast.** Parameters
stay f32 (they are the masked vector). Each conv casts its input and its
kernel to ``dtype`` and computes in it, as ``nn.Conv(dtype=...)`` does; each
GroupNorm computes its statistics and affine in f32 and returns ``dtype``
(flax promotes them to at least f32); ReLU and the residual add run in
``dtype``; the spatial mean runs in at least f32 and returns ``dtype``
(``jnp.mean`` upcasts bf16); the head Dense computes in the parameters'
f32. With ``dtype=torch.float32`` every cast is a no-op, which is how the
tests hold the port against ``ResNet50(dtype=jnp.float32)`` with a tight
tolerance (and a module in ``double()`` with ``dtype=torch.float64``
computes in f64 throughout, the reference of ``chip_smoke.py``'s step
check).

The rest follows flax, not torch's defaults:

- GroupNorm's epsilon is 1e-6 (torch: 1e-5);
- ``"SAME"`` padding is asymmetric at stride 2: the stem's 7x7/2 on 64
  pads (2, 3), a 3x3/2 on an even side (0, 1), and ``max_pool`` 3x3/2
  pads (0, 1) with -inf (``layers.pad_same``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import conv_kernel, cross_entropy, dense_leaves, init_dense_, lecun_normal_
from .layers import make_step, pad_same, sgd_momentum

GN_GROUPS, GN_EPS = 32, 1e-6


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, use_bias=False, dtype)``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel, kernel))
        self.kernel, self.stride, self.dtype = kernel, stride, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, padding = pad_same(x.to(self.dtype), self.kernel, self.stride)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride, padding=padding)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=32, dtype)``: f32 statistics and affine."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wide = x.to(torch.promote_types(x.dtype, torch.float32))  # flax: at least f32
        y = F.group_norm(wide, GN_GROUPS, self.scale.to(wide.dtype), self.bias.to(wide.dtype),
                         eps=GN_EPS)  # fmt: skip
        return y.to(self.dtype)


def _conv_norm_leaves(prefix: tuple, convs, norms) -> dict:
    out = {}
    for i, conv in enumerate(convs):
        out[(*prefix, f"Conv_{i}", "kernel")] = conv_kernel(conv.weight)
    for i, norm in enumerate(norms):
        out[(*prefix, f"GroupNorm_{i}", "bias")] = norm.bias
        out[(*prefix, f"GroupNorm_{i}", "scale")] = norm.scale
    return out


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4), each normed; a 1x1 projection of
    the input (``Conv_3``, ``GroupNorm_3``) where the shapes differ."""

    def __init__(self, in_ch: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16):  # fmt: skip
        super().__init__()
        out_ch = features * 4
        convs = [Conv(in_ch, features, 1, 1, dtype), Conv(features, features, 3, strides, dtype),
                 Conv(features, out_ch, 1, 1, dtype)]  # fmt: skip
        norms = [GroupNorm(features, dtype), GroupNorm(features, dtype), GroupNorm(out_ch, dtype)]
        self.project = in_ch != out_ch or strides != 1
        if self.project:
            convs.append(Conv(in_ch, out_ch, 1, strides, dtype))
            norms.append(GroupNorm(out_ch, dtype))
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, n = self.convs, self.norms
        y = F.relu(n[0](c[0](x)))
        y = F.relu(n[1](c[1](y)))
        y = n[2](c[2](y))
        residual = n[3](c[3](x)) if self.project else x
        return F.relu(y + residual)

    def flax_leaves(self, name: str) -> dict:
        return _conv_norm_leaves((name,), self.convs, self.norms)


class ResNet50(nn.Module):
    def __init__(self, num_classes: int = 1000, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3):  # fmt: skip
        super().__init__()
        self.dtype = dtype
        self.stem = Conv(in_channels, 64, 7, 2, dtype)
        self.stem_norm = GroupNorm(64, dtype)
        blocks, in_ch = [], 64
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = 2 if i > 0 and j == 0 else 1
                blocks.append(Bottleneck(in_ch, 64 * 2**i, strides, dtype))
                in_ch = 64 * 2**i * 4
        self.blocks = nn.ModuleList(blocks)
        self.dense = nn.Linear(in_ch, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x: [B, H, W, C]
        x = F.relu(self.stem_norm(self.stem(x.permute(0, 3, 1, 2))))
        x, padding = pad_same(x, 3, 2, value=float("-inf"))
        x = F.max_pool2d(x, 3, stride=2, padding=padding)
        for block in self.blocks:
            x = block(x)
        x = x.to(torch.promote_types(x.dtype, torch.float32)).mean(dim=(2, 3)).to(self.dtype)
        return self.dense(x.to(self.dense.weight.dtype))  # flax: Dense(dtype=float32)

    def flax_leaves(self) -> dict:
        out = _conv_norm_leaves((), [self.stem], [self.stem_norm])
        out.update(dense_leaves((), [self.dense]))
        for i, block in enumerate(self.blocks):
            out.update(block.flax_leaves(f"Bottleneck_{i}"))
        return out


def init_params(generator: torch.Generator, image_shape=(64, 64, 3), num_classes: int = 1000,
                stage_sizes: Sequence[int] = (3, 4, 6, 3), device=None,
                dtype: torch.dtype = torch.bfloat16) -> ResNet50:  # fmt: skip
    """A fresh ``ResNet50`` with flax's initializers (lecun_normal conv and
    Dense kernels, GroupNorm scale 1 and bias 0, Dense bias 0), drawn from
    ``generator``, on ``device`` (None: CUDA). The parameters depend on the
    image's channel count only."""
    model = ResNet50(num_classes, tuple(stage_sizes), dtype, in_channels=image_shape[-1])
    for module in model.modules():
        if isinstance(module, Conv):
            lecun_normal_(module.weight, module.weight[0].numel(), generator)
    init_dense_(model.dense, generator)
    return model.to(resolve_device(device))


def _loss(module: nn.Module, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return cross_entropy(module(x), y)


def make_train_step(learning_rate: float = 0.1):
    """``(loss_fn, optimizer_fn, step)``: cross-entropy, SGD with momentum 0.9."""
    return make_step(_loss, sgd_momentum(learning_rate))


def param_count(module: nn.Module) -> int:
    return sum(t.numel() for t in module.flax_leaves().values())
