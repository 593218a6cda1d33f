"""Federated LoRA adapters — baseline config #5 (stretch).

Port of ``xaynet_tpu/models/lora.py``. Each participant trains low-rank
adapters (A: [d, r], B: [r, k]) over frozen base weights and federates
only the adapter deltas, quantized to integer fixed point before masking
(integer mask configs over quantized deltas).

Adapters are a dict ``name -> {"A": tensor, "B": tensor}`` of leaf tensors
that require grad (the JAX package's pytree). Their vector order is flax's
``tree_leaves`` order: sorted target names, then ``A``, ``B``.
``quantize_deltas`` and ``dequantize_deltas`` are numpy, byte-identical to
the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from .layers import adam


@dataclass
class LoraSpec:
    """Shapes of the adapted matrices: name -> (d, k)."""

    targets: dict
    rank: int = 8
    alpha: float = 16.0


def init_adapters(generator: torch.Generator, spec: LoraSpec, device=None) -> dict:
    """A ~ N(0, 1) / r, B = 0 (standard LoRA init), drawn from ``generator``
    in the order of ``spec.targets``, on ``device`` (None: CUDA)."""
    dev = resolve_device(device)
    params = {}
    for name, (d, k) in spec.targets.items():
        a = torch.randn((d, spec.rank), generator=generator, dtype=torch.float32) / spec.rank
        params[name] = {
            "A": a.to(dev).requires_grad_(),
            "B": torch.zeros((spec.rank, k), dtype=torch.float32, device=dev).requires_grad_(),
        }
    return params


def adapter_leaves(adapters: dict) -> list[torch.Tensor]:
    """The adapters' tensors in flax's order: sorted names, then A, B."""
    return [adapters[name][part] for name in sorted(adapters) for part in sorted(adapters[name])]


def apply_adapter(base_out, x, adapter: dict, alpha: float, rank: int):
    """base_out + (alpha / r) * x @ A @ B."""
    return base_out + (alpha / rank) * (x @ adapter["A"] @ adapter["B"])


def make_train_step(loss_fn: Callable, learning_rate: float = 1e-3):
    """``(optimizer_fn, step)``: ``optimizer_fn(adapters)`` is Adam over the
    adapters alone; ``step(adapters, optimizer, batch)`` updates them in
    place and returns the loss (only the adapters receive gradients)."""

    def optimizer_fn(adapters: dict) -> torch.optim.Optimizer:
        return adam(learning_rate)(adapter_leaves(adapters))

    def step(adapters: dict, optimizer: torch.optim.Optimizer, batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(adapters, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return optimizer_fn, step


# --- quantized federation -----------------------------------------------


def quantize_deltas(adapters: dict, scale: int = 10**6) -> np.ndarray:
    """Flatten adapters and quantize to int32 fixed-point for I32 masking."""
    leaves = [t.detach().cpu().numpy() for t in adapter_leaves(adapters)]
    flat = np.concatenate([leaf.ravel() for leaf in leaves]).astype(np.float64)
    return np.clip(np.rint(flat * scale), -(2**31) + 1, 2**31 - 1).astype(np.int64)


def dequantize_deltas(q: np.ndarray, template: dict, scale: int = 10**6) -> dict:
    """Inverse of ``quantize_deltas`` against a template's names and shapes:
    fresh adapter tensors (requiring grad) on the template's device."""
    flat = np.asarray(q, dtype=np.float64) / scale
    out, pos = {}, 0
    for name in sorted(template):
        out[name] = {}
        for part in sorted(template[name]):
            leaf = template[name][part]
            n = leaf.numel()
            values = flat[pos : pos + n].astype(np.float32).reshape(tuple(leaf.shape))
            out[name][part] = torch.from_numpy(values).to(leaf.device).requires_grad_()
            pos += n
    return out
