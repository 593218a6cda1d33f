"""Planar limb arithmetic and the single-pass lazy-carry batch fold (torch).

Port of ``xaynet_tpu/ops/fold_jax.py``. Device arrays are **planar**
``uint32[L, n]`` (limb-major, model axis innermost), so a warp's threads
read neighbouring columns of one limb plane. The fold of K updates into the
accumulator is one read of the batch:

1. split each uint32 limb into its 16-bit halves and plain-sum them over K
   (sums of 16-bit values stay below 2^32 for K <= 65535);
2. carry-propagate the column sums into an (L+1)-limb value ``< K * order``;
3. reduce modulo the order with ``ceil(log2 K)`` conditional subtracts of
   ``order << b``;
4. modular-add the result into the accumulator.

``fold_planar_batch`` / ``fold_packed_batch`` launch the hand-written CUDA
kernel K1 (``ops.kernels``) on a CUDA accumulator and run its plain torch
version on a CPU one. Both update the accumulator IN PLACE (the JAX
functions donate it and return the new buffer) and return it.

torch has no ``+``, ``-``, ``<`` or ``>>`` for ``uint32``, so uint32 is kept
for storage only: the planar helpers below take limbs widened to int64
(values in ``[0, 2^32)``, see :func:`widen`) and return int64 limbs.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_LAZY_BATCH = 65535  # 16-bit lazy-carry headroom
MASK32 = 0xFFFFFFFF


def _int_to_limbs_list(value: int, n_limbs: int) -> tuple[int, ...]:
    return tuple((value >> (32 * i)) & MASK32 for i in range(n_limbs))


# --- uint32 storage <-> int64 arithmetic ----------------------------------


def widen(t: torch.Tensor) -> torch.Tensor:
    """``uint32`` limbs -> int64 limbs in ``[0, 2^32)`` (through an int32
    view: the conversion torch supports on every device)."""
    return t.view(torch.int32).to(torch.int64) & MASK32


def narrow(t: torch.Tensor) -> torch.Tensor:
    """int64 limbs in ``[0, 2^32)`` -> ``uint32`` limbs (two's-complement
    int32 bit pattern, viewed as uint32)."""
    return ((t ^ 0x80000000) - 0x80000000).to(torch.int32).view(torch.uint32)


def zeros_u32(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int32, device=device).view(torch.uint32)


def to_device_u32(arr: np.ndarray, device) -> torch.Tensor:
    """Host ``uint32`` array -> ``uint32`` tensor on ``device`` (a copy)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32)).to(device, copy=True).view(torch.uint32)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """``uint32`` tensor (any device) -> host ``uint32`` array."""
    return t.detach().view(torch.int32).cpu().numpy().view(np.uint32)


def store_(dst: torch.Tensor, limbs64: torch.Tensor) -> torch.Tensor:
    """Write int64 limbs into the ``uint32`` tensor ``dst`` in place."""
    dst.view(torch.int32).copy_(narrow(limbs64).view(torch.int32))
    return dst


# --- planar helpers: int64 limbs [L, n] -----------------------------------


def p_add(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Planar limbwise add with carry; returns (sum, carry)."""
    outs = []
    carry = torch.zeros_like(a[0])
    for j in range(a.shape[0]):
        s = a[j] + b[j] + carry
        outs.append(s & MASK32)
        carry = s >> 32
    return torch.stack(outs), carry


def p_sub(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Planar limbwise subtract with borrow; returns (diff, borrow)."""
    outs = []
    borrow = torch.zeros_like(a[0])
    for j in range(a.shape[0]):
        d = a[j] - b[j] - borrow
        outs.append(d & MASK32)
        borrow = (d < 0).to(torch.int64)
    return torch.stack(outs), borrow


def p_lt_const(a: torch.Tensor, const_limbs: tuple[int, ...]) -> torch.Tensor:
    lt = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    decided = torch.zeros_like(lt)
    for j in range(a.shape[0] - 1, -1, -1):
        o = int(const_limbs[j])
        lt = lt | (~decided & (a[j] < o))
        decided = decided | (a[j] != o)
    return lt


def _const_planar(const_limbs, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([int(c) for c in const_limbs], dtype=torch.int64, device=like.device)[
        :, None
    ].expand(len(const_limbs), *like.shape[1:])


def p_cond_sub_const(a: torch.Tensor, const_limbs: tuple[int, ...]) -> torch.Tensor:
    """Subtract the constant wherever ``a >= const`` (one fused pass)."""
    ge = ~p_lt_const(a, const_limbs)
    d, _ = p_sub(a, _const_planar(const_limbs, a))
    return torch.where(ge[None, :], d, a)


def p_mod_add(a: torch.Tensor, b: torch.Tensor, order: int) -> torch.Tensor:
    """Planar ``(a + b) mod order`` for ``a, b < order`` (handles 2^(32L))."""
    n_limb = a.shape[0]
    s, carry = p_add(a, b)
    if order == 1 << (32 * n_limb):
        return s  # wraparound IS the reduction
    ol = _int_to_limbs_list(order, n_limb)
    ge = (carry != 0) | ~p_lt_const(s, ol)
    d, _ = p_sub(s, _const_planar(ol, s))
    return torch.where(ge[None, :], d, s)


def p_mod_sub(a: torch.Tensor, b: torch.Tensor, order: int) -> torch.Tensor:
    """Planar ``(a - b) mod order`` for ``a, b < order``."""
    n_limb = a.shape[0]
    d, borrow = p_sub(a, b)
    if order == 1 << (32 * n_limb):
        return d
    ol = _int_to_limbs_list(order, n_limb)
    d2, _ = p_add(d, _const_planar(ol, d))
    return torch.where((borrow != 0)[None, :], d2, d)


def mod_sub_planar(a: torch.Tensor, b: torch.Tensor, order: int) -> torch.Tensor:
    """``(a - b) mod order`` over planar ``uint32[L, n]`` tensors -> a new
    ``uint32[L, n]`` tensor (the Unmask subtract, plain torch on any
    device; the JAX package runs it as the jitted ``p_mod_sub``)."""
    return narrow(p_mod_sub(widen(a), widen(b), order))


# --- the fold -------------------------------------------------------------


def check_fold_args(acc: torch.Tensor, stack: torch.Tensor, n_limb: int) -> None:
    """Shape/dtype/device checks shared by the kernel and its plain version."""
    if acc.dtype != torch.uint32 or acc.ndim != 2 or acc.shape[0] != n_limb:
        raise ValueError(f"acc must be uint32[{n_limb}, n], got {acc.dtype}{list(acc.shape)}")
    if stack.ndim != 3 or stack.shape[-1] != acc.shape[1]:
        raise ValueError("batch and accumulator model lengths differ")
    if stack.device != acc.device:
        raise ValueError("batch and accumulator live on different devices")
    if stack.shape[0] > MAX_LAZY_BATCH:
        raise ValueError(
            f"batch of {stack.shape[0]} exceeds lazy-carry headroom {MAX_LAZY_BATCH}"
        )


def fold_planar_batch(acc: torch.Tensor, stack_planar: torch.Tensor, order: int) -> torch.Tensor:
    """Fold planar ``uint32[K, L, n]`` updates into the planar ``[L, n]``
    accumulator, in place (kernel K1 on CUDA, its plain version on CPU)."""
    from . import kernels

    return kernels.fold_planar(acc, stack_planar, order)


def fold_packed_batch(
    acc: torch.Tensor, packed: torch.Tensor, n_limbs: int, order: int
) -> torch.Tensor:
    """Fold PACKED byte-planar ``uint8[K, bpn, n]`` updates into the planar
    ``[L, n]`` accumulator, in place: the limbs assemble from the byte
    planes inside the fold (K1's packed variant), so only ``bpn`` bytes per
    element cross host->device and are read from device memory."""
    from . import kernels

    if acc.shape[0] != n_limbs:
        raise ValueError("accumulator limb count differs from n_limbs")
    return kernels.fold_packed(acc, packed, order)


def wire_to_planar(stack: np.ndarray) -> np.ndarray:
    """Host: wire-layout ``[K, n, L]`` (or ``[n, L]``) -> planar ``[K, L, n]``."""
    stack = np.asarray(stack, dtype=np.uint32)
    if stack.ndim == 2:
        return np.ascontiguousarray(stack.T)
    return np.ascontiguousarray(stack.transpose(0, 2, 1))


def planar_to_wire(planar: np.ndarray) -> np.ndarray:
    """Host: planar ``[L, n]`` -> wire-layout ``[n, L]``."""
    return np.ascontiguousarray(np.asarray(planar).T)
