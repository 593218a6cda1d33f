"""Multi-limb finite-group arithmetic over numpy arrays (host path).

The reference stores masked models as ``Vec<BigUint>`` and aggregates them
with per-element big-integer modular adds (reference:
rust/xaynet-core/src/mask/masking.rs:292-316). This package represents a
mask object as a fixed-width limb tensor

    ``uint32[n, L]``  (limb 0 = least-significant 32 bits)

so that aggregation is a flat, branch-free, vectorizable elementwise kernel:
limb add with carry propagation followed by a conditional subtract of the
group order. This module is the numpy host implementation (the width math,
the wire codec, the packed byte-planar staging codec and the host modular
ops); the device fold lives in ``ops.fold`` and its CUDA kernels.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_U64 = np.uint64
_MASK32 = np.uint64(0xFFFFFFFF)


def wire_width_for(order: int) -> int:
    """THE wire/pack width of one group element, in bytes:
    ``bytes_per_number = ceil(bits(order - 1) / 8)``.

    The single source of truth for width math in this package: the packed
    planar codec, the wire serializers, ``MaskConfig.bytes_per_number`` and
    the device fold all derive from here.
    """
    return max(1, ((order - 1).bit_length() + 7) // 8)


def draw_width_for(order: int) -> int:
    """The rejection-sampler DRAW width in bytes: the byte length of the
    order *itself* (the reference sizes its candidate buffer with
    ``max_int.to_bytes_le()``), which exceeds :func:`wire_width_for` when
    the order is a power of two at a byte boundary (e.g. 2^88, 2^96)."""
    return (order.bit_length() + 7) // 8


def n_limbs_for_bytes(nbytes: int) -> int:
    """Byte width -> uint32 limb count (whole limbs)."""
    return max(1, (nbytes + 3) // 4)


def n_limbs_for_order(order: int) -> int:
    """Number of 32-bit limbs for elements of the group of this order.

    Matches the wire width: ``bytes_per_number = ceil(bits(order - 1) / 8)``
    rounded up to whole limbs.
    """
    return n_limbs_for_bytes(wire_width_for(order))


def order_limbs_for(order: int) -> np.ndarray:
    """Group order as an L-limb constant for the modular kernels.

    When the order is exactly ``2^(32L)`` (e.g. 2^96 from the catalogue) it
    does not fit L limbs; the kernels then see all-zero limbs, which is
    correct: the reduction condition degenerates to the carry bit and the
    conditional subtract becomes the natural wraparound.
    """
    n_limb = n_limbs_for_order(order)
    if order == 1 << (32 * n_limb):
        return np.zeros(n_limb, dtype=_U32)
    return int_to_limbs(order, n_limb)


def all_lt_order(data: np.ndarray, order: int) -> bool:
    """Whether every ``uint32[..., L]`` element is below ``order`` (the
    per-update validity check)."""
    n_limb = n_limbs_for_order(order)
    if order == 1 << (32 * n_limb):
        return True
    flat = np.ascontiguousarray(data.reshape(-1, n_limb), dtype=_U32)
    return bool(np.all(lt_const(flat, int_to_limbs(order, n_limb))))


def elements_lt_order(data: np.ndarray, order: int) -> np.ndarray:
    """Per-row validity ``element < order`` handling the 2^(32L) boundary."""
    n_limb = n_limbs_for_order(order)
    if order == 1 << (32 * n_limb):
        return np.ones(data.shape[:-1], dtype=bool)
    return lt_const(data, int_to_limbs(order, n_limb))


def int_to_limbs(value: int, n_limbs: int) -> np.ndarray:
    out = np.zeros(n_limbs, dtype=_U32)
    for i in range(n_limbs):
        out[i] = (value >> (32 * i)) & 0xFFFFFFFF
    if value >> (32 * n_limbs):
        raise OverflowError("value does not fit in the limb width")
    return out


def limbs_to_int(limbs: np.ndarray) -> int:
    value = 0
    for i in range(limbs.shape[-1] - 1, -1, -1):
        value = (value << 32) | int(limbs[..., i])
    return value


def ints_to_limbs(values, n_limbs: int) -> np.ndarray:
    """Convert an iterable of python ints to a ``uint32[n, L]`` limb array."""
    values = list(values)
    out = np.zeros((len(values), n_limbs), dtype=_U32)
    for i, v in enumerate(values):
        for j in range(n_limbs):
            out[i, j] = (v >> (32 * j)) & 0xFFFFFFFF
        if v >> (32 * n_limbs):
            raise OverflowError("value does not fit in the limb width")
    return out


def limbs_to_ints(arr: np.ndarray) -> list[int]:
    arr = np.asarray(arr, dtype=_U32)
    n, n_limb = arr.shape
    out = [0] * n
    for j in range(n_limb - 1, -1, -1):
        col = arr[:, j]
        for i in range(n):
            out[i] = (out[i] << 32) | int(col[i])
    return out


def bytes_le_to_limbs(buf: bytes | np.ndarray, count: int, bytes_per_number: int) -> np.ndarray:
    """Parse ``count`` fixed-width little-endian integers into ``uint32[count, L]``."""
    n_limb = n_limbs_for_bytes(bytes_per_number)
    raw = np.frombuffer(buf, dtype=np.uint8, count=count * bytes_per_number)
    padded = np.zeros((count, n_limb * 4), dtype=np.uint8)
    padded[:, :bytes_per_number] = raw.reshape(count, bytes_per_number)
    return padded.view("<u4").astype(_U32, copy=False)


def limbs_to_bytes_le(arr: np.ndarray, bytes_per_number: int) -> bytes:
    """Serialize ``uint32[n, L]`` limbs as fixed-width little-endian integers."""
    arr = np.ascontiguousarray(np.asarray(arr, dtype=_U32))
    raw = arr.astype("<u4", copy=False).view(np.uint8).reshape(arr.shape[0], -1)
    return raw[:, :bytes_per_number].tobytes()


def lt_const(a: np.ndarray, order_limbs: np.ndarray) -> np.ndarray:
    """Lexicographic ``a < order`` per element, over the trailing limb axis."""
    shape = a.shape[:-1]
    lt = np.zeros(shape, dtype=bool)
    decided = np.zeros(shape, dtype=bool)
    for j in range(a.shape[-1] - 1, -1, -1):
        col = a[..., j]
        o = order_limbs[j]
        lt |= (~decided) & (col < o)
        decided |= col != o
    return lt


def add_limbs(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Limbwise ``a + b`` with carry propagation; returns (sum, carry_out)."""
    n_limb = a.shape[-1]
    out = np.empty_like(a)
    carry = np.zeros(a.shape[:-1], dtype=_U64)
    for j in range(n_limb):
        s = a[..., j].astype(_U64) + b[..., j].astype(_U64) + carry
        out[..., j] = (s & _MASK32).astype(_U32)
        carry = s >> np.uint64(32)
    return out, carry.astype(_U32)


def sub_limbs(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Limbwise ``a - b`` with borrow propagation; returns (diff, borrow_out)."""
    n_limb = a.shape[-1]
    out = np.empty_like(a)
    borrow = np.zeros(a.shape[:-1], dtype=_U64)
    for j in range(n_limb):
        d = a[..., j].astype(_U64) - b[..., j].astype(_U64) - borrow
        out[..., j] = (d & _MASK32).astype(_U32)
        borrow = (d >> np.uint64(63)) & np.uint64(1)  # underflow wraps in u64
    return out, borrow.astype(_U32)


def mod_add(a: np.ndarray, b: np.ndarray, order_limbs: np.ndarray) -> np.ndarray:
    """``(a + b) mod order`` assuming ``a, b < order`` (branch-free)."""
    s, carry = add_limbs(a, b)
    # sum >= order  <=>  carry set (sum overflowed the limb width) or s >= order
    ge = carry.astype(bool) | ~lt_const(s, order_limbs)
    d, _ = sub_limbs(s, np.broadcast_to(order_limbs, s.shape))
    return np.where(ge[..., None], d, s)


def mod_sub(a: np.ndarray, b: np.ndarray, order_limbs: np.ndarray) -> np.ndarray:
    """``(a - b) mod order`` assuming ``a, b < order``."""
    d, borrow = sub_limbs(a, b)
    d2, _ = add_limbs(d, np.broadcast_to(order_limbs, d.shape))
    return np.where(borrow.astype(bool)[..., None], d2, d)


def batch_mod_sum(stack: np.ndarray, order_limbs: np.ndarray) -> np.ndarray:
    """Modular sum over axis 0 of ``uint32[K, n, L]``: a pairwise tree
    reduce — each pairwise step keeps every element ``< order``, so the
    depth is ``ceil(log2 K)`` and every level is a flat elementwise op."""
    while stack.shape[0] > 1:
        k = stack.shape[0]
        half = k // 2
        merged = mod_add(stack[:half], stack[half : 2 * half], order_limbs)
        if k % 2:
            merged = np.concatenate([merged, stack[2 * half :]], axis=0)
        stack = merged
    return stack[0]


def pack_planar(planar: np.ndarray, bpn: int, out: np.ndarray | None = None) -> np.ndarray:
    """Planar ``uint32[..., L, n]`` -> packed byte-planar ``uint8[..., bpn, n]``.

    Elements must be < 2^(8*bpn) (i.e. validated group elements); higher
    bytes are DROPPED by design.
    """
    planar = np.asarray(planar, dtype=_U32)
    n_limb, n = planar.shape[-2], planar.shape[-1]
    if bpn > 4 * n_limb:
        raise ValueError("pack width exceeds the limb width")
    if out is None:
        out = np.empty((*planar.shape[:-2], bpn, n), dtype=np.uint8)
    if planar.flags.c_contiguous:
        # little-endian u32 planes viewed as bytes: element i's byte b lives
        # at [..., b // 4, 4 * i + (b % 4)] — one strided plane copy per
        # byte-plane, no arithmetic temporaries
        raw = planar.view(np.uint8)
        for b in range(bpn):
            out[..., b, :] = raw[..., b // 4, b % 4 :: 4]
    else:
        for b in range(bpn):
            out[..., b, :] = (
                (planar[..., b // 4, :] >> _U32(8 * (b % 4))) & _U32(0xFF)
            ).astype(np.uint8)
    return out


def pack_wire(stack: np.ndarray, bpn: int, out: np.ndarray | None = None) -> np.ndarray:
    """Wire-layout ``uint32[..., n, L]`` -> packed byte-planar
    ``uint8[..., bpn, n]``: byte b of element i is byte ``b`` of its
    little-endian wire row (one strided numpy transpose copy)."""
    stack = np.ascontiguousarray(stack, dtype=_U32)
    n_limb = stack.shape[-1]
    if bpn > 4 * n_limb:
        raise ValueError("pack width exceeds the limb width")
    if out is None:
        out = np.empty((*stack.shape[:-2], bpn, stack.shape[-2]), dtype=np.uint8)
    raw = stack.view(np.uint8)  # [..., n, 4L]
    out[...] = np.moveaxis(raw[..., :bpn], -1, -2)
    return out


def unpack_planar(packed: np.ndarray, n_limbs: int, out: np.ndarray | None = None) -> np.ndarray:
    """Packed byte-planar ``uint8[..., bpn, n]`` -> planar ``uint32[..., L, n]``."""
    packed = np.asarray(packed, dtype=np.uint8)
    bpn, n = packed.shape[-2], packed.shape[-1]
    if n_limbs < n_limbs_for_bytes(bpn):
        raise ValueError("limb width too small for the packed width")
    if out is None or not out.flags.c_contiguous:
        out = np.zeros((*packed.shape[:-2], n_limbs, n), dtype=_U32)
    else:
        out[...] = 0
    raw = out.view(np.uint8)
    for b in range(bpn):
        raw[..., b // 4, b % 4 :: 4] = packed[..., b, :]
    return out
