"""Masking configurations: finite-group catalogue and fixed-point shifts.

Reimplements the reference's `MaskConfig` surface (reference:
rust/xaynet-core/src/mask/config/mod.rs:41-231): the
(GroupType x DataType x BoundType x ModelType) grid, the derived
``add_shift`` (weight bound), ``exp_shift`` (fixed-point scale),
``bytes_per_number`` (wire width) and the 240-entry group-order catalogue
(protocol constants, generated into ``_orders_data.py``).

Wire encoding is 4 bytes: [group, data, bound, model] (reference:
rust/xaynet-core/src/mask/config/serialization.rs:19-23).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from enum import IntEnum
from fractions import Fraction
from functools import cached_property

from ._orders_data import ORDERS

MASK_CONFIG_LENGTH = 4

_F32_MAX = int(2**128 - 2**104)  # f32::MAX is an exact integer
_F64_MAX = int(2**1024 - 2**971)  # f64::MAX is an exact integer


class InvalidMaskConfigError(ValueError):
    """A serialized masking configuration field is out of range."""


class GroupType(IntEnum):
    INTEGER = 0
    PRIME = 1
    POWER2 = 2


class DataType(IntEnum):
    F32 = 0
    F64 = 1
    I32 = 2
    I64 = 3


class BoundType(IntEnum):
    B0 = 0
    B2 = 2
    B4 = 4
    B6 = 6
    BMAX = 255


class ModelType(IntEnum):
    M3 = 3
    M6 = 6
    M9 = 9
    M12 = 12

    @property
    def max_nb_models(self) -> int:
        return 10**int(self)


_GROUP_KEY = {GroupType.INTEGER: "Integer", GroupType.PRIME: "Prime", GroupType.POWER2: "Power2"}
_DATA_KEY = {DataType.F32: "F32", DataType.F64: "F64", DataType.I32: "I32", DataType.I64: "I64"}
_BOUND_KEY = {
    BoundType.B0: "B0",
    BoundType.B2: "B2",
    BoundType.B4: "B4",
    BoundType.B6: "B6",
    BoundType.BMAX: "Bmax",
}
_MODEL_KEY = {ModelType.M3: "M3", ModelType.M6: "M6", ModelType.M9: "M9", ModelType.M12: "M12"}


def _is_probable_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (fixed witness set); the
    same fixed witnesses above that — a strong-probable-prime test. The
    protocol property that matters is DETERMINISM (coordinator and every
    participant compute the identical order from the same config bytes);
    the witness set is exhaustive for every f32/i32 quantized order."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _next_prime(n: int) -> int:
    if n <= 2:
        return 2
    c = n | 1  # first odd >= n
    while not _is_probable_prime(c):
        c += 2
    return c


@dataclass(frozen=True)
class MaskConfig:
    """A masking configuration (hashable, usable as a dict key).

    ``quant`` is the pre-mask quantization level (docs/DESIGN.md §17):
    level q divides the fixed-point scale ``exp_shift`` by ``10^q``, which
    shrinks the derived group order — and with it the limb count, the wire
    width, the mask derivation cost and every fold/transfer byte —
    proportionally, at the price of ``10^q`` coarser weights. ``quant = 0``
    (the default) is the exact catalogue config; quantized orders are
    DERIVED from the reference's own construction (Integer: the exact
    range product; Prime: next prime; Power2: next power of two).
    """

    group_type: GroupType
    data_type: DataType
    bound_type: BoundType
    model_type: ModelType
    quant: int = 0

    def __post_init__(self) -> None:
        # the scale ceiling (exp_shift would underflow past it) AND the
        # wire ceiling (quant rides a nibble in to_bytes, so levels > 15
        # are unannouncable — only BMAX scales are deep enough to hit it)
        ceiling = min(15, self._exp_shift_pow())
        if not (0 <= self.quant <= ceiling):
            raise InvalidMaskConfigError(
                f"quant must be in [0, {ceiling}] for this "
                f"data/bound type, got {self.quant}"
            )

    def _exp_shift_pow(self) -> int:
        """log10 of the UNQUANTIZED fixed-point scale (the quant ceiling)."""
        if self.data_type is DataType.F32:
            return 45 if self.bound_type is BoundType.BMAX else 10
        if self.data_type is DataType.F64:
            return 324 if self.bound_type is BoundType.BMAX else 20
        return 10

    @cached_property
    def order(self) -> int:
        """The finite-group order (protocol constant; derived for
        quantized configs)."""
        if self.quant == 0:
            return ORDERS[
                (
                    _GROUP_KEY[self.group_type],
                    _DATA_KEY[self.data_type],
                    _BOUND_KEY[self.bound_type],
                    _MODEL_KEY[self.model_type],
                )
            ]
        # the reference's order construction (mod.rs:234-635) at the
        # quantized scale: the group must represent every aggregate of
        # max_nb_models encoded values in [0, 2 * add_shift * exp_shift]
        base = 2 * int(self.add_shift) * self.exp_shift * self.max_nb_models + 1
        if self.group_type is GroupType.INTEGER:
            return base
        if self.group_type is GroupType.POWER2:
            return 1 << (base - 1).bit_length()
        return _next_prime(base)

    @cached_property
    def add_shift(self) -> Fraction:
        """Additive shift bound: weights are clamped to [-add_shift, add_shift]."""
        if self.bound_type is BoundType.B0:
            return Fraction(1)
        if self.bound_type is BoundType.B2:
            return Fraction(100)
        if self.bound_type is BoundType.B4:
            return Fraction(10_000)
        if self.bound_type is BoundType.B6:
            return Fraction(1_000_000)
        # BMAX: the data type's maximum absolute value, exactly
        if self.data_type is DataType.F32:
            return Fraction(_F32_MAX)
        if self.data_type is DataType.F64:
            return Fraction(_F64_MAX)
        if self.data_type is DataType.I32:
            return Fraction(2**31)
        return Fraction(2**63)

    @cached_property
    def exp_shift(self) -> int:
        """Fixed-point scale: weights are quantized to 1/exp_shift steps
        (divided by ``10^quant`` for quantized rounds)."""
        return 10 ** (self._exp_shift_pow() - self.quant)

    @cached_property
    def bytes_per_number(self) -> int:
        """Fixed wire width of one group element (the single source of
        truth lives in ops/limbs.wire_width_for)."""
        from ...ops.limbs import wire_width_for

        return wire_width_for(self.order)

    @property
    def max_nb_models(self) -> int:
        return self.model_type.max_nb_models

    # --- wire format -----------------------------------------------------

    def to_bytes(self) -> bytes:
        # the quant level rides the unused high nibble of the model byte
        # (ModelType values are 3..12): quant = 0 serializes byte-identically
        # to the reference wire format, so unquantized golden vectors and
        # old readers are untouched. Levels > 15 are unrepresentable;
        # __post_init__ enforces the same ceiling at construction, so this
        # is a defensive invariant, not a reachable path.
        if self.quant > 15:
            raise InvalidMaskConfigError("quant > 15 has no wire encoding")
        return struct.pack(
            "BBBB",
            int(self.group_type),
            int(self.data_type),
            int(self.bound_type),
            int(self.model_type) | (self.quant << 4),
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "MaskConfig":
        if len(data) < MASK_CONFIG_LENGTH:
            raise InvalidMaskConfigError("mask config buffer too short")
        g, d, b, m = struct.unpack_from("BBBB", data)
        try:
            return cls(
                GroupType(g), DataType(d), BoundType(b), ModelType(m & 0x0F), m >> 4
            )
        except ValueError as e:
            raise InvalidMaskConfigError(str(e)) from e

    def pair(self) -> "MaskConfigPair":
        return MaskConfigPair(vect=self, unit=self)


@dataclass(frozen=True)
class MaskConfigPair:
    """Masking configurations for (vector of weights, unit scalar)."""

    vect: MaskConfig
    unit: MaskConfig

    def to_bytes(self) -> bytes:
        return self.vect.to_bytes() + self.unit.to_bytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "MaskConfigPair":
        return cls(
            vect=MaskConfig.from_bytes(data[:MASK_CONFIG_LENGTH]),
            unit=MaskConfig.from_bytes(data[MASK_CONFIG_LENGTH : 2 * MASK_CONFIG_LENGTH]),
        )
