"""Mask objects: masked models / masks as fixed-width limb tensors.

Reference shape (rust/xaynet-core/src/mask/object/mod.rs:24,65,117):
``MaskVect`` (vector of group elements) + ``MaskUnit`` (one group element for
the masked scalar) compose a ``MaskObject``. Validity means every element is
below the configured group order.

Representation: elements live as ``uint32[n, L]`` limb arrays
(little-endian limb order) — the exact layout the aggregation kernels and the
wire codec consume — instead of python bignums.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...ops import limbs as limb_ops
from .config import MaskConfig, MaskConfigPair


class InvalidMaskObjectError(ValueError):
    """Mask object data does not satisfy its masking configuration."""


def _order_limbs(config: MaskConfig) -> np.ndarray:
    return limb_ops.order_limbs_for(config.order)


@dataclass
class MaskVect:
    """A vector of finite-group elements with its masking configuration."""

    config: MaskConfig
    data: np.ndarray  # uint32[n, L]

    @classmethod
    def from_ints(cls, config: MaskConfig, values) -> "MaskVect":
        n_limb = limb_ops.n_limbs_for_order(config.order)
        return cls(config, limb_ops.ints_to_limbs(values, n_limb))

    @classmethod
    def new(cls, config: MaskConfig, values) -> "MaskVect":
        obj = cls.from_ints(config, values) if not isinstance(values, np.ndarray) else cls(config, values)
        if not obj.is_valid():
            raise InvalidMaskObjectError("mask vector element >= group order")
        return obj

    def to_ints(self) -> list[int]:
        return limb_ops.limbs_to_ints(self.data)

    def __len__(self) -> int:
        return self.data.shape[0]

    def is_valid(self) -> bool:
        if self.data.ndim != 2:
            return False
        n_limb = limb_ops.n_limbs_for_order(self.config.order)
        if self.data.shape[1] != n_limb:
            return False
        return limb_ops.all_lt_order(self.data, self.config.order)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, MaskVect)
            and self.config == other.config
            and self.data.shape == other.data.shape
            and bool(np.array_equal(self.data, other.data))
        )


class LazyWireMaskVect(MaskVect):
    """A ``MaskVect`` parsed from wire with limb materialization DEFERRED.

    Carries the raw fixed-width element block (``wire_block``, a zero-copy
    uint8 view of the message) so a device-ingest coordinator unpacks and
    validity-checks it on the card (``DeviceAggregator.validate_wire_updates``
    / ``validate_planar_updates``) without ever running the host element
    parse. Any host access to ``data`` materializes the limbs exactly like
    the eager parse would have; ``is_valid()`` then applies the same element
    rule. The eager parse rejects invalid elements with ``DecodeError`` at
    parse time; the lazy path defers that rejection to
    ``validate_aggregation`` (device) or the first host materialization —
    the same update rejected, one stage later.
    """

    def __init__(
        self, config: MaskConfig, wire_block: np.ndarray, count: int, planar: bool = False
    ):
        self.config = config
        self.wire_block = wire_block  # uint8[count * bytes_per_number]
        self._count = count
        # wire format v2: the block is byte-planar (bpn planes of count
        # bytes) instead of interleaved — already the packed staging layout
        self.planar = planar
        self._data: np.ndarray | None = None
        # the device row cached by StagedAggregator.validate_aggregation /
        # prevalidate_wire_batch (planar uint32[L, n] for v1, packed
        # uint8[bpn, n] for v2) so stage() never re-uploads; _wire_invalid
        # is a cached REJECTED verdict from a batch prevalidation
        # (validate_aggregation raises on it without another device trip)
        self._staged_planar = None
        self._wire_invalid = False

    @property
    def materialized(self) -> bool:
        return self._data is not None

    @property
    def planar_block(self) -> np.ndarray:
        """Zero-copy ``uint8[bpn, count]`` view of a v2 planar element block
        (the layout the device validity check and K1's packed fold read)."""
        if not self.planar:
            raise ValueError("planar_block on an interleaved (v1) wire vect")
        return np.asarray(self.wire_block).reshape(self.config.bytes_per_number, self._count)

    @property  # type: ignore[override]
    def data(self) -> np.ndarray:
        if self._data is None:
            block = np.asarray(self.wire_block)
            bpn = self.config.bytes_per_number
            if self.planar:
                from .serialization import planar_to_interleaved

                block = planar_to_interleaved(block, self._count, bpn)
            self._data = limb_ops.bytes_le_to_limbs(block, self._count, bpn)
        return self._data

    def __len__(self) -> int:
        return self._count


@dataclass
class MaskUnit:
    """A single finite-group element (the masked scalar) with its config."""

    config: MaskConfig
    data: np.ndarray  # uint32[L]

    @classmethod
    def from_int(cls, config: MaskConfig, value: int) -> "MaskUnit":
        n_limb = limb_ops.n_limbs_for_order(config.order)
        return cls(config, limb_ops.int_to_limbs(value, n_limb))

    @classmethod
    def new(cls, config: MaskConfig, value: int) -> "MaskUnit":
        obj = cls.from_int(config, value)
        if not obj.is_valid():
            raise InvalidMaskObjectError("mask unit element >= group order")
        return obj

    def to_int(self) -> int:
        return limb_ops.limbs_to_int(self.data)

    def is_valid(self) -> bool:
        n_limb = limb_ops.n_limbs_for_order(self.config.order)
        if self.data.shape != (n_limb,):
            return False
        return bool(limb_ops.elements_lt_order(self.data[None, :], self.config.order)[0])

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, MaskUnit)
            and self.config == other.config
            and bool(np.array_equal(self.data, other.data))
        )


@dataclass
class MaskObject:
    """A masked model (or mask): vector part + unit (scalar) part."""

    vect: MaskVect
    unit: MaskUnit

    @classmethod
    def new(cls, config: MaskConfigPair, vect_values, unit_value: int) -> "MaskObject":
        return cls(MaskVect.new(config.vect, vect_values), MaskUnit.new(config.unit, unit_value))

    @classmethod
    def empty(cls, config: MaskConfigPair, size: int) -> "MaskObject":
        n_limb_v = limb_ops.n_limbs_for_order(config.vect.order)
        n_limb_u = limb_ops.n_limbs_for_order(config.unit.order)
        return cls(
            MaskVect(config.vect, np.zeros((size, n_limb_v), dtype=np.uint32)),
            MaskUnit(config.unit, np.zeros(n_limb_u, dtype=np.uint32)),
        )

    @property
    def config(self) -> MaskConfigPair:
        return MaskConfigPair(vect=self.vect.config, unit=self.unit.config)

    def __len__(self) -> int:
        return len(self.vect)

    def is_valid(self) -> bool:
        return self.vect.is_valid() and self.unit.is_valid()

    def __eq__(self, other) -> bool:
        return isinstance(other, MaskObject) and self.vect == other.vect and self.unit == other.unit
