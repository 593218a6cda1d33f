"""Wire serialization of mask objects (numpy only).

Port of ``xaynet_tpu/core/mask/serialization.py``. Layouts (reference:
rust/xaynet-core/src/mask/object/serialization/):

- ``MaskVect``: config(4) ‖ count(u32 BE) ‖ count fixed-width little-endian
  integers of ``bytes_per_number`` each (vect.rs:24-80);
- ``MaskUnit``: config(4) ‖ one fixed-width little-endian integer (unit.rs);
- ``MaskObject``: vect ‖ unit (mod.rs).

Wire format v2 (packed planar): the top bit of the count word
(``WIRE_PLANAR_FLAG``) marks the element block as BYTE-PLANAR —
``bytes_per_number`` contiguous planes of ``count`` bytes each, plane ``b``
holding byte ``b`` of every element — instead of the v1 interleaved
per-element layout. Same byte budget, but the planar block is already the
packed layout K1's packed fold reads, so a device-ingest coordinator
uploads it as it is. Element counts stay far below 2^31, so the flag bit
never collides with a real count.

``parse_mask_vect(lazy=True)`` returns a ``LazyWireMaskVect`` over a
zero-copy view of the element block: no host element parse and no host
validity check; the device does both at ``validate_aggregation``.
"""

from __future__ import annotations

import struct

import numpy as np

from ...ops import limbs as limb_ops
from .config import MASK_CONFIG_LENGTH, MaskConfig
from .object import LazyWireMaskVect, MaskObject, MaskUnit, MaskVect


class DecodeError(ValueError):
    """Malformed wire bytes."""


# config(4) + count(u32 BE): everything before the element block
VECT_HEADER_LENGTH = MASK_CONFIG_LENGTH + 4

# top bit of the count word: element block is byte-planar (wire format v2)
WIRE_PLANAR_FLAG = 0x8000_0000


def _split_count_word(word: int) -> tuple[int, bool]:
    """(element count, planar?) from the wire count word."""
    return word & ~WIRE_PLANAR_FLAG, bool(word & WIRE_PLANAR_FLAG)


def _config_at(data: bytes, offset: int) -> MaskConfig:
    try:
        return MaskConfig.from_bytes(data[offset : offset + MASK_CONFIG_LENGTH])
    except ValueError as e:
        raise DecodeError(f"invalid mask config: {e}") from e


def planar_to_interleaved(block: np.ndarray, count: int, bpn: int) -> np.ndarray:
    """Byte-planar element block ``uint8[bpn * count]`` -> the v1 interleaved
    layout (one materializing transpose: the lazy vect's host fallback)."""
    return np.ascontiguousarray(np.asarray(block).reshape(bpn, count).T).reshape(-1)


def serialized_vect_length(config: MaskConfig, count: int) -> int:
    return VECT_HEADER_LENGTH + count * config.bytes_per_number


def vect_element_block(wire: bytes) -> np.ndarray:
    """The raw fixed-width element block of a serialized v1 MaskVect as a
    zero-copy uint8 view. Validates the header and the exact framed length
    like ``parse_mask_vect`` (a truncated buffer or a whole MaskObject wire
    raises ``DecodeError`` here, not as a shape error downstream)."""
    if len(wire) < VECT_HEADER_LENGTH:
        raise DecodeError("mask vector buffer too short")
    config = _config_at(wire, 0)
    (word,) = struct.unpack_from(">I", wire, MASK_CONFIG_LENGTH)
    count, planar = _split_count_word(word)
    if planar:
        raise DecodeError("planar (v2) element block where interleaved expected")
    if len(wire) != VECT_HEADER_LENGTH + count * config.bytes_per_number:
        raise DecodeError("wire length does not match the framed element count")
    return np.frombuffer(wire, dtype=np.uint8)[VECT_HEADER_LENGTH:]


def serialize_mask_vect(vect: MaskVect, planar: bool = False) -> bytes:
    bpn = vect.config.bytes_per_number
    if not planar:
        return (
            vect.config.to_bytes()
            + struct.pack(">I", len(vect))
            + limb_ops.limbs_to_bytes_le(vect.data, bpn)
        )
    if isinstance(vect, LazyWireMaskVect) and vect.planar and not vect.materialized:
        # parsed from planar wire and never touched: re-emit the block
        block = np.asarray(vect.wire_block).tobytes()
    else:
        interleaved = limb_ops.limbs_to_bytes_le(vect.data, bpn)
        block = np.ascontiguousarray(
            np.frombuffer(interleaved, dtype=np.uint8).reshape(len(vect), bpn).T
        ).tobytes()
    return vect.config.to_bytes() + struct.pack(">I", len(vect) | WIRE_PLANAR_FLAG) + block


def parse_mask_vect(data: bytes, offset: int = 0, lazy: bool = False) -> tuple[MaskVect, int]:
    """Parse a MaskVect at ``offset``; returns (vect, bytes consumed).

    ``lazy=True`` (device-ingest coordinators) skips the host limb
    materialization AND the host element-validity check, returning a
    ``LazyWireMaskVect`` over the raw element block; element validity then
    happens on the device in ``validate_aggregation`` (or at the first host
    materialization), one stage later than the eager parse's
    ``DecodeError``.
    """
    if len(data) - offset < VECT_HEADER_LENGTH:
        raise DecodeError("mask vector buffer too short")
    config = _config_at(data, offset)
    (word,) = struct.unpack_from(">I", data, offset + MASK_CONFIG_LENGTH)
    count, planar = _split_count_word(word)
    bpn = config.bytes_per_number
    start = offset + VECT_HEADER_LENGTH
    end = start + count * bpn
    if len(data) < end:
        raise DecodeError("mask vector data truncated")
    raw = np.frombuffer(data, dtype=np.uint8, count=count * bpn, offset=start)
    if lazy:
        return LazyWireMaskVect(config, raw, count, planar=planar), end - offset
    if planar:
        raw = planar_to_interleaved(raw, count, bpn)
    vect = MaskVect(config, limb_ops.bytes_le_to_limbs(raw, count, bpn))
    if not vect.is_valid():
        raise DecodeError("mask vector element >= group order")
    return vect, end - offset


def parse_mask_vect_stream(reader, lazy: bool = False) -> MaskVect:
    """Streaming MaskVect parse from a ``ChunkReader`` (the multipart
    message reader): the element block is copied chunk by chunk into one
    staging array, so peak memory is about one element block.

    ``lazy=True`` gathers the element bytes with one byte copy into a
    ``LazyWireMaskVect`` (no limb conversion, no host validity), as
    ``parse_mask_vect(lazy=True)`` does for a single-part message.
    """
    head = reader.read(VECT_HEADER_LENGTH)
    config = _config_at(head, 0)
    (word,) = struct.unpack_from(">I", head, MASK_CONFIG_LENGTH)
    count, planar = _split_count_word(word)
    bpn = config.bytes_per_number
    nbytes = count * bpn
    if nbytes > reader.remaining:
        raise DecodeError("mask vector data truncated")
    if lazy or planar:
        # a plane-major block cannot feed the element-major segments below
        raw = np.empty(nbytes, dtype=np.uint8)
        reader.read_into(raw)
        if lazy:
            return LazyWireMaskVect(config, raw, count, planar=planar)
        limbs = limb_ops.bytes_le_to_limbs(planar_to_interleaved(raw, count, bpn), count, bpn)
    else:
        # fixed-size wire segments go straight into the limb array, so the
        # transient staging stays bounded
        limbs = np.empty((count, limb_ops.n_limbs_for_bytes(bpn)), dtype=np.uint32)
        seg_elems = max(1, (2 << 20) // max(bpn, 1))
        for s in range(0, count, seg_elems):
            k = min(seg_elems, count - s)
            staging = np.empty(k * bpn, dtype=np.uint8)
            reader.read_into(staging)
            limbs[s : s + k] = limb_ops.bytes_le_to_limbs(staging, k, bpn)
    vect = MaskVect(config, limbs)
    if not vect.is_valid():
        raise DecodeError("mask vector element >= group order")
    return vect


def parse_mask_unit_stream(reader) -> MaskUnit:
    """Streaming MaskUnit parse from a ``ChunkReader``."""
    config = _config_at(reader.read(MASK_CONFIG_LENGTH), 0)
    bpn = config.bytes_per_number
    if bpn > reader.remaining:
        raise DecodeError("mask unit data truncated")
    limbs = limb_ops.bytes_le_to_limbs(np.frombuffer(reader.read(bpn), dtype=np.uint8), 1, bpn)
    unit = MaskUnit(config, limbs[0])
    if not unit.is_valid():
        raise DecodeError("mask unit element >= group order")
    return unit


def serialize_mask_unit(unit: MaskUnit) -> bytes:
    bpn = unit.config.bytes_per_number
    return unit.config.to_bytes() + limb_ops.limbs_to_bytes_le(unit.data[None, :], bpn)


def parse_mask_unit(data: bytes, offset: int = 0) -> tuple[MaskUnit, int]:
    if len(data) - offset < MASK_CONFIG_LENGTH:
        raise DecodeError("mask unit buffer too short")
    config = _config_at(data, offset)
    bpn = config.bytes_per_number
    start = offset + MASK_CONFIG_LENGTH
    if len(data) < start + bpn:
        raise DecodeError("mask unit data truncated")
    limbs = limb_ops.bytes_le_to_limbs(
        np.frombuffer(data, dtype=np.uint8, count=bpn, offset=start), 1, bpn
    )
    unit = MaskUnit(config, limbs[0])
    if not unit.is_valid():
        raise DecodeError("mask unit element >= group order")
    return unit, MASK_CONFIG_LENGTH + bpn


def serialize_mask_object(obj: MaskObject, planar_vect: bool = False) -> bytes:
    """``planar_vect`` emits the VECTOR part in the v2 byte-planar layout
    (the unit part is one element: planes would only relabel it)."""
    return serialize_mask_vect(obj.vect, planar=planar_vect) + serialize_mask_unit(obj.unit)


def parse_mask_object(
    data: bytes, offset: int = 0, lazy_vect: bool = False
) -> tuple[MaskObject, int]:
    vect, n1 = parse_mask_vect(data, offset, lazy=lazy_vect)
    unit, n2 = parse_mask_unit(data, offset + n1)
    return MaskObject(vect, unit), n1 + n2


def serialized_object_length(config, count: int) -> int:
    return (
        serialized_vect_length(config.vect, count)
        + MASK_CONFIG_LENGTH
        + config.unit.bytes_per_number
    )
