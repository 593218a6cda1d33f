"""PET message payloads: Sum, Update, Sum2, Chunk.

Layouts (reference: rust/xaynet-core/src/message/payload/):

- Sum (sum.rs): sum_signature(64) ‖ ephm_pk(32)
- Update (update.rs): sum_signature(64) ‖ update_signature(64) ‖
  masked model (MaskObject) ‖ local seed dict (LV-encoded, 112 B/entry)
- Sum2 (sum2.rs): sum_signature(64) ‖ aggregated mask (MaskObject)
- Chunk (chunk.rs): id(u16 BE) ‖ message_id(u16 BE) ‖ flags(1, bit0 =
  LAST_CHUNK) ‖ reserved(3) ‖ data

Length-Value items use a 4-byte big-endian length that *includes* the
length field itself (reference: rust/xaynet-core/src/message/traits.rs:126-160).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Union

from ..mask.object import MaskObject
from ..mask.seed import ENCRYPTED_MASK_SEED_LENGTH, EncryptedMaskSeed
from ..mask.serialization import (
    DecodeError,
    parse_mask_object,
    parse_mask_unit_stream,
    parse_mask_vect_stream,
    serialize_mask_object,
)

SIGNATURE_LENGTH = 64
PK_LENGTH = 32
SEED_DICT_ENTRY_LENGTH = PK_LENGTH + ENCRYPTED_MASK_SEED_LENGTH  # 112
CHUNK_HEADER_LENGTH = 8

LocalSeedDict = dict  # bytes (sum pk, 32) -> EncryptedMaskSeed


# --- Length-Value helpers ---------------------------------------------------


def lv_encode(value: bytes) -> bytes:
    return struct.pack(">I", len(value) + 4) + value


def lv_decode(data: bytes, offset: int = 0) -> tuple[bytes, int]:
    """Returns (value, total bytes consumed incl. the length field)."""
    if len(data) - offset < 4:
        raise DecodeError("LV item truncated (no length field)")
    (length,) = struct.unpack_from(">I", data, offset)
    if length < 4:
        raise DecodeError("LV length below minimum")
    if len(data) - offset < length:
        raise DecodeError("LV value truncated")
    return data[offset + 4 : offset + length], length


def serialize_local_seed_dict(seed_dict: dict) -> bytes:
    body = bytearray()
    for pk, seed in seed_dict.items():
        if len(pk) != PK_LENGTH:
            raise ValueError("seed dict key must be a 32-byte public key")
        seed_bytes = seed.as_bytes() if isinstance(seed, EncryptedMaskSeed) else bytes(seed)
        if len(seed_bytes) != ENCRYPTED_MASK_SEED_LENGTH:
            raise ValueError("seed dict value must be an 80-byte encrypted seed")
        body += pk + seed_bytes
    return lv_encode(bytes(body))


def parse_local_seed_dict(data: bytes, offset: int = 0) -> tuple[dict, int]:
    value, consumed = lv_decode(data, offset)
    return _seed_dict_from_value(value), consumed


def _seed_dict_from_value(value: bytes) -> dict:
    if len(value) % SEED_DICT_ENTRY_LENGTH != 0:
        raise DecodeError("seed dict length not a multiple of the entry size")
    out: dict = {}
    for i in range(0, len(value), SEED_DICT_ENTRY_LENGTH):
        pk = value[i : i + PK_LENGTH]
        seed = EncryptedMaskSeed(value[i + PK_LENGTH : i + SEED_DICT_ENTRY_LENGTH])
        if pk in out:
            raise DecodeError("duplicate sum pk in seed dict")
        out[pk] = seed
    return out


def parse_local_seed_dict_stream(reader) -> dict:
    (length,) = struct.unpack(">I", reader.read(4))
    if length < 4:
        raise DecodeError("LV length below minimum")
    if length - 4 > reader.remaining:
        raise DecodeError("LV value truncated")
    return _seed_dict_from_value(reader.read(length - 4))


# --- payloads ---------------------------------------------------------------


@dataclass
class Sum:
    sum_signature: bytes
    ephm_pk: bytes

    def serialized_length(self) -> int:
        return SIGNATURE_LENGTH + PK_LENGTH

    def to_bytes(self) -> bytes:
        return self.sum_signature + self.ephm_pk

    @classmethod
    def from_bytes(cls, data: bytes) -> "Sum":
        if len(data) < SIGNATURE_LENGTH + PK_LENGTH:
            raise DecodeError("sum payload too short")
        return cls(
            sum_signature=data[:SIGNATURE_LENGTH],
            ephm_pk=data[SIGNATURE_LENGTH : SIGNATURE_LENGTH + PK_LENGTH],
        )


@dataclass
class Update:
    sum_signature: bytes
    update_signature: bytes
    masked_model: MaskObject
    local_seed_dict: dict
    # serialize the masked model's vector part in the v2 byte-planar wire
    # layout (negotiated via RoundParameters.wire_format; the parse side
    # auto-detects from the count-word flag, so this only shapes to_bytes)
    wire_planar: bool = False

    def serialized_length(self) -> int:
        from ..mask.serialization import serialized_object_length

        return (
            2 * SIGNATURE_LENGTH
            + serialized_object_length(self.masked_model.config, len(self.masked_model))
            + 4
            + SEED_DICT_ENTRY_LENGTH * len(self.local_seed_dict)
        )

    def to_bytes(self) -> bytes:
        return (
            self.sum_signature
            + self.update_signature
            + serialize_mask_object(self.masked_model, planar_vect=self.wire_planar)
            + serialize_local_seed_dict(self.local_seed_dict)
        )

    @classmethod
    def from_bytes(cls, data: bytes, lazy_vect: bool = False) -> "Update":
        if len(data) < 2 * SIGNATURE_LENGTH:
            raise DecodeError("update payload too short")
        masked, consumed = parse_mask_object(data, 2 * SIGNATURE_LENGTH, lazy_vect=lazy_vect)
        seed_dict, _ = parse_local_seed_dict(data, 2 * SIGNATURE_LENGTH + consumed)
        return cls(
            sum_signature=data[:SIGNATURE_LENGTH],
            update_signature=data[SIGNATURE_LENGTH : 2 * SIGNATURE_LENGTH],
            masked_model=masked,
            local_seed_dict=seed_dict,
            wire_planar=bool(getattr(masked.vect, "planar", False)),
        )

    @classmethod
    def from_stream(cls, reader, lazy_vect: bool = False) -> "Update":
        sigs = reader.read(2 * SIGNATURE_LENGTH)
        vect = parse_mask_vect_stream(reader, lazy=lazy_vect)
        unit = parse_mask_unit_stream(reader)
        seed_dict = parse_local_seed_dict_stream(reader)
        return cls(
            sum_signature=sigs[:SIGNATURE_LENGTH],
            update_signature=sigs[SIGNATURE_LENGTH:],
            masked_model=MaskObject(vect, unit),
            local_seed_dict=seed_dict,
            wire_planar=bool(getattr(vect, "planar", False)),
        )


@dataclass
class Sum2:
    sum_signature: bytes
    model_mask: MaskObject

    def serialized_length(self) -> int:
        from ..mask.serialization import serialized_object_length

        return SIGNATURE_LENGTH + serialized_object_length(
            self.model_mask.config, len(self.model_mask)
        )

    def to_bytes(self) -> bytes:
        return self.sum_signature + serialize_mask_object(self.model_mask)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Sum2":
        if len(data) < SIGNATURE_LENGTH:
            raise DecodeError("sum2 payload too short")
        mask, _ = parse_mask_object(data, SIGNATURE_LENGTH)
        return cls(sum_signature=data[:SIGNATURE_LENGTH], model_mask=mask)

    @classmethod
    def from_stream(cls, reader) -> "Sum2":
        sig = reader.read(SIGNATURE_LENGTH)
        vect = parse_mask_vect_stream(reader)
        unit = parse_mask_unit_stream(reader)
        return cls(sum_signature=sig, model_mask=MaskObject(vect, unit))


@dataclass
class Chunk:
    """One part of a multipart message.

    ``tag`` carries the enclosing message's tag (the type of the message
    being reassembled).
    """

    id: int
    message_id: int
    last: bool
    data: bytes
    tag: "object" = None  # Tag; typed loosely to avoid a circular import

    def serialized_length(self) -> int:
        return CHUNK_HEADER_LENGTH + len(self.data)

    def to_bytes(self) -> bytes:
        return (
            struct.pack(">HHB3x", self.id & 0xFFFF, self.message_id & 0xFFFF, 1 if self.last else 0)
            + self.data
        )

    @classmethod
    def from_bytes(cls, data: bytes, tag=None) -> "Chunk":
        if len(data) < CHUNK_HEADER_LENGTH:
            raise DecodeError("chunk payload too short")
        cid, mid, flags = struct.unpack_from(">HHB", data)
        return cls(id=cid, message_id=mid, last=bool(flags & 1), data=data[CHUNK_HEADER_LENGTH:], tag=tag)


Payload = Union[Sum, Update, Sum2, Chunk]


def parse_payload(
    tag, is_multipart: bool, data: bytes, lazy_update_vect: bool = False
) -> Payload:
    if is_multipart:
        return Chunk.from_bytes(data, tag=tag)
    from .message import Tag  # local import to avoid cycle

    if tag == Tag.SUM:
        return Sum.from_bytes(data)
    if tag == Tag.UPDATE:
        return Update.from_bytes(data, lazy_vect=lazy_update_vect)
    if tag == Tag.SUM2:
        return Sum2.from_bytes(data)
    raise DecodeError(f"unknown tag {tag}")


def parse_payload_stream(tag, reader, lazy_update_vect: bool = False) -> Payload:
    """Streaming payload parse from a ``ChunkReader`` (multipart reassembly).

    Reference analogue: the stream variants of ``FromBytes``
    (rust/xaynet-core/src/message/traits.rs) used by the multipart service.
    """
    from .message import Tag  # local import to avoid cycle

    try:
        if tag == Tag.SUM:
            return Sum.from_bytes(reader.read(reader.remaining))
        if tag == Tag.UPDATE:
            return Update.from_stream(reader, lazy_vect=lazy_update_vect)
        if tag == Tag.SUM2:
            return Sum2.from_stream(reader)
    except ValueError as e:
        if isinstance(e, DecodeError):
            raise
        raise DecodeError(str(e)) from e
    raise DecodeError(f"unknown tag {tag}")
