"""Signed message envelope for the PET protocol.

Header layout, 136 bytes (reference:
rust/xaynet-core/src/message/message.rs:24-49):

    signature(64) ‖ participant_pk(32) ‖ coordinator_pk(32) ‖
    length(u32 BE, whole message incl. header) ‖ tag(1) ‖ flags(1) ‖
    reserved(2) ‖ payload

The Ed25519 signature covers ``bytes[64:length]`` (everything after the
signature, message.rs:336-358). Tags: Sum=1, Update=2, Sum2=3
(message.rs:441-468); flag bit 0 marks multipart messages.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from enum import IntEnum, IntFlag

from ..crypto import sign as crypto_sign
from ..mask.serialization import DecodeError
from .payloads import Chunk, Payload, Sum, Sum2, Update, parse_payload

SIGNATURE_LENGTH = 64
PK_LENGTH = 32
HEADER_LENGTH = SIGNATURE_LENGTH + 2 * PK_LENGTH + 4 + 1 + 1 + 2  # 136

# protocol minimums per round (reference: message.rs:18-21)
SUM_COUNT_MIN = 1
UPDATE_COUNT_MIN = 3


class Tag(IntEnum):
    SUM = 1
    UPDATE = 2
    SUM2 = 3


class Flags(IntFlag):
    NONE = 0
    MULTIPART = 1


@dataclass
class Message:
    """A signed PET message (header + payload)."""

    participant_pk: bytes
    coordinator_pk: bytes
    payload: Payload
    tag: Tag | None = None
    is_multipart: bool = False
    signature: bytes | None = None

    def __post_init__(self):
        if self.tag is None:
            self.tag = _payload_tag(self.payload)

    def payload_length(self) -> int:
        return self.payload.serialized_length()

    def serialized_length(self) -> int:
        return HEADER_LENGTH + self.payload_length()

    def to_bytes(self, secret_signing_key: bytes | None = None) -> bytes:
        """Serialize; signs on serialize when a secret key is given."""
        total = self.serialized_length()
        buf = bytearray(total)
        buf[SIGNATURE_LENGTH : SIGNATURE_LENGTH + PK_LENGTH] = self.participant_pk
        buf[SIGNATURE_LENGTH + PK_LENGTH : SIGNATURE_LENGTH + 2 * PK_LENGTH] = self.coordinator_pk
        struct.pack_into(">I", buf, SIGNATURE_LENGTH + 2 * PK_LENGTH, total)
        buf[SIGNATURE_LENGTH + 2 * PK_LENGTH + 4] = int(self.tag)
        buf[SIGNATURE_LENGTH + 2 * PK_LENGTH + 5] = (
            int(Flags.MULTIPART) if self.is_multipart else 0
        )
        # reserved bytes stay zero
        buf[HEADER_LENGTH:] = self.payload.to_bytes()
        if secret_signing_key is not None:
            # memoryview: signing a 150 MB update must not copy the payload
            sig = crypto_sign.sign_detached(
                secret_signing_key, memoryview(buf)[SIGNATURE_LENGTH:total]
            )
            buf[:SIGNATURE_LENGTH] = sig
        elif self.signature is not None:
            buf[:SIGNATURE_LENGTH] = self.signature
        return bytes(buf)

    @classmethod
    def from_bytes(cls, data: bytes, verify: bool = True, lazy_update_vect: bool = False) -> "Message":
        """Parse and (by default) verify the signature.

        ``lazy_update_vect``: device-ingest coordinators defer the Update
        payload's element parse/validity to the accelerator (see
        ``parse_mask_vect``); all other payloads parse eagerly."""
        if len(data) < HEADER_LENGTH:
            raise DecodeError("message shorter than header")
        signature = data[:SIGNATURE_LENGTH]
        participant_pk = data[SIGNATURE_LENGTH : SIGNATURE_LENGTH + PK_LENGTH]
        coordinator_pk = data[SIGNATURE_LENGTH + PK_LENGTH : SIGNATURE_LENGTH + 2 * PK_LENGTH]
        (length,) = struct.unpack_from(">I", data, SIGNATURE_LENGTH + 2 * PK_LENGTH)
        if length < HEADER_LENGTH or length > len(data):
            raise DecodeError("invalid message length field")
        tag_raw = data[SIGNATURE_LENGTH + 2 * PK_LENGTH + 4]
        flags_raw = data[SIGNATURE_LENGTH + 2 * PK_LENGTH + 5]
        try:
            tag = Tag(tag_raw)
        except ValueError as e:
            raise DecodeError(f"invalid tag {tag_raw}") from e
        is_multipart = bool(flags_raw & Flags.MULTIPART)
        if verify and not crypto_sign.verify_detached(
            participant_pk, signature, memoryview(data)[SIGNATURE_LENGTH:length]
        ):
            raise DecodeError("invalid message signature")
        payload = parse_payload(
            tag, is_multipart, data[HEADER_LENGTH:length], lazy_update_vect=lazy_update_vect
        )
        return cls(
            participant_pk=participant_pk,
            coordinator_pk=coordinator_pk,
            payload=payload,
            tag=tag,
            is_multipart=is_multipart,
            signature=signature,
        )

    def verify_signature(self, data: bytes) -> bool:
        (length,) = struct.unpack_from(">I", data, SIGNATURE_LENGTH + 2 * PK_LENGTH)
        return crypto_sign.verify_detached(
            data[SIGNATURE_LENGTH : SIGNATURE_LENGTH + PK_LENGTH],
            data[:SIGNATURE_LENGTH],
            data[SIGNATURE_LENGTH:length],
        )


def _payload_tag(payload: Payload) -> Tag:
    if isinstance(payload, Sum):
        return Tag.SUM
    if isinstance(payload, Update):
        return Tag.UPDATE
    if isinstance(payload, Sum2):
        return Tag.SUM2
    if isinstance(payload, Chunk):
        return payload.tag
    raise TypeError(f"unknown payload type {type(payload)}")


def peek_header(data: bytes) -> tuple[bytes, Tag, bool]:
    """Cheap header inspection without payload parsing or verification.

    Returns (participant_pk, tag, is_multipart) — what the phase filter
    needs before paying for signature verification.
    """
    if len(data) < HEADER_LENGTH:
        raise DecodeError("message shorter than header")
    tag_raw = data[SIGNATURE_LENGTH + 2 * PK_LENGTH + 4]
    try:
        tag = Tag(tag_raw)
    except ValueError as e:
        raise DecodeError(f"invalid tag {tag_raw}") from e
    flags_raw = data[SIGNATURE_LENGTH + 2 * PK_LENGTH + 5]
    return (
        data[SIGNATURE_LENGTH : SIGNATURE_LENGTH + PK_LENGTH],
        tag,
        bool(flags_raw & Flags.MULTIPART),
    )
