"""Mask seeds and their sealed-box encryption.

Reference: rust/xaynet-core/src/mask/seed.rs:48-136. A 32-byte seed expands
(via the ChaCha20 rejection sampler) into a full mask object; update
participants encrypt their seed for every sum participant's ephemeral key.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..crypto.encrypt import DecryptError, PublicEncryptKey, SecretEncryptKey, SEALBYTES
from ..crypto.prng import StreamSampler
from .config import MaskConfigPair
from .object import MaskObject, MaskUnit, MaskVect

MASK_SEED_LENGTH = 32
ENCRYPTED_MASK_SEED_LENGTH = SEALBYTES + MASK_SEED_LENGTH  # 80


@dataclass(frozen=True)
class MaskSeed:
    bytes_: bytes

    def __post_init__(self):
        if len(self.bytes_) != MASK_SEED_LENGTH:
            raise ValueError("mask seed must be 32 bytes")

    @classmethod
    def generate(cls) -> "MaskSeed":
        return cls(os.urandom(MASK_SEED_LENGTH))

    def as_bytes(self) -> bytes:
        return self.bytes_

    def encrypt(self, pk: PublicEncryptKey) -> "EncryptedMaskSeed":
        return EncryptedMaskSeed(pk.encrypt(self.bytes_))

    def derive_mask(self, length: int, config: MaskConfigPair) -> MaskObject:
        """Expand this seed into a mask: 1 unit draw, then ``length`` vector draws."""
        sampler = StreamSampler(self.bytes_)
        unit = sampler.draw_limbs(1, config.unit.order)[0]
        vect = sampler.draw_limbs(length, config.vect.order)
        return MaskObject(MaskVect(config.vect, vect), MaskUnit(config.unit, unit))


@dataclass(frozen=True)
class EncryptedMaskSeed:
    bytes_: bytes

    def __post_init__(self):
        if len(self.bytes_) != ENCRYPTED_MASK_SEED_LENGTH:
            raise ValueError("encrypted mask seed must be 80 bytes")

    def as_bytes(self) -> bytes:
        return self.bytes_

    def decrypt(self, sk: SecretEncryptKey, pk: PublicEncryptKey | None = None) -> MaskSeed:
        try:
            plain = sk.decrypt(self.bytes_, pk)
        except DecryptError:
            raise
        if len(plain) != MASK_SEED_LENGTH:
            raise DecryptError("decrypted mask seed has invalid length")
        return MaskSeed(plain)


# --- batched seed fan-out wire format (GET /seeds?fmt=bin, §21) -----------
#
# count(u32 BE) ‖ count x [ participant pk(32) ‖ encrypted seed(80) ]
#
# Fixed 112-byte entries: a sum participant fetching a 100k-update seed
# slice downloads ~11 MB of raw entries instead of ~22 MB of JSON hex, and
# both ends slice instead of parsing. The JSON shape stays the default —
# the binary body is opt-in per request and byte-equivalent in content.

SEED_ENTRY_PK_LENGTH = 32
SEED_ENTRY_LENGTH = SEED_ENTRY_PK_LENGTH + ENCRYPTED_MASK_SEED_LENGTH  # 112


def pack_seed_entries(seed_dict: dict) -> bytes:
    """Serialize an UpdateSeedDict slice ``{pk: EncryptedMaskSeed}`` into
    the batched binary fan-out body (deterministic: entries sorted by pk,
    so identical dicts serialize identically)."""
    parts = [len(seed_dict).to_bytes(4, "big")]
    for pk in sorted(seed_dict):
        if len(pk) != SEED_ENTRY_PK_LENGTH:
            raise ValueError("seed-dict pk must be 32 bytes")
        parts.append(pk)
        parts.append(seed_dict[pk].as_bytes())
    return b"".join(parts)


def unpack_seed_entries(data) -> dict:
    """Parse a batched binary fan-out body back into
    ``{pk: EncryptedMaskSeed}``. Accepts any buffer; slices views, never
    copies the body. Raises ``ValueError`` on a malformed frame."""
    view = memoryview(data)
    if len(view) < 4:
        raise ValueError("seed fan-out body too short")
    count = int.from_bytes(view[:4], "big")
    if len(view) != 4 + count * SEED_ENTRY_LENGTH:
        raise ValueError("seed fan-out length does not match the framed count")
    out = {}
    for i in range(count):
        start = 4 + i * SEED_ENTRY_LENGTH
        pk = bytes(view[start : start + SEED_ENTRY_PK_LENGTH])
        seed = bytes(
            view[start + SEED_ENTRY_PK_LENGTH : start + SEED_ENTRY_LENGTH]
        )
        out[pk] = EncryptedMaskSeed(seed)
    return out
