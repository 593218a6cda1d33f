"""Mask seeds.

Reference: rust/xaynet-core/src/mask/seed.rs:48-136. A 32-byte seed expands
(via the ChaCha20 rejection sampler) into a full mask object. The seed's
sealed-box encryption is not part of this package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..crypto.prng import StreamSampler
from .config import MaskConfigPair
from .object import MaskObject, MaskUnit, MaskVect

MASK_SEED_LENGTH = 32


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

    def derive_mask(self, length: int, config: MaskConfigPair) -> MaskObject:
        """Expand this seed into a mask: 1 unit draw, then ``length`` vector draws."""
        sampler = StreamSampler(self.bytes_)
        unit = sampler.draw_limbs(1, config.unit.order)[0]
        vect = sampler.draw_limbs(length, config.vect.order)
        return MaskObject(MaskVect(config.vect, vect), MaskUnit(config.unit, unit))

