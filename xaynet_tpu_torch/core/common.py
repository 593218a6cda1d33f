"""Shared protocol types: round parameters and round seed.

Reference: rust/xaynet-core/src/common.rs:8-47 and the dictionary type
aliases in rust/xaynet-core/src/lib.rs:40-93.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict

from .mask.config import MaskConfigPair
from .mask.seed import EncryptedMaskSeed

ROUND_SEED_LENGTH = 32

# type aliases mirroring the reference's dictionaries
SumDict = Dict[bytes, bytes]  # sum pk -> ephemeral pk
LocalSeedDict = Dict[bytes, EncryptedMaskSeed]  # sum pk -> encrypted seed
UpdateSeedDict = Dict[bytes, EncryptedMaskSeed]  # update pk -> encrypted seed
SeedDict = Dict[bytes, UpdateSeedDict]  # sum pk -> {update pk -> seed}


@dataclass(frozen=True)
class RoundSeed:
    bytes_: bytes

    def __post_init__(self):
        if len(self.bytes_) != ROUND_SEED_LENGTH:
            raise ValueError("round seed must be 32 bytes")

    @classmethod
    def generate(cls) -> "RoundSeed":
        return cls(os.urandom(ROUND_SEED_LENGTH))

    @classmethod
    def zeroed(cls) -> "RoundSeed":
        return cls(b"\x00" * ROUND_SEED_LENGTH)

    def as_bytes(self) -> bytes:
        return self.bytes_


@dataclass
class RoundParameters:
    """Public parameters of one PET round."""

    pk: bytes  # coordinator's round-fresh encryption public key
    sum: float  # sum-task selection probability
    update: float  # update-task selection probability
    seed: RoundSeed
    mask_config: MaskConfigPair
    model_length: int
    # negotiated upload wire format: 1 = legacy interleaved element blocks,
    # 2 = packed byte-planar (serialization.WIRE_PLANAR_FLAG). Advertised to
    # participants via /params; the server parse auto-detects per message,
    # so a v1 client against a v2 round (and vice versa) stays valid.
    wire_format: int = 1

    def to_dict(self) -> dict:
        c = self.mask_config.vect
        u = self.mask_config.unit
        return {
            "pk": self.pk.hex(),
            "sum": self.sum,
            "update": self.update,
            "seed": self.seed.as_bytes().hex(),
            "mask_config": {
                "vect": list(c.to_bytes()),
                "unit": list(u.to_bytes()),
            },
            "model_length": self.model_length,
            "wire_format": self.wire_format,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "RoundParameters":
        from .mask.config import MaskConfig

        return cls(
            pk=bytes.fromhex(d["pk"]),
            sum=float(d["sum"]),
            update=float(d["update"]),
            seed=RoundSeed(bytes.fromhex(d["seed"])),
            mask_config=MaskConfigPair(
                vect=MaskConfig.from_bytes(bytes(d["mask_config"]["vect"])),
                unit=MaskConfig.from_bytes(bytes(d["mask_config"]["unit"])),
            ),
            model_length=int(d["model_length"]),
            wire_format=int(d.get("wire_format", 1)),
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, RoundParameters)
            and self.pk == other.pk
            and self.sum == other.sum
            and self.update == other.update
            and self.seed == other.seed
            and self.mask_config == other.mask_config
            and self.model_length == other.model_length
            and self.wire_format == other.wire_format
        )
