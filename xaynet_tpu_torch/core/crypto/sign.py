"""Ed25519 signatures and the PET task-eligibility check.

Reference: rust/xaynet-core/src/crypto/sign.rs:21-232. The eligibility rule
(`Signature::is_eligible`, sign.rs:186-202) decides whether a participant is
selected for the sum/update task of a round:

    int_le(sha256(signature)) / (2^256 - 1) <= threshold

evaluated exactly (the threshold f64 is converted to an exact rational).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from fractions import Fraction

try:  # native Ed25519 when the wheel is present, pure-stdlib fallback otherwise
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )

    _HAVE_CRYPTO = True
except ImportError:
    from . import _purecrypto

    _HAVE_CRYPTO = False

from .hash import sha256

PUBLIC_KEY_LENGTH = 32
SECRET_KEY_LENGTH = 32  # stored as the 32-byte seed
SIGNATURE_LENGTH = 64
SEED_LENGTH = 32

_DENOM = (1 << 256) - 1


@dataclass(frozen=True)
class Signature:
    bytes_: bytes

    def __post_init__(self):
        if len(self.bytes_) != SIGNATURE_LENGTH:
            raise ValueError("signature must be 64 bytes")

    def as_bytes(self) -> bytes:
        return self.bytes_

    def is_eligible(self, threshold: float) -> bool:
        return is_eligible(self.bytes_, threshold)


def is_eligible(signature: bytes, threshold: float) -> bool:
    """Exact eligibility check as specified by the reference."""
    if threshold < 0.0:
        return False
    if threshold > 1.0:
        return True
    numer = int.from_bytes(sha256(signature), "little")
    return Fraction(numer, _DENOM) <= Fraction(threshold)


@dataclass(frozen=True)
class SigningKeyPair:
    public: bytes  # 32-byte Ed25519 public key
    secret: bytes  # 32-byte seed / private key

    @classmethod
    def generate(cls) -> "SigningKeyPair":
        return cls.derive_from_seed(os.urandom(SEED_LENGTH))

    @classmethod
    def derive_from_seed(cls, seed: bytes) -> "SigningKeyPair":
        if len(seed) != SEED_LENGTH:
            raise ValueError("seed must be 32 bytes")
        if not _HAVE_CRYPTO:
            return cls(public=_purecrypto.ed25519_public(seed), secret=seed)
        sk = Ed25519PrivateKey.from_private_bytes(seed)
        return cls(public=sk.public_key().public_bytes_raw(), secret=seed)

    def sign(self, data: bytes) -> Signature:
        return Signature(sign_detached(self.secret, data))


def sign_detached(secret: bytes, data: bytes) -> bytes:
    if not _HAVE_CRYPTO:
        return _purecrypto.ed25519_sign(secret, data)
    return Ed25519PrivateKey.from_private_bytes(secret).sign(data)


def verify_detached(public: bytes, signature: bytes, data: bytes) -> bool:
    if not _HAVE_CRYPTO:
        try:
            return _purecrypto.ed25519_verify(public, signature, data)
        except ValueError:
            return False
    try:
        Ed25519PublicKey.from_public_bytes(public).verify(signature, data)
        return True
    except (InvalidSignature, ValueError):
        return False
