"""SHA-256 wrapper (reference: rust/xaynet-core/src/crypto/hash.rs:30-53)."""

from __future__ import annotations

import hashlib

DIGEST_LENGTH = 32


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()
