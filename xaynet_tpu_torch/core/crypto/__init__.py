"""Crypto primitives for the PET protocol.

Mirrors the reference's crypto surface (reference:
rust/xaynet-core/src/crypto/mod.rs:36-78): asymmetric sealed-box encryption,
Ed25519 signatures with the task-eligibility check, SHA-256, and the
ChaCha20-based PRNG for mask expansion.

The reference binds to libsodium; this implementation uses the Python
``cryptography`` package (X25519 + ChaCha20Poly1305 sealed boxes, Ed25519).
Wire sizes match the reference exactly (SEALBYTES = 48, 32-byte keys,
64-byte signatures); the sealed-box bytes are not libsodium-compatible —
both protocol ends are this framework.
"""

from .encrypt import SEALBYTES, EncryptKeyPair, PublicEncryptKey, SecretEncryptKey
from .hash import sha256
from .sign import Signature, SigningKeyPair, is_eligible, sign_detached, verify_detached

__all__ = [
    "SEALBYTES",
    "EncryptKeyPair",
    "PublicEncryptKey",
    "SecretEncryptKey",
    "sha256",
    "Signature",
    "SigningKeyPair",
    "is_eligible",
    "sign_detached",
    "verify_detached",
]
