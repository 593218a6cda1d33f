"""Sealed-box asymmetric encryption (C25519).

Functional port of the reference's `EncryptKeyPair` /
`PublicEncryptKey::encrypt` / `SecretEncryptKey::decrypt` (reference:
rust/xaynet-core/src/crypto/encrypt.rs:16-164). A sealed box is anonymous
public-key encryption: an ephemeral X25519 key agrees a shared secret with
the recipient's public key; the ephemeral public key travels in the
ciphertext header.

Construction: ``eph_pk(32) || ChaCha20Poly1305(msg)`` with
``key = HKDF-SHA256(X25519(eph_sk, pk), info = eph_pk || pk)`` and a zero
nonce (the key is single-use). Overhead = 32 + 16 = 48 bytes = SEALBYTES,
matching the reference's wire constant.

Backend: the ``cryptography`` wheel when importable, otherwise the
pure-stdlib RFC-conformant fallback (``_purecrypto``) — byte-identical
output, not constant-time; fine for tests/simulation, pip the wheel for
production coordinators.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

try:  # native primitives when the wheel is present ...
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey, X25519PublicKey
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF

    _HAVE_CRYPTO = True
except ImportError:  # ... pure-stdlib fallback otherwise (see _purecrypto)
    from . import _purecrypto

    _HAVE_CRYPTO = False

SEALBYTES = 48
PUBLIC_KEY_LENGTH = 32
SECRET_KEY_LENGTH = 32
SEED_LENGTH = 32

_ZERO_NONCE = b"\x00" * 12


class DecryptError(ValueError):
    """Sealed box could not be opened."""


def _derive_key(shared: bytes, eph_pk: bytes, recipient_pk: bytes) -> bytes:
    info = b"xaynet-tpu-sealedbox" + eph_pk + recipient_pk
    if not _HAVE_CRYPTO:
        return _purecrypto.hkdf_sha256(shared, info, 32)
    hkdf = HKDF(algorithm=hashes.SHA256(), length=32, salt=None, info=info)
    return hkdf.derive(shared)


@dataclass(frozen=True)
class PublicEncryptKey:
    bytes_: bytes

    def __post_init__(self):
        if len(self.bytes_) != PUBLIC_KEY_LENGTH:
            raise ValueError("public encrypt key must be 32 bytes")

    def as_bytes(self) -> bytes:
        return self.bytes_

    def encrypt(self, message: bytes) -> bytes:
        """Seal ``message`` for this public key (anyone can seal)."""
        if _HAVE_CRYPTO:
            eph_sk = X25519PrivateKey.generate()
            eph_pk = eph_sk.public_key().public_bytes_raw()
            shared = eph_sk.exchange(X25519PublicKey.from_public_bytes(self.bytes_))
            key = _derive_key(shared, eph_pk, self.bytes_)
            ct = ChaCha20Poly1305(key).encrypt(_ZERO_NONCE, message, None)
            return eph_pk + ct
        eph_seed = os.urandom(32)
        eph_pk = _purecrypto.x25519_public(eph_seed)
        shared = _purecrypto.x25519(eph_seed, self.bytes_)
        key = _derive_key(shared, eph_pk, self.bytes_)
        return eph_pk + _purecrypto.chacha20poly1305_encrypt(key, _ZERO_NONCE, message)


@dataclass(frozen=True)
class SecretEncryptKey:
    bytes_: bytes

    def __post_init__(self):
        if len(self.bytes_) != SECRET_KEY_LENGTH:
            raise ValueError("secret encrypt key must be 32 bytes")

    def as_bytes(self) -> bytes:
        return self.bytes_

    def public_key(self) -> PublicEncryptKey:
        if _HAVE_CRYPTO:
            sk = X25519PrivateKey.from_private_bytes(self.bytes_)
            return PublicEncryptKey(sk.public_key().public_bytes_raw())
        return PublicEncryptKey(_purecrypto.x25519_public(self.bytes_))

    def decrypt(self, sealed: bytes, pk: "PublicEncryptKey | None" = None) -> bytes:
        """Open a sealed box addressed to this key.

        ``pk`` (our own public key) is accepted for reference API parity; it
        is recomputed when omitted.
        """
        if len(sealed) < SEALBYTES:
            raise DecryptError("sealed box too short")
        my_pk = pk.as_bytes() if pk is not None else self.public_key().as_bytes()
        eph_pk, ct = sealed[:32], sealed[32:]
        if _HAVE_CRYPTO:
            sk = X25519PrivateKey.from_private_bytes(self.bytes_)
            shared = sk.exchange(X25519PublicKey.from_public_bytes(eph_pk))
            key = _derive_key(shared, eph_pk, my_pk)
            try:
                return ChaCha20Poly1305(key).decrypt(_ZERO_NONCE, ct, None)
            except InvalidTag as e:
                raise DecryptError("sealed box authentication failed") from e
        shared = _purecrypto.x25519(self.bytes_, eph_pk)
        key = _derive_key(shared, eph_pk, my_pk)
        try:
            return _purecrypto.chacha20poly1305_decrypt(key, _ZERO_NONCE, ct)
        except _purecrypto.AeadTagError as e:
            raise DecryptError("sealed box authentication failed") from e


@dataclass(frozen=True)
class EncryptKeyPair:
    public: PublicEncryptKey
    secret: SecretEncryptKey

    @classmethod
    def generate(cls) -> "EncryptKeyPair":
        if not _HAVE_CRYPTO:
            return cls.derive_from_seed(os.urandom(SEED_LENGTH))
        sk = X25519PrivateKey.generate()
        return cls(
            public=PublicEncryptKey(sk.public_key().public_bytes_raw()),
            secret=SecretEncryptKey(sk.private_bytes_raw()),
        )

    @classmethod
    def derive_from_seed(cls, seed: bytes) -> "EncryptKeyPair":
        """Deterministic keypair from a 32-byte seed."""
        if len(seed) != SEED_LENGTH:
            raise ValueError("seed must be 32 bytes")
        if not _HAVE_CRYPTO:
            return cls(
                public=PublicEncryptKey(_purecrypto.x25519_public(seed)),
                secret=SecretEncryptKey(bytes(seed)),
            )
        sk = X25519PrivateKey.from_private_bytes(seed)
        return cls(
            public=PublicEncryptKey(sk.public_key().public_bytes_raw()),
            secret=SecretEncryptKey(sk.private_bytes_raw()),
        )


def generate_seed() -> bytes:
    return os.urandom(SEED_LENGTH)
