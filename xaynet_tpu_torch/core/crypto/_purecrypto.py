"""Pure-stdlib fallback primitives: X25519, Ed25519, ChaCha20-Poly1305, HKDF.

``encrypt.py`` and ``sign.py`` prefer the ``cryptography`` wheel (native,
constant-time). Images without that wheel — CI sandboxes, minimal TPU pod
images — previously could not even *import* the server stack, because the
sealed-box and signature modules imported ``cryptography`` at module scope.
This module provides functionally identical, RFC-conformant implementations
on Python big ints + the repo's existing vectorized ChaCha20 core
(``chacha.keystream_blocks``), so every protocol path stays runnable.

NOT constant-time: timing side channels are out of scope for the fallback —
it exists for test/simulation environments, and the module docstrings of
the callers say so. Conformance is pinned by RFC test vectors in
``tests/test_purecrypto.py`` (RFC 7748 §5.2, RFC 8032 §7.1, RFC 8439 §2.8.2,
RFC 5869 A.1), so an environment *with* the wheel computes byte-identical
results to one without.
"""

from __future__ import annotations

import functools
import hashlib
import hmac

import numpy as np

from .chacha import CHACHA_CONSTANTS, _quarter

# --- curve25519 field / group constants -------------------------------------

_P = 2**255 - 19
_L = 2**252 + 27742317777372353535851937790883648493  # ed25519 group order
_D = (-121665 * pow(121666, -1, _P)) % _P  # edwards d
_SQRT_M1 = pow(2, (_P - 1) // 4, _P)  # sqrt(-1) mod p

# ed25519 base point
_B_Y = 4 * pow(5, -1, _P) % _P


def _recover_x(y: int, sign: int) -> int:
    """Point decompression (RFC 8032 §5.1.3)."""
    if y >= _P:
        raise ValueError("invalid point encoding")
    x2 = (y * y - 1) * pow(_D * y * y + 1, -1, _P) % _P
    if x2 == 0:
        if sign:
            raise ValueError("invalid point encoding")
        return 0
    x = pow(x2, (_P + 3) // 8, _P)
    if (x * x - x2) % _P != 0:
        x = x * _SQRT_M1 % _P
    if (x * x - x2) % _P != 0:
        raise ValueError("invalid point encoding")
    if x & 1 != sign:
        x = _P - x
    return x


_B = (_recover_x(_B_Y, 0), _B_Y)

# extended homogeneous coordinates (X, Y, Z, T) with x=X/Z, y=Y/Z, xy=T/Z
_IDENT = (0, 1, 1, 0)


def _to_ext(pt: tuple[int, int]) -> tuple[int, int, int, int]:
    x, y = pt
    return (x, y, 1, x * y % _P)


def _ext_add(p, q):
    """RFC 8032 §5.1.4 point addition."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % _P
    b = (y1 + x1) * (y2 + x2) % _P
    c = 2 * t1 * t2 * _D % _P
    d = 2 * z1 * z2 % _P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % _P, g * h % _P, f * g % _P, e * h % _P)


def _ext_double(p):
    return _ext_add(p, p)


def _scalar_mult(scalar: int, pt: tuple[int, int, int, int]):
    out = _IDENT
    while scalar:
        if scalar & 1:
            out = _ext_add(out, pt)
        pt = _ext_double(pt)
        scalar >>= 1
    return out


def _build_base_table():
    table, pt = [], None
    pt_ext = _to_ext(_B)
    for _ in range(256):
        table.append(pt_ext)
        pt_ext = _ext_double(pt_ext)
    del pt
    return table


_B_TABLE = _build_base_table()


def _scalar_mult_base(scalar: int):
    """``scalar * B`` via the precomputed doubling table — additions only,
    which makes sign/public-key derivation ~2x the generic ladder (the hot
    path of ``keys_for_task`` rejection sampling in simulations)."""
    out = _IDENT
    i = 0
    while scalar:
        if scalar & 1:
            out = _ext_add(out, _B_TABLE[i])
        scalar >>= 1
        i += 1
    return out


def _ext_encode(p) -> bytes:
    x, y, z, _ = p
    zinv = pow(z, -1, _P)
    x, y = x * zinv % _P, y * zinv % _P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _ext_decode(data: bytes):
    if len(data) != 32:
        raise ValueError("point encoding must be 32 bytes")
    raw = int.from_bytes(data, "little")
    sign = raw >> 255
    y = raw & ((1 << 255) - 1)
    return _to_ext((_recover_x(y, sign), y))


def _ext_equal(p, q) -> bool:
    # X1/Z1 == X2/Z2  <=>  X1 Z2 == X2 Z1 (and same for Y)
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % _P == 0 and (y1 * z2 - y2 * z1) % _P == 0


# --- Ed25519 (RFC 8032) ------------------------------------------------------


def _ed_secret_expand(seed: bytes) -> tuple[int, bytes]:
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


@functools.lru_cache(maxsize=4096)
def _expanded(seed: bytes) -> tuple[int, bytes, bytes]:
    """(scalar, prefix, public key) per seed — one key signs many messages
    in a PET round, so the base-point mult is paid once per key."""
    a, prefix = _ed_secret_expand(seed)
    return a, prefix, _ext_encode(_scalar_mult_base(a))


def ed25519_public(seed: bytes) -> bytes:
    """Public key for a 32-byte private seed."""
    return _expanded(bytes(seed))[2]


def ed25519_sign(seed: bytes, msg: bytes) -> bytes:
    a, prefix, pk = _expanded(bytes(seed))
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % _L
    r_enc = _ext_encode(_scalar_mult_base(r))
    k = int.from_bytes(hashlib.sha512(r_enc + pk + msg).digest(), "little") % _L
    s = (r + k * a) % _L
    return r_enc + s.to_bytes(32, "little")


def ed25519_verify(pk: bytes, sig: bytes, msg: bytes) -> bool:
    if len(sig) != 64:
        return False
    try:
        a_pt = _ext_decode(pk)
        r_pt = _ext_decode(sig[:32])
    except ValueError:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= _L:
        return False
    k = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % _L
    return _ext_equal(
        _scalar_mult_base(s),
        _ext_add(r_pt, _scalar_mult(k, a_pt)),
    )


# --- X25519 (RFC 7748) -------------------------------------------------------

_A24 = 121665


def _x_decode_scalar(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(b, "little")


def x25519(k: bytes, u: bytes) -> bytes:
    """Scalar multiplication on the montgomery curve (the DH primitive)."""
    if len(k) != 32 or len(u) != 32:
        raise ValueError("x25519 operands must be 32 bytes")
    scalar = _x_decode_scalar(k)
    x1 = int.from_bytes(u, "little") & ((1 << 255) - 1)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        k_t = (scalar >> t) & 1
        if swap ^ k_t:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = x1 * z3 * z3 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, _P - 2, _P) % _P
    return out.to_bytes(32, "little")


_X_BASE = (9).to_bytes(32, "little")


def x25519_public(k: bytes) -> bytes:
    """Public key (scalar times the base point u=9)."""
    return x25519(k, _X_BASE)


# --- ChaCha20-Poly1305 AEAD (RFC 8439) ---------------------------------------


def _ietf_keystream(key: bytes, nonce: bytes, counter: int, nblocks: int) -> bytes:
    """IETF-variant keystream: 32-bit block counter + 96-bit nonce.

    Same vectorized core as ``chacha.keystream_blocks`` (which pins the djb
    variant the PRNG needs); only the counter/nonce words differ.
    """
    key_words = np.frombuffer(key, dtype="<u4")
    if key_words.shape != (8,):
        raise ValueError("key must be 32 bytes")
    nonce_words = np.frombuffer(nonce, dtype="<u4")
    if nonce_words.shape != (3,):
        raise ValueError("nonce must be 12 bytes")
    state = np.zeros((16, nblocks), dtype=np.uint32)
    state[0:4] = np.asarray(CHACHA_CONSTANTS, dtype=np.uint32)[:, None]
    state[4:12] = key_words.astype(np.uint32)[:, None]
    state[12] = (counter + np.arange(nblocks, dtype=np.uint64)).astype(np.uint32)
    state[13:16] = nonce_words.astype(np.uint32)[:, None]
    w = state.copy()
    with np.errstate(over="ignore"):
        for _ in range(10):
            _quarter(w, 0, 4, 8, 12)
            _quarter(w, 1, 5, 9, 13)
            _quarter(w, 2, 6, 10, 14)
            _quarter(w, 3, 7, 11, 15)
            _quarter(w, 0, 5, 10, 15)
            _quarter(w, 1, 6, 11, 12)
            _quarter(w, 2, 7, 8, 13)
            _quarter(w, 3, 4, 9, 14)
        w += state
    return np.ascontiguousarray(w.T).astype("<u4").tobytes()


def _xor_keystream(key: bytes, nonce: bytes, counter: int, data: bytes) -> bytes:
    nblocks = -(-len(data) // 64)
    ks = np.frombuffer(_ietf_keystream(key, nonce, counter, nblocks)[: len(data)], dtype=np.uint8)
    return (np.frombuffer(data, dtype=np.uint8) ^ ks).tobytes()


def poly1305(key: bytes, msg: bytes) -> bytes:
    """One-time authenticator (RFC 8439 §2.5)."""
    if len(key) != 32:
        raise ValueError("poly1305 key must be 32 bytes")
    r = int.from_bytes(key[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key[16:], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        block = msg[i : i + 16]
        n = int.from_bytes(block, "little") + (1 << (8 * len(block)))
        acc = (acc + n) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(data: bytes) -> bytes:
    return data + b"\x00" * (-len(data) % 16)


def _poly_input(aad: bytes, ct: bytes) -> bytes:
    return (
        _pad16(aad)
        + _pad16(ct)
        + len(aad).to_bytes(8, "little")
        + len(ct).to_bytes(8, "little")
    )


class AeadTagError(ValueError):
    """AEAD authentication failed (the fallback's ``InvalidTag``)."""


def chacha20poly1305_encrypt(key: bytes, nonce: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
    otk = _ietf_keystream(key, nonce, 0, 1)[:32]
    ct = _xor_keystream(key, nonce, 1, plaintext)
    return ct + poly1305(otk, _poly_input(aad, ct))


def chacha20poly1305_decrypt(key: bytes, nonce: bytes, sealed: bytes, aad: bytes = b"") -> bytes:
    if len(sealed) < 16:
        raise AeadTagError("ciphertext shorter than the tag")
    ct, tag = sealed[:-16], sealed[-16:]
    otk = _ietf_keystream(key, nonce, 0, 1)[:32]
    if not hmac.compare_digest(poly1305(otk, _poly_input(aad, ct)), tag):
        raise AeadTagError("authentication failed")
    return _xor_keystream(key, nonce, 1, ct)


# --- HKDF-SHA256 (RFC 5869) --------------------------------------------------


def hkdf_sha256(ikm: bytes, info: bytes, length: int = 32, salt: bytes = b"") -> bytes:
    if not salt:
        salt = b"\x00" * 32
    prk = hmac.new(salt, ikm, hashlib.sha256).digest()
    out, block = b"", b""
    counter = 1
    while len(out) < length:
        block = hmac.new(prk, block + info + bytes([counter]), hashlib.sha256).digest()
        out += block
        counter += 1
    return out[:length]
