"""ChaCha20 keystream, bit-compatible with the reference's PRNG.

The reference expands mask seeds with Rust's ``rand_chacha::ChaCha20Rng``
(reference: rust/xaynet-core/src/crypto/prng.rs:16-27,
rust/xaynet-core/src/mask/seed.rs:61-78). That RNG is the original djb
ChaCha20 variant: 256-bit key (the seed), 64-bit block counter starting at 0,
64-bit nonce/stream 0, with the keystream consumed as a flat little-endian
byte stream. Sum2 participants and the coordinator must derive *identical*
masks from the same seed, so this implementation is bit-exact (pinned by
golden tests in tests/test_prng.py).

This is the host (numpy, vectorized over blocks) implementation; the device
keystream lives in ``ops.chacha`` (plain torch) and ``csrc/mask_fold.cu``.
"""

from __future__ import annotations

import numpy as np

CHACHA_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
BLOCK_BYTES = 64

_U32 = np.uint32


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << _U32(n)) | (x >> _U32(32 - n))


def _quarter(s: np.ndarray, a: int, b: int, c: int, d: int) -> None:
    s[a] += s[b]
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] += s[d]
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] += s[b]
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] += s[d]
    s[b] = _rotl(s[b] ^ s[c], 7)


def keystream_blocks(key: bytes, block_start: int, nblocks: int) -> np.ndarray:
    """ChaCha20 keystream blocks ``[block_start, block_start + nblocks)``.

    Returns a flat ``uint8`` array of ``nblocks * 64`` keystream bytes.
    All blocks are computed in one vectorized pass (lanes = blocks).
    """
    if nblocks <= 0:
        return np.zeros(0, dtype=np.uint8)
    key_words = np.frombuffer(key, dtype="<u4")
    if key_words.shape != (8,):
        raise ValueError("ChaCha20 key must be 32 bytes")

    counters = block_start + np.arange(nblocks, dtype=np.uint64)
    state = np.zeros((16, nblocks), dtype=_U32)
    state[0:4] = np.asarray(CHACHA_CONSTANTS, dtype=_U32)[:, None]
    state[4:12] = key_words.astype(_U32)[:, None]
    state[12] = (counters & np.uint64(0xFFFFFFFF)).astype(_U32)
    state[13] = (counters >> np.uint64(32)).astype(_U32)
    # state[14:16] stay 0: nonce / stream id 0

    w = state.copy()
    with np.errstate(over="ignore"):
        for _ in range(10):  # 20 rounds = 10 double rounds
            _quarter(w, 0, 4, 8, 12)
            _quarter(w, 1, 5, 9, 13)
            _quarter(w, 2, 6, 10, 14)
            _quarter(w, 3, 7, 11, 15)
            _quarter(w, 0, 5, 10, 15)
            _quarter(w, 1, 6, 11, 12)
            _quarter(w, 2, 7, 8, 13)
            _quarter(w, 3, 4, 9, 14)
        w += state

    # [16, B] words -> per-block 16 LE words -> flat bytes
    return np.frombuffer(np.ascontiguousarray(w.T).astype("<u4").tobytes(), dtype=np.uint8)
