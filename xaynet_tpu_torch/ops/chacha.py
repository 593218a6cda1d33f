"""ChaCha20 keystream and mask expansion in plain torch.

Port of ``xaynet_tpu/ops/chacha_jax.py``: the device counterpart of the host
``core.crypto.prng.StreamSampler``. Mask derivation (seed -> ``count``
uniform group elements, reference: rust/xaynet-core/src/mask/seed.rs:61-78)
is

1. generate keystream blocks (all blocks at once: one lane per block);
2. chop the byte stream into fixed-width (``draw_width``) little-endian
   candidates;
3. accept a candidate when it is lexicographically below the order, and
   take the first ``count`` accepted candidates;
4. repeat from the next keystream byte until ``count`` are accepted.

Every attempt consumes exactly ``draw_width`` bytes, accepted or not, so the
cursor after a derivation — the byte after the attempt that produced the
``count``-th acceptance — does not depend on how the stream is chunked
(``chacha_jax._chunk_step_traced``). The CUDA kernel K2
(``csrc/mask_fold.cu``) implements the same rule; this module is its plain
version's arithmetic and runs on any torch device.

The block counter is 64 bits wide (words 12-13), as in the host keystream;
the JAX device keystream keeps word 13 at zero, which agrees below 2^32
blocks (256 GiB of keystream per seed).
"""

from __future__ import annotations

import math

import torch

from . import limbs as host_limbs

_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_M32 = 0xFFFFFFFF
# candidates per plain derivation step: bounds the plain version's memory
# (the result and the end cursor do not depend on the step)
_PLAIN_STEP = 1 << 22


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) | (x >> (32 - n))) & _M32


def _quarter(s: list, a: int, b: int, c: int, d: int) -> None:
    s[a] = (s[a] + s[b]) & _M32
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _M32
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & _M32
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _M32
    s[b] = _rotl(s[b] ^ s[c], 7)


def keystream_words(key_words, block_start: int, nblocks: int, device=None) -> torch.Tensor:
    """ChaCha20 keystream blocks ``[block_start, block_start + nblocks)`` as
    int64 ``[nblocks, 16]`` little-endian words (values in ``[0, 2^32)``).

    ``key_words`` is the seed as 8 little-endian words (any sequence of
    ints, or an int64 tensor).
    """
    kw = [int(w) & _M32 for w in (key_words.tolist() if torch.is_tensor(key_words) else key_words)]
    if len(kw) != 8:
        raise ValueError("ChaCha20 key must be 8 words")
    ctr = block_start + torch.arange(nblocks, dtype=torch.int64, device=device)
    full = lambda v: torch.full((nblocks,), v, dtype=torch.int64, device=device)  # noqa: E731
    state = [full(c) for c in _CONSTANTS] + [full(w) for w in kw]
    state += [ctr & _M32, (ctr >> 32) & _M32, full(0), full(0)]
    w = list(state)
    for _ in range(10):
        _quarter(w, 0, 4, 8, 12)
        _quarter(w, 1, 5, 9, 13)
        _quarter(w, 2, 6, 10, 14)
        _quarter(w, 3, 7, 11, 15)
        _quarter(w, 0, 5, 10, 15)
        _quarter(w, 1, 6, 11, 12)
        _quarter(w, 2, 7, 8, 13)
        _quarter(w, 3, 4, 9, 14)
    return torch.stack([(wi + si) & _M32 for wi, si in zip(w, state)], dim=-1)


def keystream_bytes(key_words, byte_offset: int, nbytes: int, device=None) -> torch.Tensor:
    """``nbytes`` keystream bytes from byte ``byte_offset`` as ``uint8``."""
    block_start, intra = divmod(byte_offset, 64)
    nblocks = -(-(intra + nbytes) // 64)
    words = keystream_words(key_words, block_start, nblocks, device)
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=words.device)
    stream = ((words[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1)
    return stream[intra : intra + nbytes]


def chop_candidates(stream: torch.Tensor, n_cand: int, bpn: int) -> torch.Tensor:
    """Chop ``n_cand * bpn`` keystream bytes into little-endian candidates:
    int64 limbs ``[n_cand, ceil(bpn / 4)]``."""
    cand_limbs = host_limbs.n_limbs_for_bytes(bpn)
    b = stream[: n_cand * bpn].reshape(n_cand, bpn).to(torch.int64)
    limbs = []
    for j in range(cand_limbs):
        w = b[:, 4 * j]
        for i in range(1, min(4, bpn - 4 * j)):
            w = w | (b[:, 4 * j + i] << (8 * i))
        limbs.append(w)
    return torch.stack(limbs, dim=-1)


def accept_mask(cand: torch.Tensor, order_cand_limbs: tuple[int, ...]) -> torch.Tensor:
    """THE acceptance rule: lexicographic ``candidate < order`` over all
    candidate limbs (bit-identical to the host ``StreamSampler``)."""
    lt = torch.zeros(cand.shape[0], dtype=torch.bool, device=cand.device)
    decided = torch.zeros_like(lt)
    for j in range(cand.shape[1] - 1, -1, -1):
        col = cand[:, j]
        o = int(order_cand_limbs[j])
        lt = lt | (~decided & (col < o))
        decided = decided | (col != o)
    return lt


def provision_candidates(count: int, order: int) -> int:
    """Candidates to draw so that P(accepted < count) < ~2^-60."""
    bpn = host_limbs.draw_width_for(order)
    # int/int true division is correctly rounded at any magnitude
    p = order / (1 << (8 * bpn))
    p = max(min(p, 1.0), 1e-9)
    # Chernoff: need C with C*p - 7*sqrt(C*p*(1-p)) >= count
    c = count / p
    c += 7.0 * math.sqrt(max(c * (1 - p), 1.0)) / p + 64
    return int(c)


def derive_uniform_limbs(
    key_words,
    count: int,
    order: int,
    byte_offset: int = 0,
    chunk_candidates: int | None = None,
    device=None,
) -> tuple[torch.Tensor, int]:
    """The first ``count`` accepted draws below ``order`` from byte
    ``byte_offset`` of the seed's keystream, as PLANAR int64 limbs
    ``[L, count]``, and the end cursor.

    Bit-identical to the host ``StreamSampler`` (same keystream, rejection
    rule, acceptance order and consumed-bytes handoff). The stream is taken
    in steps of at most ``chunk_candidates`` candidates; a short step makes
    the multi-trip path run, and neither the limbs nor the cursor depend on
    it.
    """
    bpn = host_limbs.draw_width_for(order)
    cand_limbs = host_limbs.n_limbs_for_bytes(bpn)
    out_limbs = host_limbs.n_limbs_for_order(order)
    order_cl = tuple(int(x) for x in host_limbs.int_to_limbs(order, cand_limbs))
    trip = chunk_candidates if chunk_candidates else provision_candidates(count, order)
    step = max(1, min(trip, _PLAIN_STEP))
    out = torch.zeros((out_limbs, count), dtype=torch.int64, device=device)
    base, offset = 0, int(byte_offset)
    while base < count:
        stream = keystream_bytes(key_words, offset, step * bpn, device)
        cand = chop_candidates(stream, step, bpn)
        ok = accept_mask(cand, order_cl)
        csum = torch.cumsum(ok.to(torch.int64), 0)
        need = count - base
        take = ok & (csum <= need)
        idx = base + csum[take] - 1
        out[:, idx] = cand[take][:, :out_limbs].T
        n_acc = int(csum[-1])
        if n_acc >= need:
            # the attempt that produced the count-th acceptance: the cursor
            # stops on the byte after it (chacha_jax._chunk_step_traced)
            pos = int(torch.nonzero(csum >= need)[0, 0])
            return out, offset + (pos + 1) * bpn
        base += n_acc
        offset += step * bpn
    return out, offset
