"""The port's ChaCha20 keystream and mask expansion against the JAX package.

``xaynet_tpu_torch.ops.chacha`` (plain torch, the arithmetic of kernel K2's
plain version) against ``xaynet_tpu.ops.chacha_jax`` and the host
``StreamSampler``, plus the golden values of the reference PRNG
(rust/xaynet-core/src/crypto/prng.rs:36-80, as pinned in tests/test_prng.py).
Tolerance 0: keystream words, sampled limbs and byte cursors are exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xaynet_tpu.core.crypto.chacha import keystream_blocks
from xaynet_tpu.core.crypto.prng import StreamSampler
from xaynet_tpu.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
from xaynet_tpu.ops import chacha_jax, limbs as ref_limbs
from xaynet_tpu_torch.core.crypto.prng import StreamSampler as PortSampler
from xaynet_tpu_torch.ops import chacha

# the suite runs in several worker processes at once: keep torch's CPU ops
# on one thread each so they do not crowd the other workers
torch.set_num_threads(1)

GOLDEN_MAX = (2**128 - 1) ** 2
GOLDEN = [
    90034050956742099321159087842304570510687605373623064829879336909608119744630,
    60790020689334235010238064028215988394112077193561636249125918224917556969946,
    107415344426328791036720294006773438815099086866510488084511304829720271980447,
    50343610553303623842889112417183549658912134525854625844144939347139411162921,
    42382469383990928111449714288937630103705168010724718767641573929365517895981,
]

ORDERS = [
    20_000_000_000_001,  # Integer/F32/B0/M3
    20_000_000_000_021,  # Prime/F32/B0/M3: the shipped config
    2**45,  # Power2/F32/B0/M3
    2**88,  # Power2/F32/B4/M12: draw bytes > element bytes
    2**96,  # Power2/I32/Bmax/M9: the draw needs an extra limb
    MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B2, ModelType.M6).order,  # 8-byte draw
    MaskConfig(GroupType.PRIME, DataType.F64, BoundType.BMAX, ModelType.M3).order,  # 66 limbs
    255,  # single byte draws
]


def _words(seed: bytes) -> list[int]:
    return np.frombuffer(seed, dtype="<u4").tolist()


@pytest.mark.parametrize("block_start", [0, 1, 977, 2**32 - 64])
def test_keystream_words_match_chacha_jax(block_start):
    seed = bytes(range(7, 39))
    kw = jnp.asarray(_words(seed), jnp.uint32)
    want = np.asarray(chacha_jax.keystream_words(kw, np.uint32(block_start), 16))
    got = chacha.keystream_words(_words(seed), block_start, 16)
    assert np.array_equal(got.numpy().astype(np.uint32), want)


def test_keystream_zero_key_golden():
    """djb-variant ChaCha20, zero key, zero nonce, counter 0 (well-known vector)."""
    ks = bytes(chacha.keystream_bytes([0] * 8, 0, 32).numpy())
    assert ks.hex() == "76b8e0ada0f13d90405d6ae55386bd28bdd219b8a08ded1aa836efcc8b770dc7"


@pytest.mark.parametrize("offset,nbytes", [(0, 256), (5, 100), (63, 65), (1000, 1), (2**34 + 3, 70)])
def test_keystream_bytes_match_host_stream(offset, nbytes):
    """Any byte cursor, including past 2^32 blocks' worth of counter bits
    in word 13, against the host keystream (64-bit block counter)."""
    seed = bytes(range(32))
    first, intra = divmod(offset, 64)
    want = keystream_blocks(seed, first, -(-(intra + nbytes) // 64))[intra : intra + nbytes]
    got = chacha.keystream_bytes(_words(seed), offset, nbytes).numpy()
    assert np.array_equal(got, want)


def test_derive_matches_golden_draws():
    limbs, end = chacha.derive_uniform_limbs([0] * 8, 5, GOLDEN_MAX)
    assert ref_limbs.limbs_to_ints(limbs.T.numpy().astype(np.uint32)) == GOLDEN
    sampler = StreamSampler(b"\x00" * 32)
    sampler.draw_limbs(5, GOLDEN_MAX)
    assert end == sampler.consumed_bytes


@pytest.mark.parametrize("trips", [1, 6])
@pytest.mark.parametrize("order", ORDERS)
def test_derive_matches_stream_sampler(order, trips):
    """Same limbs and the same end cursor as the host sampler, from a
    non-zero cursor (after a unit draw), in one trip or in about six."""
    seed = bytes([order % 251, 3]) * 16
    count = 37
    bpn = ref_limbs.draw_width_for(order)
    expected = count * (1 << (8 * bpn)) // order  # candidates the draw needs
    chunk = None if trips == 1 else max(7, expected // trips)
    sampler = StreamSampler(seed)
    sampler.draw_limbs(1, order)
    start = sampler.consumed_bytes
    want = sampler.draw_limbs(count, order)
    got, end = chacha.derive_uniform_limbs(_words(seed), count, order, start, chunk)
    assert np.array_equal(got.T.numpy().astype(np.uint32), want)
    assert end == sampler.consumed_bytes


@pytest.mark.parametrize("order", ORDERS[:5])
def test_derive_matches_chacha_jax_ingraph(order):
    """Against the traced JAX derivation (limbs and the int32 end cursor)."""
    seed = bytes([9, order % 7]) * 16
    want, want_end = chacha_jax.derive_uniform_limbs_ingraph(
        jnp.asarray(_words(seed), jnp.uint32), 11, 29, order, 64
    )
    got, end = chacha.derive_uniform_limbs(_words(seed), 29, order, 11, 64)
    assert np.array_equal(got.T.numpy().astype(np.uint32), np.asarray(want))
    assert end == int(want_end)


@pytest.mark.parametrize("count", [1, 1000, 25_000_000])
@pytest.mark.parametrize("order", ORDERS)
def test_provision_candidates_matches_chacha_jax(order, count):
    assert chacha.provision_candidates(count, order) == chacha_jax.provision_candidates(count, order)


@pytest.mark.parametrize("order", ORDERS)
def test_port_host_sampler_matches_reference(order):
    """The port's numpy copy of the host sampler (no native library)."""
    seed = bytes([order % 253]) * 32
    ref, port = StreamSampler(seed), PortSampler(seed)
    for count in (1, 40, 3):
        assert np.array_equal(port.draw_limbs(count, order), ref.draw_limbs(count, order))
        assert port.consumed_bytes == ref.consumed_bytes


def test_chop_and_accept_rule():
    """The chop/accept rule on a hand-built stream: little-endian
    candidates, strict ``candidate < order`` over every draw byte."""
    order = 0x0100_0000_0002  # 6-byte draw
    cands = [order - 1, order, order + 1, 0, 2**48 - 1, 0x0100_0000_0001]
    stream = torch.tensor(
        list(b"".join(c.to_bytes(6, "little") for c in cands)), dtype=torch.uint8
    )
    limbs = chacha.chop_candidates(stream, len(cands), 6)
    assert ref_limbs.limbs_to_ints(limbs.numpy().astype(np.uint32)) == cands
    ok = chacha.accept_mask(limbs, tuple(int(x) for x in ref_limbs.int_to_limbs(order, 2)))
    assert ok.tolist() == [c < order for c in cands]
