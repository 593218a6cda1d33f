"""The port's fused Sum2 mask fold (kernel K2's plain version) against the
JAX package.

``xaynet_tpu_torch.ops.kernels.mask_fold`` runs K2's plain version on CPU
tensors; it is held byte-identical — accumulator and end cursors — to
``fold_pallas.mask_fold_planar_pallas(interpret=True)`` and to folding the
host ``MaskSeed.derive_mask`` per seed, including the multi-trip case (a
chunk far below the element count), non-zero start cursors, and draw
widths above the wire width. The JAX Pallas kernel does not trace when the
draw width is a whole number of words (8, 12, 16 bytes); those widths are
held against the host derivation only.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xaynet_tpu.core.crypto.prng import StreamSampler
from xaynet_tpu.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
from xaynet_tpu.core.mask.masking import Aggregation, Masker
from xaynet_tpu.core.mask.model import Scalar
from xaynet_tpu.core.mask.seed import MaskSeed
from xaynet_tpu.ops import chacha_jax, fold_pallas, limbs as ref_limbs, masking_jax
from xaynet_tpu.ops.fold_jax import planar_to_wire
from xaynet_tpu_torch import convert
from xaynet_tpu_torch.core.mask.model import Scalar as PortScalar
from xaynet_tpu_torch.ops import chacha, fold, kernels, masking

CPU = torch.device("cpu")
# the suite runs in several worker processes at once: keep torch's CPU ops
# on one thread each so they do not crowd the other workers
torch.set_num_threads(1)

CONFIGS = [
    MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M3),
    MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3),
    MaskConfig(GroupType.POWER2, DataType.F32, BoundType.B0, ModelType.M3),
    MaskConfig(GroupType.POWER2, DataType.F64, BoundType.B6, ModelType.M12),  # draw 17 > wire 16
]
IDS = ["INTEGER", "PRIME", "POWER2", "POWER2-draw17"]
WORD_DRAWS = [
    MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B2, ModelType.M6),  # draw 8
    MaskConfig(GroupType.POWER2, DataType.F32, BoundType.B4, ModelType.M12),  # draw 12 > wire 11
]


def _seeds(n: int, salt: int) -> list[bytes]:
    return [bytes([i, i ^ salt]) * 16 for i in range(1, n + 1)]


def _words_offsets(seeds: list[bytes], pair, extra: int = 0):
    """Key words and the byte cursors after each seed's unit draw
    (``extra`` bytes further on, to start mid-block)."""
    kws, offs = [], []
    for s in seeds:
        sampler = StreamSampler(s)
        sampler.draw_limbs(1, pair.unit.order)
        offs.append(sampler.consumed_bytes + extra)
        kws.append(np.frombuffer(s, dtype="<u4"))
    return np.stack(kws), offs


def _short_trip(n: int, order: int, trips: int) -> int:
    """A trip length that makes an ``n``-element derivation take about
    ``trips`` trips."""
    bpn = ref_limbs.draw_width_for(order)
    return max(7, n * (1 << (8 * bpn)) // order // trips)


def _port_mask_fold(kws, offs, n, order, chunk=None):
    n_limb = ref_limbs.n_limbs_for_order(order)
    acc = fold.zeros_u32((n_limb, n), CPU)
    acc, ends = kernels.mask_fold(acc, fold.to_device_u32(kws, CPU), offs, n, order, chunk)
    return fold.to_numpy_u32(acc), ends.tolist()


def _reference_sum(seeds, n, pair, extra=0):
    """Host reference: sum of the seeds' vector draws, and their cursors."""
    agg, ends = None, []
    ol = ref_limbs.order_limbs_for(pair.vect.order)
    for s in seeds:
        sampler = StreamSampler(s)
        sampler.draw_limbs(1, pair.unit.order)
        sampler.skip_bytes(extra)
        vect = sampler.draw_limbs(n, pair.vect.order)
        agg = vect if agg is None else ref_limbs.mod_add(agg, vect, ol)
        ends.append(sampler.consumed_bytes)
    return agg, ends


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_plain_mask_fold_matches_pallas_interpret(cfg):
    pair = cfg.pair()
    n = 53
    seeds = _seeds(5, 0x3C)
    kws, offs = _words_offsets(seeds, pair)
    n_limb = ref_limbs.n_limbs_for_order(pair.vect.order)
    want_acc, want_ends = fold_pallas.mask_fold_planar_pallas(
        jnp.zeros((n_limb, n), jnp.uint32), jnp.asarray(kws), np.asarray(offs, np.int32),
        n, pair.vect.order, interpret=True,
    )  # fmt: skip
    acc, ends = _port_mask_fold(kws, offs, n, pair.vect.order)
    assert np.array_equal(acc, np.asarray(want_acc))
    assert ends == np.asarray(want_ends).tolist()
    ref, ref_ends = _reference_sum(seeds, n, pair)
    assert np.array_equal(planar_to_wire(acc), ref) and ends == ref_ends


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_plain_mask_fold_multi_trip_mid_block_cursors(cfg):
    """A trip far shorter than the element count (many trips per seed) from
    cursors that start mid-block: same result and cursors as one trip and
    as the Pallas kernel's own multi-trip loop."""
    pair = cfg.pair()
    n = 41
    seeds = _seeds(3, 9)
    kws, offs = _words_offsets(seeds, pair, extra=29)
    n_limb = ref_limbs.n_limbs_for_order(pair.vect.order)
    chunk = _short_trip(n, pair.vect.order, 6)
    want_acc, want_ends = fold_pallas.mask_fold_planar_pallas(
        jnp.zeros((n_limb, n), jnp.uint32), jnp.asarray(kws), np.asarray(offs, np.int32),
        n, pair.vect.order, chunk_candidates=chunk, interpret=True,
    )  # fmt: skip
    tiny = _port_mask_fold(kws, offs, n, pair.vect.order, chunk=chunk)
    whole = _port_mask_fold(kws, offs, n, pair.vect.order)
    assert np.array_equal(tiny[0], np.asarray(want_acc))
    assert tiny[1] == np.asarray(want_ends).tolist() == whole[1]
    assert np.array_equal(tiny[0], whole[0])
    ref, ref_ends = _reference_sum(seeds, n, pair, extra=29)
    assert np.array_equal(planar_to_wire(tiny[0]), ref) and tiny[1] == ref_ends


@pytest.mark.parametrize("cfg", WORD_DRAWS, ids=["draw8", "draw12-wire11"])
def test_plain_mask_fold_word_draw_widths(cfg):
    pair = cfg.pair()
    seeds = _seeds(3, 0x51)
    kws, offs = _words_offsets(seeds, pair)
    acc, ends = _port_mask_fold(kws, offs, 30, pair.vect.order, _short_trip(30, pair.vect.order, 4))
    ref, ref_ends = _reference_sum(seeds, 30, pair)
    assert np.array_equal(planar_to_wire(acc), ref) and ends == ref_ends


@pytest.mark.parametrize("cfg", CONFIGS + WORD_DRAWS[:1], ids=IDS + ["draw8"])
def test_plain_mask_fold_rows_tensor_cursors_multi_trip(cfg):
    """``mask_fold_rows_plain`` with its cursors as an int64 tensor (K5's
    output: each seed's unit-draw cursor, ``extra`` bytes on so they start
    mid-block) and a trip far shorter than the row: each row is its seed's
    host vector draw and each end cursor the sampler's, as in one trip and
    as with the cursors given as a list."""
    pair = cfg.pair()
    order, n = pair.vect.order, 41
    n_limb = ref_limbs.n_limbs_for_order(order)
    seeds = _seeds(3, 0x2D)
    kws, offs = _words_offsets(seeds, pair, extra=23)
    kw = fold.to_device_u32(kws, CPU)
    cursors = torch.tensor(offs, dtype=torch.int64)
    chunk = _short_trip(n, order, 6)
    rows, ends = kernels.mask_fold_rows_plain(fold.zeros_u32((3, n_limb, n), CPU), kw, cursors, n,
                                              order, chunk)  # fmt: skip
    whole, whole_ends = kernels.mask_fold_rows(fold.zeros_u32((3, n_limb, n), CPU), kw, offs, n,
                                               order)  # fmt: skip
    assert torch.equal(rows, whole) and ends.tolist() == whole_ends.tolist()
    for b, seed in enumerate(seeds):
        ref, ref_ends = _reference_sum([seed], n, pair, extra=23)
        assert np.array_equal(planar_to_wire(fold.to_numpy_u32(rows[b])), ref)
        assert int(ends[b]) == ref_ends[0]
    units, starts = kernels.unit_draws(kw, convert.config_pair(pair).unit.order)
    assert starts.tolist() == [o - 23 for o in offs]
    masks, _ = kernels.mask_fold_rows(fold.zeros_u32((3, n_limb, n), CPU), kw, starts, n, order,
                                      chunk)  # fmt: skip
    for b, seed in enumerate(seeds):
        want = MaskSeed(seed).derive_mask(n, pair)
        assert np.array_equal(fold.to_numpy_u32(units[b]), want.unit.data)
        assert np.array_equal(planar_to_wire(fold.to_numpy_u32(masks[b])), want.vect.data)
    with pytest.raises(ValueError, match="int64"):
        kernels.mask_fold_rows_plain(rows, kw, cursors.to(torch.int32), n, order)
    with pytest.raises(ValueError, match="non-negative"):
        kernels.mask_fold_rows_plain(rows, kw, torch.tensor([-1, 0, 0]), n, order)


# the shipped order (draw 6) and the widest draws the Pallas kernel traces:
# 17 bytes above a 16-byte wire, 37 bytes (ten limbs)
CURSOR_CONFIGS = [
    CONFIGS[1],
    CONFIGS[3],
    MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.BMAX, ModelType.M3),
]


@pytest.mark.parametrize("trips", [1, 5], ids=["one-trip", "multi-trip"])
@pytest.mark.parametrize("cfg", CURSOR_CONFIGS, ids=["PRIME-draw6", "POWER2-draw17", "draw37"])
def test_mask_fold_tensor_cursors_equal_list_and_pallas(cfg, trips):
    """``mask_fold`` given the cursors as an int64 tensor (what K5 leaves on
    the device) gives the accumulator and end cursors it gives for the same
    cursors as a list, and both are the JAX package's fused Sum2 kernel's
    (Pallas, interpret mode), byte for byte, in one trip and in several;
    the caller's cursor tensor is left as it was."""
    pair = cfg.pair()
    order, n = pair.vect.order, 37
    n_limb = ref_limbs.n_limbs_for_order(order)
    seeds = _seeds(3, 0x6B)
    kws, offs = _words_offsets(seeds, pair, extra=11)
    chunk = None if trips == 1 else _short_trip(n, order, trips)
    kw = fold.to_device_u32(kws, CPU)
    cursors = torch.tensor(offs, dtype=torch.int64)
    listed, listed_ends = kernels.mask_fold(fold.zeros_u32((n_limb, n), CPU), kw, offs, n, order,
                                            chunk)  # fmt: skip
    held, held_ends = kernels.mask_fold(fold.zeros_u32((n_limb, n), CPU), kw, cursors, n, order,
                                        chunk)  # fmt: skip
    assert cursors.tolist() == offs
    assert fold.to_numpy_u32(held).tobytes() == fold.to_numpy_u32(listed).tobytes()
    assert held_ends.dtype == torch.int64 and held_ends.tolist() == listed_ends.tolist()
    want_acc, want_ends = fold_pallas.mask_fold_planar_pallas(
        jnp.zeros((n_limb, n), jnp.uint32), jnp.asarray(kws), np.asarray(offs, np.int32),
        n, order, chunk_candidates=chunk, interpret=True,
    )  # fmt: skip
    assert fold.to_numpy_u32(held).tobytes() == np.asarray(want_acc).tobytes()
    assert held_ends.tolist() == np.asarray(want_ends).tolist()


@pytest.mark.parametrize("trips", [1, 3], ids=["one-trip", "multi-trip"])
def test_mask_fold_tensor_cursors_at_the_widest_draw(trips):
    """The widest draw (268 bytes, 67 limbs), which the Pallas kernel does
    not trace (a whole number of words): cursors as a tensor and as a list
    give the JAX package's host derivation, byte for byte."""
    pair = MaskConfig(GroupType.INTEGER, DataType.F64, BoundType.BMAX, ModelType.M12).pair()
    order, n = pair.vect.order, 9
    n_limb = ref_limbs.n_limbs_for_order(order)
    seeds = _seeds(2, 0x35)
    kws, offs = _words_offsets(seeds, pair, extra=3)
    chunk = None if trips == 1 else _short_trip(n, order, trips)
    kw = fold.to_device_u32(kws, CPU)
    ref, ref_ends = _reference_sum(seeds, n, pair, extra=3)
    for cursors in (offs, torch.tensor(offs, dtype=torch.int64)):
        acc, ends = kernels.mask_fold(fold.zeros_u32((n_limb, n), CPU), kw, cursors, n, order,
                                      chunk)  # fmt: skip
        assert planar_to_wire(fold.to_numpy_u32(acc)).tobytes() == ref.tobytes()
        assert ends.tolist() == ref_ends


def test_mask_fold_cursor_arguments():
    """A cursor tensor must be int64[B] on the accumulator's device; a
    negative cursor is refused where the plain version reads it."""
    pair = CONFIGS[1].pair()
    order = pair.vect.order
    kws, offs = _words_offsets(_seeds(2, 0x12), pair)
    kw, acc = fold.to_device_u32(kws, CPU), fold.zeros_u32((2, 8), CPU)
    with pytest.raises(ValueError, match="int64"):
        kernels.mask_fold(acc, kw, torch.tensor(offs, dtype=torch.int32), 8, order)
    with pytest.raises(ValueError, match="int64"):
        kernels.mask_fold(acc, kw, torch.tensor(offs[:1]), 8, order)
    with pytest.raises(ValueError, match="non-negative"):
        kernels.mask_fold(acc, kw, torch.tensor([-1, 0]), 8, order)
    with pytest.raises(ValueError, match="non-negative"):
        kernels.mask_fold(acc, kw, [offs[0]], 8, order)


def test_mask_derivations_hand_k5_cursors_to_k2_as_device_tensors(monkeypatch):
    """``derive_mask_limbs`` (so ``mask_update``) and ``sum_masks_planar``
    (so ``sum_masks``) give ``kernels.mask_fold`` K5's cursors as an int64
    tensor on the accumulator's device, never as a list: the host does not
    read them between K5 and K2. Each group of ``sum_masks_planar`` gets its
    slice. The results stay the JAX package's, byte for byte."""
    from fractions import Fraction

    calls = []
    real = kernels.mask_fold

    def spy(acc, key_words, offsets, *args, **kwargs):
        tensor = torch.is_tensor(offsets)
        calls.append((tensor, tensor and offsets.dtype == torch.int64,
                      tensor and offsets.device == acc.device, len(offsets)))  # fmt: skip
        return real(acc, key_words, offsets, *args, **kwargs)

    monkeypatch.setattr(kernels, "mask_fold", spy)
    pair = CONFIGS[1].pair()
    port_pair = convert.config_pair(pair)
    n = 29
    seeds = _seeds(5, 0x4E)

    unit, vect = masking.derive_mask_limbs(seeds[0], n, port_pair, device=CPU)
    want = MaskSeed(seeds[0]).derive_mask(n, pair)
    assert np.array_equal(unit, want.unit.data)
    assert np.array_equal(planar_to_wire(fold.to_numpy_u32(vect)), want.vect.data)
    assert calls == [(True, True, True, 1)]

    weights = np.random.default_rng(8).uniform(-0.9, 0.9, n).astype(np.float32)
    _, want_masked = Masker(pair, MaskSeed(seeds[1])).mask(Scalar(Fraction(1, 5)), weights)
    masked = masking.mask_update(seeds[1], PortScalar(Fraction(1, 5)), weights, port_pair,
                                 device=CPU)  # fmt: skip
    assert masked.vect.data.tobytes() == want_masked.vect.data.tobytes()
    assert masked.unit.data.tobytes() == want_masked.unit.data.tobytes()
    assert calls[1:] == [(True, True, True, 1)]

    calls.clear()
    unit_sum, vect_sum = masking.sum_masks(seeds, n, port_pair, seed_batch=2, device=CPU)
    want_unit, want_vect = masking_jax.sum_masks(
        seeds, n, pair, seed_batch=2, kernel="fused-pallas-interpret"
    )
    assert unit_sum.tobytes() == np.asarray(want_unit).tobytes()
    assert vect_sum.tobytes() == np.asarray(want_vect).tobytes()
    assert calls == [(True, True, True, 2), (True, True, True, 2), (True, True, True, 1)]


def test_plain_mask_fold_accumulates_into_nonzero_acc():
    """K2 adds into whatever the accumulator holds (a second group)."""
    pair = CONFIGS[1].pair()
    order = pair.vect.order
    seeds = _seeds(4, 0x77)
    kws, offs = _words_offsets(seeds, pair)
    acc = fold.zeros_u32((2, 60), CPU)
    kernels.mask_fold(acc, fold.to_device_u32(kws[:2], CPU), offs[:2], 60, order)
    kernels.mask_fold(acc, fold.to_device_u32(kws[2:], CPU), offs[2:], 60, order)
    ref, _ = _reference_sum(seeds, 60, pair)
    assert np.array_equal(planar_to_wire(fold.to_numpy_u32(acc)), ref)


@pytest.mark.parametrize("cfg", CONFIGS[:3], ids=IDS[:3])
def test_sum_masks_matches_fused_pallas_route(cfg):
    pair = cfg.pair()
    n = 47
    seeds = _seeds(5, 0x1F)
    want_unit, want_vect = masking_jax.sum_masks(
        seeds, n, pair, seed_batch=2, kernel="fused-pallas-interpret"
    )
    unit, vect = masking.sum_masks(seeds, n, convert.config_pair(pair), seed_batch=2, device=CPU)
    assert np.array_equal(unit, np.asarray(want_unit))
    assert np.array_equal(vect, np.asarray(want_vect))
    ref = Aggregation(pair, n)
    for s in seeds:
        ref.aggregate(MaskSeed(s).derive_mask(n, pair))
    assert np.array_equal(vect, ref.object.vect.data)
    assert np.array_equal(unit, ref.object.unit.data)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_derive_mask_limbs_matches_seed_derive(cfg):
    pair = cfg.pair()
    seed = bytes(range(100, 132))
    want = MaskSeed(seed).derive_mask(33, pair)
    unit, vect = masking.derive_mask_limbs(seed, 33, convert.config_pair(pair), device=CPU)
    assert np.array_equal(unit, want.unit.data)
    assert np.array_equal(planar_to_wire(fold.to_numpy_u32(vect)), want.vect.data)


@pytest.mark.parametrize("cfg", CONFIGS[:2] + WORD_DRAWS[:1], ids=IDS[:2] + ["draw8"])
def test_mask_update_matches_masker(cfg):
    """A participant's masked update on the port (mask by K2, add by K1)
    against the reference ``Masker``."""
    from fractions import Fraction

    pair = cfg.pair()
    rng = np.random.default_rng(5)
    weights = rng.uniform(-0.9, 0.9, 64).astype(np.float32)
    seed = bytes(range(50, 82))
    _, want = Masker(pair, MaskSeed(seed)).mask(Scalar(Fraction(1, 3)), weights)
    got = masking.mask_update(
        seed, PortScalar(Fraction(1, 3)), weights, convert.config_pair(pair), device=CPU
    )
    assert np.array_equal(got.vect.data, want.vect.data)
    assert np.array_equal(got.unit.data, want.unit.data)


def test_unmask_vect_limbs_is_mod_sub():
    order = CONFIGS[1].order
    rng = np.random.default_rng(3)
    a = ref_limbs.ints_to_limbs([int(x) % order for x in rng.integers(0, 2**62, 40)], 2)
    b = ref_limbs.ints_to_limbs([int(x) % order for x in rng.integers(0, 2**62, 40)], 2)
    got = masking.unmask_vect_limbs(
        fold.to_device_u32(a.T, CPU), fold.to_device_u32(b.T, CPU), order
    )
    want = ref_limbs.mod_sub(a, b, ref_limbs.order_limbs_for(order))
    assert np.array_equal(planar_to_wire(fold.to_numpy_u32(got)), want)


# --- K2's trip plan (the wrapper's launch arithmetic, run on the CPU) -------

# a config for each draw width the plan must size, and its tile: as many
# candidates as keep a tile's keystream within one ChaCha block per thread
# (256 threads, 64 bytes each, any start byte within a block), at most 32
# candidates per thread
PLAN_WIDTHS = {
    6: (MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3), 2720),
    8: (MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B2, ModelType.M6), 2040),
    12: (MaskConfig(GroupType.POWER2, DataType.F32, BoundType.B4, ModelType.M12), 1360),
    17: (MaskConfig(GroupType.POWER2, DataType.F64, BoundType.B6, ModelType.M12), 960),
    37: (MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.BMAX, ModelType.M3), 441),
    268: (MaskConfig(GroupType.INTEGER, DataType.F64, BoundType.BMAX, ModelType.M12), 60),
}


@pytest.mark.parametrize("count", [1, 3000, 25_000_000])
@pytest.mark.parametrize("bpn", sorted(PLAN_WIDTHS))
def test_trip_plan_tiles_and_provisioning(bpn, count):
    cfg, tile = PLAN_WIDTHS[bpn]
    plan = kernels.plan_trips(count, cfg.order)
    assert plan.bpn == bpn == ref_limbs.draw_width_for(cfg.order)
    assert plan.trip == chacha_jax.provision_candidates(count, cfg.order)
    assert plan.tile == tile
    assert 63 + plan.tile * bpn <= 64 * kernels.K2_THREADS
    assert -(-plan.tile // kernels.K2_THREADS) <= 32
    assert (plan.n_tiles - 1) * plan.tile < plan.trip <= plan.n_tiles * plan.tile
    assert plan.scratch_words == plan.n_tiles + 2
    short = kernels.plan_trips(count, cfg.order, chunk_candidates=plan.tile + 1)
    assert (short.trip, short.n_tiles) == (plan.tile + 1, 2)


@pytest.mark.parametrize("start", [6, 2_110_731_114, 2**31 + 12_345, 2**38 + 7])
def test_trip_plan_offsets_walk_the_keystream_like_the_host_sampler(start):
    """Walking the plan's trips from a start cursor (past 2^31 bytes and
    past 2^32 blocks too) over the keystream, counting acceptances per
    trip, ends on the host sampler's cursor; the offsets are exact."""
    cfg = PLAN_WIDTHS[6][0]
    order, count = cfg.order, 400
    plan = kernels.plan_trips(count, order, chunk_candidates=_short_trip(count, order, 5))
    seed = bytes(range(7, 39))
    kw = np.frombuffer(seed, "<u4").tolist()
    order_cl = tuple(int(x) for x in ref_limbs.int_to_limbs(order, 2))
    base, t = 0, 0
    while True:
        off = plan.offset(start, t)
        assert off == start + t * plan.trip * plan.bpn
        ok = chacha.accept_mask(
            chacha.chop_candidates(chacha.keystream_bytes(kw, off, plan.trip * 6), plan.trip, 6),
            order_cl,
        )
        csum = torch.cumsum(ok.to(torch.int64), 0)
        if base + int(csum[-1]) >= count:
            end = off + (int(torch.nonzero(csum >= count - base)[0, 0]) + 1) * plan.bpn
            break
        base += int(csum[-1])
        t += 1
    assert t >= 3
    sampler = StreamSampler(seed)
    sampler.skip_bytes(start)
    sampler.draw_limbs(count, order)
    assert end == sampler.consumed_bytes


@pytest.mark.parametrize("chunk", [None, 2000])
@pytest.mark.parametrize("start", [2**31 + 12_345, 2**38 + 7])
def test_plain_mask_fold_from_cursors_past_32_bits(start, chunk):
    """The plain K2 from a cursor past 2^31 bytes (the 25M mask ends at
    ~2.11e9) and past 2^32 blocks (the block counter's high word), in one
    trip and in several, against the host sampler."""
    order = PLAN_WIDTHS[6][0].order
    seed = bytes(range(9, 41))
    kws = np.frombuffer(seed, "<u4")[None].copy()
    acc, ends = _port_mask_fold(kws, [start], 300, order, chunk)
    sampler = StreamSampler(seed)
    sampler.skip_bytes(start)
    want = sampler.draw_limbs(300, order)
    assert np.array_equal(planar_to_wire(acc), want) and ends == [sampler.consumed_bytes]
