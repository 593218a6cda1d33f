"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test needs an NVIDIA GPU and ``nvcc`` and skips
without them. This file imports neither JAX nor the JAX package, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``chip_smoke.py`` runs the same comparisons at the main path's sizes.)
The streaming pipeline's card cases (the dispatch-ahead stress, the
degrade-once fault and the fault on both tries) use the same seams as
``chip_smoke.py``'s phase P: the accumulator's fold seam and the
``streaming.fold`` fault site. The coordinator rounds use the port's
participant SDK as ``chip_smoke.py``'s phases R and R-wire do.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from xaynet_tpu_torch.core.crypto.prng import StreamSampler
from xaynet_tpu_torch.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
from xaynet_tpu_torch.ops import chacha, kernels, limbs
from xaynet_tpu_torch.ops.fold import to_device_u32, widen
from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator
from xaynet_tpu_torch.parallel.streaming import StreamingAggregator, StreamingError
from xaynet_tpu_torch.resilience import faults

pytestmark = pytest.mark.cuda

ORDERS = {
    "L2": MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3).order,
    "L3-2^96": MaskConfig(GroupType.POWER2, DataType.I32, BoundType.BMAX, ModelType.M9).order,
    "L4-draw17": MaskConfig(GroupType.POWER2, DataType.F64, BoundType.B6, ModelType.M12).order,
    "L10": MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.BMAX, ModelType.M3).order,
    "L67": MaskConfig(GroupType.INTEGER, DataType.F64, BoundType.BMAX, ModelType.M12).order,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    try:
        kernels.nvcc_path()
    except RuntimeError as exc:
        pytest.skip(str(exc))
    return torch.device("cuda")


def _elements(order: int, shape: tuple[int, ...], seed: int) -> np.ndarray:
    """Planar limbs of valid group elements (top limb below the order's)."""
    rng = np.random.default_rng(seed)
    n_limb = limbs.n_limbs_for_order(order)
    *lead, n = shape
    out = rng.integers(0, 1 << 32, size=(*lead, n_limb, n), dtype=np.uint64).astype(np.uint32)
    if order != 1 << (32 * n_limb):
        top = int(limbs.int_to_limbs(order, n_limb)[-1])
        out[..., n_limb - 1, :] = rng.integers(0, top, size=(*lead, n), dtype=np.uint64)
    return out


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(widen(a), widen(b)))


@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("name", ["L2", "L3-2^96", "L10", "L67"])
def test_fold_kernels_match_plain(cuda, name, k):
    order = ORDERS[name]
    n = 4099
    acc = to_device_u32(_elements(order, (n,), k), cuda)
    stack = _elements(order, (k, n), k + 1)
    planar = to_device_u32(stack, cuda)
    got = kernels.fold_planar(acc.clone(), planar, order)
    assert _same(got, kernels.fold_planar_plain(acc.clone(), planar, order))
    packed = torch.from_numpy(limbs.pack_planar(stack, limbs.wire_width_for(order))).to(cuda)
    got = kernels.fold_packed(acc.clone(), packed, order)
    assert _same(got, kernels.fold_packed_plain(acc.clone(), packed, order))


@pytest.mark.parametrize("trips", [1, 5])
@pytest.mark.parametrize("name", ["L2", "L4-draw17", "L67"])
def test_mask_fold_kernel_matches_plain_and_host(cuda, name, trips):
    order = ORDERS[name]
    n_limb = limbs.n_limbs_for_order(order)
    bpn = limbs.draw_width_for(order)
    count = 500
    seeds = [bytes([i, 7]) * 16 for i in range(3)]
    kws = to_device_u32(np.stack([np.frombuffer(s, "<u4") for s in seeds]), cuda)
    offs = [13 * i + 6 for i in range(3)]
    chunk = None if trips == 1 else max(7, count * (1 << (8 * bpn)) // order // trips)
    acc0 = to_device_u32(_elements(order, (count,), 3), cuda)
    got, ends = kernels.mask_fold(acc0.clone(), kws, offs, count, order, chunk)
    want, want_ends = kernels.mask_fold_plain(acc0.clone(), kws, offs, count, order, chunk)
    assert _same(got, want) and ends.tolist() == want_ends.tolist()
    zero = torch.zeros((n_limb, count), dtype=torch.int32, device=cuda).view(torch.uint32)
    mask, end = kernels.mask_fold(zero, kws[:1], offs[:1], count, order, chunk)
    sampler = StreamSampler(seeds[0])
    sampler.skip_bytes(offs[0])
    host = sampler.draw_limbs(count, order)
    assert np.array_equal(mask.view(torch.int32).cpu().numpy().view(np.uint32).T, host)
    assert int(end[0]) == sampler.consumed_bytes


def _tile_acceptances(seed: bytes, start: int, order: int, n_tiles: int) -> list[int]:
    """Accepted candidates in each of K2's first ``n_tiles`` tiles of a trip
    from byte ``start`` (host arithmetic, independent of the kernel)."""
    bpn = limbs.draw_width_for(order)
    tile = kernels.plan_trips(1, order).tile
    kw = np.frombuffer(seed, "<u4").tolist()
    cand = chacha.chop_candidates(
        chacha.keystream_bytes(kw, start, n_tiles * tile * bpn), n_tiles * tile, bpn
    )
    order_cl = tuple(int(x) for x in limbs.int_to_limbs(order, cand.shape[1]))
    return chacha.accept_mask(cand, order_cl).view(n_tiles, tile).sum(1).tolist()


def _look_back_case(name: str):
    """(seeds, start cursors, count, chunk_candidates) of one look-back edge
    case, on the main path's order (draw width 6)."""
    order = ORDERS["L2"]
    seed = bytes(range(40, 72))
    acc0, acc1 = _tile_acceptances(seed, 6, order, 2)
    cases = {
        "count-in-tile-0": ([seed], [6], acc0 // 2, None),
        "last-of-tile-0": ([seed], [6], acc0, None),
        "first-of-tile-1": ([seed], [6], acc0 + 1, None),
        "last-of-tile-1": ([seed], [6], acc0 + acc1, None),
        "count-1": ([seed], [6], 1, None),
        # a trip 200 tiles long for 300 elements: most tiles exit on the done flag
        "early-exit": ([seed], [6], 300, 200 * kernels.plan_trips(1, order).tile),
        # about seven trips, the trip no multiple of the tile
        "seven-trips": ([seed], [6], 3000, 3000 * (1 << 48) // order // 7 + 13),
        "cursor-above-2^31": ([seed], [2**31 + 12345], 2000, None),
        "block-counter-above-2^32": ([seed], [2**38 + 7], 2000, None),
    }
    seeds = [bytes([i, 3]) * 16 for i in range(16)]
    cases["B16-mid-block"] = (seeds, [13 * i + 5 for i in range(16)], 5000, None)
    return cases[name]


LOOK_BACK_CASES = [
    "count-in-tile-0", "last-of-tile-0", "first-of-tile-1", "last-of-tile-1", "count-1",
    "early-exit", "seven-trips", "cursor-above-2^31", "block-counter-above-2^32",
    "B16-mid-block",
]  # fmt: skip


@pytest.mark.parametrize("case", LOOK_BACK_CASES)
def test_mask_fold_look_back_edge_cases(cuda, case):
    """K2's single pass where its look-back and early exit have edges: the
    count-th acceptance in tile 0 and on either side of a tile boundary,
    count 1, a trip far longer than the count, many trips, cursors past
    2^31 bytes and 2^32 blocks, a 16-seed group. Accumulator and end
    cursors against the plain version, and the first seed's mask and
    cursor against the host sampler."""
    order = ORDERS["L2"]
    seeds, offs, count, chunk = _look_back_case(case)
    kws = to_device_u32(np.stack([np.frombuffer(s, "<u4") for s in seeds]), cuda)
    acc0 = to_device_u32(_elements(order, (count,), 11), cuda)
    got, ends = kernels.mask_fold(acc0.clone(), kws, offs, count, order, chunk)
    want, want_ends = kernels.mask_fold_plain(acc0.clone(), kws, offs, count, order, chunk)
    assert _same(got, want) and ends.tolist() == want_ends.tolist()
    zero = torch.zeros((2, count), dtype=torch.int32, device=cuda).view(torch.uint32)
    mask, end = kernels.mask_fold(zero, kws[:1], offs[:1], count, order, chunk)
    sampler = StreamSampler(seeds[0])
    sampler.skip_bytes(offs[0])
    host = sampler.draw_limbs(count, order)
    assert np.array_equal(mask.view(torch.int32).cpu().numpy().view(np.uint32).T, host)
    assert int(end[0]) == sampler.consumed_bytes


def test_mask_fold_twenty_launches_into_one_acc(cuda):
    """Twenty K2 calls in a row into one accumulator, each over many tiles:
    a status word left from an earlier launch would shift a prefix."""
    order = ORDERS["L2"]
    count = 20_000
    acc = to_device_u32(_elements(order, (count,), 5), cuda)
    want = acc.clone()
    for i in range(20):
        kw = to_device_u32(np.frombuffer(bytes([i, 9]) * 16, "<u4")[None].copy(), cuda)
        _, end = kernels.mask_fold(acc, kw, [7 * i], count, order)
        _, want_end = kernels.mask_fold_plain(want, kw, [7 * i], count, order)
        assert end.tolist() == want_end.tolist()
    assert _same(acc, want)


def test_launch_counters_count_kernel_launches(cuda):
    order = ORDERS["L2"]
    kernels.reset_launches()
    acc = to_device_u32(_elements(order, (64,), 0), cuda)
    kernels.fold_planar(acc, to_device_u32(_elements(order, (2, 64), 1), cuda), order)
    kws = to_device_u32(np.zeros((2, 8), np.uint32), cuda)
    kernels.mask_fold(acc, kws, [0, 5], 64, order)
    assert kernels.LAUNCHES == {
        "fold_planar": 1, "fold_packed": 0, "mask_fold": 2, "wire_unpack": 0, "packed_check": 0
    }


WIRE_ORDERS = {
    "L2 prime": ORDERS["L2"],
    "L2 bpn7": MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6).order,
    "L3-2^96": ORDERS["L3-2^96"],
    "L4 bpn13": MaskConfig(GroupType.PRIME, DataType.F64, BoundType.B6, ModelType.M3).order,
    "L67": ORDERS["L67"],
}


def _wire_case(order: int, k: int, n: int, seed: int) -> np.ndarray:
    """Wire limbs ``uint32[k, n, L]`` of valid elements, with an all-0xFF
    element first in update 0, the order in the middle of update k // 2 and
    order - 1 last in update k - 1."""
    n_limb, bpn = limbs.n_limbs_for_order(order), limbs.wire_width_for(order)
    rows = np.ascontiguousarray(_elements(order, (k, n), seed).transpose(0, 2, 1))
    rows[0, 0] = limbs.int_to_limbs((1 << (8 * bpn)) - 1, n_limb)
    if order != 1 << (32 * n_limb):
        rows[k // 2, n // 2] = limbs.int_to_limbs(order, n_limb)
        rows[k - 1, n - 1] = limbs.int_to_limbs(order - 1, n_limb)
    return rows


@pytest.mark.parametrize("k", [1, 3, 8, 64])
@pytest.mark.parametrize("name", list(WIRE_ORDERS))
def test_wire_kernels_match_plain(cuda, name, k):
    """K3 and K4 against their plain versions on the card, byte-exact, with
    invalid elements at the first and middle element of chosen updates."""
    order = WIRE_ORDERS[name]
    n = 4099 if k < 64 else 1031
    bpn = limbs.wire_width_for(order)
    rows = _wire_case(order, k, n, seed=k)
    raw = np.stack([np.ascontiguousarray(r.view(np.uint8).reshape(n, -1)[:, :bpn]).reshape(-1)
                    for r in rows])
    raw_dev = torch.from_numpy(raw).to(cuda)
    planar, bad = kernels.wire_unpack(raw_dev, order)
    want_planar, want_bad = kernels.wire_unpack_plain(raw_dev, order)
    assert _same(planar, want_planar) and _same(bad, want_bad)
    packed = torch.from_numpy(np.ascontiguousarray(raw.reshape(k, n, bpn).transpose(0, 2, 1)))
    packed = packed.to(cuda)
    got = kernels.packed_check(packed, order)
    assert _same(got, kernels.packed_check_plain(packed, order))
    assert _same(got, bad)
    if order != 1 << (32 * limbs.n_limbs_for_order(order)):
        assert bool(bad[0]) and bool(bad[k // 2])


@pytest.mark.parametrize("name", [n for n in WIRE_ORDERS if n != "L3-2^96"])
def test_packed_check_decides_at_every_plane(cuda, name):
    """K4 walks down the planes while an element ties the order: elements
    ``order + 256^b`` (invalid) and ``order - 256^b`` (valid), whose planes
    above b equal the order's, are decided at plane b, for every b."""
    order = WIRE_ORDERS[name]
    n_limb, bpn = limbs.n_limbs_for_order(order), limbs.wire_width_for(order)
    n = 5000
    rows = np.ascontiguousarray(_elements(order, (2 * bpn + 1, n), seed=7).transpose(0, 2, 1))
    want = [0] * (2 * bpn + 1)
    for b in range(bpn):
        up = order + (1 << (8 * b))
        if up < 1 << (8 * bpn):
            rows[2 * b, (37 * b + 5) % n] = limbs.int_to_limbs(up, n_limb)
            want[2 * b] = 1
        rows[2 * b + 1, (37 * b + 5) % n] = limbs.int_to_limbs(order - (1 << (8 * b)), n_limb)
    raw = np.stack([np.ascontiguousarray(r.view(np.uint8).reshape(n, -1)[:, :bpn]) for r in rows])
    packed = torch.from_numpy(np.ascontiguousarray(raw.transpose(0, 2, 1))).to(cuda)
    got = kernels.packed_check(packed, order)
    assert _same(got, kernels.packed_check_plain(packed, order))
    assert [int(v != 0) for v in got.view(torch.int32).tolist()] == want
    # the same bytes from a base that is not 16-byte aligned
    buf = torch.empty(packed.numel() + 16, dtype=torch.uint8, device=cuda)
    for off in (1, 7, 15):
        shifted = buf[off : off + packed.numel()].view(packed.shape)
        shifted.copy_(packed)
        assert _same(kernels.packed_check(shifted, order), got)


def test_wire_launch_counters(cuda):
    order = ORDERS["L2"]
    raw = torch.zeros((3, 6 * 100), dtype=torch.uint8, device=cuda)
    kernels.reset_launches()
    kernels.wire_unpack(raw, order)
    kernels.packed_check(raw.view(3, 6, 100), order)
    kernels.packed_check(raw.view(3, 12, 50)[:, :12].contiguous(), ORDERS["L3-2^96"])
    assert kernels.LAUNCHES["wire_unpack"] == 1
    assert kernels.LAUNCHES["packed_check"] == 1  # none at the 2^(32L) boundary


def test_staged_wire_ingest_on_card_matches_cpu(cuda):
    """Lazy v1/v2 updates through StagedAggregator on the card and on the
    CPU: same aggregate, same rejection, no host element parse, and K3, K4
    and K1 launched once per group and chunk."""
    from xaynet_tpu_torch.core.mask.masking import AggregationError, Masker
    from xaynet_tpu_torch.core.mask.model import Scalar
    from xaynet_tpu_torch.core.mask.serialization import parse_mask_object, serialize_mask_object
    from xaynet_tpu_torch.server.aggregation import StagedAggregator

    cfg = PIPE_CFG
    n, total = 3001, 6
    rng = np.random.default_rng(8)
    wires = []
    for i in range(total):
        _, masked = Masker(cfg.pair()).mask(Scalar(1, total), rng.uniform(-1, 1, n).astype(np.float32))
        wires.append(serialize_mask_object(masked, planar_vect=i % 2 == 1))
    corrupt = bytearray(wires[0])
    corrupt[8 + 6 * 1500 : 8 + 6 * 1501] = b"\xff" * 6
    wires.insert(3, bytes(corrupt))
    results = {}
    for dev in ("cpu", cuda):
        agg = StagedAggregator(cfg.pair(), n, batch_size=4, device=dev)
        objs = [parse_mask_object(w, lazy_vect=True)[0] for w in wires]
        kernels.reset_launches()
        agg.prevalidate_wire_batch(objs)
        rejected = []
        for i, obj in enumerate(objs):
            try:
                agg.validate_aggregation(obj)
            except AggregationError as e:
                rejected.append((i, e.kind))
                continue
            agg.aggregate(obj)
        vect, unit, nb = agg.snapshot_state()
        assert not any(o.vect.materialized for o in objs)
        results[str(dev)] = (vect, unit, nb, rejected, dict(kernels.LAUNCHES))
    cpu, card = results["cpu"], results[str(cuda)]
    assert np.array_equal(cpu[0], card[0]) and np.array_equal(cpu[1], card[1])
    assert cpu[2] == card[2] == total and cpu[3] == card[3] == [(3, "InvalidObject")]
    launches = card[4]
    # v1 members 0, 2, corrupt, 4 in one group; v2 members 1, 3, 5 in another
    assert launches["wire_unpack"] == 1 and launches["packed_check"] == 1
    # flushes at 4 staged: [0(v1), 1(v2), 2(v1), 3(v2)] and [4(v1), 5(v2)]
    assert launches["fold_planar"] == 2 and launches["fold_packed"] == 2


PIPE_CFG = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)


def _wire_batches(n: int, count: int, k: int, seed: int) -> list[np.ndarray]:
    return [np.ascontiguousarray(_elements(PIPE_CFG.order, (k, n), seed + i).transpose(0, 2, 1))
            for i in range(count)]


def _plain_fold(n: int, wires: list) -> DeviceAggregator:
    ref = DeviceAggregator(PIPE_CFG, n, device="cpu")
    for w in wires:
        ref.add_batch(w)
    return ref


@pytest.fixture
def no_fault_plan():
    yield
    faults.clear_plan()


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "planar"])
def test_pipeline_dispatch_ahead_stress(cuda, packed):
    """Depth 3, four ring buffers, a jittered fold seam, 32 batches: the
    pinned ring's buffers are reused only after their copies completed, so
    the aggregate equals the plain sequential fold; each batch folds once
    and every buffer comes back."""
    n, k, count = 65_539, 4, 32
    wires = _wire_batches(n, count, k, seed=100)
    agg = DeviceAggregator(PIPE_CFG, n, device=cuda)
    stream = StreamingAggregator(agg, staging_buffers=4, dispatch_ahead=3, max_batch=k,
                                 packed=packed)
    name = "_packed_fold_fn" if packed else "_fold_fn"
    real_fold = getattr(agg, name)
    jitter = iter(np.random.default_rng(3).uniform(0.0, 0.004, size=count))
    sizes = []

    def slow_fold(acc, staged):
        time.sleep(float(next(jitter)))
        sizes.append(int(staged.shape[0]))
        return real_fold(acc, staged)

    setattr(agg, name, slow_fold)
    for w in wires:
        stream.submit_batch(w)
    stream.drain()
    ref = _plain_fold(n, wires)
    assert np.array_equal(agg.snapshot(), ref.snapshot())
    assert agg.nb_models == ref.nb_models == k * count
    assert sizes == [k] * count
    assert stream.in_flight_models == 0
    assert all(ring.in_use == 0 for ring in stream._rings.values())
    stream.close()


def test_pipeline_fault_degrades_once_and_stays_exact(cuda, no_fault_plan):
    n, k = 32_771, 4
    wires = _wire_batches(n, 6, k, seed=200)
    faults.install_plan(faults.FaultPlan.parse("streaming.fold:error,nth=2"))
    agg = DeviceAggregator(PIPE_CFG, n, device=cuda)
    stream = StreamingAggregator(agg, max_batch=k)
    for w in wires:
        stream.submit_batch(w)
    stream.drain()
    assert stream.degraded
    ref = _plain_fold(n, wires)
    assert np.array_equal(agg.snapshot(), ref.snapshot()) and agg.nb_models == ref.nb_models
    stream.close()


def test_pipeline_fault_on_both_tries_poisons(cuda, no_fault_plan):
    n, k = 32_771, 4
    wires = _wire_batches(n, 3, k, seed=300)
    faults.install_plan(faults.FaultPlan.parse("streaming.fold:error,nth=2"))
    agg = DeviceAggregator(PIPE_CFG, n, device=cuda)
    stream = StreamingAggregator(agg, max_batch=k)
    stream.submit_batch(wires[0])
    stream.drain()

    def failed_copy(payload):
        raise RuntimeError("host-to-device copy failed (injected)")

    stream._upload = failed_copy
    stream.submit_batch(wires[1])
    for _ in range(2):
        with pytest.raises(StreamingError, match="copy failed"):
            stream.drain()
    with pytest.raises(StreamingError):
        stream.submit_batch(wires[2])
    assert stream.degraded and agg.nb_models == k and stream.in_flight_models == 0
    stream.close()


def test_pipeline_fold_error_after_launch_poisons_without_retry(cuda):
    """K1 ran, then the seam raised: the batch may be in ``acc``, so it is
    not retried (a retry would fold it twice)."""
    n, k = 32_771, 4
    wires = _wire_batches(n, 2, k, seed=400)
    agg = DeviceAggregator(PIPE_CFG, n, device=cuda)
    stream = StreamingAggregator(agg, max_batch=k)
    real_fold, calls = agg._packed_fold_fn, []

    def fold_then_raise(acc, staged):
        calls.append(1)
        real_fold(acc, staged)
        raise RuntimeError("K1 fold (packed) failed (injected after the launch)")

    agg._packed_fold_fn = fold_then_raise
    stream.submit_batch(wires[0])
    with pytest.raises(StreamingError, match="after the launch"):
        stream.drain()
    assert calls == [1] and not stream.degraded and agg.nb_models == 0
    stream.close()


def test_pipeline_pins_each_buffer_once_per_process(cuda):
    """A closed pipeline's pinned buffers go to the process-wide pool; the
    next round's ring of the same shape reuses them without pinning, and
    its aggregate is exact. Each batch drains before the next, so each
    round's ring holds one buffer (a producer that runs ahead adds more)."""
    n, k = 40_961, 4
    wires = _wire_batches(n, 4, k, seed=500)
    rings = []
    for _ in range(2):
        agg = DeviceAggregator(PIPE_CFG, n, device=cuda)
        stream = StreamingAggregator(agg, max_batch=k)
        for w in wires:
            stream.submit_batch(w)
            stream.drain()
        assert np.array_equal(agg.snapshot(), _plain_fold(n, wires).snapshot())
        rings.append(stream._rings["packed"])
        stream.close()
    first, second = rings
    assert first.allocated == first.reused + 1 == 1 and first.pin_seconds > 0.0
    assert second.allocated == second.reused == 1 and second.pin_seconds == 0.0


def test_short_flush_pins_a_buffer_sized_to_its_rows(cuda):
    """A flush of 3 rows at ``max_batch`` 64 stages through a pinned buffer
    of 4 rows, not 64, and folds exactly; the next pipeline's flush of 3
    takes that buffer from the process's pool without pinning."""
    n = 77_777  # a shape no other case pins
    wires = _wire_batches(n, 1, 3, seed=700)
    rings = []
    for _ in range(2):
        agg = DeviceAggregator(PIPE_CFG, n, device=cuda)
        stream = StreamingAggregator(agg, max_batch=64)
        stream.submit_batch(wires[0])
        stream.drain()
        assert np.array_equal(agg.snapshot(), _plain_fold(n, wires).snapshot())
        rings.append(stream._rings["packed"])
        stream.close()
    first, second = rings
    assert [len(b) for b in first._bufs] == [len(b) for b in second._bufs] == [4]
    assert first.nbytes == 4 * agg.packed_width * agg.padded_length
    assert first.pin_seconds > 0.0 and second.reused == 1 and second.pin_seconds == 0.0


def test_pipeline_closes_after_poison_with_its_copies_done(cuda):
    """A fold seam that raises (as a failed launch does) poisons the
    pipeline; ``close`` still waits out the fold stream and hands the ring
    buffers back, and a new pipeline reusing them folds exactly."""
    n, k = 32_771, 4
    wires = _wire_batches(n, 2, k, seed=600)
    agg = DeviceAggregator(PIPE_CFG, n, device=cuda)
    stream = StreamingAggregator(agg, max_batch=k)

    def failed_launch(acc, staged):
        raise RuntimeError("K1 launch failed (injected)")

    agg._packed_fold_fn = failed_launch
    stream.submit_batch(wires[0])
    with pytest.raises(StreamingError, match="injected"):
        stream.drain()
    assert stream._rings["packed"].in_use == 0
    stream.close()
    agg = DeviceAggregator(PIPE_CFG, n, device=cuda)
    stream = StreamingAggregator(agg, max_batch=k)
    for w in wires:
        stream.submit_batch(w)
    stream.drain()
    assert stream._rings["packed"].reused >= 1
    assert np.array_equal(agg.snapshot(), _plain_fold(n, wires).snapshot())
    stream.close()


def _sdk_round_on(tmp_path, device, length: int, seed: int, wire: bool = False) -> dict:
    """A small round through the port's coordinator (``serve()`` with
    ``device``) over the socket, driven by the port's SDK on ``device``
    (``chip_smoke.sdk_round``), with the launch counts of the round."""
    import chip_smoke
    from xaynet_tpu_torch.server.settings import Settings

    n_up = 3
    port = chip_smoke.free_port()
    base = f"http://127.0.0.1:{port}"
    cfg = chip_smoke.write_coordinator_config(tmp_path / f"config-{port}.toml", port, length,
                                              tmp_path / f"models-{port}", n_up, wire=wire)
    coordinator = chip_smoke.InProcessCoordinator(Settings.load(str(cfg), env={}), device)
    rng = np.random.default_rng(seed)
    weights = [rng.uniform(-0.9, 0.9, length).astype(np.float32) for _ in range(n_up)]
    try:
        chip_smoke.wait_for(lambda: chip_smoke.coordinator_phase(base) == "sum", 60, "sum")
        kernels.reset_launches()
        out = chip_smoke.sdk_round(base, weights, device, 4096, timeout=120)
        out["launches"] = dict(kernels.LAUNCHES)
    finally:
        coordinator.stop()
    out["weights"] = weights
    return out


def test_coordinator_round_on_card(cuda, tmp_path):
    """A small round through the port's coordinator (``serve()`` with no
    device, so CUDA) over the socket, with the port's SDK participants (no
    device, so CUDA): K1 packed folds the update phase's flush, the
    participants launch K1 planar and K2, and the model is byte-identical
    to the plain CPU fold + unmask of the updates and mask they sent."""
    from xaynet_tpu_torch.server.aggregation import StagedAggregator

    length, n_up = 10_000, 3
    out = _sdk_round_on(tmp_path, None, length, seed=5)
    launches = out["launches"]
    assert out["parts_per_update"][0] > 1  # multipart
    assert launches["fold_packed"] == 1
    assert launches["fold_planar"] == n_up and launches["mask_fold"] == 2 * n_up
    ref = StagedAggregator(out["mask"].config, length, batch_size=n_up, device="cpu")
    for obj in out["updates"]:
        ref.validate_aggregation(obj)
        ref.aggregate(obj)
    want = ref.finalize_inplace().unmask_array(out["mask"])
    assert out["model"].tobytes() == want.tobytes()
    mean = np.sum([w.astype(np.float64) for w in out["weights"]], axis=0) / n_up
    assert np.max(np.abs(out["model"] - mean)) <= n_up / out["mask"].config.vect.exp_shift + 1e-6


@pytest.mark.parametrize("wire", [False, True], ids=["staged", "wire-ingest"])
def test_sdk_round_on_card_equals_cpu_round(cuda, tmp_path, wire):
    """The same small round, coordinator and SDK participants on the card,
    then both on the CPU device: the models are the same floats (the masks
    differ, they cancel). With wire ingest the coordinator's K4 checks each
    v2 update."""
    length, n_up = 20_000, 3
    on_card = _sdk_round_on(tmp_path, None, length, seed=9, wire=wire)
    on_cpu = _sdk_round_on(tmp_path, "cpu", length, seed=9, wire=wire)
    assert on_card["model"].tobytes() == on_cpu["model"].tobytes()
    assert on_card["launches"]["packed_check"] == (n_up if wire else 0)
    assert on_card["launches"]["mask_fold"] == 2 * n_up
    assert not any(on_cpu["launches"].values())
    assert on_card["wire_planar"] == [wire] * n_up


def test_aggregate_masks_on_card_matches_cpu(cuda):
    """The SDK's Sum2 step at 1M parameters: the participant's
    ``_aggregate_masks`` on the card (K2) equals ``sum_masks`` on the CPU
    (the plain version), for 9 seeds (two of ``sum_masks``' groups)."""
    from xaynet_tpu_torch.core.mask.seed import MaskSeed
    from xaynet_tpu_torch.ops import masking
    from xaynet_tpu_torch.sdk.simulation import keys_for_task
    from xaynet_tpu_torch.sdk.state_machine import PetSettings, StateMachine

    pair = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3).pair()
    length = 1_000_000
    rng = np.random.default_rng(21)
    raw = [rng.bytes(32) for _ in range(9)]
    keys = keys_for_task(b"\x07" * 32, 0.0, 0.999, "update")
    sm = StateMachine(PetSettings(keys=keys), None, None)
    assert sm.device.type == "cuda"
    kernels.reset_launches()
    got = sm._aggregate_masks([MaskSeed(s) for s in raw], length, pair)
    assert kernels.LAUNCHES["mask_fold"] == 9
    unit, vect = masking.sum_masks(raw, length, pair, device="cpu")
    assert got.vect.data.tobytes() == vect.tobytes() and got.unit.data.tobytes() == unit.tobytes()
