"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test needs an NVIDIA GPU and ``nvcc`` and skips
without them. This file imports neither JAX nor the JAX package, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``chip_smoke.py`` runs the same comparisons at the main path's sizes.)
The streaming pipeline's card cases (the dispatch-ahead stress, the
degrade-once fault and the fault on both tries) use the same seams as
``chip_smoke.py``'s phase P: the accumulator's fold seam and the
``streaming.fold`` fault site.
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
    assert kernels.LAUNCHES == {"fold_planar": 1, "fold_packed": 0, "mask_fold": 2}


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
