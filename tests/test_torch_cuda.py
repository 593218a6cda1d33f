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
participant SDK as ``chip_smoke.py``'s phases R and R-wire do, and the
durable round is its Phase D at a small length.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from xaynet_tpu_torch.core.crypto.prng import StreamSampler
from xaynet_tpu_torch.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
from xaynet_tpu_torch.ops import chacha, kernels, limbs
from xaynet_tpu_torch.ops.fold import to_device_u32, widen, zeros_u32
from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator
from xaynet_tpu_torch.parallel.streaming import StreamingAggregator, StreamingError
from xaynet_tpu_torch.resilience import faults
from xaynet_tpu_torch.tenancy import LOCAL_TENANT, PagePool, TenantScheduler

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
        "fold_planar": 1, "fold_packed": 0, "mask_fold": 2, "mask_fold_rows": 0, "wire_unpack": 0,
        "packed_check": 0, "unit_draws": 0, "wire_fold": 0,
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


@pytest.mark.parametrize("k", [1, 3, 8, 64])
@pytest.mark.parametrize("name", list(WIRE_ORDERS))
def test_wire_fold_matches_plain(cuda, name, k):
    """K6 (the fused wire ingest) against ``wire_fold_plain`` on the card,
    byte-exact: rejected members (an all-0xFF element first in update 0, the
    order in the middle of update k // 2) left out, ``order - 1`` kept, a
    ragged length, a non-zero accumulator updated in place."""
    order = WIRE_ORDERS[name]
    n = 4099 if k < 64 else 1031
    bpn = limbs.wire_width_for(order)
    rows = _wire_case(order, k, n, seed=k + 100)
    raw = np.stack([np.ascontiguousarray(r.view(np.uint8).reshape(n, -1)[:, :bpn]).reshape(-1)
                    for r in rows])
    raw_dev = torch.from_numpy(raw).to(cuda)
    acc = to_device_u32(_elements(order, (n,), k), cuda)
    want, want_ok = kernels.wire_fold_plain(acc.clone(), raw_dev, order)
    got = acc.clone()
    out, ok = kernels.wire_fold(got, raw_dev, order)
    assert out is got and ok.device.type == "cuda"
    assert _same(got, want) and ok.tolist() == want_ok.tolist()
    if order != 1 << (32 * limbs.n_limbs_for_order(order)):
        assert not ok[0] and not ok[k // 2]
    # all rejected: the accumulator comes back unchanged
    bad_rows = np.stack([raw[0]] * min(k, 3))
    same = acc.clone()
    _, ok = kernels.wire_fold(same, torch.from_numpy(bad_rows).to(cuda), order)
    if order != 1 << (32 * limbs.n_limbs_for_order(order)):
        assert not any(ok.tolist()) and _same(same, acc)


def test_wire_fold_launches_and_aggregator_paths(cuda):
    """One K6 launch per batch; ``add_wire_batch`` and the pipeline's
    ``submit_wire_batch`` + ``drain`` on the card equal the CPU's."""
    order = ORDERS["L2"]
    cfg = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)
    n, k = 3001, 5
    rows = _wire_case(order, k, n, seed=3)
    raw = np.stack([np.ascontiguousarray(r.view(np.uint8).reshape(n, -1)[:, :6]).reshape(-1)
                    for r in rows])
    kernels.reset_launches()
    card = DeviceAggregator(cfg, n, device=cuda)
    host = DeviceAggregator(cfg, n, device="cpu")
    assert card.add_wire_batch(raw).tolist() == host.add_wire_batch(raw).tolist()
    assert kernels.LAUNCHES["wire_fold"] == 1 and kernels.LAUNCHES["wire_unpack"] == 0
    stream = StreamingAggregator(card, max_batch=4)
    tickets = [stream.submit_wire_batch(raw[:3]), stream.submit_wire_batch(raw[3:])]
    assert stream.drain() == sum(int(t.accepted.sum()) for t in tickets)
    host.add_wire_batch(raw)
    assert np.array_equal(card.snapshot(), host.snapshot())
    assert card.nb_models == host.nb_models
    assert kernels.LAUNCHES["wire_fold"] == 3
    stream.close()


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


def test_coalesced_prevalidation_on_card_matches_per_member_path(cuda):
    """A coalesced micro-batch of v2 uploads, one with an invalid element:
    ``prevalidate_wire_batch`` (one K4 launch for the batch) caches the
    verdicts and device rows the per-member path (one K4 launch each)
    computes, and the aggregates they fold to are the same."""
    from xaynet_tpu_torch.core.mask.masking import AggregationError, Masker
    from xaynet_tpu_torch.core.mask.model import Scalar
    from xaynet_tpu_torch.core.mask.serialization import parse_mask_object, serialize_mask_object
    from xaynet_tpu_torch.server.aggregation import StagedAggregator

    cfg = PIPE_CFG
    n, total = 2049, 10
    rng = np.random.default_rng(12)
    wires = []
    for _ in range(total):
        _, masked = Masker(cfg.pair()).mask(Scalar(1, total), rng.uniform(-1, 1, n).astype(np.float32))
        wires.append(serialize_mask_object(masked, planar_vect=True))
    corrupt = parse_mask_object(wires[4], lazy_vect=True)[0].vect.planar_block.copy()
    corrupt[:, 700] = 0xFF  # an all-0xFF element, above the order
    results = {}
    for batched in (True, False):
        agg = StagedAggregator(cfg.pair(), n, batch_size=64, device=cuda)
        objs = [parse_mask_object(w, lazy_vect=True)[0] for w in wires]
        objs[4].vect.wire_block = corrupt.reshape(-1).copy()
        kernels.reset_launches()
        if batched:
            agg.prevalidate_wire_batch(objs)
        verdicts, rows = [], []
        for obj in objs:
            try:
                agg.validate_aggregation(obj)
            except AggregationError as e:
                verdicts.append(e.kind)
                rows.append(None)
                continue
            verdicts.append("ok")
            rows.append(obj.vect._staged_planar.clone())
            agg.aggregate(obj)
        launches = kernels.LAUNCHES["packed_check"]
        results[batched] = (verdicts, rows, agg.snapshot_state(), launches,
                            agg.prevalidated_chunks, agg.member_checks)  # fmt: skip
    (bv, brows, bstate, blaunch, bchunks, bmembers) = results[True]
    (pv, prows, pstate, plaunch, pchunks, pmembers) = results[False]
    assert bv == pv and bv.count("ok") == total - 1 and bv[4] == "InvalidObject"
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(brows, prows))
    assert all(np.array_equal(a, b) for a, b in zip(bstate[:2], pstate[:2]))
    assert bstate[2] == pstate[2] == total - 1
    assert (blaunch, bchunks, bmembers) == (1, 1, 0)
    assert (plaunch, pchunks, pmembers) == (total, 0, total)


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
    """A closed pipeline's leases go back to the page pool, whose slab stays
    page-locked; the next round's ring leases the same pages without
    pinning, and its aggregate is exact. Each batch drains before the
    next, so each round's ring holds one buffer (a producer that runs
    ahead adds more)."""
    n, k = 40_961, 4
    wires = _wire_batches(n, 4, k, seed=500)
    pool = PagePool()
    rings = []
    for _ in range(2):
        agg = DeviceAggregator(PIPE_CFG, n, device=cuda)
        stream = StreamingAggregator(agg, max_batch=k, pool=pool)
        for w in wires:
            stream.submit_batch(w)
            stream.drain()
        assert np.array_equal(agg.snapshot(), _plain_fold(n, wires).snapshot())
        rings.append(stream._rings["packed"])
        stream.close()
    first, second = rings
    assert first.allocated == first.reused + 1 == 1 and first.pin_seconds > 0.0
    assert second.allocated == second.reused == 1 and second.pin_seconds == 0.0
    assert pool.balanced(LOCAL_TENANT) and pool.pinned_bytes() > 0


def test_short_flush_pins_a_buffer_sized_to_its_rows(cuda):
    """A flush of 3 rows at ``max_batch`` 64 stages through a pinned buffer
    of 4 rows, not 64, and folds exactly; the next pipeline's flush of 3
    leases the same pinned pages from the page pool without pinning."""
    n = 77_777
    wires = _wire_batches(n, 1, 3, seed=700)
    pool = PagePool()
    rings = []
    for _ in range(2):
        agg = DeviceAggregator(PIPE_CFG, n, device=cuda)
        stream = StreamingAggregator(agg, max_batch=64, pool=pool)
        stream.submit_batch(wires[0])
        stream.drain()
        assert np.array_equal(agg.snapshot(), _plain_fold(n, wires).snapshot())
        rings.append(stream._rings["packed"])
        stream.close()
    first, second = rings
    assert first.buffer_rows == second.buffer_rows == [4]
    assert first.nbytes == 4 * agg.packed_width * agg.padded_length
    assert first.pin_seconds > 0.0 and second.reused == 1 and second.pin_seconds == 0.0


def test_pipeline_closes_after_poison_with_its_copies_done(cuda):
    """A fold seam that raises (as a failed launch does) poisons the
    pipeline; ``close`` still waits out the fold stream and gives the ring's
    leases back, and a new pipeline reusing their pinned pages folds
    exactly."""
    n, k = 32_771, 4
    wires = _wire_batches(n, 2, k, seed=600)
    pool = PagePool()
    agg = DeviceAggregator(PIPE_CFG, n, device=cuda)
    stream = StreamingAggregator(agg, max_batch=k, pool=pool)

    def failed_launch(acc, staged):
        raise RuntimeError("K1 launch failed (injected)")

    agg._packed_fold_fn = failed_launch
    stream.submit_batch(wires[0])
    with pytest.raises(StreamingError, match="injected"):
        stream.drain()
    assert stream._rings["packed"].in_use == 0
    stream.close()
    assert pool.balanced(LOCAL_TENANT)
    agg = DeviceAggregator(PIPE_CFG, n, device=cuda)
    stream = StreamingAggregator(agg, max_batch=k, pool=pool)
    for w in wires:
        stream.submit_batch(w)
    stream.drain()
    assert stream._rings["packed"].reused >= 1
    assert np.array_equal(agg.snapshot(), _plain_fold(n, wires).snapshot())
    stream.close()


def test_pool_slab_stays_pinned_across_release_and_re_lease(cuda):
    """A pinned lease's slab is page-locked once: the lease's tensor view is
    pinned, the run released and leased again by another tenant is the
    same pinned memory (zeroed, no new pinning), and only the compaction's
    trim of the free slab unlocks it."""
    pool = PagePool(page_bytes=1 << 20, slab_pages=4)
    first = pool.lease_host("a", (2, 1 << 20), np.uint8, pinned=True)
    assert torch.from_numpy(first.array).is_pinned() and first.pin_seconds > 0.0
    first.array[:] = 0xAB
    where = (first.slab, first.offset)
    assert pool.pinned_bytes() == 4 << 20
    pool.release(first)
    again = pool.lease_host("b", (2, 1 << 20), np.uint8, pinned=True)
    assert (again.slab, again.offset) == where and again.pin_seconds == 0.0
    assert torch.from_numpy(again.array).is_pinned() and not again.array.any()
    # an asynchronous copy out of the re-leased run reads what was written
    again.array[:] = 7
    dev = torch.from_numpy(again.array).to(cuda, non_blocking=True)
    torch.cuda.synchronize()
    assert int(dev.min()) == int(dev.max()) == 7
    pool.release(again)
    assert pool.pinned_bytes() == 4 << 20  # still held, still locked
    pool.compact()  # trims the free trailing slab: unlocked before dropped
    assert pool.pinned_bytes() == 0 and pool.stats()["slabs"] == 0
    third = pool.lease_host("a", (2, 1 << 20), np.uint8, pinned=True)
    assert third.pin_seconds > 0.0 and torch.from_numpy(third.array).is_pinned()
    pool.release(third)


def test_two_tenants_pipelines_on_card_at_once(cuda):
    """Two tenants' streaming pipelines fold on the card at the same time,
    each from its own thread, on one page pool and one scheduler with fewer
    slots than their batches: each aggregate equals the plain fold of its
    own batches, every batch held a slot, and the pool balances."""
    import threading

    pool, sched = PagePool(), TenantScheduler(max_inflight=2)
    lengths = {"a": 250_007, "b": 40_961}
    wires = {t: _wire_batches(n, 6, 4, seed=800 + i) for i, (t, n) in enumerate(lengths.items())}
    aggs = {t: DeviceAggregator(PIPE_CFG, n, device=cuda, tenant=t, pool=pool)
            for t, n in lengths.items()}  # fmt: skip
    streams = {t: StreamingAggregator(aggs[t], max_batch=4, tenant=t, pool=pool, scheduler=sched)
               for t in lengths}  # fmt: skip
    errors = []

    def run(tenant):
        try:
            torch.cuda.set_device(aggs[tenant].device.index or 0)  # per thread
            for w in wires[tenant]:
                streams[tenant].submit_batch(w)
            streams[tenant].drain()
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in lengths]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    for tenant, n in lengths.items():
        assert np.array_equal(aggs[tenant].snapshot(), _plain_fold(n, wires[tenant]).snapshot())
        streams[tenant].close()
        aggs[tenant].release_plan_pages()
        assert pool.balanced(tenant)
    assert sched.split() == {"a": 6, "b": 6} and sched._inflight == 0


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
    assert launches["unit_draws"] == n_up + 1  # each participant's mask, one for the Sum2
    ref = StagedAggregator(out["mask"].config, length, batch_size=n_up, device="cpu")
    for obj in out["updates"]:
        ref.validate_aggregation(obj)
        ref.aggregate(obj)
    want = ref.finalize_inplace().unmask_array(out["mask"])
    assert out["model"].tobytes() == want.tobytes()
    mean = np.sum([w.astype(np.float64) for w in out["weights"]], axis=0) / n_up
    assert np.max(np.abs(out["model"] - mean)) <= n_up / out["mask"].config.vect.exp_shift + 1e-6


def test_durable_round_killed_in_sum2_resumes_on_card(cuda, tmp_path, monkeypatch):
    """``chip_smoke.py``'s Phase D at a small length: the coordinator CLI on
    the card with the Redis and S3 stores (in this process), SIGKILLed in
    Sum2 once the journal holds the entry tagged ``sum2``, and started
    again: it resumes Sum2 with the accumulator uploaded to the card and
    read back byte-identical to the journaled one (the sha256 of the
    journal's accumulator in Redis), and the model read back from S3 is the
    plain CPU fold and unmask of what the participants sent (checks
    (d0)-(d9))."""
    import argparse

    import chip_smoke

    monkeypatch.chdir(tmp_path)  # the coordinators' logs go to ./chiprun_out
    args = argparse.Namespace(length=10_000, updates=3, batch=8, seed=11, device="cuda")
    record = chip_smoke.Smoke(args).phase_d()
    assert record["journal_gets"] and record["restore_upload_s"] >= 0
    assert record["process_launches"][0]["fold_packed"] == 1


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


def test_speculative_sum2_on_card_matches_cpu(cuda):
    """The speculative Sum2 on the card (K5, K2, K1 planar in the worker
    thread; the discard subtracted on the card) at 200,000 parameters: 7
    hits, 1 miss, 1 discard, equal to ``sum_masks`` on the CPU, no worker
    error, idle slots from a scheduler."""
    import time as _time

    from xaynet_tpu_torch.ops import masking
    from xaynet_tpu_torch.ops.speculation import SpeculativeMaskSession

    pair = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3).pair()
    length = 200_000
    rng = np.random.default_rng(22)
    seeds = [rng.bytes(32) for _ in range(8)]
    stray = rng.bytes(32)
    spec = SpeculativeMaskSession(length, pair, group=4, scheduler=TenantScheduler(max_inflight=2))
    assert spec.device.type == "cuda"
    kernels.reset_launches()
    spec.offer(seeds[:7] + [stray])
    deadline = _time.monotonic() + 120
    while spec.speculated() < 8 and _time.monotonic() < deadline:
        _time.sleep(0.01)
    assert spec.speculated() == 8 and spec.worker_error is None
    assert kernels.LAUNCHES["fold_planar"] == 2  # one per derive group
    unit, vect = spec.settle(seeds)
    want_unit, want_vect = masking.sum_masks(seeds, length, pair, device="cpu")
    assert vect.tobytes() == want_vect.tobytes() and unit.tobytes() == want_unit.tobytes()


def _trips_needed(starts, ends, trip: int, bpn: int) -> int:
    """Trips of ``trip`` candidates the slowest seed took (from its start
    and end cursors)."""
    return max((e - s - 1) // (trip * bpn) for s, e in zip(starts, ends)) + 1


@pytest.mark.parametrize("trips", [1, 5])
@pytest.mark.parametrize("b", [1, 8, 33, 256])
@pytest.mark.parametrize("name", ["L2", "L4-draw17", "L67"])
def test_mask_fold_rows_matches_plain(cuda, name, b, trips):
    """K2 with one accumulator per seed: each row against the plain version
    (rows and end cursors), from mid-block cursors that differ by seed, one
    or five trips; one launch per trip for the whole block, not one per
    seed."""
    order = ORDERS[name]
    bpn = limbs.draw_width_for(order)
    count = 301 if name == "L67" else 1001  # ragged
    rng = np.random.default_rng(b)
    seeds = [rng.bytes(32) for _ in range(b)]
    kws = to_device_u32(np.stack([np.frombuffer(s, "<u4") for s in seeds]), cuda)
    offs = [13 * i + 6 for i in range(b)]
    chunk = None if trips == 1 else max(7, count * (1 << (8 * bpn)) // order // trips)
    rows0 = to_device_u32(_elements(order, (b, count), b + 2), cuda)
    kernels.reset_launches()
    got, ends = kernels.mask_fold_rows(rows0.clone(), kws, offs, count, order, chunk)
    launched = kernels.LAUNCHES["mask_fold_rows"]
    want, want_ends = kernels.mask_fold_rows_plain(rows0.clone(), kws, offs, count, order, chunk)
    assert _same(got, want) and ends.tolist() == want_ends.tolist()
    plan = kernels.plan_trips(count, order, chunk)
    assert launched == _trips_needed(offs, want_ends.tolist(), plan.trip, bpn)
    assert (launched == 1) == (trips == 1) and kernels.LAUNCHES["mask_fold"] == 0


@pytest.mark.parametrize("trips", [1, 4])
@pytest.mark.parametrize("name", ["L2", "L10"])
def test_mask_fold_rows_strided_view_from_device_cursors(cuda, name, trips):
    """``mask_fold_rows`` into a strided view (every other row of a block
    with one spare limb per row) from K5's cursors, which stay on the card:
    the rows equal the plain version's, the block's other limbs and rows
    are untouched, and each seed's mask is its host sampler draw."""
    order = ORDERS[name]
    n_limb, bpn = limbs.n_limbs_for_order(order), limbs.draw_width_for(order)
    b, count = 8, 777
    rng = np.random.default_rng(41)
    raw = [rng.bytes(32) for _ in range(b)]
    kws = to_device_u32(np.stack([np.frombuffer(s, "<u4") for s in raw]), cuda)
    kernels.reset_launches()
    units, starts = kernels.unit_draws(kws, order)
    assert starts.device.type == "cuda" and kernels.LAUNCHES["unit_draws"] == 1
    chunk = None if trips == 1 else max(7, count * (1 << (8 * bpn)) // order // trips)
    block = to_device_u32(np.zeros((2 * b, n_limb + 1, count), np.uint32), cuda)
    rows = block[::2, :n_limb]
    assert not rows.is_contiguous()
    _, ends = kernels.mask_fold_rows(rows, kws, starts, count, order, chunk)
    want, want_ends = kernels.mask_fold_rows_plain(
        zeros_u32(tuple(rows.shape), cuda), kws, starts.cpu().tolist(), count, order, chunk
    )
    assert _same(rows, want) and ends.tolist() == want_ends.tolist()
    assert not widen(block[1::2]).any() and not widen(block[::2, n_limb]).any()
    plan = kernels.plan_trips(count, order, chunk)
    assert kernels.LAUNCHES["mask_fold_rows"] == _trips_needed(
        starts.tolist(), ends.tolist(), plan.trip, bpn
    )
    for i in (0, b - 1):
        sampler = StreamSampler(raw[i])
        unit = sampler.draw_limbs(1, order)[0]
        assert sampler.consumed_bytes == int(starts[i])
        assert np.array_equal(unit, units[i].cpu().view(torch.int32).numpy().view(np.uint32))
        host = sampler.draw_limbs(count, order)
        got = rows[i].cpu().view(torch.int32).numpy().view(np.uint32).T
        assert np.array_equal(got, host) and sampler.consumed_bytes == int(ends[i])


UNIT_ORDERS = {
    "draw6": ORDERS["L2"],
    "draw7": MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6).order,
    "draw8": MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B2, ModelType.M6).order,
    "draw12": MaskConfig(GroupType.POWER2, DataType.F32, BoundType.B4, ModelType.M12).order,
    "draw13-2^96": ORDERS["L3-2^96"],
    "draw16": MaskConfig(GroupType.PRIME, DataType.F64, BoundType.B4, ModelType.M12).order,
    "draw17-2^128": ORDERS["L4-draw17"],
    "draw37": ORDERS["L10"],
    "draw268": ORDERS["L67"],
}


@pytest.mark.parametrize("b", [1, 3, 257])
@pytest.mark.parametrize("name", sorted(UNIT_ORDERS))
def test_unit_draws_match_plain(cuda, name, b):
    """K5 against its plain version (units and cursors) at every draw width
    K2 is tested at, the 2^(32 L) orders among them; one launch; the first
    seed against the host sampler."""
    order = UNIT_ORDERS[name]
    kws = np.random.default_rng(b).integers(0, 1 << 32, (b, 8), dtype=np.uint64).astype(np.uint32)
    kw = to_device_u32(kws, cuda)
    kernels.reset_launches()
    units, cursors = kernels.unit_draws(kw, order)
    assert kernels.LAUNCHES["unit_draws"] == 1
    want_units, want_cursors = kernels.unit_draws_plain(kw, order)
    assert _same(units, want_units) and cursors.tolist() == want_cursors.tolist()
    sampler = StreamSampler(kws[0].astype("<u4").tobytes())
    unit = sampler.draw_limbs(1, order)[0]
    assert np.array_equal(unit, units[0].cpu().view(torch.int32).numpy().view(np.uint32))
    assert int(cursors[0]) == sampler.consumed_bytes


def test_sim_and_engine_on_card_equal_cpu(cuda):
    """A small ``SimRound`` (both sum-mask phases, a short last block) and a
    ``PopulationEngine`` on the card give the CPU run's bytes."""
    from fractions import Fraction

    from xaynet_tpu_torch.loadgen import PopulationEngine
    from xaynet_tpu_torch.sim import SimRound, SimSpec

    pair = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M6).pair()
    p, n = 37, 2049
    rng = np.random.default_rng(31)
    seeds = [rng.bytes(32) for _ in range(p)]
    weights = rng.uniform(-1, 1, (p, n)).astype(np.float32)
    scalar = Fraction(1, p)
    for fuse in (True, False):
        spec = SimSpec(pair, n, block_size=16, fuse_mask_sum=fuse, return_internals=True)
        kernels.reset_launches()
        on_card = SimRound(spec).run(seeds, weights, scalar)
        blocks = -(-p // 16)  # one K5 and one K2-per-row launch a block (one trip each)
        assert kernels.LAUNCHES["mask_fold_rows"] == blocks and kernels.LAUNCHES["fold_planar"] > 0
        assert kernels.LAUNCHES["unit_draws"] == blocks + (not fuse)  # + the Sum2's one
        on_cpu = SimRound(spec, device="cpu").run(seeds, weights, scalar)
        assert on_card.global_model.tobytes() == on_cpu.global_model.tobytes()
        for key, value in on_cpu.internals.items():
            assert np.array_equal(on_card.internals[key], value)
    card = PopulationEngine(pair, n, block_size=16).emit(seeds, weights, scalar)
    cpu = PopulationEngine(pair, n, block_size=16, device="cpu").emit(seeds, weights, scalar)
    assert all(np.array_equal(a, b) for a, b in zip(card, cpu))


# -- the model families: one train step on the card against the CPU ----------


@pytest.fixture
def card_f32():
    """A CUDA device with TF32 off (cuDNN convolutions use TF32 by default;
    the CPU computes in f32), restored afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _family_on_cpu(name: str):
    """(module on the CPU, make_train_step, x, y) at a small size."""
    from xaynet_tpu_torch.models import lenet, lstm, mlp, resnet

    g = torch.Generator().manual_seed(5)
    rng = np.random.default_rng(5)
    cpu = torch.device("cpu")
    if name == "mlp":
        return (mlp.init_params(g, 13, device=cpu), mlp.make_train_step,
                rng.normal(size=(16, 13)).astype(np.float32), rng.normal(size=16).astype(np.float32))  # fmt: skip
    if name == "lenet":
        return (lenet.init_params(g, device=cpu), lenet.make_train_step,
                rng.normal(size=(8, 32, 32, 3)).astype(np.float32), rng.integers(0, 10, 8))  # fmt: skip
    if name == "lstm":
        return (lstm.init_params(g, hidden=64, device=cpu), lstm.make_train_step,
                rng.integers(0, 80, (4, 20)), rng.integers(0, 80, (4, 20)))  # fmt: skip
    dtype = torch.float32 if name == "resnet-f32" else torch.bfloat16
    module = resnet.init_params(g, num_classes=10, stage_sizes=(1, 1, 1, 1), device=cpu, dtype=dtype)
    return (module, resnet.make_train_step,
            rng.normal(size=(4, 32, 32, 3)).astype(np.float32), rng.integers(0, 10, 4))  # fmt: skip


def _step(module, make_train_step, x, y) -> np.ndarray:
    from xaynet_tpu_torch.models.mlp import flatten_params

    _, optimizer_fn, step = make_train_step()
    step(module, optimizer_fn(module.parameters()), x, y)
    return flatten_params(module)


@pytest.mark.parametrize("name", ["mlp", "lenet", "lstm", "resnet-f32", "resnet-bf16"])
def test_train_step_on_card_matches_cpu(card_f32, name):
    """One step of each family from the same weights and batch, on the card
    and on the CPU. f32: 1e-5 absolute (SGD: lr x gradient; Adam: about lr
    per weight, so 1% of lr). ResNet bf16: the update's norm-relative
    distance from the CPU's at most twice the CPU bf16 update's own
    distance from the CPU f32 update (the rounding noise of the path)."""
    import copy

    from xaynet_tpu_torch.models.mlp import flatten_params

    module, make_train_step, x, y = _family_on_cpu(name)
    p0 = flatten_params(module)
    on_card = _step(copy.deepcopy(module).to(card_f32), make_train_step, x, y)
    on_cpu = _step(module, make_train_step, x, y)
    if name != "resnet-bf16":
        np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=1e-5)
        assert np.abs(on_cpu - p0).max() > 1e-4
        return
    f32_step = _step(_family_on_cpu("resnet-f32")[0], make_train_step, x, y)  # same weights
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)  # noqa: E731
    assert rel(on_card - p0, on_cpu - p0) <= 2 * rel(on_cpu - p0, f32_step - p0)


def test_lora_step_on_card_matches_cpu(card_f32):
    from xaynet_tpu_torch.models import lora

    spec = lora.LoraSpec({"q": (16, 8), "v": (16, 8)}, rank=4)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 16)).astype(np.float32)
    y = rng.normal(size=(32, 8)).astype(np.float32)
    out = {}
    for dev in ("cpu", card_f32):
        adapters = lora.init_adapters(torch.Generator().manual_seed(3), spec, device=dev)
        with torch.no_grad():
            adapters["q"]["B"].fill_(0.1)

        def loss_fn(a, batch):
            bx, by = batch
            pred = lora.apply_adapter(bx[:, :8], bx, a["q"], spec.alpha, spec.rank)
            return torch.mean((pred - by) ** 2)

        optimizer_fn, step = lora.make_train_step(loss_fn, learning_rate=1e-2)
        batch = (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
        step(adapters, optimizer_fn(adapters), batch)
        out[str(dev)] = lora.quantize_deltas(adapters, 10**6)
    assert np.abs(out["cpu"] - out["cuda"]).max() <= 100  # 1e-4 at scale 1e6: 1% of lr
