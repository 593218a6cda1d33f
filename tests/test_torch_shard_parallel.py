"""The port's shard-parallel pipeline against the JAX package's, on the CPU.

After ``tests/test_shard_parallel.py``. The same masked updates (made from
a seed with the JAX package's ``Masker``) go through the JAX
``StreamingAggregator`` over a ``ShardedAggregator(kernel="xla")`` on the
first 1, 2 or 8 of ``conftest.py``'s virtual CPU devices, and through the
port's ``StreamingAggregator`` over a ``DeviceAggregator`` on a mesh of
the CPU device repeated as often (``make_mesh([cpu] * m)``: each entry a
shard of its own, with its own fold worker, ring and accumulator), and
through the port's one-shard path. Tolerance: none. The aggregates are
exact modular sums, so limbs must be byte-identical and ``nb_models``
equal, and the decoded floats must equal the JAX package's bit for bit.

The journal half writes and reads per-shard planes at model length 1001,
which 8 shards pad to 1008: JAX 8-shard planes restore into port meshes of
8 (shard-exact), 4 and 1, the port's 8-shard planes into the JAX package
on 8 devices, and a plane with a non-zero padding column is refused.
"""

from __future__ import annotations

import random
import sys
import threading
import time
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from xaynet_tpu.core.mask import (
    Aggregation,
    BoundType,
    DataType,
    GroupType,
    Masker,
    MaskConfig,
    ModelType,
    Scalar,
)
from xaynet_tpu.core.mask.object import MaskObject as JaxMaskObject
from xaynet_tpu.core.mask.object import MaskUnit as JaxMaskUnit
from xaynet_tpu.core.mask.object import MaskVect as JaxMaskVect
from xaynet_tpu.core.mask.seed import MaskSeed
from xaynet_tpu.core.mask.serialization import serialize_mask_vect, vect_element_block
from xaynet_tpu.parallel.aggregator import ShardedAggregator
from xaynet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from xaynet_tpu.parallel.streaming import StreamingAggregator as JaxStreamingAggregator
from xaynet_tpu.resilience.checkpoint import RoundCheckpoint as JaxRoundCheckpoint
from xaynet_tpu.server.aggregation import StagedAggregator as JaxStagedAggregator
from xaynet_tpu_torch import convert
from xaynet_tpu_torch.ops import kernels
from xaynet_tpu_torch.ops import masking as port_masking
from xaynet_tpu_torch.parallel import streaming as port_streaming
from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator
from xaynet_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple, serve_mesh, shard_slices
from xaynet_tpu_torch.parallel.shards import ShardPlan
from xaynet_tpu_torch.parallel.streaming import (
    SHARD_INFLIGHT,
    SHARD_STAGING_DEPTH,
    StreamingAggregator,
    StreamingError,
)
from xaynet_tpu_torch.resilience import faults
from xaynet_tpu_torch.resilience.checkpoint import RoundCheckpoint
from xaynet_tpu_torch.server.aggregation import StagedAggregator
from xaynet_tpu_torch.server.rest import RestServer
from xaynet_tpu_torch.telemetry.registry import get_registry

CPU = torch.device("cpu")
torch.set_num_threads(1)
CFG = MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6)
PAIR = convert.config_pair(CFG.pair())
BPN = CFG.bytes_per_number
MESH_SIZES = (1, 2, 8)
PACKED = pytest.mark.parametrize("packed", [True, False], ids=["packed", "planar"])


def _updates(n: int, total: int, seed: int):
    """``total`` masked updates (wire ``uint32[n, L]``), their v1 element
    blocks, and the host oracle that aggregated them one by one."""
    rng = np.random.default_rng(seed)
    host = Aggregation(CFG.pair(), n)
    stacks, raws = [], []
    for _ in range(total):
        w = rng.uniform(-1, 1, size=n).astype(np.float32)
        _, masked = Masker(CFG.pair()).mask(Scalar(1, total), w)
        host.aggregate(masked)
        stacks.append(masked.vect.data)
        raws.append(np.frombuffer(vect_element_block(serialize_mask_vect(masked.vect)),
                                  dtype=np.uint8))  # fmt: skip
    return stacks, raws, host


def _jax(n: int, m: int, **kw):
    agg = ShardedAggregator(CFG, n, mesh=jax_make_mesh(jax.devices()[:m]), kernel="xla")
    return agg, JaxStreamingAggregator(agg, **kw)


def _port(n: int, m: int | None, **kw):
    mesh = None if m is None else make_mesh([CPU] * m)
    agg = DeviceAggregator(PAIR.vect, n, device=CPU if mesh is None else None, mesh=mesh)
    return agg, StreamingAggregator(agg, **kw)


@pytest.fixture
def no_fault_plans():
    yield
    faults.clear_plan()


def test_mesh_helpers_match_jax():
    from xaynet_tpu.parallel import mesh as jax_mesh

    for n, k in ((1001, 8), (1000, 4), (7, 3), (8, 8)):
        assert pad_to_multiple(n, k) == jax_mesh.pad_to_multiple(n, k)
        p = pad_to_multiple(n, k)
        assert shard_slices(p, k) == jax_mesh.shard_slices(p, k)
    with pytest.raises(ValueError):
        shard_slices(10, 3)
    assert make_mesh([CPU] * 3) == (CPU, CPU, CPU)
    assert serve_mesh(CPU) == (CPU,)  # the coordinator never repeats a device


# --- the core property: mesh sizes x planar/packed/wire -------------------


@PACKED
@pytest.mark.parametrize("mesh_size", MESH_SIZES)
def test_sharded_batches_byte_identical_to_jax(mesh_size, packed):
    n, total, bs = 103, 13, 4  # 103 is no multiple of 2 or 8: padding columns
    stacks, _, host = _updates(n, total, seed=0)
    jax_agg, jax_stream = _jax(n, mesh_size, max_batch=bs, packed=packed)
    one, one_stream = _port(n, None, max_batch=bs, packed=packed)
    agg, stream = _port(n, mesh_size, max_batch=bs, packed=packed)
    assert stream._sharded == jax_stream._sharded == (mesh_size > 1)
    assert agg.padded_length == jax_agg.padded_length
    for i in range(0, total, bs):
        for s in (jax_stream, one_stream, stream):
            s.submit_batch(np.stack(stacks[i : i + bs]))
    for s in (jax_stream, one_stream, stream):
        s.drain()
    assert np.array_equal(agg.snapshot(), jax_agg.snapshot())
    assert np.array_equal(agg.snapshot(), one.snapshot())
    assert np.array_equal(agg.snapshot(), host.object.vect.data)
    assert agg.nb_models == jax_agg.nb_models == one.nb_models == total
    if mesh_size > 1:
        assert [len(w["fold"]) for w in stream.last_window["shards"]] == [4] * mesh_size
    for s in (jax_stream, one_stream, stream):
        s.close()


@pytest.mark.parametrize("mesh_size", MESH_SIZES)
def test_sharded_wire_byte_identical_with_deferred_acceptance(mesh_size):
    """K6 on each shard's byte slice, the verdicts settled across the
    shards at the batch's commit, the tickets resolved at the drain."""
    n, total, bs = 57, 11, 4
    _, raws, _ = _updates(n, total, seed=3)
    bad = raws[5].copy()
    bad[:BPN] = 0xFF  # element 0 >= order: the member is rejected
    wires = raws[:5] + [bad] + raws[6:]
    jax_agg, jax_stream = _jax(n, mesh_size, max_batch=bs)
    agg, stream = _port(n, mesh_size, max_batch=bs)
    want = [jax_stream.submit_wire_batch(np.stack(wires[i : i + bs])) for i in range(0, total, bs)]
    tickets = [stream.submit_wire_batch(np.stack(wires[i : i + bs])) for i in range(0, total, bs)]
    assert all(t.accepted is None for t in tickets)  # deferred to the drain
    jax_stream.drain()
    stream.drain()
    got = np.concatenate([t.accepted for t in tickets])
    assert np.array_equal(got, np.concatenate([t.accepted for t in want]))
    assert not got[5] and got.sum() == total - 1
    assert np.array_equal(agg.snapshot(), jax_agg.snapshot())
    assert agg.nb_models == jax_agg.nb_models == total - 1
    stream.close()
    jax_stream.close()


def test_wire_member_rejected_by_one_shard_only(monkeypatch):
    """n = 1001 on 8 shards: the invalid element is the model's last, in
    shard 7's slice alone. Shards 0-6 folded the member; each takes it back
    with K6's subtract-back pass (``kernels.wire_unfold``), so every shard
    holds the aggregate without it, as the JAX package's one mesh program
    does."""
    n, bs = 1001, 5
    stacks, raws, _ = _updates(n, 4, seed=11)
    bad = raws[2].copy()
    bad[(n - 1) * BPN : n * BPN] = 0xFF
    batch = np.stack(raws[:2] + [bad] + raws[3:])
    jax_agg = ShardedAggregator(CFG, n, mesh=jax_make_mesh(jax.devices()[:8]), kernel="xla")
    want_ok = jax_agg.add_wire_batch(batch)
    taken_back = []
    real = kernels.wire_unfold

    def spy(acc, raw, drop, order):
        taken_back.append((acc.shape[1], drop.tolist()))
        return real(acc, raw, drop, order)

    monkeypatch.setattr(kernels, "wire_unfold", spy)
    agg, stream = _port(n, 8, max_batch=bs)
    ticket = stream.submit_wire_batch(batch)
    stream.drain()
    assert ticket.accepted.tolist() == want_ok.tolist() == [True, True, False, True]
    # shards 0-6 took member 2 back; shard 7 had left it out
    assert taken_back == [(126, [False, False, True, False])] * 7
    assert np.array_equal(agg.snapshot(), jax_agg.snapshot())
    assert np.array_equal(agg.snapshot(), _host_sum([stacks[i] for i in (0, 1, 3)]))
    # the caller-thread entry settles the same way
    direct, _ = _port(n, 8)
    assert direct.add_wire_batch(batch).tolist() == [True, True, False, True]
    assert np.array_equal(direct.snapshot(), agg.snapshot()) and direct.nb_models == 3
    stream.close()


@pytest.mark.parametrize("planar", [False, True], ids=["v1-rows", "v2-rows"])
def test_sharded_fold_rows_now_device_resident(planar):
    """The wire-ingest flush: rows validated on the mesh's first device
    fold on the caller's thread, each shard its columns, as the JAX
    package's per-shard fan-out does."""
    n, total = 96, 10
    stacks, raws, _ = _updates(n, total, seed=29)
    jax_agg, jax_stream = _jax(n, 8, max_batch=4)
    agg, stream = _port(n, 8, max_batch=4)
    if planar:
        blocks = [np.ascontiguousarray(r.reshape(n, BPN).T) for r in raws]
        jax_stream.fold_packed_rows_now(jax_agg.validate_planar_updates(blocks))
        stream.fold_packed_rows_now(agg.validate_planar_updates(blocks))
    else:
        jax_stream.fold_planar_rows_now(jax_agg.validate_wire_updates(raws))
        stream.fold_planar_rows_now(agg.validate_wire_updates(raws))
    for s in (jax_stream, stream):
        s.drain()
    assert np.array_equal(agg.snapshot(), jax_agg.snapshot())
    assert agg.nb_models == jax_agg.nb_models == total
    stream.close()
    jax_stream.close()


def test_sharded_dispatch_ahead_out_of_order_stress():
    """The producer runs several batches ahead of 8 shard workers whose
    folds finish late with per-shard jitter: every batch commits exactly
    once, the per-shard gauges return to zero, the aggregate stays exact."""
    n, total, bs = 64, 36, 3
    stacks, _, host = _updates(n, total, seed=7)
    agg, stream = _port(n, 8, staging_buffers=4, dispatch_ahead=3, max_batch=bs)
    rng = random.Random(0)
    real = agg._packed_fold_fn
    folds = []

    def slow_fold(acc, staged):
        time.sleep(rng.uniform(0.0, 0.004))
        folds.append(staged.shape[0])
        return real(acc, staged)

    agg._packed_fold_fn = slow_fold
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: lost updates show
    try:
        for i in range(0, total, bs):
            stream.submit_batch(np.stack(stacks[i : i + bs]))
        stream.drain()
    finally:
        sys.setswitchinterval(interval)
    assert len(folds) == 8 * (total // bs)  # each batch once on each shard
    assert np.array_equal(agg.snapshot(), host.object.vect.data)
    assert agg.nb_models == total and stream.in_flight_models == 0
    for d in range(8):
        assert SHARD_INFLIGHT.labels(shard=str(d)).value == 0
        assert SHARD_STAGING_DEPTH.labels(shard=str(d)).value == 0
    stream.close()


# --- the degradation ladder ---------------------------------------------------


def test_shard_failure_degrades_then_completes_byte_identical(no_fault_plans):
    """Shard 3's fold fails once before its launch: that shard retries its
    slice, the pipeline flips to the synchronous path, and the round ends
    with the JAX package's aggregate."""
    n, total, bs = 48, 12, 3
    stacks, _, host = _updates(n, total, seed=5)
    jax_agg, jax_stream = _jax(n, 8, max_batch=bs)
    agg, stream = _port(n, 8, max_batch=bs)
    faults.install_plan(faults.FaultPlan.parse("streaming.shard3.fold:error,nth=2"))
    for i in range(0, total, bs):
        jax_stream.submit_batch(np.stack(stacks[i : i + bs]))
        stream.submit_batch(np.stack(stacks[i : i + bs]))
    jax_stream.drain()
    stream.drain()
    assert stream.degraded
    assert np.array_equal(agg.snapshot(), jax_agg.snapshot())
    assert np.array_equal(agg.snapshot(), host.object.vect.data)
    assert agg.nb_models == total
    stream.close()
    jax_stream.close()


def test_shard_failure_twice_poisons_with_batch_and_one_flight_dump(no_fault_plans,
                                                                    monkeypatch):
    """Shard 5 fails at its fault site, then its retry fails too (at the
    upload: K1 folds in place, so only a failure before the launch is
    retried): the batch is lost, the pipeline poisons naming batch 1 and the
    cause, every later submit and drain raises, and exactly one flight dump
    is taken."""
    n, bs = 48, 3
    stacks, _, _ = _updates(n, 9, seed=6)
    dumps = []
    monkeypatch.setattr(port_streaming, "flight_dump",
                        lambda trigger, detail="", **kw: dumps.append((trigger, detail)))
    agg, stream = _port(n, 8, max_batch=bs)
    real_upload = stream._upload

    def upload(payload, device=None):
        if threading.current_thread().name == "xn-stream-fold-5":
            raise RuntimeError("shard 5 is on fire")
        return real_upload(payload, device)

    stream._upload = upload
    faults.install_plan(faults.FaultPlan.parse("streaming.shard5.fold:error,max=1"))
    stream.submit_batch(np.stack(stacks[0:3]))
    with pytest.raises(StreamingError, match="batch 1.*shard 5 is on fire"):
        stream.drain()
    with pytest.raises(StreamingError, match="poisoned"):
        stream.submit_batch(np.stack(stacks[3:6]))
    with pytest.raises(StreamingError, match="batch 1"):
        stream.drain()
    assert stream.in_flight_models == 0
    stream.close()
    assert len(dumps) == 1 and dumps[0][0] == "pipeline-poison" and "batch 1" in dumps[0][1]


def test_shard_parallel_opt_out_folds_every_shard_on_one_worker():
    n, total, bs = 64, 6, 3
    stacks, raws, _ = _updates(n, total, seed=21)
    jax_agg, jax_stream = _jax(n, 8, max_batch=bs, shard_parallel=False)
    agg, stream = _port(n, 8, max_batch=bs, shard_parallel=False)
    assert not stream._sharded and not jax_stream._sharded
    for s in (jax_stream, stream):
        s.submit_batch(np.stack(stacks[0:3]))
        s.submit_wire_batch(np.stack(raws[3:6]))
        s.drain()
    assert stream._shard_queues is None  # the single worker folded them
    assert np.array_equal(agg.snapshot(), jax_agg.snapshot())
    assert agg.nb_models == jax_agg.nb_models == total
    stream.close()
    jax_stream.close()


def test_shard_plan_reassemble_roundtrip():
    """Split a non-zero accumulator into 4 shards, fold each shard's slice,
    reassemble: the JAX package's sequential fold, byte for byte."""
    n, total = 96, 4
    stacks, _, _ = _updates(n, total, seed=17)
    base = _updates(n, 2, seed=18)[0]
    ref = ShardedAggregator(CFG, n, mesh=jax_make_mesh(jax.devices()[:1]), kernel="xla")
    ref.add_batch(np.stack(base))
    ref.add_batch(np.stack(stacks))
    agg = DeviceAggregator(PAIR.vect, n, mesh=[CPU] * 4)
    agg.restore(_host_sum(base), 2)  # a global accumulator
    assert agg._live_plan is None
    plan = agg.ensure_plan()  # split from it
    planar = np.zeros((total, agg.n_limbs, agg.padded_length), np.uint32)
    planar[:, :, :n] = np.stack(stacks).transpose(0, 2, 1)
    for d, (lo, hi) in enumerate(plan.slices):
        plan.fold(d, torch.from_numpy(np.ascontiguousarray(planar[:, :, lo:hi]).view(np.int32))
                  .view(torch.uint32))  # fmt: skip
    plan.synchronize()
    agg.acc = plan.reassemble()
    assert agg._live_plan is None
    assert np.array_equal(agg.snapshot(), ref.snapshot())
    zero = ShardPlan(agg, zero_accs=True)
    assert not np.any(np.concatenate([a.numpy() for a in zero.accs], axis=1))


def _host_sum(stacks) -> np.ndarray:
    host = Aggregation(CFG.pair(), stacks[0].shape[0])
    # one zero unit per update, as many limbs as the unit's order needs: the
    # reference's numpy fold takes nothing narrower (its native fold happens
    # to, and a worker whose native build raced another's falls back)
    units = np.zeros((len(stacks),) + host.object.unit.data.shape, np.uint32)
    host.aggregate_batch(np.stack(stacks), units)
    return host.object.vect.data


def test_healthz_pipeline_section_reports_shards():
    """``/healthz``'s ``pipeline`` section carries the per-shard gauges
    under the JAX names, read from the registry; ``/statusz`` renders them."""
    n, bs = 64, 3
    stacks, _, _ = _updates(n, 6, seed=23)
    agg, stream = _port(n, 8, max_batch=bs)
    stream.submit_batch(np.stack(stacks[0:3]))
    stream.submit_batch(np.stack(stacks[3:6]))
    stream.drain()
    stream.close()
    rest = RestServer.__new__(RestServer)  # only _streaming_health is exercised
    rest.registry = get_registry()
    section = rest._streaming_health()
    assert section["degraded"] is False and section["inflight_folds"] == 0
    for d in range(8):
        shard = section["shards"][str(d)]
        assert shard["staging_depth"] == 0 and shard["inflight_folds"] == 0
        assert "overlap_ratio" in shard
    from xaynet_tpu_torch.server import console

    html = console._streaming_section(rest)
    assert all(f">{d}<" in html for d in range(8))


# --- the eager per-shard unmask -------------------------------------------------


def test_eager_per_shard_unmask_decodes_as_jax_package():
    """Five updates through ``StagedAggregator`` on 8 shards; Unmask with
    the drain deferred stages one unmask leg per shard behind the folds.
    The decoded floats equal the JAX ``DeviceAggregation.unmask_array``'s on
    its 8 devices, bit for bit."""
    n, k = 1001, 5
    pair = CFG.pair()
    rng = np.random.default_rng(2024)
    seeds = [rng.bytes(32) for _ in range(k)]
    updates = [
        Masker(pair, MaskSeed(s)).mask(Scalar(Fraction(1, k)), rng.uniform(-1, 1, n).astype(np.float32))[1]
        for s in seeds
    ]
    unit, vect = port_masking.sum_masks(seeds, n, PAIR, seed_batch=2, device=CPU)
    mask = JaxMaskObject(JaxMaskVect(pair.vect, vect), JaxMaskUnit(pair.unit, unit))
    theirs = JaxStagedAggregator(pair, n, device=True, batch_size=2, kernel="xla")
    ours = StagedAggregator(PAIR, n, batch_size=2, mesh=[CPU] * 8)
    for obj in updates:
        theirs.aggregate(obj)
        ours.aggregate(convert.mask_object(obj))
    legs = []
    real = ours._stream.finish_unmask
    ours._stream.finish_unmask = lambda job: legs.append(job) or real(job)
    want = theirs.finalize_inplace(defer_drain=True).unmask_array(mask)
    got = ours.finalize_inplace(defer_drain=True).unmask_array(convert.mask_object(mask))
    del ours._stream.finish_unmask  # the spy: no cycle keeps the pipeline alive
    ours.close()  # its leases are the process pool's: give them back now
    assert len(legs) == 1 and legs[0].remaining == 0  # every shard ran its leg
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# --- the journal's per-shard planes ------------------------------------------------


def _ckpt(cls, snap, n: int):
    return cls(round_id=1, phase="sum2", round_seed=b"\0" * 32, mask_config=[],
               model_length=n, nb_models=snap.nb_models, seed_watermark=0,
               vect=np.zeros((0, 0), np.uint32), unit=snap.unit, planes=snap.planes)  # fmt: skip


def _staged_round(staged, updates, port: bool):
    for obj in updates:
        staged.aggregate(convert.mask_object(obj) if port else obj)
    return staged.snapshot_journal()


@pytest.fixture(scope="module")
def journal_updates():
    rng = np.random.default_rng(99)
    return [Masker(CFG.pair()).mask(Scalar(1, 4), rng.uniform(-1, 1, 1001).astype(np.float32))[1]
            for _ in range(4)]  # fmt: skip


@pytest.mark.parametrize("mesh_size", [8, 4, 1])
def test_jax_8_shard_journal_restores_on_port_meshes(journal_updates, mesh_size):
    n = 1001
    theirs = JaxStagedAggregator(CFG.pair(), n, device=True, batch_size=2, kernel="xla")
    snap = _staged_round(theirs, journal_updates, port=False)
    assert [(lo, hi) for lo, hi, _ in snap.planes] == shard_slices(1008, 8)
    want_vect, want_unit, want_nb = theirs.snapshot_state()
    ours = StagedAggregator(PAIR, n, batch_size=2, mesh=[CPU] * mesh_size)
    ours.restore_journal(_ckpt(RoundCheckpoint, snap, n))
    # 8 shards take the planes as they are; 4 and 1 join them on the host
    assert (ours._device._live_plan is not None) == (mesh_size == 8)
    vect, unit, nb = ours.snapshot_state()
    ours.close()
    assert np.array_equal(vect, want_vect) and np.array_equal(unit, want_unit)
    assert nb == want_nb == 4
    if mesh_size == 4:  # the reference's own host fallback cannot pad 1008 down to 1004
        jax4 = ShardedAggregator(CFG, n, mesh=jax_make_mesh(jax.devices()[:4]), kernel="xla")
        with pytest.raises(ValueError, match="broadcast"):
            jax4.restore_shards(snap.planes, snap.nb_models)


def test_port_8_shard_journal_restores_in_jax_package(journal_updates):
    n = 1001
    ours = StagedAggregator(PAIR, n, batch_size=2, mesh=[CPU] * 8)
    snap = _staged_round(ours, journal_updates, port=True)
    assert [(lo, hi) for lo, hi, _ in snap.planes] == shard_slices(1008, 8)
    theirs = JaxStagedAggregator(CFG.pair(), n, device=True, batch_size=2, kernel="xla")
    theirs.restore_journal(_ckpt(JaxRoundCheckpoint, snap, n))
    want = JaxStagedAggregator(CFG.pair(), n, device=True, batch_size=2, kernel="xla")
    want_snap = _staged_round(want, journal_updates, port=False)
    for (lo, hi, a), (lo2, hi2, b) in zip(snap.planes, want_snap.planes):
        assert (lo, hi) == (lo2, hi2) and np.array_equal(a, b)
    assert np.array_equal(theirs.snapshot_state()[0], want.snapshot_state()[0])
    # and the port's own journal round trip, through the serialized entry
    again = StagedAggregator(PAIR, n, batch_size=2, mesh=[CPU] * 8)
    entry = RoundCheckpoint.from_bytes(_ckpt(RoundCheckpoint, snap, n).to_bytes())
    again.restore_journal(entry)
    assert np.array_equal(again.snapshot_state()[0], want.snapshot_state()[0])
    ours.close()
    again.close()


def test_journal_plane_with_non_zero_padding_column_is_refused(journal_updates):
    n = 1001
    ours = StagedAggregator(PAIR, n, batch_size=2, mesh=[CPU] * 8)
    snap = _staged_round(ours, journal_updates, port=True)
    lo, hi, last = snap.planes[-1]
    last = last.copy()
    last[0, n - lo] = 1  # column 1001: padding
    snap.planes[-1] = (lo, hi, last)
    for size in (8, 4, 1):
        fresh = StagedAggregator(PAIR, n, batch_size=2, mesh=[CPU] * size)
        with pytest.raises(ValueError, match="past the model length"):
            fresh.restore_journal(_ckpt(RoundCheckpoint, snap, n))
        fresh.close()
    ours.close()


def test_eager_unmask_waits_for_the_wire_commit(monkeypatch):
    """A shard's unmask leg runs behind its own folds, but a wire batch's
    commit (on the last shard to fold it) may still take a rejected member
    back from this shard: the leg waits for every batch queued before it to
    commit. The commit is slowed here so each shard's leg would otherwise
    run first."""
    n, bs = 1003, 3
    stacks, raws, _ = _updates(n, 6, seed=41)
    bad = raws[4].copy()
    bad[(n - 1) * BPN :] = 0xFF  # shard 3's slice only
    real = ShardPlan.settle_wire

    def slow_settle(plan, *args, **kwargs):
        time.sleep(0.2)
        return real(plan, *args, **kwargs)

    monkeypatch.setattr(ShardPlan, "settle_wire", slow_settle)
    mask = np.ascontiguousarray(stacks[5])  # any valid group elements
    got = []
    for m in (4, None):
        agg, stream = _port(n, m, max_batch=bs)
        stream.submit_batch(np.stack(stacks[:3]))
        ticket = stream.submit_wire_batch(np.stack([raws[3], bad, raws[5]]))
        job = stream.stage_unmask(agg.mask_planar(mask))
        assert (job is not None) == (m is not None)
        stream.drain()
        got.append((stream.finish_unmask(job) if job else agg.unmask_limbs(mask),
                    ticket.accepted.tolist()))  # fmt: skip
        stream.close()
    assert got[0][1] == got[1][1] == [True, False, True]
    assert np.array_equal(got[0][0], got[1][0])


def test_pool_ledger_counts_each_card_and_finalizer_releases_never_wait():
    """The device ledger's cap holds per card: a plan over two cards leases
    a slice on each. A finalizer's release (``release_soon``) that a
    collection runs inside a pool call on the same thread, with the pool
    lock held, queues instead of waiting for that lock; the next pool call
    releases it."""
    from xaynet_tpu_torch.tenancy import PagePool, PoolExhausted

    pool = PagePool(page_bytes=4096, slab_pages=4, device_pages=2)
    a = pool.lease_device("t", 2 * 4096, "cuda:0")
    b = pool.lease_device("t", 2 * 4096, "cuda:1")  # another card: its own cap
    with pytest.raises(PoolExhausted, match="cuda:0"):
        pool.lease_device("t", 4096, "cuda:0")
    assert pool.device_pages_by_device() == {"cuda:0": 2, "cuda:1": 2}
    with pool._lock:  # a collection inside a pool call on this thread
        pool.release_soon([a, b])
    assert not a.released and not b.released
    assert pool.balanced("t") and a.released and b.released
    assert pool.device_pages_by_device() == {}
