"""The port's fused wire ingest against the JAX package's, on the CPU.

``DeviceAggregator.add_wire_batch`` / ``dispatch_staged_bytes`` and
``StreamingAggregator.submit_wire_batch`` (kernel K6 on a card, its plain
version ``kernels.wire_fold_plain`` here) are held against the JAX
``ShardedAggregator.add_wire_batch``, its fused program ``_make_ingest_fn``
and the JAX ``StreamingAggregator.submit_wire_batch``
(``tests/test_jax_kernels.py``'s wire ingest cases,
``tests/test_streaming_agg.py``'s deferred acceptance). Inputs are masked
updates made from a seed with the JAX package's ``Masker`` and serialized
to v1 element blocks; invalid members carry an element >= the order.
Tolerance: none, the aggregates and acceptance vectors are exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
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
from xaynet_tpu.core.mask.serialization import serialize_mask_vect, vect_element_block
from xaynet_tpu.parallel.aggregator import ShardedAggregator
from xaynet_tpu.parallel.mesh import make_mesh
from xaynet_tpu.parallel.streaming import StreamingAggregator as JaxStreamingAggregator
from xaynet_tpu.parallel.streaming import StreamingError as JaxStreamingError
from xaynet_tpu.resilience import faults as jax_faults
from xaynet_tpu_torch.core.mask.config import MaskConfig as PortMaskConfig
from xaynet_tpu_torch.ops import kernels
from xaynet_tpu_torch.ops.fold import to_device_u32, to_numpy_u32
from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator
from xaynet_tpu_torch.parallel.streaming import StreamingAggregator, StreamingError, StreamTicket
from xaynet_tpu_torch.resilience import faults

CPU = torch.device("cpu")
CONFIGS = {
    "prime-f32-m3": MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3),
    "int-f32-m6": MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6),
    "pow2-2^96": MaskConfig(GroupType.POWER2, DataType.I32, BoundType.BMAX, ModelType.M9),
    "prime-f64-multilimb": MaskConfig(GroupType.PRIME, DataType.F64, BoundType.B6, ModelType.M3),
}
CFG = CONFIGS["int-f32-m6"]


def _port_cfg(cfg) -> PortMaskConfig:
    return PortMaskConfig.from_bytes(cfg.to_bytes())


def _wires(cfg, n: int, k: int, seed: int) -> tuple[list, list]:
    """``k`` masked updates of length ``n``: their v1 element blocks and
    their mask objects."""
    rng = np.random.default_rng(seed)
    raws, objs = [], []
    for _ in range(k):
        w = rng.uniform(-1, 1, size=n).astype(np.float32)
        if cfg.data_type is DataType.I32:
            w = rng.integers(-100, 100, size=n).astype(np.int32)
        _, masked = Masker(cfg.pair()).mask(Scalar(1, k), w)
        raws.append(np.frombuffer(vect_element_block(serialize_mask_vect(masked.vect)),
                                  dtype=np.uint8).copy())  # fmt: skip
        objs.append(masked)
    return raws, objs


def _corrupt(raw: np.ndarray, bpn: int, at: int) -> np.ndarray:
    """``raw`` with element ``at`` set to all 0xFF bytes (>= every order
    below 2^(8 bpn))."""
    bad = raw.copy()
    bad[at * bpn : (at + 1) * bpn] = 0xFF
    return bad


def _host_fold(cfg, n: int, objs: list) -> np.ndarray:
    host = Aggregation(cfg.pair(), n)
    for obj in objs:
        host.aggregate(obj)
    return host.object.vect.data


@pytest.mark.parametrize("cfg_id", list(CONFIGS))
def test_add_wire_batch_matches_jax(cfg_id):
    """Two batches, the second with invalid members at the first, a middle
    and the last element: the port's accumulator, acceptance vectors and
    ``nb_models`` equal the JAX aggregator's (whose 8-device mesh pads the
    odd length) and the host fold of the valid members."""
    cfg = CONFIGS[cfg_id]
    n, bpn = 103, cfg.bytes_per_number
    raws, objs = _wires(cfg, n, 6, seed=5)
    pow2 = cfg.group_type is GroupType.POWER2
    second = np.stack([_corrupt(raws[2], bpn, 0), raws[3], _corrupt(raws[4], bpn, n // 2),
                       _corrupt(raws[5], bpn, n - 1)])  # fmt: skip
    theirs = ShardedAggregator(cfg, n)
    ours = DeviceAggregator(_port_cfg(cfg), n, device=CPU)
    for batch in (np.stack(raws[:2]), second):
        want = theirs.add_wire_batch(batch)
        got = ours.add_wire_batch(batch)
        assert got.dtype == np.bool_ and got.tolist() == want.tolist()
    expect = [True, True] + ([True] * 4 if pow2 else [False, True, False, False])
    assert ours.nb_models == theirs.nb_models == sum(expect)
    assert np.array_equal(ours.snapshot(), theirs.snapshot())
    kept = [o for o, ok in zip(objs, expect) if ok]
    if not pow2:  # the corrupted blocks' objects are not the bytes folded
        assert np.array_equal(ours.snapshot(), _host_fold(cfg, n, kept))


@pytest.mark.parametrize("cfg_id", list(CONFIGS))
def test_wire_fold_plain_matches_jax_fused_program(cfg_id):
    """``kernels.wire_fold`` on CPU tensors (``wire_fold_plain``) against
    the JAX fused ingest program ``_make_ingest_fn`` (the XLA program K6
    replaces) on a one-device mesh: same accumulator, same ``ok``; the
    accumulator starts non-zero and is updated in place."""
    cfg = CONFIGS[cfg_id]
    n, bpn = 57, cfg.bytes_per_number
    raws, _ = _wires(cfg, n, 5, seed=7)
    batch = np.stack([raws[0], _corrupt(raws[1], bpn, 3), raws[2], raws[3], raws[4]])
    theirs = ShardedAggregator(cfg, n, mesh=make_mesh(jax.devices()[:1]), kernel="xla")
    theirs.add_wire_batch(np.stack(raws[3:]))  # a non-zero accumulator
    start = theirs.snapshot()
    acc_j, ok_j = theirs._make_ingest_fn()(theirs.acc, jnp.asarray(batch))
    ours = to_device_u32(np.ascontiguousarray(start.T), CPU)
    same = ours
    acc, ok = kernels.wire_fold(ours, torch.from_numpy(batch), _port_cfg(cfg).order)
    assert acc is same  # in place
    assert ok.dtype == torch.bool and ok.tolist() == np.asarray(ok_j).tolist()
    assert np.array_equal(to_numpy_u32(acc), np.asarray(acc_j)[:, :n])


def test_dispatch_staged_bytes_defers_the_fetch():
    """``dispatch_staged_bytes`` returns the device ``ok`` and credits
    nothing; ``add_wire_batch`` fetches and credits at once."""
    n = 40
    raws, _ = _wires(CFG, n, 3, seed=3)
    batch = np.stack([raws[0], _corrupt(raws[1], CFG.bytes_per_number, 7), raws[2]])
    agg = DeviceAggregator(_port_cfg(CFG), n, device=CPU)
    ok = agg.dispatch_staged_bytes(torch.from_numpy(batch))
    assert torch.is_tensor(ok) and ok.tolist() == [True, False, True]
    assert agg.nb_models == 0
    theirs = ShardedAggregator(CFG, n)
    ok_j = theirs.dispatch_staged_bytes(theirs._stage_raw_bytes(batch))
    assert np.asarray(ok_j).tolist() == ok.tolist() and theirs.nb_models == 0
    assert np.array_equal(agg.snapshot(), theirs.snapshot())
    assert agg.add_wire_batch(batch).tolist() == [True, False, True]
    assert agg.nb_models == 2


@pytest.mark.parametrize("bad", ["dtype", "length", "rank"])
def test_add_wire_batch_refuses_wrong_shapes(bad):
    n = 10
    agg = DeviceAggregator(_port_cfg(CFG), n, device=CPU)
    raw = np.zeros((2, n * CFG.bytes_per_number), dtype=np.uint8)
    raw = {"dtype": raw.astype(np.uint16), "length": raw[:, 1:], "rank": raw[None]}[bad]
    with pytest.raises(ValueError, match="expected uint8"):
        agg.add_wire_batch(raw)


def _pipelines(n: int, **kw):
    theirs = ShardedAggregator(CFG, n, mesh=make_mesh(jax.devices()[:1]), kernel="xla")
    ours = DeviceAggregator(_port_cfg(CFG), n, device=CPU)
    return (theirs, JaxStreamingAggregator(theirs, **kw)), (ours, StreamingAggregator(ours, **kw))


def test_streaming_wire_deferred_acceptance_matches_jax_and_sequential():
    """Raw-wire streaming: accumulator, nb_models AND the per-member
    acceptance vectors (fetched in one deferred sync at drain) equal the
    sequential ``add_wire_batch`` path and the JAX pipeline, an invalid
    member included. Batches of 4 and a last of 3 (staged in a 4-row ring
    buffer: its unused row is never folded)."""
    n, total, bs = 57, 11, 4
    raws, objs = _wires(CFG, n, total, seed=3)
    wires = raws[:5] + [_corrupt(raws[5], CFG.bytes_per_number, 0)] + raws[6:]
    seq = DeviceAggregator(_port_cfg(CFG), n, device=CPU)
    seq_oks = [seq.add_wire_batch(np.stack(wires[i : i + bs])) for i in range(0, total, bs)]
    (jagg, jstream), (agg, stream) = _pipelines(n, staging_buffers=3, dispatch_ahead=2,
                                                max_batch=bs)  # fmt: skip
    out = {}
    for name, s in (("jax", jstream), ("port", stream)):
        tickets = [s.submit_wire_batch(np.stack(wires[i : i + bs])) for i in range(0, total, bs)]
        if name == "port":
            assert all(isinstance(t, StreamTicket) and t.k == len(wires[i * bs:(i + 1) * bs])
                       for i, t in enumerate(tickets))  # fmt: skip
            assert stream.counted_models() == total  # optimistic until the drain
        accepted = s.drain()
        assert accepted == total - 1
        out[name] = np.concatenate([t.accepted for t in tickets])
    # the last batch of 3 staged through a buffer of 4 rows, like the others
    assert set(stream._rings["wire"].buffer_rows) == {4}
    assert np.array_equal(out["port"], out["jax"])
    assert np.array_equal(out["port"], np.concatenate(seq_oks))
    assert not out["port"][5] and int(out["port"].sum()) == total - 1
    assert np.array_equal(agg.snapshot(), seq.snapshot())
    assert np.array_equal(agg.snapshot(), jagg.snapshot())
    kept = [o for i, o in enumerate(objs) if i != 5]
    assert np.array_equal(agg.snapshot(), _host_fold(CFG, n, kept))
    assert agg.nb_models == jagg.nb_models == seq.nb_models == total - 1
    assert stream.in_flight_models == 0 and stream.drain() == 0
    stream.close()
    jstream.close()


def test_tickets_resolve_only_at_drain():
    n = 20
    raws, _ = _wires(CFG, n, 2, seed=4)
    (_, jstream), (agg, stream) = _pipelines(n, max_batch=2)
    gate = __import__("threading").Event()
    real = agg._wire_fold_fn

    def held(acc, staged):
        gate.wait(10.0)
        return real(acc, staged)

    agg._wire_fold_fn = held
    ticket = stream.submit_wire_batch(np.stack(raws))
    assert ticket.accepted is None and agg.nb_models == 0
    assert stream.counted_models() == 2
    gate.set()
    assert stream.drain() == 2
    assert ticket.accepted.tolist() == [True, True] and agg.nb_models == 2
    stream.close()
    jstream.close()


def _boom(*_):
    raise RuntimeError("wire fold died (stand-in)")


def test_wire_worker_failure_surfaces_at_drain_and_stays_poisoned():
    """A wire fold that fails in the worker surfaces at drain in both
    packages, its ticket never resolves, its count leaves flight, and the
    pipeline stays poisoned. The port does not retry it (K6 folds in
    place)."""
    n, bs = 32, 2
    raws, _ = _wires(CFG, n, 4, seed=9)
    (jagg, jstream), (agg, stream) = _pipelines(n, staging_buffers=2, dispatch_ahead=1,
                                                max_batch=bs)  # fmt: skip
    for s in (jstream, stream):
        s.submit_wire_batch(np.stack(raws[:bs]))
        assert s.drain() == bs
    jagg._fold_fn = jagg._packed_fold_fn = _boom
    jagg._make_unpack_fn = lambda: _boom
    agg._wire_fold_fn = _boom
    for s, err in ((jstream, JaxStreamingError), (stream, StreamingError)):
        ticket = s.submit_wire_batch(np.stack(raws[bs:]))
        with pytest.raises(err, match="wire fold died"):
            s.drain()
        assert ticket.accepted is None
        with pytest.raises(err):
            s.drain()
        with pytest.raises(err):
            s.submit_wire_batch(np.stack(raws[bs:]))
    assert agg.nb_models == jagg.nb_models == bs
    assert stream.in_flight_models == jstream.in_flight_models == 0
    assert not stream.degraded
    stream.close()
    jstream.close()


def test_wire_fault_at_fold_site_degrades_and_resolves_at_submit():
    """``streaming.fold`` fails the second batch's first try: it is retried
    on the synchronous path, the pipeline degrades, and from then on a
    wire ticket resolves at submit; the aggregate equals the JAX
    pipeline's under the same plan."""
    n, total, bs = 48, 8, 2
    raws, _ = _wires(CFG, n, total, seed=11)
    wires = raws[:3] + [_corrupt(raws[3], CFG.bytes_per_number, 1)] + raws[4:]
    spec = "streaming.fold:error,nth=2"
    faults.install_plan(faults.FaultPlan.parse(spec))
    jax_faults.install_plan(jax_faults.FaultPlan.parse(spec))
    try:
        (jagg, jstream), (agg, stream) = _pipelines(n, max_batch=bs)
        for name, s in (("jax", jstream), ("port", stream)):
            tickets = [s.submit_wire_batch(np.stack(wires[0:bs])),
                       s.submit_wire_batch(np.stack(wires[bs : 2 * bs]))]  # fmt: skip
            s.drain()
            assert s.degraded
            assert tickets[1].accepted.tolist() == [True, False]
            for i in range(2 * bs, total, bs):
                t = s.submit_wire_batch(np.stack(wires[i : i + bs]))
                assert t.accepted is not None  # degraded: resolved at submit
                assert s.in_flight_models == 0
            s.drain()
        assert np.array_equal(agg.snapshot(), jagg.snapshot())
        assert agg.nb_models == jagg.nb_models == total - 1
        stream.close()
        jstream.close()
    finally:
        faults.clear_plan()
        jax_faults.clear_plan()


def test_wire_ring_leases_from_the_pool_and_gives_back():
    """The ``wire`` ring leases its buffers from the page pool like the
    planar and packed rings, and ``close`` returns them. The pool is the
    test's own: the process-wide one also holds the leases of any pipeline
    another test left to the garbage collector."""
    from xaynet_tpu_torch.tenancy import LOCAL_TENANT, PagePool

    n = 30
    raws, _ = _wires(CFG, n, 3, seed=12)
    pool = PagePool()
    agg = DeviceAggregator(_port_cfg(CFG), n, device=CPU)
    stream = StreamingAggregator(agg, max_batch=4, pool=pool)
    stream.submit_wire_batch(np.stack(raws))
    stream.drain()
    ring = stream._rings["wire"]
    assert ring.allocated == 1 and ring.nbytes == 4 * n * CFG.bytes_per_number
    assert len(pool.outstanding(LOCAL_TENANT)) == 1  # the ring's one buffer
    stream.close()
    assert pool.balanced(LOCAL_TENANT)
