"""The port's streaming pipeline against the JAX package's, on the CPU.

The same masked updates (made from a seed with the JAX package's
``Masker``, numpy throughout) go through the JAX ``StreamingAggregator``
over a one-device ``ShardedAggregator(kernel="xla")`` — the single-worker
pipeline of ``tests/test_streaming_agg.py`` — and through the port's
``StreamingAggregator`` over a ``DeviceAggregator`` on the CPU, packed and
planar. Tolerance: none. The aggregates are exact modular sums, so limbs
must be byte-identical and ``nb_models`` equal, to each other and to the
host oracle.

The failure ladder differs where the fold differs: K1 folds in place, so
the port retries only failures raised before the fold's launch (the fault
site, the upload) and poisons on anything the fold seam raises. Both
halves are held here: a fault at ``streaming.fold`` degrades once and
keeps the aggregate exact, and a seam that writes the accumulator and then
raises poisons without a retry.
"""

from __future__ import annotations

import threading
import time

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
from xaynet_tpu.parallel.aggregator import ShardedAggregator
from xaynet_tpu.parallel.mesh import make_mesh
from xaynet_tpu.parallel.streaming import StreamingAggregator as JaxStreamingAggregator
from xaynet_tpu.parallel.streaming import StreamingError as JaxStreamingError
from xaynet_tpu.resilience import faults as jax_faults
from xaynet_tpu.server.aggregation import StagedAggregator as JaxStagedAggregator
from xaynet_tpu_torch import convert
from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator
from xaynet_tpu_torch.parallel.streaming import StreamingAggregator, StreamingError
from xaynet_tpu_torch.resilience import faults
from xaynet_tpu_torch.server.aggregation import StagedAggregator

CPU = torch.device("cpu")
torch.set_num_threads(1)
CFG = MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6)
PAIR = convert.config_pair(CFG.pair())
PACKED = pytest.mark.parametrize("packed", [True, False], ids=["packed", "planar"])


def _updates(n: int, total: int, seed: int):
    """``total`` masked updates of length ``n`` (wire ``uint32[n, L]``) and
    the host oracle that aggregated them one by one."""
    rng = np.random.default_rng(seed)
    host = Aggregation(CFG.pair(), n)
    masked = []
    for _ in range(total):
        w = rng.uniform(-1, 1, size=n).astype(np.float32)
        _, obj = Masker(CFG.pair()).mask(Scalar(1, total), w)
        host.aggregate(obj)
        masked.append(obj)
    return masked, host


def _jax_pipeline(n: int, **kw):
    agg = ShardedAggregator(CFG, n, mesh=make_mesh(jax.devices()[:1]), kernel="xla")
    return agg, JaxStreamingAggregator(agg, **kw)


def _port_pipeline(n: int, **kw):
    agg = DeviceAggregator(PAIR.vect, n, device=CPU)
    return agg, StreamingAggregator(agg, **kw)


@pytest.fixture
def no_fault_plans():
    yield
    faults.clear_plan()
    jax_faults.clear_plan()


@PACKED
@pytest.mark.parametrize("submit", ["batch", "rows"])
def test_streaming_byte_identical_to_jax_and_sequential(packed, submit):
    """A wire stack (``batch``) or a list of wire rows (``rows``, the
    shape ``StagedAggregator.flush`` submits) per batch."""
    n, total, bs = 103, 13, 4
    masked, host = _updates(n, total, seed=0)
    stacks = [m.vect.data for m in masked]
    jax_agg, jax_stream = _jax_pipeline(n, staging_buffers=3, dispatch_ahead=2, max_batch=bs,
                                        packed=packed)
    agg, stream = _port_pipeline(n, staging_buffers=3, dispatch_ahead=2, max_batch=bs,
                                 packed=packed)
    seq = DeviceAggregator(PAIR.vect, n, device=CPU)
    assert stream._packed == jax_stream._packed == packed
    n_batches = 0
    for i in range(0, total, bs):
        batch = stacks[i : i + bs]
        seq.add_batch(np.stack(batch))
        jax_stream.submit_batch(np.stack(batch))
        stream.submit_batch(np.stack(batch) if submit == "batch" else list(batch))
        n_batches += 1
    jax_stream.drain()
    stream.drain()

    assert np.array_equal(agg.snapshot(), jax_agg.snapshot())
    assert np.array_equal(agg.snapshot(), seq.snapshot())
    assert np.array_equal(agg.snapshot(), host.object.vect.data)
    assert agg.nb_models == jax_agg.nb_models == seq.nb_models == total
    window = stream.last_window
    assert len(window["stage"]) == len(window["fold"]) == n_batches
    stream.close()
    jax_stream.close()


def test_dispatch_ahead_out_of_order_completion_stress():
    """The producer races up to three batches ahead of folds that finish
    late with jittered timing (32 batches): every batch folds exactly once,
    nothing stays in flight, every ring buffer comes back, and the
    aggregate equals the JAX pipeline's over the same batches."""
    n, total, bs = 64, 96, 3
    masked, host = _updates(n, total, seed=7)
    stacks = [m.vect.data for m in masked]
    jax_agg, jax_stream = _jax_pipeline(n, staging_buffers=4, dispatch_ahead=3, max_batch=bs)
    for i in range(0, total, bs):
        jax_stream.submit_batch(np.stack(stacks[i : i + bs]))
    jax_stream.drain()

    agg, stream = _port_pipeline(n, staging_buffers=4, dispatch_ahead=3, max_batch=bs)
    real_fold = agg._packed_fold_fn
    jitter = iter(np.random.default_rng(1).uniform(0.0, 0.004, size=total // bs))
    folded_sizes, in_flight_seen = [], []

    def slow_fold(acc, staged):
        time.sleep(float(next(jitter)))
        folded_sizes.append(int(staged.shape[0]))
        in_flight_seen.append(stream.in_flight_models)
        return real_fold(acc, staged)

    agg._packed_fold_fn = slow_fold
    for i in range(0, total, bs):
        stream.submit_batch(np.stack(stacks[i : i + bs]))
    stream.drain()

    assert np.array_equal(agg.snapshot(), jax_agg.snapshot())
    assert np.array_equal(agg.snapshot(), host.object.vect.data)
    assert agg.nb_models == jax_agg.nb_models == total
    assert folded_sizes == [bs] * (total // bs)  # each batch once, in order
    assert max(in_flight_seen) > bs  # the producer did run ahead of the folds
    assert stream.in_flight_models == 0
    assert all(ring.in_use == 0 for ring in stream._rings.values())
    # buffers as the depth needed them, never more than the ring's size
    assert 2 <= stream._rings["packed"].allocated <= 4
    stream.close()
    jax_stream.close()


def _boom(acc, staged):
    raise RuntimeError("fold died (stand-in)")


def test_worker_failure_surfaces_at_drain_and_stays_poisoned():
    """A fold seam that raises: both pipelines surface it at drain, stay
    poisoned for every later drain and submit, and still close. The port
    does not retry it (the seam may have folded in place)."""
    n, bs = 32, 2
    masked, _ = _updates(n, 4, seed=9)
    stacks = [m.vect.data for m in masked]
    jax_agg, jax_stream = _jax_pipeline(n, staging_buffers=2, dispatch_ahead=1, max_batch=bs)
    agg, stream = _port_pipeline(n, staging_buffers=2, dispatch_ahead=1, max_batch=bs)
    for s in (jax_stream, stream):
        s.submit_batch(np.stack(stacks[0:bs]))
        s.drain()
    jax_agg._fold_fn = jax_agg._packed_fold_fn = _boom
    agg._fold_fn = agg._packed_fold_fn = _boom
    for s, err in ((jax_stream, JaxStreamingError), (stream, StreamingError)):
        s.submit_batch(np.stack(stacks[bs : 2 * bs]))
        with pytest.raises(err, match="fold died"):
            s.drain()
        with pytest.raises(err):
            s.drain()
        with pytest.raises(err):
            s.submit_batch(np.stack(stacks[bs : 2 * bs]))
    assert agg.nb_models == jax_agg.nb_models == bs
    assert stream.in_flight_models == jax_stream.in_flight_models == 0
    assert not stream.degraded  # poisoned straight away, no retry
    with pytest.raises(StreamingError, match="batch 2"):
        stream.drain()
    stream.close()
    jax_stream.close()


@PACKED
def test_fault_at_fold_site_degrades_once_and_stays_exact(packed, no_fault_plans):
    """``streaming.fold`` fails the second batch's first try in both
    packages: it is retried synchronously, the pipeline degrades to the
    caller's thread, and the aggregate stays byte-identical."""
    n, total, bs = 48, 10, 2
    masked, host = _updates(n, total, seed=11)
    stacks = [m.vect.data for m in masked]
    spec = "streaming.fold:error,nth=2"
    faults.install_plan(faults.FaultPlan.parse(spec))
    jax_faults.install_plan(jax_faults.FaultPlan.parse(spec))
    jax_agg, jax_stream = _jax_pipeline(n, max_batch=bs, packed=packed)
    agg, stream = _port_pipeline(n, max_batch=bs, packed=packed)
    for s in (jax_stream, stream):
        s.submit_batch(np.stack(stacks[0:bs]))
        s.submit_batch(np.stack(stacks[bs : 2 * bs]))
        s.drain()
        assert s.degraded
        for i in range(2 * bs, total, bs):
            s.submit_batch(np.stack(stacks[i : i + bs]))
            assert s.in_flight_models == 0  # degraded: folded before submit returns
        s.drain()
    assert np.array_equal(agg.snapshot(), jax_agg.snapshot())
    assert np.array_equal(agg.snapshot(), host.object.vect.data)
    assert agg.nb_models == jax_agg.nb_models == total
    stream.close()
    jax_stream.close()


def test_seam_that_folds_in_place_then_raises_poisons_without_retry():
    """A fold seam that writes the accumulator and then raises (a launch
    error reported after the kernel ran): a retry would fold the batch
    twice, so the pipeline poisons without one."""
    n, bs = 40, 2
    masked, _ = _updates(n, 6, seed=13)
    stacks = [m.vect.data for m in masked]
    agg, stream = _port_pipeline(n, max_batch=bs)
    stream.submit_batch(np.stack(stacks[0:bs]))
    stream.drain()
    real_fold, calls = agg._packed_fold_fn, []

    def fold_then_raise(acc, staged):
        calls.append(int(staged.shape[0]))
        real_fold(acc, staged)
        raise RuntimeError("K1 fold (packed) failed: CUDA error (stand-in)")

    agg._packed_fold_fn = fold_then_raise
    stream.submit_batch(np.stack(stacks[bs : 2 * bs]))
    with pytest.raises(StreamingError, match="stand-in"):
        stream.drain()
    assert calls == [bs]  # folded once, never retried
    assert not stream.degraded
    assert agg.nb_models == bs and stream.in_flight_models == 0
    with pytest.raises(StreamingError):
        stream.drain()
    stream.close()


def test_fault_on_both_tries_poisons(no_fault_plans):
    """The fault site fails the first try and the upload fails the retry:
    the batch is lost, the pipeline is degraded and poisoned, and every
    later drain raises."""
    n, bs = 24, 2
    masked, _ = _updates(n, 4, seed=17)
    stacks = [m.vect.data for m in masked]
    agg, stream = _port_pipeline(n, max_batch=bs)
    stream.submit_batch(np.stack(stacks[0:bs]))
    stream.drain()
    faults.install_plan(faults.FaultPlan.parse("streaming.fold:error,max=1"))

    def failed_copy(payload):
        raise RuntimeError("host-to-device copy failed (stand-in)")

    stream._upload = failed_copy
    stream.submit_batch(np.stack(stacks[bs : 2 * bs]))
    for _ in range(2):
        with pytest.raises(StreamingError, match="copy failed"):
            stream.drain()
    assert stream.degraded
    assert agg.nb_models == bs and stream.in_flight_models == 0
    assert all(ring.in_use == 0 for ring in stream._rings.values())
    stream.close()


def test_staged_aggregator_flush_is_submit_drain_is_sync():
    """``flush()`` submits without losing updates; ``nb_models`` counts
    staged + in-flight + folded at every point, as the JAX package's;
    ``drain()`` is the synchronization; the finalized aggregates agree."""
    n, k = 40, 6
    masked, _ = _updates(n, k, seed=13)
    # the JAX package's shipped pipeline depths, which the port's uses
    jax_staged = JaxStagedAggregator(CFG.pair(), n, device=True, batch_size=2, kernel="xla",
                                     dispatch_ahead=2, staging_buffers=3)
    port = StagedAggregator(PAIR, n, batch_size=2, device=CPU)
    assert (port._stream.dispatch_ahead, port._stream.staging_buffers) == (2, 3)
    for obj in masked:
        port_obj = convert.mask_object(obj)
        jax_staged.validate_aggregation(obj)
        jax_staged.aggregate(obj)
        port.validate_aggregation(port_obj)
        port.aggregate(port_obj)
        assert port.nb_models == jax_staged.nb_models
    assert port.pending == jax_staged.pending == 0
    port.drain()
    jax_staged.drain()
    assert port.nb_models == jax_staged.nb_models == k
    a, b = jax_staged.finalize(), port.finalize()
    assert a.nb_models == b.nb_models == k
    assert np.array_equal(b.object.vect.data, a.object.vect.data)
    assert np.array_equal(b.object.unit.data, a.object.unit.data)


def test_flush_returns_before_the_fold_finishes():
    """A fold held at a gate: ``flush()`` has returned with the batch in
    flight; only ``drain()`` waits for it."""
    n = 16
    masked, host = _updates(n, 2, seed=19)
    port = StagedAggregator(PAIR, n, batch_size=2, device=CPU)
    gate, real_fold = threading.Event(), port._device._packed_fold_fn

    def gated_fold(acc, staged):
        assert gate.wait(timeout=30)
        return real_fold(acc, staged)

    port._device._packed_fold_fn = gated_fold
    for obj in masked:
        port.aggregate(convert.mask_object(obj))  # the second one flushes
    assert port.pending == 0
    assert port._stream.in_flight_models == 2 and port._device.nb_models == 0
    assert port.nb_models == 2
    gate.set()
    vect, _unit, nb = port.snapshot_state()
    assert nb == 2 and np.array_equal(vect, host.object.vect.data)
    port.finalize()


@pytest.mark.parametrize("bad", ["model_length", "limbs", "ragged"])
def test_submit_batch_rejects_rows_of_the_wrong_shape(bad):
    """A batch whose rows are not wire ``uint32[model_len, L]`` is refused
    before it takes a ring buffer; the pipeline stays usable."""
    n, L = 12, 2
    agg, stream = _port_pipeline(n, max_batch=2)
    good = np.zeros((n, L), np.uint32)
    rows = {
        "model_length": [np.zeros((n + 1, L), np.uint32)],
        "limbs": [np.zeros((n, L + 1), np.uint32)],
        "ragged": [good, good[:-1]],
    }[bad]
    with pytest.raises(ValueError, match="wire rows"):
        stream.submit_batch(rows)
    assert stream.in_flight_models == 0 and not stream._rings
    stream.submit_batch([good, good])
    stream.drain()
    assert agg.nb_models == 2
    stream.close()


def test_submitted_rows_may_be_reused_at_once():
    """``submit_batch`` copies each row into the ring: the caller may
    overwrite its arrays while the batch still waits for its fold."""
    n = 20
    masked, host = _updates(n, 2, seed=29)
    agg, stream = _port_pipeline(n, max_batch=2)
    gate, real_fold = threading.Event(), agg._packed_fold_fn

    def gated_fold(acc, staged):
        assert gate.wait(timeout=30)
        return real_fold(acc, staged)

    agg._packed_fold_fn = gated_fold
    rows = [np.array(m.vect.data) for m in masked]
    stream.submit_batch(rows)
    for row in rows:
        row[...] = 0xFFFFFFFF
    gate.set()
    stream.drain()
    assert np.array_equal(agg.snapshot(), host.object.vect.data)
    stream.close()


def test_pipeline_arguments_and_one_device_surface():
    agg = DeviceAggregator(PAIR.vect, 8, device=CPU)
    for kw, msg in (({"staging_buffers": 1}, "staging_buffers"),
                    ({"dispatch_ahead": 0}, "dispatch_ahead"),
                    ({"max_batch": 0}, "max_batch")):
        with pytest.raises(ValueError, match=msg):
            StreamingAggregator(agg, **kw)
    stream = StreamingAggregator(agg, max_batch=2)
    assert agg.padded_length == agg.model_length == 8
    for _ in range(3):  # folds that keep up: one buffer serves every batch
        stream.submit_batch(np.zeros((2, 8, agg.n_limbs), np.uint32))
        stream.drain()
    ring = stream._rings["packed"]
    assert ring.allocated == 1 and ring.nbytes == 2 * agg.packed_width * 8
    with pytest.raises(ValueError, match="max_batch"):
        stream.submit_batch(np.zeros((3, 8, agg.n_limbs), np.uint32))
    with pytest.raises(ValueError, match="empty"):
        stream.submit_batch([])
    stream.close()
    stream.close()  # idempotent
    with pytest.raises(StreamingError, match="closed"):
        stream.submit_batch(np.zeros((1, 8, agg.n_limbs), np.uint32))


@pytest.mark.parametrize("spec", [
    "streaming.fold:error,nth=2/5",
    "streaming.fold:error,nth=1/3/4/9,max=2;streaming.other:error,max=3",
    "t:t1:streaming.fold:error;streaming.fold:error,max=1",
])
def test_fault_plan_decides_as_jax_package(spec):
    """The port's fault plan makes the JAX package's decisions, call by
    call, for the same spec."""
    ours, theirs = faults.FaultPlan.parse(spec), jax_faults.FaultPlan.parse(spec)
    for site in ("streaming.fold", "t:t1:streaming.fold", "streaming.other"):
        for _ in range(20):
            a, b = ours.decide(site), theirs.decide(site)
            assert (a is None) == (b is None)
            assert a is None or (a.index, a.kind) == (b.index, b.kind) == (b.index, "error")


def test_maybe_fail_raises_and_clears(no_fault_plans):
    faults.install_plan(faults.FaultPlan.parse("streaming.fold:error,max=1"))
    with pytest.raises(faults.InjectedFault, match="streaming.fold"):
        faults.maybe_fail("streaming.fold")
    faults.maybe_fail("streaming.fold")  # max=1: spent
    faults.clear_plan()
    assert faults.current_plan() is None


@PACKED
def test_short_flush_stages_through_a_buffer_sized_to_its_rows(packed):
    """A flush of 3 rows at ``max_batch`` 64 stages through a buffer of 4
    rows (3 rounded up to a power of two), and a second flush of 3 reuses
    it; a full flush of 64 gets a buffer of 64 beside it. The aggregate
    equals the JAX pipeline's over the same batches at the same
    ``max_batch``, byte for byte."""
    from xaynet_tpu_torch.parallel.streaming import bucket_rows

    assert [bucket_rows(k, 64) for k in (1, 2, 3, 4, 5, 33, 64)] == [1, 2, 4, 4, 8, 64, 64]
    assert [bucket_rows(k, 6) for k in (3, 5, 6)] == [4, 6, 6]
    n = 101
    masked, host = _updates(n, 70, seed=31)
    stacks = [m.vect.data for m in masked]
    batches = [stacks[0:3], stacks[3:6], stacks[6:70]]
    jax_agg, jax_stream = _jax_pipeline(n, max_batch=64, packed=packed)
    agg, stream = _port_pipeline(n, max_batch=64, packed=packed)
    seen = []
    for batch in batches:
        jax_stream.submit_batch(np.stack(batch))
        stream.submit_batch(batch)
        stream.drain()
        ring = stream._rings["packed" if packed else "planar"]
        seen.append(list(ring.buffer_rows))
    jax_stream.drain()
    width = agg.packed_width if packed else agg.n_limbs
    itemsize = 1 if packed else 4
    assert seen == [[4], [4], [4, 64]]  # the second flush of 3 reused the 4-row buffer
    assert ring.nbytes == (4 + 64) * width * n * itemsize
    assert ring.in_use == 0 and ring.reused == 0  # a CPU ring pins nothing
    assert agg.nb_models == jax_agg.nb_models == 70
    assert np.array_equal(agg.snapshot(), jax_agg.snapshot())
    assert np.array_equal(agg.snapshot(), host.object.vect.data)
    stream.close()
    jax_stream.close()
