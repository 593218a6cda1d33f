"""The port's speculative Sum2 (``xaynet_tpu_torch.ops.speculation``) against
the JAX package's (``xaynet_tpu.ops.speculation``), on the CPU.

Mirrors ``tests/test_overlap.py``'s speculation cases: all hits, a settle
before the worker did anything, discards (a speculated participant that
dropped before Sum2) with a never-offered miss, the recorded outcomes,
idle scheduler slots only; and a failing derive that leaves
``worker_error`` set while ``settle`` still returns the exact aggregate.
Every case compares the port's bytes with the JAX session's on the same
seeds.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from xaynet_tpu.core.mask.config import (
    BoundType as JBoundType,
    DataType as JDataType,
    GroupType as JGroupType,
    MaskConfig as JMaskConfig,
    ModelType as JModelType,
)
from xaynet_tpu.ops.speculation import SpeculativeMaskSession as JaxSession
from xaynet_tpu_torch.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
from xaynet_tpu_torch.ops import masking, speculation
from xaynet_tpu_torch.ops.speculation import SpeculativeMaskSession
from xaynet_tpu_torch.tenancy.scheduler import TenantScheduler

CFGS = {
    "integer-m6": (
        MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6),
        JMaskConfig(JGroupType.INTEGER, JDataType.F32, JBoundType.B0, JModelType.M6),
    ),
    "prime-m3": (
        MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3),
        JMaskConfig(JGroupType.PRIME, JDataType.F32, JBoundType.B0, JModelType.M3),
    ),
}
LEN = 257  # odd on purpose


def _seeds(n, tag=0):
    return [bytes([i & 0xFF, i >> 8, tag]) + b"\x5a" * 29 for i in range(n)]


def _wait_folded(spec, n, deadline_s=60.0):
    """Wait until the worker folded ``n`` offered seeds (deterministic
    all-hit setup; a fixed sleep would be flaky)."""
    t0 = time.monotonic()
    while spec.speculated() < n:
        if time.monotonic() - t0 > deadline_s:
            pytest.fail(f"speculation folded {spec.speculated()}/{n} seeds")
        time.sleep(0.01)


def _jax_settle(offered, actual, jcfg, wait=True):
    spec = JaxSession(LEN, jcfg.pair())
    spec.offer(offered)
    if wait:
        _wait_folded(spec, len(offered))
    unit, vect = spec.settle(actual)
    return np.asarray(unit), np.asarray(vect)


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.uint32 and got[1].shape == want[1].shape


@pytest.mark.parametrize("cfg", list(CFGS))
def test_speculation_all_hits_byte_identical(cfg):
    ours, theirs = CFGS[cfg]
    seeds = _seeds(6)
    spec = SpeculativeMaskSession(LEN, ours.pair(), group=4, device="cpu")
    spec.offer(seeds)
    spec.offer(seeds[:2])  # idempotent per seed
    _wait_folded(spec, len(seeds))
    got = spec.settle(seeds)
    assert spec.worker_error is None and spec.speculated() == 6
    _same(got, _jax_settle(seeds, seeds, theirs))
    _same(got, masking.sum_masks(seeds, LEN, ours.pair(), device="cpu"))


def test_speculation_settle_without_worker_progress_is_serial():
    ours, theirs = CFGS["integer-m6"]
    seeds = _seeds(5, tag=1)
    spec = SpeculativeMaskSession(LEN, ours.pair(), device="cpu")
    spec.offer(seeds)
    got = spec.settle(seeds)  # at once: any mix of hits and misses
    assert spec.worker_error is None
    _same(got, _jax_settle(seeds, seeds, theirs, wait=False))


@pytest.mark.parametrize("cfg", list(CFGS))
def test_misspeculation_discard_byte_identical(cfg):
    """A speculated participant drops before Sum2: its folded mask is
    subtracted back exactly; a never-offered seed is a miss."""
    ours, theirs = CFGS[cfg]
    offered = _seeds(5, tag=2)
    actual = [s for s in offered if s != offered[2]] + _seeds(1, tag=3)
    spec = SpeculativeMaskSession(LEN, ours.pair(), group=2, device="cpu")
    spec.offer(offered)
    _wait_folded(spec, len(offered))  # the dropped seed IS folded: a discard
    got = spec.settle(actual)
    assert spec.worker_error is None
    _same(got, _jax_settle(offered, actual, theirs))
    _same(got, masking.sum_masks(actual, LEN, ours.pair(), device="cpu"))


def test_duplicate_seeds_take_the_serial_path(monkeypatch):
    ours, theirs = CFGS["integer-m6"]
    recorded = []
    monkeypatch.setattr(speculation, "record_spec_outcomes",
                        lambda hits=0, misses=0, discards=0: recorded.append((hits, misses, discards)))  # fmt: skip
    seeds = _seeds(3, tag=7)
    actual = seeds + seeds[:1]
    spec = SpeculativeMaskSession(LEN, ours.pair(), device="cpu")
    spec.offer(seeds)
    _wait_folded(spec, 3)
    got = spec.settle(actual)
    assert recorded == [(0, 4, 0)]
    _same(got, _jax_settle(seeds, actual, theirs))


def test_speculation_records_outcomes(monkeypatch):
    from xaynet_tpu_torch.telemetry import timeline

    ours, theirs = CFGS["integer-m6"]
    recorded, overlaps = [], []
    monkeypatch.setattr(speculation, "record_spec_outcomes",
                        lambda hits=0, misses=0, discards=0: recorded.append((hits, misses, discards)))  # fmt: skip
    monkeypatch.setattr(speculation, "record_overlap",
                        lambda kind, seconds, **kw: overlaps.append((kind, kw)))  # fmt: skip
    offered = _seeds(4, tag=4)
    actual = offered[:3] + _seeds(1, tag=5)
    spec = SpeculativeMaskSession(LEN, ours.pair(), tenant="t0", device="cpu")
    spec.offer(offered)
    _wait_folded(spec, len(offered))
    got = spec.settle(actual)
    assert recorded == [(3, 1, 1)]
    assert overlaps == [("spec_derive", {"tenant": "t0", "hits": 3, "misses": 1, "discards": 1})]
    assert timeline.SPEC_DERIVE is not None
    _same(got, _jax_settle(offered, actual, theirs))


def test_speculation_records_derive_spans():
    from xaynet_tpu_torch.telemetry import tracing as trace

    ours, _ = CFGS["integer-m6"]
    tracer = trace.get_tracer()
    seen = []
    real = tracer.record_span

    def spy(name, **kw):
        seen.append((name, kw.get("phase"), kw.get("seeds")))
        return real(name, **kw)

    tracer.record_span = spy
    try:
        spec = SpeculativeMaskSession(LEN, ours.pair(), group=2, device="cpu")
        spec.offer(_seeds(4, tag=8))
        _wait_folded(spec, 4)
        spec.close()
    finally:
        del tracer.record_span
    assert [s for s in seen if s[0] == "overlap.spec_derive"] == [
        ("overlap.spec_derive", "update", 2)
    ] * 2


def test_speculation_idle_slots_only():
    """A busy scheduler (its one slot held) denies the worker: every seed
    becomes a miss, settle still returns the exact aggregate, and idle
    grants never charge the fairness split."""
    ours, theirs = CFGS["integer-m6"]
    sched = TenantScheduler(max_inflight=1)
    blocker = sched.new_owner()
    sched.acquire("real", blocker)
    try:
        seeds = _seeds(4, tag=6)
        spec = SpeculativeMaskSession(LEN, ours.pair(), tenant="spec", scheduler=sched,
                                      device="cpu")  # fmt: skip
        spec.offer(seeds)
        time.sleep(0.2)  # give the worker a chance to (wrongly) take a slot
        assert spec.speculated() == 0
        got = spec.settle(seeds)
        _same(got, _jax_settle(seeds, seeds, theirs))
        assert "spec" not in sched.split()
    finally:
        sched.release_owner(blocker)
    # an idle scheduler grants: the worker folds through it and gives back
    spec = SpeculativeMaskSession(LEN, ours.pair(), tenant="spec", scheduler=sched, device="cpu")
    spec.offer(seeds)
    _wait_folded(spec, 4)
    _same(spec.settle(seeds), _jax_settle(seeds, seeds, theirs))
    assert "spec" not in sched.split() and sched.try_acquire_idle("x", sched.new_owner())


def test_failing_derive_sets_worker_error_and_settles_exactly(monkeypatch):
    """A derive that raises in the worker is fail-soft (its seeds become
    misses) but is kept on ``worker_error``: a broken kernel cannot pass
    as a run of misses."""
    ours, theirs = CFGS["integer-m6"]
    real = speculation.sum_masks_planar
    worker_calls = threading.Event()

    def flaky(seeds, *a, **kw):
        if threading.current_thread().name == "xn-spec-derive":
            worker_calls.set()
            raise RuntimeError("derive failed on the card")
        return real(seeds, *a, **kw)

    monkeypatch.setattr(speculation, "sum_masks_planar", flaky)
    seeds = _seeds(3, tag=9)
    spec = SpeculativeMaskSession(LEN, ours.pair(), device="cpu")
    spec.offer(seeds)
    assert worker_calls.wait(30.0)
    t0 = time.monotonic()
    while spec.worker_error is None and time.monotonic() - t0 < 30.0:
        time.sleep(0.01)
    assert isinstance(spec.worker_error, RuntimeError)
    assert spec.speculated() == 0
    _same(spec.settle(seeds), _jax_settle(seeds, seeds, theirs))


def test_close_discards_and_later_offers_are_ignored():
    ours, _ = CFGS["integer-m6"]
    spec = SpeculativeMaskSession(LEN, ours.pair(), device="cpu")
    spec.offer(_seeds(2, tag=10))
    spec.close()
    late = _seeds(2, tag=11)
    spec.offer(late)
    assert not any(s in spec._queued for s in late)
    with pytest.raises(ValueError, match="no seeds"):
        spec.settle([])


def test_session_needs_a_card_without_a_device(monkeypatch):
    from xaynet_tpu_torch.device import DeviceUnavailable

    ours, _ = CFGS["integer-m6"]
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        SpeculativeMaskSession(LEN, ours.pair())
