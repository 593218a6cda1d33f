"""The port's multi-tenant coordinator (``xaynet_tpu_torch.tenancy`` and the
tenant wiring of ``server``) against the JAX package's, on the CPU.

- The page pool: the same seeded sequence of ``lease_host``,
  ``lease_device``, ``release``, ``reclaim``, ``set_migrator`` and
  ``compact`` on both packages' pools gives the same page tables,
  ``stats()``, ``fragmentation()``, ``balanced()`` and ``PoolExhausted``
  points, and compaction keeps every moved lease's bytes; a page run
  reused across tenants comes back zeroed.
- The scheduler: the same acquire, idle-grant, release, weight, tier and
  demotion calls give the same grant order, ``split()`` and
  ``window_split()``; the round report's fairness section reads the same
  split.
- Tenant ids get the same verdicts, and the admission budget sheds at the
  same points.
- The port's streaming pipeline and round aggregator lease pool pages
  under their tenant and balance after ``close()`` and ``release_pool()``.
- Two tenants (``alpha``: 37 elements, integer group, seed 11; ``beta``:
  64 elements, prime group, seed 22, as ``tests/test_tenancy.py`` runs
  them) round concurrently in the port's coordinator on the CPU: both
  models are byte-identical to the JAX package's rounds and to the port's
  single-tenant controls, and the pool balances.
- ``serve_tenants`` over the socket: ``/t/<id>`` and the bare routes, a
  404 for an unknown tenant, a 429 for a quarantined one, the rounds of
  both tenants through their routes.
- A ``file`` round journal the JAX coordinator wrote for tenant ``alpha``
  resumes in the port's tenant ``alpha``, and ``beta`` sees none.

Aggregates are exact: no tolerance anywhere.
"""

from __future__ import annotations

import asyncio
import json
import socket
import threading
import time
import weakref
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest

import xaynet_tpu.tenancy as jax_tenancy
import xaynet_tpu_torch.tenancy as port_tenancy
from xaynet_tpu.core.mask.config import GroupType as JaxGroupType
from xaynet_tpu.server import settings as jax_settings
from xaynet_tpu_torch.core.mask.config import GroupType as PortGroupType
from xaynet_tpu_torch.server import settings as port_settings
from xaynet_tpu_torch.tenancy import pool as port_pool_mod
from xaynet_tpu_torch.tenancy import scheduler as port_sched_mod

PACKAGES = {"jax": jax_tenancy, "port": port_tenancy}
SUM_PROB, UPDATE_PROB = 0.4, 0.5
N_SUM, N_UPDATE = 1, 3
# tests/test_tenancy.py's two tenants: model length, group, weights seed
TENANT_CASES = {"alpha": (37, "INTEGER", 11), "beta": (64, "PRIME", 22)}


@pytest.fixture
def port_singletons():
    """The port's process-wide pool and scheduler, restored after the test
    (``serve_tenants`` installs configured ones)."""
    pool, sched = port_pool_mod._pool, port_sched_mod._scheduler
    yield
    port_pool_mod._pool, port_sched_mod._scheduler = pool, sched


def _wait_for(predicate, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.002)
    return False


# --------------------------------------------------------------------------
# the page pool: one seeded sequence of operations on both packages
# --------------------------------------------------------------------------

POOL_CASES = {
    # seed, page_bytes, slab_pages, host_pages cap, device_pages cap
    "uncapped": (1, 4096, 8, 0, 0),
    "capped": (2, 4096, 8, 40, 24),
    "big-slabs": (3, 8192, 32, 0, 12),
    "small-slabs-capped": (4, 4096, 2, 16, 0),
}


def _pool_trace(pkg, seed: int, page_bytes: int, slab_pages: int, host_pages: int,
                device_pages: int) -> list:
    """Run one seeded sequence of pool operations; return what each step
    observed. Every lease's array is filled with its tenant's byte, so a
    reused run that were handed over unzeroed, or a compaction that lost
    bytes, shows in the trace."""
    pool = pkg.PagePool(page_bytes=page_bytes, slab_pages=slab_pages,
                        host_pages=host_pages, device_pages=device_pages)  # fmt: skip
    rng = np.random.default_rng(seed)
    tenants = ["a", "b", "c"]
    live: list = []
    trace: list = []
    for step in range(160):
        op = rng.choice(["host", "host", "host", "device", "release", "release",
                         "migrator", "reclaim", "compact"])  # fmt: skip
        tenant = tenants[int(rng.integers(len(tenants)))]
        seen = None
        if op == "host":
            words = int(rng.integers(1, 3 * slab_pages * page_bytes // 4))
            try:
                lease = pool.lease_host(tenant, (words,), np.uint32)
            except pkg.PoolExhausted:
                seen = "exhausted"
            else:
                seen = (lease.lease_id, lease.pages, bool(not lease.array.any()))
                lease.array.view(np.uint8)[:] = 1 + tenants.index(tenant)
                live.append(lease)
        elif op == "device":
            try:
                lease = pool.lease_device(tenant, int(rng.integers(1, 6 * page_bytes)))
            except pkg.PoolExhausted:
                seen = "exhausted"
            else:
                seen = (lease.lease_id, lease.pages)
                live.append(lease)
        elif op == "release" and live:
            lease = live.pop(int(rng.integers(len(live))))
            seen = (lease.lease_id, pool.release(lease), pool.release(lease))
        elif op == "migrator" and live:
            lease = live[int(rng.integers(len(live)))]
            moved = []
            pool.set_migrator(lease, moved.append)
            seen = lease.lease_id
        elif op == "reclaim":
            before = {l.lease_id for l in pool.outstanding(tenant)}
            seen = pool.reclaim(tenant)
            live = [l for l in live if l.lease_id not in before]
        elif op == "compact":
            seen = pool.compact()
        trace.append((
            step, str(op), tenant, seen, pool.stats(), pool.fragmentation(),
            {t: (pool.balanced(t), pool.page_table(t)) for t in tenants},
            # every live host lease still holds its tenant's bytes
            sorted((l.lease_id, int(l.array.view(np.uint8).min()),
                    int(l.array.view(np.uint8).max()))
                   for l in live if l.array is not None),
        ))  # fmt: skip
    return trace


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pool_sequences_match_jax(case):
    traces = {name: _pool_trace(pkg, *POOL_CASES[case]) for name, pkg in PACKAGES.items()}
    assert traces["port"] == traces["jax"]
    steps = traces["port"]
    assert any(s[1] == "compact" for s in steps) and any(s[1] == "reclaim" for s in steps)
    if POOL_CASES[case][3] or POOL_CASES[case][4]:
        assert any(s[3] == "exhausted" for s in steps)  # the caps were reached
    # every host lease came zeroed, whoever held its pages before
    assert all(s[3][2] for s in steps if s[1] == "host" and s[3] != "exhausted")


def test_reused_run_comes_back_zeroed_across_tenants():
    """Tenant b's lease reuses the run tenant a released, at the same page
    offset, and finds it zeroed; the page tables match the JAX pool's."""
    seen = {}
    for name, pkg in PACKAGES.items():
        pool = pkg.PagePool(page_bytes=4096, slab_pages=4)
        a = pool.lease_host("a", (3, 1024), np.uint32)
        a.array[:] = 0xDEADBEEF
        where = (a.slab, a.offset)
        pool.release(a)
        b = pool.lease_host("b", (3, 1024), np.uint32)
        seen[name] = ((b.slab, b.offset) == where, bool(not b.array.any()), pool.page_table("b"))
    assert seen["port"] == seen["jax"]
    assert seen["port"][:2] == (True, True)


# --------------------------------------------------------------------------
# the scheduler: grant order and splits
# --------------------------------------------------------------------------

SCHED_CASES = {
    # history of served grants, weights, tiers, demoted, waiters in arrival order
    "fifo": ({}, {}, {}, set(), ["a", "b", "c", "a", "b", "c"]),
    "deficit": ({"a": 3, "b": 1}, {}, {}, set(), ["a", "b", "c", "a", "b"]),
    "weights": ({"a": 1, "b": 2}, {"b": 4.0}, {}, set(), ["a", "b", "a", "b", "a"]),
    "tiers": ({}, {}, {"a": 1}, set(), ["a", "b", "c", "a", "b"]),
    "demotion": ({}, {}, {}, {"a"}, ["a", "b", "a", "c", "b"]),
    "mixed": ({"c": 2}, {"a": 0.5, "c": 3.0}, {"b": 1}, {"c"}, ["a", "b", "c", "a", "b", "c"]),
}


def _sched_trace(pkg, case: str) -> list:
    """Drive one scheduler deterministically: the history is granted
    first, then two holder slots fill it, the waiters queue in their order
    (each registered before the next starts), and slots free one at a
    time, each grant released before the next slot frees."""
    history, weights, tiers, demoted, waiters = SCHED_CASES[case]
    sched = pkg.TenantScheduler(max_inflight=2)
    holder = sched.new_owner()
    trace = []
    for tenant, n in history.items():
        for _ in range(n):
            sched.acquire(tenant, holder)
            sched.release(holder)
    for tenant, weight in weights.items():
        sched.set_weight(tenant, weight)
    for tenant, tier in tiers.items():
        sched.set_tier(tenant, tier)
    for tenant in demoted:
        sched.set_demoted(tenant, True)
    trace.append(("idle while free", sched.try_acquire_idle("idle", holder)))
    sched.release(holder)
    sched.acquire("hold", holder)
    sched.acquire("hold", holder)
    trace.append(("idle while full", sched.try_acquire_idle("idle", holder)))
    order: list = []
    owners = [sched.new_owner() for _ in waiters]

    def waiter(tenant, owner):
        sched.acquire(tenant, owner)
        order.append((tenant, owner))

    threads = []
    for i, (tenant, owner) in enumerate(zip(waiters, owners)):
        t = threading.Thread(target=waiter, args=(tenant, owner), daemon=True)
        t.start()
        threads.append(t)
        assert _wait_for(lambda: len(sched._waiting) == i + 1)
    sched.release(holder)  # one slot frees: the chosen waiter takes it
    for n in range(1, len(waiters) + 1):
        assert _wait_for(lambda: len(order) == n)
        sched.release(order[-1][1])  # the grant returns its slot
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    trace.append(("grant order", [tenant for tenant, _ in order]))
    trace.append(("split", sched.split()))
    trace.append(("window", sched.window_split()))
    sched.acquire("b", holder)
    trace.append(("window after one more", sched.window_split()))
    trace.append(("demoted", sorted(sched.demoted())))
    sched.forget_tenant("a")
    trace.append(("split after forget", sched.split()))
    for owner in owners + [holder]:
        sched.release_owner(owner)
    trace.append(("idle after release_owner", sched.try_acquire_idle("idle", holder)))
    return trace


@pytest.mark.parametrize("case", list(SCHED_CASES))
def test_scheduler_sequences_match_jax(case):
    traces = {name: _sched_trace(pkg, case) for name, pkg in PACKAGES.items()}
    assert traces["port"] == traces["jax"]
    assert traces["port"][0] == ("idle while free", True)
    assert traces["port"][1] == ("idle while full", False)


@pytest.mark.parametrize("grants", [{"a": 2}, {"a": 2, "b": 1}, {"x": 1, "y": 4, "z": 2}])
def test_round_report_fairness_section_matches_jax(grants, port_singletons):
    """The round report's fairness section reads the process scheduler's
    cumulative split, and only once more than one tenant was granted."""
    import xaynet_tpu.tenancy.scheduler as jax_sched_mod
    from xaynet_tpu.telemetry import report as jax_report
    from xaynet_tpu_torch.telemetry import report as port_report

    saved = jax_sched_mod._scheduler
    try:
        sections = {}
        for name, pkg, report in (("jax", jax_tenancy, jax_report),
                                  ("port", port_tenancy, port_report)):  # fmt: skip
            sched = pkg.configure_scheduler(2)
            owner = sched.new_owner()
            for tenant, n in grants.items():
                for _ in range(n):
                    sched.acquire(tenant, owner)
                    sched.release(owner)
            sections[name] = report._fairness_snapshot()
    finally:
        jax_sched_mod._scheduler = saved
    assert sections["port"] == sections["jax"]
    assert sections["port"] == (grants if len(grants) >= 2 else None)


# --------------------------------------------------------------------------
# tenant ids and the admission budget
# --------------------------------------------------------------------------

TENANT_IDS = ["a", "t0", "abc-def_1", "0", "x" * 32, "x" * 33, "", "A", "-x", "_x",
              "with space", "t/1", "ünï", "a.b", "t0\n"]  # fmt: skip


def _verdict(pkg, tenant: str):
    try:
        return pkg.validate_tenant_id(tenant)
    except ValueError as err:
        return ("ValueError", str(err))


@pytest.mark.parametrize("tenant", TENANT_IDS)
def test_tenant_id_verdicts_match_jax(tenant):
    assert _verdict(port_tenancy, tenant) == _verdict(jax_tenancy, tenant)


@pytest.mark.parametrize("capacity,share", [(1, 1.0), (5, 0.6), (10, 0.25), (7, 0.5)])
def test_admission_budget_matches_jax(capacity, share):
    """The same charges and discharges shed at the same points: one tenant
    is capped at its share, all together at the capacity."""
    traces = {}
    for name, pkg in PACKAGES.items():
        budget = pkg.TenantAdmissionBudget(capacity, share)
        rng = np.random.default_rng(capacity)
        trace = [budget.per_tenant]
        for _ in range(60):
            tenant = ["p", "q", "r"][int(rng.integers(3))]
            if rng.random() < 0.7:
                trace.append(("charge", tenant, budget.charge(tenant)))
            else:
                budget.discharge(tenant, int(rng.integers(1, 3)))
            trace.append(tuple(budget.held(t) for t in "pqr"))
        traces[name] = trace
    assert traces["port"] == traces["jax"]
    charges = [step for step in traces["port"][1:] if step[0] == "charge"]
    assert any(ok is False for _, _, ok in charges)  # some charge was shed
    with pytest.raises(ValueError):
        port_tenancy.TenantAdmissionBudget(0)
    with pytest.raises(ValueError):
        port_tenancy.TenantAdmissionBudget(4, 0.0)


# --------------------------------------------------------------------------
# the port's pipeline and round aggregator on the pool
# --------------------------------------------------------------------------


def test_streaming_pipeline_leases_and_releases_pool_pages():
    """The staging ring leases one run per buffer under the pipeline's
    tenant, each batch holds a scheduler slot, and ``close()`` gives the
    pages back (tests/test_tenancy.py's case on the port)."""
    from xaynet_tpu_torch.core.mask.config import BoundType, DataType, MaskConfig, ModelType
    from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator
    from xaynet_tpu_torch.parallel.streaming import StreamingAggregator

    config = MaskConfig(PortGroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M3)
    pool = port_tenancy.PagePool(page_bytes=4096, slab_pages=16)
    sched = port_tenancy.TenantScheduler(max_inflight=4)
    agg = DeviceAggregator(config.pair().vect, 64, device="cpu")
    stream = StreamingAggregator(agg, staging_buffers=2, dispatch_ahead=1, max_batch=4,
                                 tenant="tenant-x", pool=pool, scheduler=sched)  # fmt: skip
    rng = np.random.default_rng(0)
    stack = rng.integers(0, 2**16, size=(3, 64, agg.n_limbs), dtype=np.uint32)
    stream.submit_batch(stack)
    stream.submit_batch(stack[:1])
    stream.drain()
    assert agg.nb_models == 4
    table = pool.page_table("tenant-x")
    assert len(table) == 2 and {e["arena"] for e in table.values()} == {"host"}
    assert stream._rings["packed"].buffer_rows == [4, 1]
    stream.close()
    assert pool.balanced("tenant-x")  # leases == releases at round end
    assert sched.split() == {"tenant-x": 2}  # one slot per batch
    assert sched._inflight == 0


def test_round_aggregator_leases_the_ledger_and_releases_it(port_singletons):
    """``StagedAggregator(tenant=...)``: the accumulator's bytes on the
    device ledger, the ring's pages on the host arena, both back after the
    Unmask handoff closes the pipeline and ``release_pool`` runs."""
    from xaynet_tpu_torch.core.mask.config import BoundType, DataType, MaskConfig, ModelType
    from xaynet_tpu_torch.core.mask.masking import Masker
    from xaynet_tpu_torch.core.mask.model import Scalar
    from xaynet_tpu_torch.server.aggregation import StagedAggregator

    pool = port_tenancy.configure_pool(4, 8, 0, 0)
    sched = port_tenancy.configure_scheduler(3)
    config = MaskConfig(PortGroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3).pair()
    n = 301
    agg = StagedAggregator(config, n, batch_size=2, device="cpu", tenant="ledger")
    device_pages = pool.pages_for(agg._device.n_limbs * n * 4)
    assert pool.stats()["device_pages_in_use"] == device_pages
    rng = np.random.default_rng(5)
    for _ in range(3):
        _, masked = Masker(config).mask(Scalar(1, 3), rng.uniform(-1, 1, n).astype(np.float32))
        agg.validate_aggregation(masked)
        agg.aggregate(masked)
    view = agg.finalize_inplace()
    assert {e["arena"] for e in pool.page_table("ledger").values()} == {"device"}
    assert view.nb_models == 3
    view.release_pool()
    view.release_pool()  # idempotent
    assert pool.balanced("ledger") and pool.stats()["device_pages_in_use"] == 0
    assert sched.split() == {"ledger": 2}


def _masked_updates(config, n: int, count: int, seed: int) -> list:
    from xaynet_tpu_torch.core.mask.masking import Masker
    from xaynet_tpu_torch.core.mask.model import Scalar

    rng = np.random.default_rng(seed)
    return [Masker(config).mask(Scalar(1, count), rng.uniform(-1, 1, n).astype(np.float32))[1]
            for _ in range(count)]  # fmt: skip


def _reclaimed(tenant: str) -> float:
    from xaynet_tpu_torch.telemetry.registry import get_registry

    value = get_registry().sample_value("xaynet_pool_reclaimed_total", {"tenant": tenant})
    return float(value or 0.0)


def test_hard_kill_mid_flush_closes_the_round_before_reclaiming(port_singletons):
    """A drain that times out cancels the tenant's machine while its
    executor is in the middle of a flush: one batch folding on the worker
    (held there), one queued, the producer waiting for a ring buffer. The
    teardown closes the round's aggregator, which waits for that flush and
    its folds, before a page goes back. Another tenant leasing meanwhile
    gets pages of its own and keeps its bytes, the victim's aggregate
    holds every batch, and nothing had to be force-reclaimed."""
    from xaynet_tpu_torch.core.mask.config import BoundType, DataType, MaskConfig, ModelType
    from xaynet_tpu_torch.server.aggregation import StagedAggregator

    pool = port_tenancy.configure_pool(4, 64, 0, 0)
    port_tenancy.configure_scheduler(8)
    config = MaskConfig(PortGroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M3).pair()
    n = 301
    updates = _masked_updates(config, n, 6, seed=9)
    control = StagedAggregator(config, n, batch_size=2, device="cpu", tenant="control")
    for obj in updates:
        control.aggregate(obj)
    control.drain()
    agg = StagedAggregator(config, n, batch_size=2, staging_buffers=2, dispatch_ahead=1,
                           device="cpu", tenant="victim")  # fmt: skip
    for obj in updates:
        agg.stage(obj)  # three batches of two, submitted by one flush
    folding, go = threading.Event(), threading.Event()
    dev = agg._device

    def held(fold):
        def run(acc, staged):
            folding.set()
            assert go.wait(30)
            fold(acc, staged)

        return run

    dev._fold_fn, dev._packed_fold_fn = held(dev._fold_fn), held(dev._packed_fold_fn)
    reclaimed0 = _reclaimed("victim")

    async def scenario():
        clock = SimpleNamespace(now=0.0)
        registry = port_tenancy.TenantRegistry()
        lc = port_tenancy.TenantLifecycle(
            port_settings.TenancySettings(enabled=True, drain_timeout_s=5.0), registry, {},
            clock=lambda: clock.now,
        )  # fmt: skip

        async def machine_run():
            await asyncio.get_running_loop().run_in_executor(None, agg.flush)
            await asyncio.Event().wait()  # no round boundary ever comes

        shared = SimpleNamespace(round_aggregator=agg)
        machine = SimpleNamespace(run=machine_run, phase=SimpleNamespace(shared=shared))
        ctx = registry.add(port_tenancy.TenantContext(tenant="victim", settings=None,
                                                      machine=machine))  # fmt: skip
        lc.mark_serving("victim")
        ctx.task = asyncio.create_task(machine_run())
        stream = agg._stream

        def mid_flush():
            rings = list(stream._rings.values())
            return folding.is_set() and rings and rings[0].in_use == 2 and stream._queue.full()

        assert await asyncio.to_thread(_wait_for, mid_flush)
        drain = asyncio.create_task(lc.offboard("victim"))
        await asyncio.sleep(0.1)
        clock.now += 10.0  # the drain budget runs out: hard kill
        assert await asyncio.to_thread(_wait_for, ctx.task.done)
        await asyncio.sleep(0.3)  # a reclaim that did not wait would have run
        held_runs = [e for e in pool.page_table("victim").values() if e["arena"] == "host"]
        other = pool.lease_host("other", (3, 4096), np.uint8)
        other.array[:] = 0xAB
        done_early = drain.done()
        go.set()
        return await asyncio.wait_for(drain, 30), held_runs, other, done_early

    try:
        result, held_runs, other, done_early = asyncio.run(scenario())
    finally:
        go.set()
    assert result["outcome"] == "timeout" and not done_early
    assert len(held_runs) == 2  # the ring's buffers stayed the victim's
    for run in held_runs:
        assert run["slab"] != other.slab or (
            run["offset"] + run["pages"] <= other.offset
            or other.offset + other.pages <= run["offset"]
        )
    assert (other.array == 0xAB).all()
    assert agg._device.nb_models == 6
    assert np.array_equal(agg._device.snapshot(), control._device.snapshot())
    assert pool.balanced("victim") and _reclaimed("victim") == reclaimed0
    pool.release(other)
    control.close()


def test_slab_pinning_runs_outside_the_pool_lock(monkeypatch):
    """Page-locking a slab (up to a second for a large one on a card) holds
    no pool lock: while one lease locks its slab, another tenant's lease
    in the slab, a release and ``stats()`` go on, and a second pinned lease
    in the slab waits for the locking and pins nothing itself. A failed
    locking gives the run back, and the next pinned lease tries again."""
    pool = port_tenancy.PagePool(page_bytes=4096, slab_pages=8)
    entered, go = threading.Event(), threading.Event()
    pins = []

    def slow_pin(slab):
        pins.append(slab)
        entered.set()
        assert go.wait(30)
        if len(pins) == 1:
            raise RuntimeError("cannot page-lock (injected)")
        slab._unpin = weakref.finalize(slab.buf, lambda: None)
        return 0.5

    monkeypatch.setattr(port_pool_mod._Slab, "pin", slow_pin)
    leases, errors = {}, {}

    def lease(name, rows):
        try:
            leases[name] = pool.lease_host(name, (rows, 4096), np.uint8, pinned=True)
        except RuntimeError as e:
            errors[name] = e

    failing = threading.Thread(target=lease, args=("a", 2))
    failing.start()
    assert entered.wait(10)
    other = pool.lease_host("b", (1, 4096), np.uint8)  # same slab, no pinning
    assert other.slab == 0 and pool.stats()["leases"] == 2
    pool.release(other)
    waiter = threading.Thread(target=lease, args=("c", 1))
    waiter.start()
    time.sleep(0.05)
    assert waiter.is_alive() and len(pins) == 1  # waits for the slab, not the pool
    go.set()
    failing.join(10)
    waiter.join(10)
    assert "cannot page-lock" in str(errors["a"]) and pool.balanced("a")
    assert len(pins) == 2 and leases["c"].pin_seconds == 0.5 and pool.pin_seconds == 0.5
    assert pool.pinned_bytes() == 8 * 4096
    again = pool.lease_host("d", (1, 4096), np.uint8, pinned=True)
    assert again.pin_seconds == 0.0 and len(pins) == 2


def test_idle_reconcile_closes_its_round_and_spares_helpers(port_singletons):
    """The Idle phase after a failed round: it closes the round's
    aggregator (the ring's pages go back through the close, not a
    force-reclaim), and a pipeline built without a tenant (a helper,
    ``LOCAL_TENANT``) keeps its lease, even on a single-tenant coordinator
    whose tenant is ``default``."""
    from xaynet_tpu_torch.core.mask.config import BoundType, DataType, MaskConfig, ModelType
    from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator
    from xaynet_tpu_torch.parallel.streaming import StreamingAggregator
    from xaynet_tpu_torch.server.aggregation import StagedAggregator
    from xaynet_tpu_torch.server.phases.idle import Idle

    pool = port_tenancy.configure_pool(4, 8, 0, 0)
    port_tenancy.configure_scheduler(4)
    config = MaskConfig(PortGroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3).pair()
    n = 64
    helper_agg = DeviceAggregator(config.vect, n, device="cpu")
    helper = StreamingAggregator(helper_agg, max_batch=2)
    helper.submit_batch(np.zeros((2, n, helper_agg.n_limbs), np.uint32))
    helper.drain()
    agg = StagedAggregator(config, n, batch_size=2, device="cpu", tenant="default")
    for obj in _masked_updates(config, n, 2, seed=4):
        agg.aggregate(obj)  # a flush, folded, the pipeline left open
    assert {e["arena"] for e in pool.page_table("default").values()} == {"host", "device"}
    reclaimed0 = _reclaimed("default")
    idle = SimpleNamespace(shared=SimpleNamespace(tenant="default", settings=SimpleNamespace()))
    Idle._reconcile_pool(idle, agg)
    assert pool.balanced("default") and _reclaimed("default") == reclaimed0
    assert agg._stream._shut.is_set()
    assert len(pool.page_table(port_tenancy.LOCAL_TENANT)) == 1
    helper.close()
    assert pool.balanced(port_tenancy.LOCAL_TENANT)


# --------------------------------------------------------------------------
# two tenants' rounds, in process: both packages, and single-tenant controls
# --------------------------------------------------------------------------


def _round_settings(mod, length: int, group: str):
    def phase(n, prob):
        return mod.PhaseSettings(
            prob=prob, count=mod.CountSettings(n, n), time=mod.TimeSettings(0.0, 60.0)
        )

    s = mod.Settings(
        pet=mod.PetSettings(
            sum=phase(N_SUM, SUM_PROB),
            update=phase(N_UPDATE, UPDATE_PROB),
            sum2=mod.Sum2Settings(
                count=mod.CountSettings(N_SUM, N_SUM), time=mod.TimeSettings(0.0, 60.0)
            ),
        )
    )
    s.model.length = length
    groups = JaxGroupType if mod is jax_settings else PortGroupType
    s.mask.group_type = getattr(groups, group)
    s.aggregation.device = True
    s.aggregation.batch_size = 2
    s.resilience.retry_base_ms = 1.0
    s.resilience.retry_max_ms = 20.0
    return s


def _weights(seed: int, length: int):
    rng = np.random.default_rng(seed)
    mask_seeds = [rng.bytes(32) for _ in range(N_UPDATE)]
    weights = rng.uniform(-1, 1, (N_UPDATE, length)).astype(np.float32)
    return mask_seeds, weights


def _sdk(package: str) -> SimpleNamespace:
    if package == "jax":
        from xaynet_tpu.sdk import client, simulation, state_machine, traits
    else:
        from xaynet_tpu_torch.sdk import client, simulation, state_machine, traits
    return SimpleNamespace(client=client, keys_for_task=simulation.keys_for_task,
                           sm=state_machine, traits=traits, package=package)  # fmt: skip


def _array_store(sdk, model):
    """``sdk``'s model store over one fixed local model."""

    class ArrayModelStore(sdk.traits.ModelStore):
        async def load_model(self):
            return model

    return ArrayModelStore()


def _participants(sdk, round_seed: bytes, seed: int, length: int, client_for) -> list:
    """One sum and ``N_UPDATE`` update participants of ``sdk`` with the
    tenant's weights and pinned mask seeds."""
    device = {} if sdk.package == "jax" else {"device": "cpu"}
    mask_seeds, weights = _weights(seed, length)
    out = []
    for i in range(N_SUM):
        keys = sdk.keys_for_task(round_seed, SUM_PROB, UPDATE_PROB, "sum", start=i * 1000)
        out.append(sdk.sm.StateMachine(sdk.sm.PetSettings(keys=keys, **device), client_for(),
                                       _array_store(sdk, None)))  # fmt: skip
    for i in range(N_UPDATE):
        keys = sdk.keys_for_task(round_seed, SUM_PROB, UPDATE_PROB, "update",
                                 start=(10 + i) * 1000)  # fmt: skip
        out.append(sdk.sm.StateMachine(
            sdk.sm.PetSettings(keys=keys, scalar=Fraction(1, N_UPDATE),
                               mask_seed=mask_seeds[i], **device),
            client_for(), _array_store(sdk, weights[i]),
        ))  # fmt: skip
    return out


async def _drive(sm, done, timeout: float = 240.0) -> bool:
    """Step ``sm`` until its task for this round is sent (it is back in
    ``awaiting`` after another phase), then wait for ``done()``: stepping
    on would let it re-draw a role in the next round."""
    deadline = time.monotonic() + timeout
    took_part = False
    while time.monotonic() < deadline:
        if took_part != "sent":
            try:
                await sm.transition()
            except asyncio.CancelledError:
                raise
            except Exception:  # the SDK retries on its next tick
                pass
            took_part = sm.phase.value != "awaiting" or took_part
            if took_part and sm.phase.value == "awaiting":
                took_part = "sent"
        if took_part == "sent" and await done():
            return True
        await asyncio.sleep(0.005)
    return False


async def _in_process_round(package: str, tenant: str) -> bytes:
    """One in-process round of ``tenant`` on ``package``'s coordinator and
    SDK (the port's on the CPU); the float64 global model's bytes."""
    length, group, seed = TENANT_CASES[tenant]
    if package == "jax":
        from xaynet_tpu.server import services, state_machine
        from xaynet_tpu.storage import memory, traits

        settings, init_kw = _round_settings(jax_settings, length, group), {}
    else:
        from xaynet_tpu_torch.server import services, state_machine
        from xaynet_tpu_torch.storage import memory, traits

        settings, init_kw = _round_settings(port_settings, length, group), {"device": "cpu"}
    store = traits.Store(memory.InMemoryCoordinatorStorage(), memory.InMemoryModelStorage(),
                         memory.NoOpTrustAnchor())  # fmt: skip
    machine, request_tx, events = await state_machine.StateMachineInitializer(
        settings, store, tenant=tenant, **init_kw
    ).init()
    handler, fetcher = services.PetMessageHandler(events, request_tx), services.Fetcher(events)
    task = asyncio.create_task(machine.run())
    try:
        while fetcher.phase().value != "sum":
            await asyncio.sleep(0.005)
        sdk = _sdk(package)
        sms = _participants(sdk, fetcher.round_params().seed.as_bytes(), seed, length,
                            lambda: sdk.client.InProcessClient(fetcher, handler))  # fmt: skip

        async def done():
            return fetcher.model() is not None

        assert all(await asyncio.gather(*(_drive(sm, done) for sm in sms)))
        return np.asarray(fetcher.model(), dtype=np.float64).tobytes()
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)


@pytest.fixture(scope="module")
def jax_models() -> dict:
    return {t: asyncio.run(asyncio.wait_for(_in_process_round("jax", t), timeout=300))
            for t in TENANT_CASES}  # fmt: skip


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_two_tenants_concurrent_rounds_match_jax_and_controls(jax_models, port_singletons):
    pool = port_tenancy.configure_pool(4, 8, 0, 0)
    sched = port_tenancy.configure_scheduler(2)
    controls = {t: asyncio.run(asyncio.wait_for(_in_process_round("port", t), timeout=300))
                for t in TENANT_CASES}  # fmt: skip
    assert sched.split() == {"alpha": 2, "beta": 2}  # batch 2: a flush of 2, then of 1

    async def concurrent():
        return await asyncio.gather(*(_in_process_round("port", t) for t in TENANT_CASES))

    models = asyncio.run(asyncio.wait_for(concurrent(), timeout=300))
    for tenant, model in zip(TENANT_CASES, models):
        length = TENANT_CASES[tenant][0]
        assert model == controls[tenant] == jax_models[tenant], tenant
        mean = _weights(TENANT_CASES[tenant][2], length)[1].astype(np.float64).mean(axis=0)
        np.testing.assert_allclose(np.frombuffer(model), mean, atol=1e-6)
        # leases == releases: the unmask released the ledger, the pipeline
        # close the ring
        assert pool.balanced(tenant), pool.page_table(tenant)
    assert sched.split() == {"alpha": 4, "beta": 4}
    assert pool.stats()["host_pages_in_use"] == pool.stats()["device_pages_in_use"] == 0


# --------------------------------------------------------------------------
# serve_tenants over the socket
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _tenant_toml(length: int, group: str, journal_dir=None) -> str:
    """A tenant's settings file; with ``journal_dir`` the ``file`` store
    and the round journal there."""
    window = "time = {{ min = 0.0, max = 60.0 }}\ncount = {{ min = {n}, max = {n} }}"
    journal = ("checkpoint_enabled = true\ncheckpoint_every_batches = 1\n"
               f'[storage]\ncoordinator = "file"\nmodel_dir = "{journal_dir}"\n'
               "[restore]\nenable = true\n"
               if journal_dir else "")  # fmt: skip
    return (
        f"[pet.sum]\nprob = {SUM_PROB}\n{window.format(n=N_SUM)}\n"
        f"[pet.update]\nprob = {UPDATE_PROB}\n{window.format(n=N_UPDATE)}\n"
        f"[pet.sum2]\n{window.format(n=N_SUM)}\n"
        f'[mask]\ngroup_type = "{group.lower()}"\n'
        f"[model]\nlength = {length}\n"
        "[aggregation]\ndevice = true\nbatch_size = 2\n"
        "[resilience]\nretry_base_ms = 1.0\nretry_max_ms = 20.0\n"
        f"{journal}"
    )


def _tenancy_settings(tmp_path, tenants: list, **tenancy):
    for tenant in tenants:
        length, group, _ = TENANT_CASES[tenant]
        (tmp_path / f"{tenant}.toml").write_text(_tenant_toml(length, group))
    settings = port_settings.Settings.default()
    settings.api.bind_address = f"127.0.0.1:{_free_port()}"
    settings.tenancy.enabled = True
    settings.tenancy.tenants = list(tenants)
    settings.tenancy.config_dir = str(tmp_path)
    settings.tenancy.page_kib = 4
    settings.tenancy.slab_pages = 8
    for key, value in tenancy.items():
        setattr(settings.tenancy, key, value)
    return settings


async def _http(url: str, method: str, path: str, body: bytes = b"", headers=None):
    host, port = url.rsplit("/", 1)[-1].split(":")
    reader, writer = await asyncio.open_connection(host, int(port))
    head = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    writer.write(f"{method} {path} HTTP/1.1\r\nConnection: close\r\n{head}"
                 f"Content-Length: {len(body)}\r\n\r\n".encode() + body)  # fmt: skip
    await writer.drain()
    raw = await reader.read()
    writer.close()
    status_line, _, rest = raw.partition(b"\r\n")
    head_bytes, _, payload = rest.partition(b"\r\n\r\n")
    return int(status_line.split()[1]), head_bytes.decode(), payload


async def _wait_for_phase(url: str, path: str, want: str, timeout: float = 60.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            status, _, payload = await _http(url, "GET", path)
            if status == 200 and json.loads(payload)["phase"] == want:
                return json.loads(payload)
        except (OSError, ValueError, IndexError):
            pass
        await asyncio.sleep(0.02)
    raise TimeoutError(f"{path} never reached phase {want!r}")


async def _socket_round(url: str, tenant: str) -> bytes:
    """One round of ``tenant`` through ``url`` (a tenant route or the
    bare root) with the port's SDK on the CPU."""
    sdk = _sdk("port")
    length, _, seed = TENANT_CASES[tenant]
    probe = sdk.client.HttpClient(url)
    params = await probe.get_round_params()
    assert params.model_length == length
    sms = _participants(sdk, params.seed.as_bytes(), seed, length,
                        lambda: sdk.client.HttpClient(url))  # fmt: skip

    async def done():
        return (await probe.get_model()) is not None

    try:
        assert all(await asyncio.gather(*(_drive(sm, done) for sm in sms)))
        return np.asarray(await probe.get_model(), dtype=np.float64).tobytes()
    finally:
        probe.close()


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_serve_tenants_routes_over_socket(tmp_path, jax_models, port_singletons):
    """One listener, two tenants with their own files: the bare routes
    serve ``alpha`` (the first), ``/t/beta`` serves beta, both rounds run
    at once through their routes and give the JAX package's models; an
    unknown tenant is 404, a quarantined tenant's ``POST /message`` is 429
    (its polls still served), the health payload carries both tenants and
    the pool, and every lease is back after the rounds."""
    from xaynet_tpu_torch.server import runner
    from xaynet_tpu_torch.tenancy import get_manager, get_pool

    settings = _tenancy_settings(tmp_path, ["alpha", "beta"], admin_token="tok",
                                 quarantine_failures=1)  # fmt: skip
    url = f"http://{settings.api.bind_address}"

    async def run():
        server = asyncio.create_task(runner.serve(settings, device="cpu"))
        try:
            await _wait_for_phase(url, "/healthz", "sum")
            await _wait_for_phase(url, "/t/beta/healthz", "sum")
            bare = json.loads((await _http(url, "GET", "/params"))[2])
            alpha = json.loads((await _http(url, "GET", "/t/alpha/params"))[2])
            beta = json.loads((await _http(url, "GET", "/t/beta/params"))[2])
            assert bare == alpha and bare != beta
            assert (alpha["model_length"], beta["model_length"]) == (37, 64)
            assert (await _http(url, "GET", "/t/nope/params"))[0] == 404
            assert (await _http(url, "POST", "/t/nope/message", b"x"))[0] == 404
            assert (await _http(url, "GET", "/admin/tenants"))[0] == 401
            status, _, payload = await _http(url, "GET", "/admin/tenants",
                                             headers={"x-admin-token": "tok"})  # fmt: skip
            assert status == 200
            assert json.loads(payload) == {"tenants": {"alpha": "serving", "beta": "serving"}}
            models = await asyncio.gather(_socket_round(url, "alpha"),
                                          _socket_round(f"{url}/t/beta", "beta"))  # fmt: skip
            health = json.loads((await _http(url, "GET", "/healthz"))[2])
            assert set(health["tenancy"]["tenants"]) == {"alpha", "beta"}
            assert health["tenancy"]["pool"]["pinned_bytes"] == 0
            # a round failure trips beta's breaker (quarantine_failures 1)
            get_manager().note_round_failed("beta")
            status, head, _ = await _http(url, "POST", "/t/beta/message", b"x")
            assert status == 429 and "Retry-After: 60" in head
            assert (await _http(url, "GET", "/t/beta/params"))[0] == 200
            assert (await _http(url, "POST", "/message", b"x"))[0] == 200  # alpha admits
            return models
        finally:
            server.cancel()
            await asyncio.wait_for(server, timeout=30)

    models = asyncio.run(asyncio.wait_for(run(), timeout=300))
    assert models == [jax_models["alpha"], jax_models["beta"]]
    pool = get_pool()
    assert pool.balanced("alpha") and pool.balanced("beta")
    assert get_manager() is None  # uninstalled at shutdown


# --------------------------------------------------------------------------
# a tenant's file journal: written by the JAX coordinator, resumed by the port
# --------------------------------------------------------------------------


def test_jax_tenant_journal_resumes_in_port_tenant(tmp_path, jax_models, port_singletons):
    """The JAX coordinator runs tenant alpha's round to 2 of 3 updates with
    the ``file`` store and the journal under ``model_dir/t-alpha``; the
    port's ``serve_tenants`` over the same ``model_dir`` resumes alpha's
    round in its update phase (same seed) and completes it to the JAX
    model, while beta, whose subtree is empty, starts a fresh round."""
    from xaynet_tpu.resilience import checkpoint as jax_ckpt
    from xaynet_tpu.sdk.client import HttpClient as JaxHttpClient
    from xaynet_tpu.sdk.client import InProcessClient as JaxInProcessClient
    from xaynet_tpu.sdk.state_machine import StateMachine as JaxSM
    from xaynet_tpu.server import runner as jax_runner
    from xaynet_tpu.server import services as jax_services
    from xaynet_tpu.server.state_machine import StateMachineInitializer as JaxInitializer
    from xaynet_tpu_torch.server import runner

    length, group, seed = TENANT_CASES["alpha"]
    blobs = {}

    async def jax_half():
        settings = _round_settings(jax_settings, length, group)
        settings.aggregation.batch_size = 1
        settings.restore.enable = True
        settings.resilience.checkpoint_enabled = True
        settings.resilience.checkpoint_every_batches = 1
        settings.storage.coordinator = "file"
        settings.storage.model_dir = str(tmp_path / "models")
        store = jax_runner.init_store(settings, "alpha")
        machine, request_tx, events = await JaxInitializer(settings, store, tenant="alpha").init()
        handler, fetcher = jax_services.PetMessageHandler(events, request_tx), jax_services.Fetcher(events)
        task = asyncio.create_task(machine.run())
        try:
            while fetcher.phase().value != "sum":
                await asyncio.sleep(0.005)
            round_seed = fetcher.round_params().seed.as_bytes()
            summer, *updaters = _participants(_sdk("jax"), round_seed, seed, length,
                                              lambda: JaxInProcessClient(fetcher, handler))

            async def summed():
                return True

            for _ in range(2000):
                await summer.transition()
                if summer.phase.value == "sum2":
                    break
                await asyncio.sleep(0.005)
            while fetcher.phase().value != "update":
                await asyncio.sleep(0.005)
            for sm in updaters[:2]:
                assert await _drive(sm, summed)

            async def journaled():
                blob = await store.coordinator.round_checkpoint()
                return blob is not None and jax_ckpt.RoundCheckpoint.from_bytes(blob).nb_models == 2

            for _ in range(1000):
                if await journaled():
                    break
                await asyncio.sleep(0.01)
            assert await journaled()
            blobs["summer"] = summer.save()
            return round_seed
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)

    round_seed = asyncio.run(asyncio.wait_for(jax_half(), timeout=300))
    settings = _tenancy_settings(tmp_path, [])
    settings.tenancy.tenants = ["alpha", "beta"]
    for tenant in ("alpha", "beta"):
        t_length, t_group, _ = TENANT_CASES[tenant]
        (tmp_path / f"{tenant}.toml").write_text(
            _tenant_toml(t_length, t_group, journal_dir=tmp_path / "models")
        )
    url = f"http://{settings.api.bind_address}"

    async def scoped():
        stores = {t: runner.init_store(runner._tenant_settings(settings, t), t)
                  for t in ("alpha", "beta")}  # fmt: skip
        return {t: await s.coordinator.round_checkpoint() is not None for t, s in stores.items()}

    assert asyncio.run(scoped()) == {"alpha": True, "beta": False}

    async def port_half():
        server = asyncio.create_task(runner.serve(settings, device="cpu"))
        try:
            await _wait_for_phase(url, "/t/alpha/healthz", "update")
            await _wait_for_phase(url, "/t/beta/healthz", "sum")
            probe = JaxHttpClient(f"{url}/t/alpha")
            assert (await probe.get_round_params()).seed.as_bytes() == round_seed  # same round

            summer = JaxSM.restore(blobs["summer"], JaxHttpClient(f"{url}/t/alpha"),
                                   _array_store(_sdk("jax"), None))  # fmt: skip
            last = _participants(_sdk("jax"), round_seed, seed, length,
                                 lambda: JaxHttpClient(f"{url}/t/alpha"))[-1]  # fmt: skip

            async def done():
                return (await probe.get_model()) is not None

            assert all(await asyncio.gather(_drive(summer, done), _drive(last, done)))
            return np.asarray(await probe.get_model(), dtype=np.float64).tobytes()
        finally:
            server.cancel()
            await asyncio.wait_for(server, timeout=30)

    model = asyncio.run(asyncio.wait_for(port_half(), timeout=300))
    assert model == jax_models["alpha"]
    holders = {p.relative_to(tmp_path / "models").parts[0]
               for p in (tmp_path / "models").rglob("coordinator_state.json*")}  # fmt: skip
    assert holders <= {"t-alpha", "t-beta"} and "t-alpha" in holders
