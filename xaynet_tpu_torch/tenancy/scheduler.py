"""Tenant scheduler: fairness + backpressure over the shared fold pipeline.

The port's copy of ``xaynet_tpu/tenancy/scheduler.py``. On a CUDA device a
slot is held until the batch's fold has completed on the card (the fold
worker waits on an event recorded behind it), not merely launched, so
``max_inflight`` bounds work queued on the device.

NET-SA-style multi-stream aggregation (PAPERS.md) on one device: every
tenant's streaming pipeline asks this scheduler for a *fold-batch slot*
before dispatching a batch, and the scheduler grants slots

- **bounded** — at most ``max_inflight`` batches across ALL tenants are
  in flight at once (the device-wide backpressure: one tenant's burst
  cannot queue unbounded device work behind another tenant's fold), and
- **fairly** — when several tenants are waiting, the grant goes to the
  tenant with the fewest slots served so far (deficit round-robin,
  arrival order breaking ties), so a heavy tenant interleaves with a
  light one instead of starving it.

Slots are owned: each pipeline registers an owner id and every slot it
acquires is charged to that owner, so an abandoned pipeline (a round that
died mid-flight) returns its slots via ``release_owner`` — from the
pipeline's close() or its GC finalizer — instead of leaking scheduler
capacity for the life of the process.

The per-tenant served counters double as the round report's **fairness
split**: ``split()`` snapshots cumulative grants, ``window_split()``
drains the delta since the previous call (one round's interleave ratio).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..telemetry.registry import get_registry

_registry = get_registry()
TENANT_BATCHES = _registry.counter(
    "xaynet_tenant_fold_batches_total",
    "Fold-batch slots granted by the tenant scheduler, by tenant.",
    ("tenant",),
)
TENANT_SCHED_WAIT = _registry.counter(
    "xaynet_tenant_sched_wait_seconds_total",
    "Seconds producers spent waiting for a fold-batch slot, by tenant.",
    ("tenant",),
)
SCHED_INFLIGHT = _registry.gauge(
    "xaynet_tenant_sched_inflight",
    "Fold-batch slots currently granted across all tenants.",
)
SCHED_DEMOTIONS = _registry.counter(
    "xaynet_tenant_sched_demotions_total",
    "Preemptive demotions applied to a tenant by the SLO feedback loop "
    "(an over-budget tenant yields fold-batch slots until its burn "
    "recovers).",
    ("tenant",),
)

DEFAULT_MAX_INFLIGHT = 8


class TenantScheduler:
    """Fair, bounded fold-batch slot allocator (docs/DESIGN.md §19)."""

    def __init__(self, max_inflight: int = DEFAULT_MAX_INFLIGHT):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.max_inflight = max_inflight
        self._cond = threading.Condition()
        self._inflight = 0  # guarded-by: _cond
        self._owners: dict[int, int] = {}  # owner -> slots held  # guarded-by: _cond
        self._next_owner = 0  # guarded-by: _cond
        self._next_seq = 0  # guarded-by: _cond
        self._waiting: list[tuple[str, int]] = []  # (tenant, seq)  # guarded-by: _cond
        self._served: dict[str, int] = {}  # cumulative grants  # guarded-by: _cond
        self._window_prev: dict[str, int] = {}  # guarded-by: _cond
        self._weights: dict[str, float] = {}  # guarded-by: _cond
        self._tiers: dict[str, int] = {}  # guarded-by: _cond
        self._demoted: set[str] = set()  # guarded-by: _cond

    # -- ownership ----------------------------------------------------------

    def new_owner(self) -> int:
        with self._cond:
            self._next_owner += 1
            self._owners[self._next_owner] = 0
            return self._next_owner

    def release_owner(self, owner: int) -> None:
        """Return every slot the owner still holds (pipeline close / GC
        finalizer backstop). Idempotent."""
        with self._cond:
            held = self._owners.pop(owner, 0)
            if held:
                self._inflight -= held
                SCHED_INFLIGHT.dec(held)
                self._cond.notify_all()

    # -- slots --------------------------------------------------------------

    def _chosen(self) -> tuple[str, int]:
        """The waiter the next free slot belongs to, in precedence order:
        not SLO-demoted first (a demoted tenant only wins a slot when no
        healthy tenant is waiting — preemption at fold-batch granularity),
        then priority tier (lower tier number wins), then the smallest
        *weighted* deficit (served / weight: a weight-2 tenant earns slots
        twice as fast as a weight-1 one), FIFO on ties."""
        return min(
            self._waiting,
            key=lambda w: (
                w[0] in self._demoted,
                self._tiers.get(w[0], 0),
                self._served.get(w[0], 0) / self._weights.get(w[0], 1.0),
                w[1],
            ),
        )

    # -- SLO-weighted preemption -------------------------------------------

    def set_weight(self, tenant: str, weight: float) -> None:
        """Configure the tenant's fair-share weight (>= a weight-1 tenant's
        share per unit weight). Takes effect on the next grant decision."""
        if weight <= 0:
            raise ValueError("weight must be > 0")
        with self._cond:
            self._weights[tenant] = float(weight)
            self._cond.notify_all()

    def set_tier(self, tenant: str, tier: int) -> None:
        """Configure the tenant's priority tier (lower wins; default 0).
        A tier strictly dominates weights: tier-0 waiters always beat
        tier-1 waiters regardless of deficit."""
        with self._cond:
            self._tiers[tenant] = int(tier)
            self._cond.notify_all()

    def set_demoted(self, tenant: str, demoted: bool) -> None:
        """SLO feedback: an over-budget (burn-paging) tenant is demoted —
        it only receives fold-batch slots the healthy tenants do not
        want. Restoring is the same call with ``demoted=False``."""
        with self._cond:
            was = tenant in self._demoted
            if demoted:
                self._demoted.add(tenant)
            else:
                self._demoted.discard(tenant)
            changed = was != demoted
            if changed:
                self._cond.notify_all()
        if changed and demoted:
            SCHED_DEMOTIONS.labels(tenant=tenant).inc()

    def demoted(self) -> set[str]:
        with self._cond:
            return set(self._demoted)

    def forget_tenant(self, tenant: str) -> None:
        """Drop a drained tenant's scheduler state so a later re-onboard
        starts with a fresh deficit instead of a stale credit."""
        with self._cond:
            self._served.pop(tenant, None)
            self._window_prev.pop(tenant, None)
            self._weights.pop(tenant, None)
            self._tiers.pop(tenant, None)
            self._demoted.discard(tenant)
            self._cond.notify_all()

    def acquire(self, tenant: str, owner: int) -> None:
        """Block until a fold-batch slot is granted to ``tenant``."""
        t0 = time.monotonic()
        with self._cond:
            self._next_seq += 1
            me = (tenant, self._next_seq)
            self._waiting.append(me)
            try:
                while not (self._inflight < self.max_inflight and self._chosen() == me):
                    self._cond.wait()
            finally:
                self._waiting.remove(me)
            self._inflight += 1
            self._owners[owner] = self._owners.get(owner, 0) + 1
            self._served[tenant] = self._served.get(tenant, 0) + 1
            # another waiter may now be the chosen one for a remaining slot
            self._cond.notify_all()
        SCHED_INFLIGHT.inc()
        TENANT_BATCHES.labels(tenant=tenant).inc()
        waited = time.monotonic() - t0
        if waited > 0:
            TENANT_SCHED_WAIT.labels(tenant=tenant).inc(waited)

    def try_acquire_idle(self, tenant: str, owner: int) -> bool:
        """Grant a slot ONLY if the device is idle enough to give one away:
        capacity free AND no regular ``acquire`` waiter pending. Never
        blocks, never starves a real fold batch — the speculation/overlap
        engines (docs/DESIGN.md §22) use this to soak up scheduler slack
        between a round's fold batches. An idle grant is a normal owned
        slot (same ``release``/``release_owner``), but it is NOT charged
        to the fairness split: background speculation must not distort
        the deficit-round-robin ordering of real fold grants. Nothing in
        the port calls it until the speculative sum2 (ROADMAP item 9b) is
        ported."""
        with self._cond:
            if self._inflight >= self.max_inflight or self._waiting:
                return False
            self._inflight += 1
            self._owners[owner] = self._owners.get(owner, 0) + 1
        SCHED_INFLIGHT.inc()
        TENANT_BATCHES.labels(tenant=tenant).inc()
        return True

    def release(self, owner: int) -> None:
        """Return one slot held by ``owner``."""
        with self._cond:
            held = self._owners.get(owner, 0)
            if held <= 0:
                return  # already returned via release_owner (idempotence)
            self._owners[owner] = held - 1
            self._inflight -= 1
            self._cond.notify_all()
        SCHED_INFLIGHT.dec()

    # -- fairness observability --------------------------------------------

    def split(self) -> dict[str, int]:
        """Cumulative fold-batch grants per tenant."""
        with self._cond:
            return dict(self._served)

    def window_split(self) -> dict[str, int]:
        """Grants per tenant since the previous ``window_split`` call (the
        round report's fairness section)."""
        with self._cond:
            out = {
                t: n - self._window_prev.get(t, 0)
                for t, n in self._served.items()
                if n - self._window_prev.get(t, 0) > 0
            }
            self._window_prev = dict(self._served)
            return out


_sched_lock = threading.Lock()
_scheduler: Optional[TenantScheduler] = None


def get_scheduler() -> TenantScheduler:
    """The process-wide tenant scheduler (configured from ``[tenancy]`` by
    the runner; the default bound keeps single-tenant pipelining intact)."""
    global _scheduler
    with _sched_lock:
        if _scheduler is None:
            _scheduler = TenantScheduler()
        return _scheduler


def configure_scheduler(max_inflight: int) -> TenantScheduler:
    global _scheduler
    sched = TenantScheduler(max_inflight=max_inflight)
    with _sched_lock:
        _scheduler = sched
    return sched
