"""Elastic tenant lifecycle: live onboard/drain, quarantine, SLO feedback.

The port's copy of ``xaynet_tpu/tenancy/lifecycle.py``. It makes the
tenant set of a multi-tenant coordinator elastic (docs/DESIGN.md §23). One ``TenantLifecycle`` manager per multi-tenant
process owns the per-tenant state machine

    drained -> onboarding -> serving <-> quarantined
                                 \\-> draining -> drained

and the three control loops around it:

- **onboard/offboard** — the authenticated ``/admin/tenants`` REST
  surface calls :meth:`onboard` (build the tenant's full round pipeline
  via the runner's builder, THEN register routes and admit traffic; the
  port has one fold per device type, so there is no kernel calibration
  to warm) and :meth:`offboard` (graceful drain: stop admission, let the
  in-flight round finish or degraded-close per the liveness quorum/stall
  semantics, then tear down — task cancel, channel close, page reclaim,
  unregister — with a hard-kill escalation and a flight
  bundle when the drain budget runs out).
- **fault quarantine** — each tenant gets a ``resilience.CircuitBreaker``
  fed by round outcomes (``note_round_failed`` / ``note_round_completed``
  from the phase close paths). Repeated failures — a storage breaker
  stuck open fails its rounds, a poisoned fold pipeline fails its rounds — trip
  the breaker OPEN: the tenant's ingress sheds with 429s, its scheduler
  priority is demoted, and a forensic flight bundle with scrubbed
  per-tenant counter deltas is written. Recovery is the breaker's own
  half-open probing: after ``quarantine_reset_s`` the next round's traffic
  is admitted as a probe; a completed round closes the breaker and
  restores the tenant, a failed one re-opens it. While the breaker is
  OPEN, round outcomes are NOT recorded — a shed tenant's timeout failures
  are self-inflicted and must not hold the quarantine open forever, and a
  degraded-close of pre-quarantine traffic must not end it early.
- **SLO-weighted preemption** — the burn-rate engine (``telemetry.slo``)
  reports every severity transition here (``set_transition_hook``); a tenant paging
  on any SLO is demoted in the fold-batch scheduler (it only receives
  slots no healthy tenant wants) and restored the moment the burn
  recovers. Configured ``[tenancy] weights``/``tiers`` apply at
  serving-entry.

Quarantine deliberately does NOT force-reclaim the tenant's pool pages
mid-round: in-flight fold threads hold live numpy views into the slabs
(and the card may still be copying out of them),
and freeing + re-leasing those runs to another tenant would corrupt both.
Pages return at the tenant's own round boundary (``Idle._reconcile_pool``
gc + reclaim), scheduler slots via the pipeline's owner release — the
isolation guarantee is *admission* (shed at the door) plus *priority*
(demoted in the scheduler), both effective immediately. A drain's
teardown, on either outcome, reclaims only after it has closed the
tenant's round aggregator: cancelling the machine task does not stop a
flush running in the executor, so the close waits for that flush and for
every queued fold before a page goes back to the pool.
"""

from __future__ import annotations

import asyncio
import gc
import logging
import threading
import time
from typing import Any, Callable, Optional

from ..resilience.breaker import OPEN, CircuitBreaker
from ..telemetry.recorder import flight_dump
from ..telemetry.redact import scrub_attrs
from ..telemetry.registry import get_registry
from .pool import get_pool
from .registry import TenantRegistry, validate_tenant_id
from .scheduler import get_scheduler

logger = logging.getLogger("xaynet.tenancy")

_registry = get_registry()
TENANT_STATE = _registry.gauge(
    "xaynet_tenant_state",
    "Lifecycle state per tenant (0 = drained, 1 = onboarding, 2 = serving, "
    "3 = quarantined, 4 = draining; docs/DESIGN.md §23).",
    ("tenant",),
)
TENANT_QUARANTINES = _registry.counter(
    "xaynet_tenant_quarantines_total",
    "Fault quarantines tripped, by tenant (repeated round failures opened "
    "the tenant's breaker; traffic sheds until the half-open probe round "
    "completes).",
    ("tenant",),
)
TENANT_DRAINS = _registry.counter(
    "xaynet_tenant_drains_total",
    "Tenant drains finished, by outcome (graceful = the in-flight round "
    "closed inside the budget; timeout = hard-kill escalation).",
    ("outcome",),
)

DRAINED = "drained"
ONBOARDING = "onboarding"
SERVING = "serving"
QUARANTINED = "quarantined"
DRAINING = "draining"
_STATE_VALUE = {DRAINED: 0, ONBOARDING: 1, SERVING: 2, QUARANTINED: 3, DRAINING: 4}

# per-tenant counter families sampled into quarantine/drain flight bundles
# (deltas since the tenant last entered serving — the rounds that spent
# the failure budget); entries are (family, extra labels, short name)
_DELTA_FAMILIES = (
    ("xaynet_tenant_fold_batches_total", {}, "fold_batches"),
    ("xaynet_tenant_ingest_shed_total", {}, "ingest_shed"),
    ("xaynet_pool_reclaimed_total", {}, "pool_reclaims"),
    ("xaynet_pool_pages", {"arena": "host"}, "host_pages_held"),
)


class LifecycleError(RuntimeError):
    """An admin-path transition was requested from an incompatible state
    (onboarding a live tenant, draining one that is not serving, ...)."""


class TenantLifecycle:
    """Per-process elastic tenancy manager (docs/DESIGN.md §23).

    ``builder`` is the runner's async factory: ``await builder(tenant)``
    builds the tenant's full round pipeline (scoped store, channels,
    machine, handler, fetcher), registers it in ``registry`` and returns
    ``(TenantContext, TenantRoutes)``. ``routes`` is the LIVE dict the
    RestServer routes ``/t/<tenant>/...`` by — mutating it here is what
    makes onboard/offboard take effect without a restart. ``clock`` is
    injectable so lifecycle tests don't sleep through drain budgets.
    """

    def __init__(
        self,
        settings: Any,  # TenancySettings
        registry: TenantRegistry,
        routes: dict,
        budget: Any = None,
        builder: Optional[Callable] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.settings = settings
        self.registry = registry
        self.routes = routes  # the RestServer's live routing dict
        self.budget = budget
        self.builder = builder
        self._clock = clock
        self._lock = threading.RLock()
        self._states: dict[str, str] = {}  # guarded-by: _lock
        self._breakers: dict[str, CircuitBreaker] = {}  # guarded-by: _lock
        self._boundaries: dict[str, int] = {}  # round-close count  # guarded-by: _lock
        self._marks: dict[str, dict[str, float]] = {}  # counter marks  # guarded-by: _lock
        self._slo_paging: dict[str, set] = {}  # tenant -> paging SLOs  # guarded-by: _lock

    # -- state bookkeeping ---------------------------------------------------

    def _set_state_locked(self, tenant: str, state: str) -> None:
        self._states[tenant] = state  # lint: guarded-ok: _locked suffix — every caller holds _lock
        TENANT_STATE.labels(tenant=tenant).set(_STATE_VALUE[state])

    def state(self, tenant: str) -> str:
        with self._lock:
            return self._states.get(tenant, DRAINED)

    def states(self) -> dict[str, str]:
        with self._lock:
            return dict(self._states)

    def breaker(self, tenant: str) -> Optional[CircuitBreaker]:
        with self._lock:
            return self._breakers.get(tenant)

    def mark_serving(self, tenant: str) -> None:
        """Enter ``serving``: breaker + counter marks + configured
        weight/tier. The runner calls this for boot-time tenants; onboard
        calls it for runtime ones."""
        sched = get_scheduler()
        with self._lock:
            self._set_state_locked(tenant, SERVING)
            self._breakers.setdefault(
                tenant,
                CircuitBreaker(
                    component=f"tenant:{tenant}",
                    failure_threshold=self.settings.quarantine_failures,
                    reset_timeout_s=self.settings.quarantine_reset_s,
                    clock=self._clock,
                ),
            )
            self._marks[tenant] = self._sample_counters(tenant)
            weight = self.settings.tenant_weights().get(tenant)
            if weight is not None:
                sched.set_weight(tenant, weight)  # guarded-by: _lock
            tier = self.settings.tenant_tiers().get(tenant)
            if tier is not None:
                sched.set_tier(tenant, tier)  # guarded-by: _lock

    # -- admission (REST hot path) -------------------------------------------

    def admit(self, tenant: str) -> tuple[bool, Optional[float]]:
        """May ``tenant``'s mutating traffic (message POSTs, edge
        envelopes) be admitted right now? Returns ``(admit, retry_after_s)``.
        Read-only polls are always served — a draining tenant's in-flight
        round still needs its participants to fetch round params."""
        with self._lock:
            state = self._states.get(tenant)
            breaker = self._breakers.get(tenant)
        if state in (DRAINING, ONBOARDING):
            return False, None
        if state == QUARANTINED and breaker is not None:
            # breaker.state transitions open -> half-open by itself after
            # quarantine_reset_s: the first admit after that IS the probe
            if breaker.state == OPEN:
                return False, self.settings.quarantine_reset_s
        return True, None

    # -- round outcome feedback (phase close paths) --------------------------

    def note_round_completed(self, tenant: str) -> None:
        with self._lock:
            if tenant not in self._states:
                return
            self._boundaries[tenant] = self._boundaries.get(tenant, 0) + 1
            state = self._states.get(tenant)
            breaker = self._breakers.get(tenant)
        if breaker is None or state in (DRAINING, DRAINED):
            return
        if breaker.state == OPEN:
            # a degraded-close of pre-quarantine traffic while shedding:
            # not a probe outcome, must not end the quarantine early
            return
        breaker.record(True)
        if state == QUARANTINED:
            with self._lock:
                self._set_state_locked(tenant, SERVING)
                self._marks[tenant] = self._sample_counters(tenant)
            self._sync_demotion(tenant)
            logger.warning("tenant %s: probe round completed, quarantine lifted", tenant)

    def note_round_failed(self, tenant: str) -> None:
        with self._lock:
            if tenant not in self._states:
                return
            self._boundaries[tenant] = self._boundaries.get(tenant, 0) + 1
            state = self._states.get(tenant)
            breaker = self._breakers.get(tenant)
        if breaker is None or state in (DRAINING, DRAINED):
            return
        if breaker.state == OPEN:
            # self-inflicted: a shed tenant's rounds time out BECAUSE we
            # shed — recording them would hold the quarantine open forever
            return
        breaker.record(False)
        if breaker.state == OPEN and state != QUARANTINED:
            self._enter_quarantine(tenant)

    def _enter_quarantine(self, tenant: str) -> None:
        with self._lock:
            self._set_state_locked(tenant, QUARANTINED)
        TENANT_QUARANTINES.labels(tenant=tenant).inc()
        self._sync_demotion(tenant)
        deltas = self._counter_deltas(tenant)
        flight_dump(
            "tenant-quarantine",
            f"tenant {tenant} quarantined after "
            f"{self.settings.quarantine_failures} consecutive round failures",
            tenant=tenant,
            counter_deltas=scrub_attrs(deltas, "tenant-quarantine"),
        )
        logger.error(
            "tenant %s QUARANTINED (shedding with 429; half-open probe in %.0fs)",
            tenant,
            self.settings.quarantine_reset_s,
        )

    # -- SLO feedback (telemetry.slo transition hook) ------------------------

    def slo_transition(self, tenant: str, slo: str, severity: str) -> None:
        """Installed on the SLO engine: any SLO paging demotes the tenant's
        scheduler priority; recovery restores it. Fires on every severity
        change, both directions."""
        with self._lock:
            if tenant not in self._states:
                return
            paging = self._slo_paging.setdefault(tenant, set())
            if severity == "page":
                paging.add(slo)
            else:
                paging.discard(slo)
        self._sync_demotion(tenant)

    def _sync_demotion(self, tenant: str) -> None:
        """One writer for the scheduler demotion flag: demoted while
        quarantined OR while any SLO pages; restored when both clear."""
        with self._lock:
            demoted = self._states.get(tenant) == QUARANTINED or bool(
                self._slo_paging.get(tenant)
            )
            get_scheduler().set_demoted(tenant, demoted)  # guarded-by: _lock

    def install_slo_hook(self, engine) -> None:
        engine.set_transition_hook(self.slo_transition)

    # -- onboard -------------------------------------------------------------

    async def onboard(self, tenant: str) -> dict:
        """Build + admit a new tenant at runtime. Pool budget is allocated
        by the tenant's first leases against the configured caps; routes
        register only after the round pipeline is fully up."""
        validate_tenant_id(tenant)
        if self.builder is None:
            raise LifecycleError("runtime onboarding unavailable (no builder)")
        with self._lock:
            current = self._states.get(tenant, DRAINED)
            if current != DRAINED or self.registry.get(tenant) is not None:
                raise LifecycleError(f"tenant {tenant!r} is {current}, not drained")
            self._set_state_locked(tenant, ONBOARDING)
        t0 = self._clock()
        try:
            ctx, troutes = await self.builder(tenant)
        except BaseException:
            with self._lock:
                self._states.pop(tenant, None)
                TENANT_STATE.labels(tenant=tenant).set(_STATE_VALUE[DRAINED])
            raise
        ctx.task = asyncio.create_task(ctx.machine.run(), name=f"machine-{tenant}")
        with self._lock:
            self.routes[tenant] = troutes  # guarded-by: _lock
            self.mark_serving(tenant)
        onboard_s = self._clock() - t0
        logger.info("tenant %s onboarded in %.3fs (serving)", tenant, onboard_s)
        return {"tenant": tenant, "state": SERVING, "onboard_s": round(onboard_s, 4)}

    # -- offboard ------------------------------------------------------------

    async def offboard(self, tenant: str) -> dict:
        """Graceful drain with hard-kill escalation. Admission stops the
        moment the state flips to ``draining``; the in-flight round then
        finishes or degraded-closes per the liveness stall-grace/quorum
        semantics (its already-admitted traffic keeps flowing, GET polls
        stay served). If no round boundary arrives inside
        ``drain_timeout_s``, the drain escalates: flight bundle, then the
        same hard teardown."""
        with self._lock:
            current = self._states.get(tenant, DRAINED)
            if current not in (SERVING, QUARANTINED):
                raise LifecycleError(f"tenant {tenant!r} is {current}, not drainable")
            self._set_state_locked(tenant, DRAINING)
            boundary0 = self._boundaries.get(tenant, 0)
        ctx = self.registry.get(tenant)
        deadline = self._clock() + self.settings.drain_timeout_s
        graceful = False
        while self._clock() < deadline:
            with self._lock:
                if self._boundaries.get(tenant, 0) > boundary0:
                    graceful = True
                    break
            if ctx is None or (ctx.task is not None and ctx.task.done()):
                graceful = True
                break
            await asyncio.sleep(0.05)
        outcome = "graceful" if graceful else "timeout"
        if not graceful:
            flight_dump(
                "tenant-drain-timeout",
                f"tenant {tenant} drain exceeded "
                f"{self.settings.drain_timeout_s:.0f}s; hard-killing",
                tenant=tenant,
                counter_deltas=scrub_attrs(
                    self._counter_deltas(tenant), "tenant-drain-timeout"
                ),
            )
            logger.error("tenant %s drain TIMED OUT; hard-kill escalation", tenant)
        TENANT_DRAINS.labels(outcome=outcome).inc()
        await self._teardown(tenant)
        with self._lock:
            self._set_state_locked(tenant, DRAINED)
            self._slo_paging.pop(tenant, None)
            self._breakers.pop(tenant, None)
            self._marks.pop(tenant, None)
        logger.info("tenant %s drained (%s)", tenant, outcome)
        return {"tenant": tenant, "state": DRAINED, "outcome": outcome}

    async def _teardown(self, tenant: str) -> None:
        """Hard teardown, shared by both drain outcomes: unroute,
        unregister, cancel the machine, close channels (and an ingest
        pipeline, where a context has one), close the round's aggregator,
        then release every pool page and scheduler slot the tenant held."""
        with self._lock:
            self.routes.pop(tenant, None)  # guarded-by: _lock
            ctx = self.registry.remove(tenant)  # guarded-by: _lock
        if ctx is None:
            return
        phase = getattr(ctx.machine, "phase", None)
        agg = getattr(phase.shared, "round_aggregator", None) if phase is not None else None
        if ctx.task is not None:
            ctx.task.cancel()
            try:
                await ctx.task
            except (asyncio.CancelledError, Exception):
                pass
        if ctx.request_tx is not None:
            ctx.request_tx.close()
        if ctx.pipeline is not None:
            await ctx.pipeline.stop()
        if ctx.metrics is not None:
            ctx.metrics.close()
        # the cancelled task's executor job (a flush) runs on and the fold
        # worker still copies out of the ring: close the aggregator, which
        # waits for both, then collect the finalizer backstops and
        # force-release the rest — zero leaked pages is the drain
        # postcondition the churn soak pins
        await asyncio.to_thread(self._reclaim_pages, tenant, agg)
        get_scheduler().forget_tenant(tenant)  # guarded-by: scheduler._cond
        if self.budget is not None:
            self.budget.discharge(tenant, self.budget.held(tenant))  # guarded-by: budget._lock

    @staticmethod
    def _reclaim_pages(tenant: str, agg) -> None:
        if agg is not None:
            agg.close()
        gc.collect()
        get_pool().reclaim(tenant)  # guarded-by: pool._lock

    # -- reconfigure ---------------------------------------------------------

    def reconfigure(self, tenant: str, weight: Optional[float] = None,
                    tier: Optional[int] = None) -> dict:
        """Runtime scheduling reconfiguration for a live tenant."""
        sched = get_scheduler()
        with self._lock:
            if self._states.get(tenant) not in (SERVING, QUARANTINED):
                raise LifecycleError(f"tenant {tenant!r} is not live")
            if weight is not None:
                sched.set_weight(tenant, float(weight))  # guarded-by: _lock
            if tier is not None:
                sched.set_tier(tenant, int(tier))  # guarded-by: _lock
        return {"tenant": tenant, "weight": weight, "tier": tier}

    # -- forensics -----------------------------------------------------------

    def _sample_counters(self, tenant: str) -> dict[str, float]:
        reg = get_registry()
        out: dict[str, float] = {}
        for family, extra, short in _DELTA_FAMILIES:
            value = reg.sample_value(family, {"tenant": tenant, **extra})
            out[short] = float(value or 0.0)
        return out

    def _counter_deltas(self, tenant: str) -> dict[str, float]:
        now = self._sample_counters(tenant)
        with self._lock:
            mark = self._marks.get(tenant, {})
        return {k: round(v - mark.get(k, 0.0), 3) for k, v in now.items()}


_manager_lock = threading.Lock()
_manager: Optional[TenantLifecycle] = None


def install_manager(manager: Optional[TenantLifecycle]) -> None:
    """Install the process lifecycle manager (multi-tenant runner startup;
    None uninstalls — single-tenant serving runs without one)."""
    global _manager
    with _manager_lock:
        _manager = manager


def get_manager() -> Optional[TenantLifecycle]:
    with _manager_lock:
        return _manager


def note_round_completed(tenant: str) -> None:
    """Phase-close forwarder (Unmask -> Idle). No-op without a manager;
    never raises — a lifecycle bug must not sink the round that just
    closed cleanly."""
    manager = get_manager()
    if manager is None:
        return
    try:
        manager.note_round_completed(tenant)
    except Exception:
        logger.exception("lifecycle round-completed hook failed")


def note_round_failed(tenant: str) -> None:
    """Phase-close forwarder (Failure -> Idle). No-op without a manager;
    never raises on the failure path it observes."""
    manager = get_manager()
    if manager is None:
        return
    try:
        manager.note_round_failed(tenant)
    except Exception:
        logger.exception("lifecycle round-failed hook failed")
