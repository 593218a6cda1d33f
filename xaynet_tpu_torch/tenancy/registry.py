"""Tenant registry: specs, per-tenant runtime contexts, admission budgets.

The port's copy of ``xaynet_tpu/tenancy/registry.py``.

One coordinator process serves N tenants. Each tenant is a full,
independent PET round pipeline — its own settings (mask config, model
length, liveness policy), its own scoped store, its own phase state
machine, request channel and ingest pipeline — while the process-level
resources (the device, the accumulator page pool, the fold-batch scheduler,
the REST listener, the telemetry registry) are shared. The registry owns
the id -> context mapping the REST layer routes ``/t/<tenant>/...`` by.

The **admission budget** bounds any single tenant's share of a
PROCESS-wide in-queue message total, so a flooding tenant sheds (429 +
Retry-After) before it can crowd the other tenants' decrypt capacity. It
sits in front of each tenant's ingest pipeline (``ingest.IngestPipeline``
charges it at admission and discharges it as its decrypt workers drain
the intake); the lifecycle returns a drained tenant's whole share.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

from ..telemetry.registry import get_registry

DEFAULT_TENANT = "default"

_TENANT_ID_RE = re.compile(r"^[a-z0-9][a-z0-9_-]{0,31}$")

_registry = get_registry()
TENANT_INGEST_SHED = _registry.counter(
    "xaynet_tenant_ingest_shed_total",
    "Messages shed by the per-tenant admission budget (tenant over its "
    "share of the process-wide intake), by tenant.",
    ("tenant",),
)
TENANT_INGEST_OCCUPANCY = _registry.gauge(
    "xaynet_tenant_ingest_occupancy",
    "Messages a tenant currently holds in the process-wide intake, "
    "by tenant.",
    ("tenant",),
)


def validate_tenant_id(tenant: str) -> str:
    """Tenant ids are routing tokens, metric label values and storage key
    prefixes at once: lowercase alphanumerics plus ``-``/``_``, at most 32
    chars, never empty."""
    if not _TENANT_ID_RE.match(tenant):
        raise ValueError(
            f"invalid tenant id {tenant!r}: want ^[a-z0-9][a-z0-9_-]{{0,31}}$"
        )
    return tenant


@dataclass
class TenantContext:
    """One tenant's live runtime surface (built by the runner)."""

    tenant: str
    settings: Any
    store: Any = None
    machine: Any = None
    request_tx: Any = None
    events: Any = None
    handler: Any = None
    fetcher: Any = None
    pipeline: Any = None  # ingest.IngestPipeline or None
    edge_api: Any = None
    metrics: Any = None
    task: Any = None  # the state machine's asyncio task
    extra: dict = field(default_factory=dict)


class TenantRegistry:
    """Ordered id -> context map; the first registered tenant is the
    *default* (it also serves the unprefixed legacy routes)."""

    def __init__(self):
        self._contexts: dict[str, TenantContext] = {}
        self._lock = threading.Lock()

    def add(self, ctx: TenantContext) -> TenantContext:
        validate_tenant_id(ctx.tenant)
        with self._lock:
            if ctx.tenant in self._contexts:
                raise ValueError(f"tenant {ctx.tenant!r} already registered")
            self._contexts[ctx.tenant] = ctx
        return ctx

    def remove(self, tenant: str) -> Optional[TenantContext]:
        """Unregister a drained tenant (lifecycle offboard). Returns the
        removed context, or None if it was never (or no longer)
        registered. The first-registered tenant stays the default for the
        life of the process — offboarding it leaves the unprefixed legacy
        routes pointing at the next-oldest tenant."""
        with self._lock:
            return self._contexts.pop(tenant, None)

    def get(self, tenant: str) -> Optional[TenantContext]:
        with self._lock:
            return self._contexts.get(tenant)

    def ids(self) -> list[str]:
        with self._lock:
            return list(self._contexts)

    def contexts(self) -> list[TenantContext]:
        with self._lock:
            return list(self._contexts.values())

    @property
    def default(self) -> Optional[TenantContext]:
        with self._lock:
            return next(iter(self._contexts.values()), None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._contexts)


class TenantAdmissionBudget:
    """Per-tenant share of the process-wide intake occupancy.

    ``charge(tenant)`` accounts one admitted message and returns False —
    shed — when the tenant would exceed ``max_share`` of ``capacity``;
    ``discharge(tenant, n)`` returns capacity as the tenant's decrypt
    workers drain. The budget sits IN FRONT of the tenant's own
    ``AdmissionController`` (which still applies its watermark hysteresis
    to what the budget admits)."""

    def __init__(self, capacity: int, max_share: float = 0.6):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if not (0.0 < max_share <= 1.0):
            raise ValueError("max_share must be in (0, 1]")
        self.capacity = capacity
        self.max_share = max_share
        # ceil, and never below 1: a tiny capacity must not 0-out a tenant
        self.per_tenant = max(1, int(capacity * max_share))
        self._lock = threading.Lock()
        self._held: dict[str, int] = {}  # guarded-by: _lock

    def charge(self, tenant: str) -> bool:
        with self._lock:
            held = self._held.get(tenant, 0)
            total = sum(self._held.values())
            if held >= self.per_tenant or total >= self.capacity:
                TENANT_INGEST_SHED.labels(tenant=tenant).inc()
                return False
            self._held[tenant] = held + 1
        TENANT_INGEST_OCCUPANCY.labels(tenant=tenant).inc()
        return True

    def discharge(self, tenant: str, n: int = 1) -> None:
        with self._lock:
            held = self._held.get(tenant, 0)
            n = min(n, held)
            if n <= 0:
                return
            self._held[tenant] = held - n
        TENANT_INGEST_OCCUPANCY.labels(tenant=tenant).dec(n)

    def held(self, tenant: str) -> int:
        with self._lock:
            return self._held.get(tenant, 0)
