"""Multi-tenant coordinator plumbing (docs/DESIGN.md §19, §23).

The port's copy of ``xaynet_tpu/tenancy``: one coordinator process serves
several tenants' rounds on one CUDA device, through one REST listener,
one page pool and one fold-batch scheduler.

- :mod:`pool` — the paged accumulator pool: fixed-size pages, host slab
  arena (page-locked slabs under the staging rings that feed a CUDA
  device) + device capacity ledger, per-tenant page tables, lease/release
  accounting with the round-end leases == releases invariant, and
  between-round compaction of fragmented slabs.
- :mod:`scheduler` — the tenant fold-batch scheduler: bounded in-flight
  slots across tenants, weighted deficit-round-robin fairness with
  priority tiers and SLO-fed demotion, the round report's fairness split.
- :mod:`registry` — tenant specs/contexts, id validation, and the
  per-tenant admission budget that each tenant's ingest pipeline charges.
- :mod:`lifecycle` — the elastic tenant lifecycle: runtime
  onboard/drain, fault quarantine over per-tenant breakers, SLO-weighted
  preemption feedback.
"""

from .lifecycle import (
    LifecycleError,
    TenantLifecycle,
    get_manager,
    install_manager,
)
from .pool import (
    LOCAL_TENANT,
    PageLease,
    PagePool,
    PoolExhausted,
    configure_pool,
    get_pool,
)
from .registry import (
    DEFAULT_TENANT,
    TenantAdmissionBudget,
    TenantContext,
    TenantRegistry,
    validate_tenant_id,
)
from .scheduler import TenantScheduler, configure_scheduler, get_scheduler

__all__ = [
    "DEFAULT_TENANT",
    "LOCAL_TENANT",
    "LifecycleError",
    "PageLease",
    "PagePool",
    "PoolExhausted",
    "TenantAdmissionBudget",
    "TenantContext",
    "TenantLifecycle",
    "TenantRegistry",
    "TenantScheduler",
    "configure_pool",
    "configure_scheduler",
    "get_manager",
    "get_pool",
    "get_scheduler",
    "install_manager",
    "validate_tenant_id",
]
