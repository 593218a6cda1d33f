"""ResilientStore: retry + circuit breaker + fault injection over a Store.

Every ``CoordinatorStorage`` / ``ModelStorage`` / ``TrustAnchor`` call the
coordinator makes flows through a :class:`_ResilientProxy`:

1. **fault injection** — if a :class:`~.faults.FaultPlan` is installed and
   decides to fault the site, the proxy applies it (raise / delay /
   write-then-raise) *around* the real backend;
2. **breaker gate** — an open circuit fail-fasts with ``BreakerOpen``
   before touching the backend (``is_ready`` probes bypass the gate — they
   ARE the recovery path);
3. **retry** — transient failures (``is_transient``) are retried in place
   on the policy's backoff schedule; permanent errors and protocol-error
   *returns* pass through untouched.

Retry-safety contract: **transient means not-executed (or idempotent)**.
Backends must mark a failure where the command may have executed
server-side (reply lost mid-command) as ``transient = False`` — replaying
a conditional insert whose first attempt landed would surface its dedup
verdict (ALREADY_*) for our own write, and in the update phase that means
a seed dict entry with no staged masked model: an undetectably corrupt
round. The redis backend honors this (``RespClient.command`` with
``replay_safe=False``); docs/DESIGN.md §9 discusses it.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ..storage.traits import Store, TransientStorageError
from .breaker import BreakerOpen, CircuitBreaker
from .faults import FaultAction, current_plan
from .policy import RetryPolicy

logger = logging.getLogger("xaynet.resilience")

# methods that probe backend health rather than serve round traffic: they
# bypass the breaker gate and their retries are pointless (the Failure
# phase already loops on them with its own backoff)
_PROBE_METHODS = frozenset({"is_ready"})


class _ResilientProxy:
    """Wraps one storage component; forwards non-coroutine attributes."""

    def __init__(
        self,
        inner,
        component: str,
        policy: RetryPolicy,
        breaker: CircuitBreaker,
        site_prefix: str = "",
    ):
        self._inner = inner
        self._component = component
        self._policy = policy
        self._breaker = breaker
        self._site_prefix = site_prefix
        self._wrapped: dict[str, object] = {}

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name.startswith("_") or not asyncio.iscoroutinefunction(attr):
            return attr
        cached = self._wrapped.get(name)
        if cached is None:
            cached = self._wrapped[name] = self._wrap(name, attr)
        return cached

    def _wrap(self, name: str, method):
        site = f"{self._site_prefix}storage.{self._component}.{name}"
        probe = name in _PROBE_METHODS

        async def attempt(*args, **kwargs):
            held = self._breaker.guard(probe=probe)
            plan = current_plan()
            action: Optional[FaultAction] = plan.decide(site) if plan is not None else None
            if action is not None and action.kind == "latency":
                await asyncio.sleep(action.delay_s)
                action = None
            if action is not None and action.kind == "error":
                # an injected error stands in for the backend failing, so
                # the breaker must see it like any real failure
                self._breaker.record(success=False, held_slot=held)
                if action.permanent:
                    raise _permanent(site, action.index)
                raise TransientStorageError(
                    f"injected transient fault at {site} (call #{action.index})"
                )
            try:
                result = await method(*args, **kwargs)
            except asyncio.CancelledError:
                # a phase window expiring mid-call is a control signal, not
                # a backend failure — no verdict, but give back any
                # half-open slot guard() handed us
                self._breaker.release(held_slot=held)
                raise
            except BaseException:
                self._breaker.record(success=False, held_slot=held)
                raise
            self._breaker.record(success=True, held_slot=held)
            if action is not None:  # 'partial': the write landed, caller errors
                raise TransientStorageError(
                    f"injected partial-write fault at {site} (call #{action.index})"
                )
            return result

        if probe:
            # no in-place retry for probes; the outer readiness loop paces them
            return attempt

        async def call(*args, **kwargs):
            return await self._policy.call_async(
                attempt, *args, site=site, no_retry=(BreakerOpen,), **kwargs
            )

        return call


def _permanent(site: str, index: int) -> Exception:
    from ..storage.traits import StorageError

    err = StorageError(f"injected permanent fault at {site} (call #{index})")
    err.transient = False
    return err


class ResilientStore(Store):
    """A :class:`Store` whose components retry, break and inject.

    Drop-in: phases keep calling ``store.coordinator.<method>`` /
    ``store.models.<method>`` exactly as before. Component breakers are
    independent — a dead model store must not fail coordinator-dict reads.
    """

    def __init__(
        self,
        inner: Store,
        policy: Optional[RetryPolicy] = None,
        breaker_threshold: int = 5,
        breaker_reset_s: float = 10.0,
        breaker_half_open_max: int = 1,
        tenant: str = "default",
    ):
        self.inner = inner
        policy = policy if policy is not None else RetryPolicy()
        # tenant-scoped fault/breaker sites (docs/DESIGN.md §23): a
        # non-default tenant's storage sites are "t:<id>:storage.*", so a
        # chaos plan can fault ONE tenant's backend while its neighbours'
        # stores stay byte-identical; the default tenant keeps the flat
        # site names every existing spec targets
        prefix = "" if tenant == "default" else f"t:{tenant}:"

        def breaker(component: str) -> CircuitBreaker:
            return CircuitBreaker(
                component=f"{prefix}{component}",
                failure_threshold=breaker_threshold,
                reset_timeout_s=breaker_reset_s,
                half_open_max=breaker_half_open_max,
            )

        super().__init__(
            coordinator=_ResilientProxy(
                inner.coordinator, "coordinator", policy, breaker("coordinator"),
                site_prefix=prefix,
            ),
            models=_ResilientProxy(
                inner.models, "models", policy, breaker("models"),
                site_prefix=prefix,
            ),
            trust_anchor=(
                _ResilientProxy(
                    inner.trust_anchor, "trust_anchor", policy,
                    breaker("trust_anchor"), site_prefix=prefix,
                )
                if inner.trust_anchor is not None
                else None
            ),
        )


def wrap_store(store: Store, resilience, tenant: str = "default") -> Store:
    """Wrap per ``ResilienceSettings`` (identity when disabled / already wrapped)."""
    if not resilience.enabled or isinstance(store, ResilientStore):
        return store
    from .policy import policy_from_settings

    return ResilientStore(
        store,
        policy=policy_from_settings(resilience),
        breaker_threshold=resilience.breaker_threshold,
        breaker_reset_s=resilience.breaker_reset_s,
        breaker_half_open_max=resilience.breaker_half_open_max,
        tenant=tenant,
    )
