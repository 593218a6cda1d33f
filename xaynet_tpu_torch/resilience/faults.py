"""Deterministic fault injection: seeded plans, reproducible chaos.

A :class:`FaultPlan` is a seeded schedule of faults keyed by *site* — a
dotted string naming an injection point (``storage.coordinator.seed_dict``,
``ingest.worker.0``, ``streaming.fold``; participant side:
``sdk.send`` fails a send attempt, ``sdk.drop`` silently loses the message
on the wire, ``sdk.straggle`` delays it — see
``sdk.client.ResilientClient``). Sites consult the plan on every
call; whether the Nth call at a site faults depends only on the plan's
seed, its rules and N — never on wall clock, thread timing or hash
randomization — so a chaos scenario that fails in CI replays byte-for-byte
from its spec string.

Spec grammar (``;``-separated clauses)::

    seed=42;storage.coordinator.*:error,nth=2/5;streaming.fold:error,max=1
    ingest.worker.*:error,rate=0.1;storage.models.*:latency,delay=0.05

Each clause is ``<site-glob>:<kind>`` plus ``key=value`` options (the LAST
colon separates glob from kind, so tenant-scoped globs like
``t:t1:storage.*`` work unquoted):

- kind ``error``   — raise (transient by default; ``perm=1`` for permanent)
- kind ``latency`` — delay the call by ``delay`` seconds (default 0.05)
- kind ``partial`` — storage only: the write LANDS, then the caller sees a
  transient error (exercises retry idempotency). Aim it at IDEMPOTENT
  writes (``set_coordinator_state``, ``set_latest_global_model_id``); on a
  conditional insert it models a backend that violates the transient ⇒
  not-executed contract (see ``resilience.store``)
- ``nth=2/5/9``    — fire on exactly these 1-based call indices at the site
- ``rate=0.1``     — else fire per-call with this probability (per-site RNG)
- ``max=3``        — at most this many faults from this rule (per site)
- ``delay=0.05``   — latency seconds for kind ``latency``

Injection points are compiled out to a single ``is None`` check when no
plan is installed — the fault-free hot path stays fault-free.
"""

from __future__ import annotations

import fnmatch
import hashlib
import os
import random
import threading
from dataclasses import dataclass
from typing import Optional

from ..telemetry.registry import get_registry

_registry = get_registry()
FAULTS_INJECTED = _registry.counter(
    "xaynet_resilience_faults_injected_total",
    "Faults fired by the installed fault plan, by site and kind.",
    ("site", "kind"),
)


class InjectedFault(RuntimeError):
    """An error fired by the fault plan (non-storage sites)."""

    def __init__(self, site: str, index: int, transient: bool = True):
        super().__init__(f"injected {'transient' if transient else 'permanent'} "
                         f"fault at {site} (call #{index})")
        self.site = site
        self.index = index
        self.transient = transient


@dataclass
class FaultRule:
    pattern: str
    kind: str  # error | latency | partial
    nth: frozenset = frozenset()
    rate: float = 0.0
    max_faults: int = 1 << 30
    delay_s: float = 0.05
    permanent: bool = False

    def __post_init__(self) -> None:
        if self.kind not in ("error", "latency", "partial"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError("fault rate must be in [0, 1]")
        if self.delay_s < 0:
            raise ValueError("fault delay must be >= 0")


@dataclass
class FaultAction:
    """One decided fault: what the site should do to itself."""

    site: str
    kind: str
    index: int  # 1-based call index at the site
    delay_s: float = 0.0
    permanent: bool = False

    def to_error(self) -> InjectedFault:
        return InjectedFault(self.site, self.index, transient=not self.permanent)


class FaultPlan:
    """Seeded, per-site-deterministic fault schedule."""

    def __init__(self, seed: int, rules: list):
        self.seed = int(seed)
        self.rules = list(rules)
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._rngs: dict[str, random.Random] = {}
        self._fired: dict[tuple[str, int], int] = {}  # (site, rule idx) -> count

    # -- construction ------------------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        seed = 0
        rules: list[FaultRule] = []
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if clause.startswith("seed="):
                seed = int(clause[5:])
                continue
            # rpartition, not partition: tenant-scoped site globs carry
            # colons of their own ("t:<id>:storage.*", docs/DESIGN.md §23),
            # while kinds and options never do — the LAST colon is always
            # the glob/kind separator
            pattern, sep, rest = clause.rpartition(":")
            if not sep:
                raise ValueError(f"fault clause {clause!r}: expected '<site-glob>:<kind>[,...]'")
            parts = rest.split(",")
            kw: dict = {"pattern": pattern.strip(), "kind": parts[0].strip()}
            for opt in parts[1:]:
                key, sep, value = opt.partition("=")
                key, value = key.strip(), value.strip()
                if not sep:
                    raise ValueError(f"fault option {opt!r}: expected key=value")
                if key == "nth":
                    kw["nth"] = frozenset(int(v) for v in value.split("/"))
                elif key == "rate":
                    kw["rate"] = float(value)
                elif key == "max":
                    kw["max_faults"] = int(value)
                elif key == "delay":
                    kw["delay_s"] = float(value)
                elif key == "perm":
                    kw["permanent"] = value not in ("0", "false", "")
                else:
                    raise ValueError(f"unknown fault option {key!r}")
            rules.append(FaultRule(**kw))
        return cls(seed, rules)

    def _site_rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            # sha256 (not hash()) so the per-site stream is stable across
            # processes and PYTHONHASHSEED values
            digest = hashlib.sha256(f"{self.seed}:{site}".encode()).digest()
            rng = self._rngs[site] = random.Random(int.from_bytes(digest[:8], "little"))
        return rng

    # -- decisions ---------------------------------------------------------

    def decide(self, site: str) -> Optional[FaultAction]:
        """Advance the site's call counter; return the fault to apply, if any.

        First matching rule wins. Rate draws consume the per-site RNG on
        every matching call, so the decision for call N is a pure function
        of (seed, rules, N).
        """
        with self._lock:
            index = self._counters.get(site, 0) + 1
            self._counters[site] = index
            for rule_idx, rule in enumerate(self.rules):
                if not fnmatch.fnmatchcase(site, rule.pattern):
                    continue
                fired = self._fired.get((site, rule_idx), 0)
                if rule.nth:
                    hit = index in rule.nth
                elif rule.rate > 0.0:
                    hit = self._site_rng(site).random() < rule.rate
                else:
                    # no trigger option: fire on every matching call,
                    # bounded by max= ("error,max=1" = fail the first call)
                    hit = True
                if not hit or fired >= rule.max_faults:
                    continue
                self._fired[(site, rule_idx)] = fired + 1
                FAULTS_INJECTED.labels(site=site, kind=rule.kind).inc()
                return FaultAction(
                    site=site,
                    kind=rule.kind,
                    index=index,
                    delay_s=rule.delay_s,
                    permanent=rule.permanent,
                )
            return None

    def schedule(self, site: str, n: int) -> list:
        """Preview the first ``n`` decisions for a site WITHOUT mutating this
        plan (tests assert determinism against this)."""
        clone = FaultPlan(self.seed, self.rules)
        return [clone.decide(site) for _ in range(n)]


# -- process-global installation ------------------------------------------

_PLAN: Optional[FaultPlan] = None
_ENV_CHECKED = False
_ENV_VAR = "XAYNET_FAULT_PLAN"


def install_plan(plan: Optional[FaultPlan]) -> None:
    global _PLAN, _ENV_CHECKED
    _PLAN = plan
    _ENV_CHECKED = True  # an explicit install (or clear) overrides the env


def clear_plan() -> None:
    """Definitively no plan: also pins the env var as consumed, so a test
    teardown cannot be silently re-armed by a leftover XAYNET_FAULT_PLAN
    in the developer's shell."""
    global _PLAN, _ENV_CHECKED
    _PLAN = None
    _ENV_CHECKED = True


def current_plan() -> Optional[FaultPlan]:
    """The installed plan; on first call, picks up ``XAYNET_FAULT_PLAN``
    from the environment (so subprocess harnesses like the soak can inject
    without touching settings plumbing)."""
    global _PLAN, _ENV_CHECKED
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        spec = os.environ.get(_ENV_VAR)
        if spec:
            _PLAN = FaultPlan.parse(spec)
    return _PLAN


def maybe_fail(site: str) -> None:
    """Synchronous injection point: raise/delay per the installed plan.

    For sites running on DEDICATED THREADS (the streaming fold worker):
    ``latency`` actions block the calling thread only. Event-loop sites
    must use :func:`maybe_fail_async` — a ``time.sleep`` there would stall
    the whole coordinator, measuring event-loop starvation instead of the
    intended fault.
    """
    plan = current_plan()
    if plan is None:
        return
    action = plan.decide(site)
    if action is None:
        return
    if action.kind == "latency":
        import time

        time.sleep(action.delay_s)
        return
    # 'partial' has no meaning outside storage writes; treat as error
    raise action.to_error()


async def maybe_fail_async(site: str) -> None:
    """Event-loop-safe injection point (asyncio tasks: ingest workers).
    ``latency`` delays only this task via ``asyncio.sleep``."""
    plan = current_plan()
    if plan is None:
        return
    action = plan.decide(site)
    if action is None:
        return
    if action.kind == "latency":
        import asyncio

        await asyncio.sleep(action.delay_s)
        return
    raise action.to_error()
