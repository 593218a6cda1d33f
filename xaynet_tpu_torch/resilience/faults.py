"""Deterministic fault injection at named sites.

The port's copy of ``xaynet_tpu/resilience/faults.py``, as much as the
streaming fold's injection site (``streaming.fold``) needs, so the same
plan drives the pipeline's degrade ladder in both packages. A
:class:`FaultPlan` counts the calls at each *site* (a dotted string naming
an injection point) and fails the ones its rules pick.

Spec grammar (``;``-separated clauses), a subset of the JAX package's::

    streaming.fold:error,nth=2/5
    streaming.fold:error,max=1

Each clause is ``<site>:error`` plus options: ``nth=2/5`` fires on exactly
these 1-based call indices at the site (without it, every call fires);
``max=3`` caps the faults of the rule. With no plan installed an injection
point is one ``is None`` check.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


class InjectedFault(RuntimeError):
    """An error fired by the fault plan."""

    def __init__(self, site: str, index: int):
        super().__init__(f"injected transient fault at {site} (call #{index})")
        self.site = site
        self.index = index


@dataclass
class FaultRule:
    site: str
    nth: frozenset = frozenset()
    max_faults: int = 1 << 30


class FaultPlan:
    """Per-site call counters and the rules that fail some of the calls."""

    def __init__(self, rules: list):
        self.rules = list(rules)
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._fired: dict[int, int] = {}  # rule index -> faults fired

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        rules = []
        for clause in filter(None, (c.strip() for c in spec.split(";"))):
            site, sep, rest = clause.rpartition(":")
            kind, *opts = rest.split(",")
            if not sep or kind.strip() != "error":
                raise ValueError(f"fault clause {clause!r}: expected '<site>:error[,...]'")
            rule = FaultRule(site.strip())
            for opt in opts:
                key, _, value = (part.strip() for part in opt.partition("="))
                if key == "nth":
                    rule.nth = frozenset(int(v) for v in value.split("/"))
                elif key == "max":
                    rule.max_faults = int(value)
                else:
                    raise ValueError(f"unknown fault option {key!r}")
            rules.append(rule)
        return cls(rules)

    def decide(self, site: str) -> int | None:
        """Advance the site's call counter; the 1-based call index if this
        call faults, else None. The first matching rule wins."""
        with self._lock:
            index = self._counters.get(site, 0) + 1
            self._counters[site] = index
            for i, rule in enumerate(self.rules):
                fired = self._fired.get(i, 0)
                if rule.site != site or (rule.nth and index not in rule.nth):
                    continue
                if fired >= rule.max_faults:
                    continue
                self._fired[i] = fired + 1
                return index
            return None


_PLAN: FaultPlan | None = None


def install_plan(plan: FaultPlan | None) -> None:
    """Install ``plan`` process-wide (``None`` clears it)."""
    global _PLAN
    _PLAN = plan


def clear_plan() -> None:
    install_plan(None)


def current_plan() -> FaultPlan | None:
    return _PLAN


def maybe_fail(site: str) -> None:
    """Injection point: raise if the plan fails this call."""
    plan = _PLAN
    if plan is None:
        return
    index = plan.decide(site)
    if index is not None:
        raise InjectedFault(site, index)
