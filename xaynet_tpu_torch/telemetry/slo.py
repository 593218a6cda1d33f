"""Per-tenant SLO engine: multi-window burn-rate alerts over registry
deltas (docs/DESIGN.md §20).

Three SLOs per tenant, all fed by signals the process already records:

- ``round_wall``  — fraction of rounds whose end-to-end wall
  (``telemetry.timeline``) stays under the tenant's ``round_wall_s``
  target; the error budget is ``round_wall_budget`` (allowed fraction of
  slow rounds);
- ``degraded``    — fraction of rounds that closed a request window
  degraded/timeout (the ``[liveness]`` machinery); budget
  ``degraded_budget``;
- ``shed``        — ingress sheds (HTTP 429) as a fraction of admission
  decisions, read as deltas of the admission counters
  (``xaynet_tenant_ingest_shed_total{tenant}`` per tenant, the global
  ``xaynet_ingest_{admitted,shed}_total`` as the traffic denominator);
  budget ``shed_budget``.

Evaluation is the standard multi-window burn-rate scheme: at every round
boundary the engine appends one timestamped sample of the cumulative
(good, bad) event counts per SLO and computes the burn rate — (bad
fraction over the window) / budget — over a FAST and a SLOW window. An
alert fires only when BOTH windows burn (the fast window makes the alert
prompt, the slow window keeps a single spike from paging):
``page`` at ``page_burn``, ``warn`` at ``warn_burn``. Transitions land on
``xaynet_slo_alerts_total{slo,severity}`` and in a bounded recent-alert
ring (``GET /alerts``, the ``/statusz`` console), and a page-severity
transition routes through the flight recorder (``slo-page`` trigger) so
the forensic bundle of the burn is written the moment it starts, not when
an operator gets around to it. ``xaynet_slo_budget_remaining{tenant,slo}``
and ``xaynet_slo_burn_rate{tenant,slo}`` expose the live state.

Like every telemetry consumer the engine is fail-soft and stdlib-only;
with no ``[slo]`` section configured it runs with generous defaults (the
timeline signal stays always-on, alerts effectively never fire).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from .redact import scrub_attrs
from .registry import get_registry

_registry = get_registry()
SLO_BUDGET = _registry.gauge(
    "xaynet_slo_budget_remaining",
    "Fraction of the slow-window error budget left, by tenant and SLO "
    "(1 = untouched, 0 = exhausted, negative = overspent; §20).",
    ("tenant", "slo"),
)
SLO_BURN = _registry.gauge(
    "xaynet_slo_burn_rate",
    "Fast-window burn rate, by tenant and SLO (1.0 = spending exactly "
    "the error budget; §20).",
    ("tenant", "slo"),
)
SLO_ALERTS = _registry.counter(
    "xaynet_slo_alerts_total",
    "Burn-rate alert transitions, by SLO and severity (warn | page; §20).",
    ("slo", "severity"),
)

SLOS = ("round_wall", "degraded", "shed")
_SEVERITY_RANK = {"": 0, "warn": 1, "page": 2}
_RING_SIZE = 64
# sample retention: enough history for the slow window plus one sample
# before it (delta anchoring), bounded so a fast round cadence cannot
# grow the deque without limit
_MAX_SAMPLES = 4096


class SloConfig:
    """Resolved engine configuration (defaults when no [slo] section)."""

    def __init__(
        self,
        enabled: bool = True,
        round_wall_s: float = 600.0,
        tenant_round_wall_s: Optional[dict[str, float]] = None,
        round_wall_budget: float = 0.05,
        degraded_budget: float = 0.1,
        shed_budget: float = 0.05,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        warn_burn: float = 6.0,
        page_burn: float = 14.4,
    ):
        self.enabled = enabled
        self.round_wall_s = round_wall_s
        self.tenant_round_wall_s = dict(tenant_round_wall_s or {})
        self.round_wall_budget = round_wall_budget
        self.degraded_budget = degraded_budget
        self.shed_budget = shed_budget
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.warn_burn = warn_burn
        self.page_burn = page_burn

    def target_for(self, tenant: str) -> float:
        return self.tenant_round_wall_s.get(tenant, self.round_wall_s)

    def budget_for(self, slo: str) -> float:
        return {
            "round_wall": self.round_wall_budget,
            "degraded": self.degraded_budget,
            "shed": self.shed_budget,
        }[slo]


def _burn(samples, now: float, window: float, slo: str, budget: float) -> float:
    """Burn rate over ``[now - window, now]`` from cumulative samples:
    (bad delta / total delta) / budget; 0.0 with no traffic."""
    if not samples:
        return 0.0
    # anchor = the state AT window start: the last sample before the
    # window, or the zero state when the whole history is inside it (a
    # samples[0] anchor would silently drop the first round's events
    # until enough history ages out of the window)
    anchor = None
    for s in samples:
        if s["ts"] >= now - window:
            break
        anchor = s
    anchor_bad, anchor_total = anchor[slo] if anchor is not None else (0.0, 0.0)
    latest = samples[-1]
    total = latest[slo][1] - anchor_total
    bad = latest[slo][0] - anchor_bad
    if total <= 0 or budget <= 0:
        return 0.0
    return (bad / total) / budget


class SloEngine:
    """Round-driven burn-rate evaluator; one per process (``get_engine``)."""

    def __init__(self, config: Optional[SloConfig] = None):
        self.config = config or SloConfig()
        self._lock = threading.Lock()
        # per-tenant cumulative event counts and timestamped samples
        self._counts: dict[str, dict[str, list[float]]] = {}  # guarded-by: _lock
        self._samples: dict[str, deque] = {}  # guarded-by: _lock
        self._active: dict[tuple[str, str], str] = {}  # guarded-by: _lock
        self._ring: deque = deque(maxlen=_RING_SIZE)  # guarded-by: _lock
        self._transition_hook = None  # set via set_transition_hook

    def configure(self, config: SloConfig) -> None:
        self.config = config

    def set_transition_hook(self, hook) -> None:
        """Install a callback fired on EVERY severity transition —
        escalations AND de-escalations back to ok — as ``hook(tenant, slo,
        severity)`` with severity one of ``"" | "warn" | "page"``. The
        tenancy lifecycle uses this to demote a burn-paging tenant's
        scheduler priority and restore it when the burn recovers. Called
        outside the engine lock; must be fail-soft and non-blocking."""
        self._transition_hook = hook

    # -- shed signal: registry deltas ---------------------------------------

    @staticmethod
    def _shed_totals(tenant: str) -> tuple[float, float]:
        """Cumulative (sheds, admission decisions) for ``tenant`` from the
        live registry: the per-tenant shed counter when the tenancy layer
        runs, the global admission counters as the traffic denominator
        (single-tenant deployments shed on the global counter only)."""
        reg = get_registry()
        shed = reg.sample_value("xaynet_tenant_ingest_shed_total", {"tenant": tenant})
        global_shed = reg.sample_value("xaynet_ingest_shed_total") or 0.0
        if shed is None:
            # no per-tenant series: the bare-route tenant owns the global
            shed = global_shed if tenant == "default" else 0.0
        admitted = reg.sample_value("xaynet_ingest_admitted_total") or 0.0
        return float(shed), float(admitted + global_shed)

    # -- round boundary (called by the timeline fold) ------------------------

    def on_round(
        self, tenant: str, round_id: int, wall_s: float, degraded: bool
    ) -> None:
        if not self.config.enabled:
            return
        now = time.monotonic()
        target = self.config.target_for(tenant)
        sheds, decisions = self._shed_totals(tenant)
        with self._lock:
            counts = self._counts.setdefault(
                tenant, {"rounds": [0.0, 0.0], "degraded_rounds": [0.0, 0.0]}
            )
            counts["rounds"][1] += 1
            if wall_s > target:
                counts["rounds"][0] += 1
            counts["degraded_rounds"][1] += 1
            if degraded:
                counts["degraded_rounds"][0] += 1
            sample = {
                "ts": now,
                # (bad, total) cumulative pairs per SLO
                "round_wall": tuple(counts["rounds"]),
                "degraded": tuple(counts["degraded_rounds"]),
                "shed": (sheds, decisions),
            }
            samples = self._samples.setdefault(tenant, deque(maxlen=_MAX_SAMPLES))
            samples.append(sample)
            horizon = now - 2 * self.config.slow_window_s
            while len(samples) > 1 and samples[0]["ts"] < horizon:
                samples.popleft()
        self._evaluate(tenant, round_id, now)

    # -- evaluation ----------------------------------------------------------

    def _evaluate(self, tenant: str, round_id: int, now: float) -> None:
        cfg = self.config
        with self._lock:
            samples = list(self._samples.get(tenant, ()))
        transitions: list[dict] = []
        changed: list[tuple[str, str]] = []  # (slo, severity), any direction
        for slo in SLOS:
            budget = cfg.budget_for(slo)
            fast = _burn(samples, now, cfg.fast_window_s, slo, budget)
            slow = _burn(samples, now, cfg.slow_window_s, slo, budget)
            SLO_BURN.labels(tenant=tenant, slo=slo).set(round(fast, 4))
            # budget remaining over the slow window: 1 - (bad / (total *
            # budget)); burn_slow IS that consumed fraction scaled by the
            # window, so remaining falls out directly
            SLO_BUDGET.labels(tenant=tenant, slo=slo).set(round(1.0 - slow, 4))
            effective = min(fast, slow)  # both windows must burn
            if effective >= cfg.page_burn:
                severity = "page"
            elif effective >= cfg.warn_burn:
                severity = "warn"
            else:
                severity = ""
            with self._lock:
                previous = self._active.get((tenant, slo), "")
                if severity == previous:
                    continue
                self._active[(tenant, slo)] = severity
                entry = {
                    "ts": round(time.time(), 3),
                    "tenant": tenant,
                    "slo": slo,
                    "severity": severity or "ok",
                    "previous": previous or "ok",
                    "round_id": round_id,
                    "burn_fast": round(fast, 3),
                    "burn_slow": round(slow, 3),
                }
                # defense-in-depth (DESIGN §18): alert payloads leave the
                # process via /alerts and /statusz — scrub before they are
                # ever stored, not at render time
                self._ring.append(scrub_attrs(entry, "alerts"))
            changed.append((slo, severity))
            if _SEVERITY_RANK[severity] > _SEVERITY_RANK[previous]:
                transitions.append(entry)
        hook = self._transition_hook
        if hook is not None:
            for slo, severity in changed:
                try:
                    hook(tenant, slo, severity)
                except Exception:  # fail-soft: feedback must not sink a round
                    import logging

                    logging.getLogger("xaynet.telemetry").exception(
                        "slo transition hook failed"
                    )
        for entry in transitions:
            SLO_ALERTS.labels(slo=entry["slo"], severity=entry["severity"]).inc()
            if entry["severity"] == "page":
                # forensic bundle at burn start: the span ring + counter
                # deltas of the rounds that spent the budget
                from .recorder import flight_dump

                flight_dump(
                    "slo-page",
                    f"tenant {entry['tenant']} {entry['slo']} burn "
                    f"{entry['burn_fast']}x (slow {entry['burn_slow']}x)",
                    tenant=entry["tenant"],
                    slo=entry["slo"],
                    round_id=entry["round_id"],
                    burn_fast=entry["burn_fast"],
                    burn_slow=entry["burn_slow"],
                )

    # -- readers (REST endpoints, console, tests) ----------------------------

    def active_alerts(self) -> list[dict]:
        """Currently-firing alerts (severity warn/page), sorted."""
        with self._lock:
            return [
                {"tenant": tenant, "slo": slo, "severity": severity}
                for (tenant, slo), severity in sorted(self._active.items())
                if severity
            ]

    def recent_alerts(self) -> list[dict]:
        """The bounded transition ring, oldest first (already scrubbed)."""
        with self._lock:
            return [dict(e) for e in self._ring]

    def burn_snapshot(self, tenant: str) -> dict[str, dict[str, float]]:
        """Live burn/budget gauges for one tenant (console section)."""
        out: dict[str, dict[str, float]] = {}
        reg = get_registry()
        for slo in SLOS:
            labels = {"tenant": tenant, "slo": slo}
            burn = reg.sample_value("xaynet_slo_burn_rate", labels)
            budget = reg.sample_value("xaynet_slo_budget_remaining", labels)
            if burn is None and budget is None:
                continue
            out[slo] = {
                "burn_rate": burn or 0.0,
                "budget_remaining": 1.0 if budget is None else budget,
            }
        return out

    def alerts_payload(self) -> dict:
        """The ``GET /alerts`` JSON body: active alerts + recent-transition
        ring + the engine's targets, scrubbed (§18) before export."""
        cfg = self.config
        payload = {
            "enabled": cfg.enabled,
            "targets": {
                "round_wall_s": cfg.round_wall_s,
                "tenants": dict(cfg.tenant_round_wall_s),
                "round_wall_budget": cfg.round_wall_budget,
                "degraded_budget": cfg.degraded_budget,
                "shed_budget": cfg.shed_budget,
                "fast_window_s": cfg.fast_window_s,
                "slow_window_s": cfg.slow_window_s,
                "warn_burn": cfg.warn_burn,
                "page_burn": cfg.page_burn,
            },
            "active": self.active_alerts(),
            "recent": self.recent_alerts(),
        }
        return scrub_attrs(payload, "alerts")


_engine = SloEngine()


def get_engine() -> SloEngine:
    """The process-wide SLO engine (configured by the runner)."""
    return _engine


def configure(settings) -> None:
    """Apply a ``SloSettings`` section (``server.settings``) to the engine.

    Accepts any object with the section's attributes so telemetry stays
    import-independent from the server package.
    """
    _engine.configure(
        SloConfig(
            enabled=settings.enabled,
            round_wall_s=settings.round_wall_s,
            tenant_round_wall_s=settings.tenant_targets(),
            round_wall_budget=settings.round_wall_budget,
            degraded_budget=settings.degraded_budget,
            shed_budget=settings.shed_budget,
            fast_window_s=settings.fast_window_s,
            slow_window_s=settings.slow_window_s,
            warn_burn=settings.warn_burn,
            page_burn=settings.page_burn,
        )
    )
