"""Always-on round-wall timeline: a streaming critical-path fold over the
per-round span buffer (docs/DESIGN.md §20).

Five perf PRs optimized throughput *inside* phases; the number a production
operator actually watches — end-to-end round wall — was still only
recoverable offline from a Chrome-trace export. This module makes it a
first-class in-process signal: every time the tracer flushes a round window
(``Tracer.add_flush_hook``), one O(n) pass over the round's spans computes

- the **round wall** — Idle-close → Unmask-complete, i.e. the interval from
  the end of the ``phase.idle`` span (the moment the new round's params are
  live) to the end of the ``phase.unmask`` span (the moment the global
  model is published). Falls back to the root ``round`` span's duration
  when a failed round never reached unmask;
- a **per-phase decomposition** — per-phase wall and *self time* (the part
  of the phase's interval no other phase overlaps), the cross-phase
  **overlap** and the uncovered **gap**, chosen so the identity
  ``sum(phase walls) - overlap + gap == wall`` holds exactly: the report's
  numbers always sum (with overlap accounted) to the recorded wall;
- the **top-k slowest spans** of the round — "where did this round's wall
  go" without opening a trace viewer;
- the round's **degraded flag** — any phase span that closed its request
  window ``degraded``/``timeout`` (the outcome rides in the span attrs).

The wall lands in the ``xaynet_round_wall_seconds{tenant}`` histogram, the
decomposition in the round report (``telemetry.report``) and on the
``/statusz`` operator console, and every completed round is forwarded to
the SLO engine (``telemetry.slo``). The fold is always on — it costs one
list pass per round (bounded by the span-buffer cap, measured well under
0.1% of a round's aggregation wall by ``tools/trace_overhead.py``) — and,
like every telemetry consumer, it is fail-soft: the tracer swallows flush-
hook exceptions, so a fold bug can never fail a round.
"""

from __future__ import annotations

import heapq
import threading
from collections import deque
from typing import Optional

from .registry import get_registry
from .tracing import get_tracer

# log ladder covering 0.05s-120s: the registry default tops out sparsely
# above 30s, so a large-model round (61s @25M) landed in a coarse tail
# bucket and burn-rate math saw almost no distribution. Sub-50ms rounds
# only exist in unit tests; >120s rounds are SLO pages, +Inf is fine.
ROUND_WALL_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 15.0, 30.0, 60.0, 90.0, 120.0,
)

ROUND_WALL = get_registry().histogram(
    "xaynet_round_wall_seconds",
    "End-to-end round wall (Idle-close to Unmask-complete), by tenant — "
    "the operator headline the SLO engine budgets (docs/DESIGN.md §20).",
    ("tenant",),
    buckets=ROUND_WALL_BUCKETS,
)

OVERLAP_SECONDS = get_registry().counter(
    "xaynet_overlap_seconds_total",
    "Seconds of cross-phase work hidden inside another phase's wall, by "
    "overlap kind (spec_derive | eager_unmask | drain; docs/DESIGN.md §22).",
    ("kind",),
)
SPEC_DERIVE = get_registry().counter(
    "xaynet_spec_derive_total",
    "Speculatively derived sum2 mask seeds by outcome: hit (speculated and "
    "folded), miss (derived on demand at sum2), discard (mis-speculated, "
    "subtracted back out; docs/DESIGN.md §22).",
    ("outcome",),
)

# per-round overlap window: entries recorded by the overlap features and
# drained into the round report's `overlap` section (the
# `record_mask_calibration` idiom — bounded, fail-soft)
_overlap_window_lock = threading.Lock()
_overlap_window: list[dict] = []
_MAX_OVERLAP_ENTRIES = 256


def record_overlap(kind: str, seconds: float, tenant: str = "default", **extra) -> None:
    """Credit ``seconds`` of work hidden under another phase's wall and
    stash one entry for the round report's ``overlap`` section."""
    OVERLAP_SECONDS.labels(kind=kind).inc(max(0.0, seconds))
    entry = {"kind": kind, "seconds": round(seconds, 6), "tenant": tenant, **extra}
    with _overlap_window_lock:
        if len(_overlap_window) < _MAX_OVERLAP_ENTRIES:
            _overlap_window.append(entry)


def record_spec_outcomes(hits: int = 0, misses: int = 0, discards: int = 0) -> None:
    """Count speculative-derive seed outcomes (hit | miss | discard)."""
    if hits:
        SPEC_DERIVE.labels(outcome="hit").inc(hits)
    if misses:
        SPEC_DERIVE.labels(outcome="miss").inc(misses)
    if discards:
        SPEC_DERIVE.labels(outcome="discard").inc(discards)


def drain_overlap_window() -> list[dict]:
    """Drain the per-round overlap entries (round-report flush)."""
    global _overlap_window
    with _overlap_window_lock:
        out, _overlap_window = _overlap_window, []
    return out

# phases inside the round-wall bracket (idle is the bracket's left edge,
# not part of the decomposition; failure/shutdown abort the bracket)
_WORK_PHASES = ("sum", "update", "sum2", "unmask")
_TOP_K = 5
# recent walls kept per tenant for the /statusz sparkline
_SPARK_WINDOW = 64


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sorted, disjoint union of (start, end) intervals."""
    merged: list[tuple[float, float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def _measure(merged: list[tuple[float, float]]) -> float:
    return sum(end - start for start, end in merged)


def _intersection(
    a: list[tuple[float, float]], b: list[tuple[float, float]]
) -> float:
    """Measure of the intersection of two disjoint-sorted interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if lo < hi:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def fold_spans(round_id: int, spans: list) -> Optional[dict]:
    """One streaming pass over a round's span buffer -> the round-wall
    decomposition dict (None when the buffer carries no usable bracket).

    The pass collects the phase spans' intervals, the root span, the
    degraded flag and a bounded top-k heap in a single iteration; the
    interval arithmetic afterwards touches only the handful of phase
    intervals, so the cost is O(n) in the buffer size with a tiny constant
    — cheap enough to stay always-on.
    """
    phase_iv: dict[str, list[tuple[float, float]]] = {}
    idle_end: Optional[float] = None
    root = None
    tenant = ""
    degraded = False
    heap: list[tuple[float, int, str]] = []  # (duration, seq, name) min-heap
    for seq, span in enumerate(spans):
        name = span.name
        if name == "round":
            root = span
            continue
        # the top-k heap sees every non-root span except idle (which is
        # outside the wall bracket), phases included: a phase dominating
        # its own children IS the signal (self time)
        if name != "phase.idle":
            if len(heap) < _TOP_K:
                heapq.heappush(heap, (span.duration, seq, name))
            elif span.duration > heap[0][0]:
                heapq.heapreplace(heap, (span.duration, seq, name))
        if name.startswith("overlap."):
            # an overlap span is WORK BELONGING TO ITS HOME PHASE (the
            # `phase` attr) that ran outside the phase's own span — a
            # speculative derive inside update, update's drain riding the
            # sum2 window, an eager per-shard unmask inside the drain.
            # Merging it into the home phase's interval set makes the
            # identity's overlap term measure the hidden work: phase
            # intervals now genuinely intersect, so ``sum(phase walls) -
            # overlap + gap == wall`` reports negative slack (wall < sum
            # of walls) exactly when the overlap engine saved wall time.
            home = str(span.attrs.get("phase") or "")
            if home in _WORK_PHASES and span.duration > 0:
                phase_iv.setdefault(home, []).append(
                    (span.start, span.start + span.duration)
                )
            continue
        if not name.startswith("phase."):
            continue
        phase = name[len("phase."):]
        outcome = span.attrs.get("outcome")
        if outcome in ("degraded", "timeout"):
            degraded = True
        if span.attrs.get("tenant"):
            tenant = str(span.attrs["tenant"])
        end = span.start + span.duration
        if phase == "idle":
            idle_end = end if idle_end is None else max(idle_end, end)
        elif phase in _WORK_PHASES:
            phase_iv.setdefault(phase, []).append((span.start, end))
    if root is None and not phase_iv:
        return None
    merged = {p: _merge(iv) for p, iv in phase_iv.items()}
    # bracket: Idle-close -> Unmask-complete; a round that died before
    # unmask (or a buffer that lost idle to the cap) falls back to the
    # edges the buffer still has, and an empty decomposition falls back to
    # the root span outright
    ends = [iv[-1][1] for iv in merged.values()]
    starts = [iv[0][0] for iv in merged.values()]
    if idle_end is not None:
        left = idle_end
    elif starts:
        left = min(starts)
    else:
        left = root.start
    right_candidates = merged.get("unmask")
    if right_candidates:
        right = right_candidates[-1][1]
    elif ends:
        right = max(ends)
    else:
        right = root.start + root.duration
    wall = max(0.0, right - left)
    # clip each phase to the bracket so the identity below is exact even
    # when a phase span straddles an edge (idle overlap-starting sum, say)
    clipped = {
        p: [(max(s, left), min(e, right)) for s, e in iv if min(e, right) > max(s, left)]
        for p, iv in merged.items()
    }
    clipped = {p: iv for p, iv in clipped.items() if iv}
    union = _merge([pair for iv in clipped.values() for pair in iv])
    union_s = _measure(union)
    phases: dict[str, dict[str, float]] = {}
    total_phase_wall = 0.0
    for p in _WORK_PHASES:
        iv = clipped.get(p)
        if not iv:
            continue
        p_wall = _measure(iv)
        others = _merge(
            [pair for q, oiv in clipped.items() if q != p for pair in oiv]
        )
        phases[p] = {
            "wall_s": round(p_wall, 6),
            "self_s": round(p_wall - _intersection(iv, others), 6),
        }
        total_phase_wall += p_wall
    overlap = max(0.0, total_phase_wall - union_s)
    gap = max(0.0, wall - union_s)
    slowest = [
        {"span": name, "seconds": round(dur, 6)}
        for dur, _, name in sorted(heap, key=lambda t: -t[0])
    ]
    out = {
        "round_id": round_id,
        "tenant": tenant or "default",
        "wall_s": round(wall, 6),
        "phases": phases,
        "overlap_s": round(overlap, 6),
        "gap_s": round(gap, 6),
        "overlap_ratio": round(overlap / wall, 4) if wall > 0 else 0.0,
        "degraded": degraded,
        "spans": len(spans),
        "slowest": slowest,
    }
    return out


# per-tenant span accumulator bound: a tenant whose round never reaches
# unmask (crash-looping Failure) must not grow memory without limit
_PENDING_CAP = 2048


def _span_tenant(span) -> Optional[str]:
    tenant = span.attrs.get("tenant")
    return str(tenant) if tenant else None


class RoundTimeline:
    """Per-process timeline state: last decomposition + recent walls per
    tenant (one instance behind :func:`get_timeline`, registered as a
    tracer flush hook at import).

    Multi-tenant coordinators share ONE tracer, so a flushed round window
    may interleave several tenants' spans and a tenant's round may span
    several windows (every tenant's Idle flushes the shared window). The
    timeline therefore accumulates phase spans PER TENANT across flushes
    and folds a tenant's round the moment its ``phase.unmask`` span
    arrives — per-tenant walls stay exact even under interleaving.
    Untagged spans (streaming/request children carry no tenant attr) ride
    into the top-k only when a window belongs to a single tenant.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._last: dict[str, dict] = {}  # guarded-by: _lock
        self._walls: dict[str, deque] = {}  # guarded-by: _lock
        self._pending: dict[str, list] = {}  # guarded-by: _lock
        self._rounds = 0  # guarded-by: _lock

    @staticmethod
    def _partition(spans: list) -> dict[str, list]:
        """Group a span buffer by tenant: phase spans carry the tenant
        attr; untagged spans are attributed only when exactly one tenant
        owns the buffer."""
        by_tenant: dict[str, list] = {}
        untagged: list = []
        for seq, span in enumerate(spans):
            if span.name == "round":
                continue
            tenant = _span_tenant(span)
            if tenant is not None:
                by_tenant.setdefault(tenant, []).append((seq, span))
            else:
                untagged.append((seq, span))
        if len(by_tenant) == 1 and untagged:
            # merge in BUFFER order: the fold splits a tenant's list at its
            # unmask span, so an untagged child appended at the end would
            # leak into the next round's window instead of this fold
            only = next(iter(by_tenant))
            by_tenant[only] = sorted(
                by_tenant[only] + untagged, key=lambda pair: pair[0]
            )
        return {t: [span for _, span in lst] for t, lst in by_tenant.items()}

    # -- fold consumer (tracer flush hook) ----------------------------------

    def on_round(self, round_id: int, spans: list) -> None:
        by_tenant = self._partition(spans)
        if not by_tenant:
            # no phase spans at all (edge/SDK processes, span-less tests):
            # the root span's duration is still a round wall
            decomp = fold_spans(round_id, spans)
            if decomp is not None:
                self._finalize(decomp)
            return
        for tenant, tenant_spans in by_tenant.items():
            with self._lock:
                merged = self._pending.pop(tenant, []) + tenant_spans
            unmask_at = None
            for i, span in enumerate(merged):
                if span.name == "phase.unmask":
                    unmask_at = i
            if unmask_at is None:
                with self._lock:
                    self._pending[tenant] = merged[-_PENDING_CAP:]
                continue
            # spans recorded after unmask (the next round's idle, say)
            # seed the next accumulation window instead of polluting the
            # completed round's bracket
            fold_part, rest = merged[: unmask_at + 1], merged[unmask_at + 1:]
            rid = merged[unmask_at].attrs.get("round_id", round_id)
            decomp = fold_spans(rid, fold_part)
            with self._lock:
                if rest:
                    self._pending[tenant] = rest[-_PENDING_CAP:]
            if decomp is not None:
                decomp["tenant"] = tenant
                self._finalize(decomp)

    def _finalize(self, decomp: dict) -> None:
        tenant = decomp["tenant"]
        ROUND_WALL.labels(tenant=tenant).observe(decomp["wall_s"])
        with self._lock:
            self._last[tenant] = decomp
            self._walls.setdefault(tenant, deque(maxlen=_SPARK_WINDOW)).append(
                (decomp["round_id"], decomp["wall_s"])
            )
            self._rounds += 1
        # feed the SLO engine (lazy import: slo imports nothing from here,
        # but keeping the edge one-directional at import time is cheaper
        # than reasoning about cycles)
        from . import slo

        slo.get_engine().on_round(
            tenant, decomp["round_id"], decomp["wall_s"], decomp["degraded"]
        )

    # -- readers (round report, /statusz console, tests) --------------------

    def fold_for_report(self, tenant: str, round_id: int) -> Optional[dict]:
        """The decomposition for ``(tenant, round_id)`` AT REPORT-FLUSH
        TIME: the report flushes (next round's Idle ``__init__``) before
        the tracer window closes (next round's Idle ``process``), so the
        completed round's spans usually still sit in the open window —
        fold the pending accumulator plus a snapshot of the open buffer;
        fall back to the last flushed decomposition (multi-tenant windows
        flush on every tenant's round boundary, so the fold often already
        ran)."""
        open_id, open_spans = get_tracer().round_spans_snapshot()
        with self._lock:
            merged = list(self._pending.get(tenant, ()))
        if open_id is not None and open_spans:
            merged += self._partition(open_spans).get(tenant, [])
        if any(s.name == "phase.unmask" for s in merged):
            decomp = fold_spans(round_id, merged)
            if decomp is not None:
                decomp["tenant"] = tenant
                return decomp
        last = self.last(tenant)
        if last is not None and last.get("round_id") == round_id:
            return last
        return None

    def last(self, tenant: str = "default") -> Optional[dict]:
        """The most recent folded round's decomposition for ``tenant``."""
        with self._lock:
            decomp = self._last.get(tenant)
            return dict(decomp) if decomp is not None else None

    def recent_walls(self, tenant: str = "default") -> list[tuple[int, float]]:
        """Recent ``(round_id, wall_s)`` pairs, oldest first (sparkline)."""
        with self._lock:
            return list(self._walls.get(tenant, ()))

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(self._last)

    def rounds_folded(self) -> int:
        with self._lock:
            return self._rounds


_timeline = RoundTimeline()
get_tracer().add_flush_hook(_timeline.on_round)


def get_timeline() -> RoundTimeline:
    """The process-wide timeline every round flush folds into."""
    return _timeline
