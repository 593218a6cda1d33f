"""Per-round JSON round reports.

One structured JSON object per completed round, appended to a JSONL file:
round id, per-phase durations, message accepted/rejected/discarded counts
per phase, unique-mask total, aggregation kernel stats (calls, device-synced
seconds, elements, derived elements/sec) and any phase events. Consumers
(``tools/tpu_watch.py``, ``bench.py``, dashboards) read one artifact instead
of scraping coordinator logs.

Fed by ``telemetry.bridge.BridgedMetrics``: a report window opens when Idle
records ``round_total`` for a new round and flushes when the next round
starts (or on ``close()`` for the in-flight tail).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Optional

from . import profiling

logger = logging.getLogger("xaynet.telemetry")

# mask-kernel auto-calibration verdicts since the last report flush
# (the round report drains). Module-level like the
# profiling round window: verdicts are process-wide facts, and attributing
# them to the round whose report drains them is exactly the audit trail the
# headline needs (a verdict flip shows up in THAT round's report).
_calib_lock = threading.Lock()
_mask_calibrations: list[dict] = []

# bound: verdicts are one-per-(backend, shape, mesh) and memoized, so a
# handful per process is normal; a runaway recording bug must not grow the
# report without limit
_MAX_CALIBRATIONS = 64


def record_mask_calibration(entry: dict) -> None:
    """Record one auto-calibration verdict (winner + per-candidate probe
    walls) for the next round report."""
    with _calib_lock:
        if len(_mask_calibrations) < _MAX_CALIBRATIONS:
            _mask_calibrations.append(dict(entry))


def drain_mask_calibrations() -> list[dict]:
    with _calib_lock:
        out, _mask_calibrations[:] = list(_mask_calibrations), []
    return out


def _streaming_snapshot() -> Optional[dict]:
    """Streaming-fold pipeline state for the round report, read from the
    registry gauges (None when no streaming pipeline ever ran — host-mode
    coordinators don't grow an empty section): the pipeline overlap ratio,
    degraded flag, and — for shard-parallel folds — the per-shard overlap
    ratios keyed by shard index."""
    from .registry import get_registry

    reg = get_registry()
    overlap = reg.sample_value("xaynet_streaming_overlap_ratio")
    if overlap is None:
        return None
    out = {
        "overlap_ratio": round(overlap, 4),
        "degraded": bool(reg.sample_value("xaynet_streaming_degraded") or 0),
    }
    family = reg.get("xaynet_streaming_shard_overlap_ratio")
    if family is not None:
        shards = {
            key[0]: round(child.value, 4) for key, child in family.children()
        }
        if shards:
            out["shard_overlap_ratio"] = shards
    return out


def _bytes_counters() -> dict[str, dict[str, float]]:
    """Cumulative staged/reduced byte counters from the registry, keyed
    ``{series: {label_value: total}}`` (packed-reduction observability,
    docs/DESIGN.md §17)."""
    from .registry import get_registry

    reg = get_registry()
    out: dict[str, dict[str, float]] = {}
    for name, short in (
        ("xaynet_bytes_staged_total", "staged"),
        ("xaynet_bytes_reduced_total", "reduced"),
    ):
        family = reg.get(name)
        if family is None:
            continue
        series = {key[0]: child.value for key, child in family.children()}
        if series:
            out[short] = series
    return out


def _timeline_snapshot(tenant: str, round_id: Optional[int]) -> Optional[dict]:
    """The round-wall decomposition for the flushing round from the
    always-on timeline fold (docs/DESIGN.md §20); ``None`` when tracing is
    off or the round left no foldable bracket. The report carries tenant
    and round id already, so both are stripped from the section."""
    if round_id is None:
        return None
    from .timeline import get_timeline

    decomp = get_timeline().fold_for_report(tenant, round_id)
    if decomp is None:
        return None
    out = dict(decomp)
    out.pop("round_id", None)
    out.pop("tenant", None)
    return out


def _fairness_snapshot() -> Optional[dict]:
    """Per-tenant fold-batch grants since the previous round flush, read
    from the tenant scheduler (lazy import: telemetry must not pull the
    tenancy machinery into processes that never aggregate). ``None`` until
    the scheduler has granted slots to MORE than one tenant — single-tenant
    reports don't grow a trivial section."""
    from ..tenancy.scheduler import get_scheduler

    split = get_scheduler().split()
    # cumulative (not a drained window): each tenant's reporter flushes on
    # its own round cadence, and a shared drained delta would let one
    # tenant's flush steal another's window; consumers diff consecutive
    # reports for per-round rates
    return split if len(split) >= 2 else None


class RoundReporter:
    """Accumulates one round's telemetry and writes it as a JSON line."""

    def __init__(self, path: Optional[str] = None, tenant: str = "default"):
        self.path = path
        # the tenant this reporter's rounds belong to: stamped on every
        # report line so N tenants can share one JSONL file (§19)
        self.tenant = tenant
        self.last_report: Optional[dict] = None
        self._lock = threading.Lock()
        self._round_id: Optional[int] = None
        self._started: float = 0.0
        # previous cumulative byte-counter sample: the report carries
        # per-round DELTAS (bytes moved during this round), not process
        # totals
        self._bytes_prev: dict[str, dict[str, float]] = {}
        self._reset()

    def _reset(self) -> None:
        self._phases: list[str] = []
        self._durations: dict[str, float] = {}
        self._messages: dict[str, dict[str, int]] = {}
        self._masks_total: Optional[int] = None
        self._events: list[dict] = []

    # --- recording (called by the bridge) ---------------------------------

    def begin_round(self, round_id: int) -> None:
        with self._lock:
            if self._round_id is not None and self._round_id != round_id:
                self._flush_locked()
            if self._round_id != round_id:
                self._round_id = round_id
                self._started = time.time()

    def record_phase(self, phase: str) -> None:
        with self._lock:
            self._phases.append(phase)

    def record_phase_duration(self, phase: str, seconds: float) -> None:
        with self._lock:
            self._durations[phase] = round(
                self._durations.get(phase, 0.0) + seconds, 6
            )

    def record_message(self, phase: str, outcome: str) -> None:
        with self._lock:
            counts = self._messages.setdefault(
                phase, {"accepted": 0, "rejected": 0, "discarded": 0}
            )
            counts[outcome] = counts.get(outcome, 0) + 1

    def record_masks_total(self, count: int) -> None:
        with self._lock:
            self._masks_total = count

    def record_event(self, kind: str, detail: str) -> None:
        with self._lock:
            self._events.append({"kind": kind, "detail": detail})

    # --- flushing ----------------------------------------------------------

    def _flush_locked(self) -> None:
        if self._round_id is None:
            return
        report = {
            "ts": round(time.time(), 3),
            "round_id": self._round_id,
            "tenant": self.tenant,
            "seconds": round(time.time() - self._started, 3),
            "phases": self._phases,
            "phase_durations": dict(self._durations),
            "messages": self._messages,
            "masks_total": self._masks_total,
            "kernels": profiling.drain_round_stats(),
            "events": self._events,
        }
        timeline_section = _timeline_snapshot(self.tenant, self._round_id)
        if timeline_section is not None:
            # the round-wall decomposition from the always-on timeline
            # fold (docs/DESIGN.md §20): end-to-end wall, per-phase
            # wall/self time, cross-phase overlap + gap (the identity
            # sum(phase walls) - overlap + gap == wall holds), top-k
            # slowest spans and the degraded flag
            report["round_wall"] = timeline_section
        streaming = _streaming_snapshot()
        if streaming is not None:
            report["streaming"] = streaming
        fairness = _fairness_snapshot()
        if fairness is not None:
            # the tenant scheduler's fold-batch split: how the rounds'
            # device work interleaved across tenants (docs/DESIGN.md §19).
            # Only present once the scheduler has granted slots to more
            # than one tenant.
            report["fairness"] = fairness
        current = _bytes_counters()
        deltas = {
            short: {
                label: int(total - self._bytes_prev.get(short, {}).get(label, 0.0))
                for label, total in series.items()
                if total - self._bytes_prev.get(short, {}).get(label, 0.0) > 0
            }
            for short, series in current.items()
        }
        deltas = {k: v for k, v in deltas.items() if v}
        if deltas:
            # bytes moved THIS round on the staging (packed/unpacked/wire
            # layouts) and cross-shard combine (scatter/gather) paths —
            # the per-round view of the packed-reduction counters (§17)
            report["bytes"] = deltas
        self._bytes_prev = current
        from .timeline import drain_overlap_window

        overlap = drain_overlap_window()
        if overlap:
            # phase-overlap work that landed during this round
            # (docs/DESIGN.md §22): hidden seconds by kind (spec_derive |
            # drain | eager_unmask) with the speculation reconciliation
            # counts — the round-report view of why the round wall came in
            # under the serial sum of phase walls
            report["overlap"] = overlap
        calibrations = drain_mask_calibrations()
        if calibrations:
            # auto-calibration verdicts that landed during this round:
            # winner + per-candidate probe walls per (backend, length,
            # bucket, mesh) — a headline shift caused by a verdict flip is
            # auditable from the report instead of requiring a re-run
            report["mask_calibration"] = calibrations
        from .tracing import get_tracer

        ctx = get_tracer().round_ctx()
        if ctx is not None:
            # join key to the per-round Chrome trace / flight dumps
            report["trace_id"] = ctx.trace_id
        self.last_report = report
        if self.path:
            # a bad report path must never take the coordinator down: the
            # flush runs inside round_total (next round's Idle) and inside
            # close() — raising would abort the round / skip the sink drain
            try:
                with open(self.path, "a") as f:
                    f.write(json.dumps(report) + "\n")
            except OSError as err:
                logger.warning("round report write failed (%s): %s", self.path, err)
        self._round_id = None
        self._reset()

    def flush(self) -> None:
        """Write the in-flight round (shutdown path)."""
        with self._lock:
            self._flush_locked()
