"""Flight recorder: a forensic "what led up to this" artifact on failure.

The tracer's bounded ring always holds the most recent spans (streaming
batch/shard spans included); this module pairs it with a per-round snapshot
of the registry's counters and dumps both as ONE JSON bundle when a failure
trigger fires:

- ``pipeline-poison``   — the streaming fold pipeline poisoned permanently;
- ``degraded-close``    — a phase window closed in degraded mode;
- ``phase-timeout``     — a window closed below quorum (PhaseTimeout);
- ``breaker-open``      — a resilience circuit breaker opened;
- ``edge-ship-drop``    — an edge dropped a sealed envelope (retries
  exhausted / upstream unreachable);
- ``slo-page``          — a page-severity SLO burn-rate alert fired
  (``telemetry.slo``): the bundle is the forensics of the rounds that
  spent the error budget.

Dumps are rate-limited (at most one per trigger per
``_MIN_INTERVAL_S``, ``_MAX_DUMPS`` per process) so a crash-looping
component cannot fill a disk, and every dump path is logged at WARNING —
chaos soaks grep for it. The dump directory comes from
``XAYNET_FLIGHT_DIR`` (the runner overrides it from ``[metrics]
flight_dir``); the default lands under the system temp dir so the recorder
works in any process (edge, bench, tests) without configuration.

Everything here is fail-soft by contract: a broken disk must never turn a
degraded close into a crashed coordinator.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from typing import Optional

from .redact import scrub_attrs
from .registry import get_registry
from .tracing import get_tracer

logger = logging.getLogger("xaynet.telemetry")

FLIGHT_DUMPS = get_registry().counter(
    "xaynet_flight_dumps_total",
    "Flight-recorder dumps written, by trigger (pipeline-poison | "
    "degraded-close | phase-timeout | breaker-open | edge-ship-drop | "
    "slo-page).",
    ("trigger",),
)

_MIN_INTERVAL_S = 5.0  # per-trigger floor between dumps
_MAX_DUMPS = 64  # per-process ceiling (a crash loop stops writing, not failing)


def default_dir() -> str:
    return os.environ.get("XAYNET_FLIGHT_DIR", "") or os.path.join(
        tempfile.gettempdir(), "xaynet_flight"
    )


class FlightRecorder:
    """Ring + registry-delta dumper; one per process (``get_recorder``)."""

    def __init__(self, directory: str | None = None):
        self._dir = directory
        self._lock = threading.Lock()
        self._last_dump: dict[str, float] = {}  # guarded-by: _lock
        self._dumps = 0  # guarded-by: _lock
        self._round_id: Optional[int] = None  # guarded-by: _lock
        self._baseline: dict[str, float] = {}  # guarded-by: _lock
        self.last_path: Optional[str] = None  # test/soak observability
        get_tracer().add_round_hook(self.on_round)

    @property
    def directory(self) -> str:
        return self._dir or default_dir()

    def configure(self, directory: str | None) -> None:
        self._dir = directory or None

    # -- round boundary ----------------------------------------------------

    def on_round(self, round_id: int) -> None:
        """Round-begin hook (registered on the tracer): snapshot counters so
        a dump can show WHAT MOVED this round, not absolute totals."""
        with self._lock:
            self._round_id = round_id
            self._baseline = self._counter_snapshot()

    @staticmethod
    def _counter_snapshot() -> dict[str, float]:
        snap: dict[str, float] = {}
        reg = get_registry()
        # private-ish iteration kept inside telemetry (this module and the
        # registry are one subsystem). Histograms contribute their _sum and
        # _count series (latency evidence — "update handling took 40s this
        # round" is exactly what a forensic bundle is for); the per-bucket
        # vectors stay out, they would bloat the bundle without adding a
        # story the sum/count pair doesn't tell
        with reg._lock:
            families = list(reg._families.values())
        for family in families:
            for labelvalues, child in family.children():
                label = ",".join(labelvalues)
                if family.kind == "histogram":
                    suffix = f"{{{label}}}" if label else ""
                    snap[f"{family.name}_sum{suffix}"] = child.sum
                    snap[f"{family.name}_count{suffix}"] = float(child.count)
                    continue
                key = f"{family.name}{{{label}}}" if label else family.name
                snap[key] = child.value
        return snap

    def _deltas(self) -> dict[str, dict[str, float]]:
        now = self._counter_snapshot()
        with self._lock:
            base = dict(self._baseline)
        out: dict[str, dict[str, float]] = {}
        for key, value in now.items():
            before = base.get(key, 0.0)
            if value != before:
                out[key] = {"before": before, "now": value}
        return out

    # -- dumping -----------------------------------------------------------

    def dump(self, trigger: str, detail: str = "", **attrs) -> Optional[str]:
        """Write one forensic bundle; returns its path (None if suppressed
        by rate limiting or on any write failure)."""
        now = time.monotonic()
        with self._lock:
            if self._dumps >= _MAX_DUMPS:
                return None
            last = self._last_dump.get(trigger, -1e9)
            if now - last < _MIN_INTERVAL_S:
                return None
            self._last_dump[trigger] = now
            self._dumps += 1
            round_id = self._round_id
        tracer = get_tracer()
        # defense-in-depth (DESIGN §18): the static taint pass proves no
        # key material flows here at lint time; the deny-list scrub covers
        # what static analysis cannot see (values that became secret
        # dynamically) before the bundle hits disk
        bundle = {
            "trigger": trigger,
            "detail": detail,
            "attrs": scrub_attrs(attrs, "flight"),
            "ts": round(time.time(), 3),
            "round_id": round_id,
            "trace_id": (tracer.round_ctx().trace_id if tracer.round_ctx() else None),
            "ring": [
                scrub_attrs(s.to_json(anchor=tracer.anchor), "flight")
                for s in tracer.ring_spans()
            ],
            "metrics_delta": self._deltas(),
        }
        try:
            directory = self.directory
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(
                directory, f"flight_{int(time.time() * 1000)}_{trigger}.json"
            )
            with open(path, "w") as f:
                json.dump(bundle, f)
        except OSError as err:
            logger.warning("flight-recorder dump failed (%s): %s", trigger, err)
            return None
        FLIGHT_DUMPS.labels(trigger=trigger).inc()
        self.last_path = path
        logger.warning("[flight] %s: dump written to %s (%s)", trigger, path, detail)
        return path


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def flight_dump(trigger: str, detail: str = "", **attrs) -> Optional[str]:
    """Module-level trigger entry point; NEVER raises (failure paths call
    this while already handling an error — a recorder bug must not mask
    the original failure)."""
    try:
        return get_recorder().dump(trigger, detail, **attrs)
    except Exception:
        logger.exception("flight recorder failed")
        return None
