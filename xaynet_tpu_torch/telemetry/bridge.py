"""Bridge: the reference ``Metrics`` recorder surface on top of the registry.

``BridgedMetrics`` implements the same eight-measurement recorder interface
as ``server.metrics.Metrics`` (duck-typed — no import of the server layer),
so it drops into ``Shared.metrics`` unchanged. Every measurement

- lands in the telemetry registry (phase-duration histograms, message
  outcome counters, round/mask gauges) for ``GET /metrics``;
- feeds the per-round JSON reporter, when one is attached;
- is forwarded verbatim to an optional inner sink (``JsonlMetrics``,
  ``InfluxLineMetrics``, ``InfluxHttpMetrics``, ...) — so the existing
  Influx line-protocol output is byte-for-byte what it was before the
  registry existed.

The telemetry design is one-registry-per-process: hot-path modules
(request queue, message pipeline, kernel profiling, dispatcher health)
bind their families to ``get_registry()`` at import time, and the
per-round kernel window in ``profiling`` is process-global. Passing a
custom ``registry`` here isolates only the bridge-owned families (useful
in unit tests); it does not re-home the module-level series, and two
coordinators in one process share the global series.
"""

from __future__ import annotations

from typing import Optional

from .registry import DEFAULT_BUCKETS, MetricsRegistry, get_registry
from .report import RoundReporter

# per-request handler latencies are ms-scale; phase windows minute-scale
_HANDLE_BUCKETS = tuple(b for b in DEFAULT_BUCKETS if b <= 10.0)


class BridgedMetrics:
    """Registry-first recorder with optional sink and round-report fan-out."""

    def __init__(
        self,
        sink=None,
        reporter: Optional[RoundReporter] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.sink = sink
        self.reporter = reporter
        self.registry = registry if registry is not None else get_registry()
        r = self.registry
        self._round_id = r.gauge("xaynet_round_id", "Current PET round id.")
        self._phase_transitions = r.counter(
            "xaynet_phase_transitions_total", "Phase entries by phase name.", ("phase",)
        )
        self._messages = r.counter(
            "xaynet_messages_total",
            "Requests handled by the state machine, by phase and outcome.",
            ("phase", "outcome"),
        )
        self._masks = r.gauge(
            "xaynet_masks_total", "Unique masks submitted in the current round."
        )
        self._phase_duration = r.histogram(
            "xaynet_phase_duration_seconds",
            "Wall time of one phase run (process + purge).",
            ("phase",),
        )
        self._handle_duration = r.histogram(
            "xaynet_request_handle_seconds",
            "State-machine handling time of one accepted/rejected request.",
            ("phase",),
            buckets=_HANDLE_BUCKETS,
        )
        self._events = r.counter(
            "xaynet_events_total", "Free-form coordinator events by kind.", ("kind",)
        )

    # --- the eight reference measurements ---------------------------------

    def phase(self, round_id: int, phase: str) -> None:
        self._phase_transitions.labels(phase=phase).inc()
        if self.reporter is not None:
            self.reporter.record_phase(phase)
        if self.sink is not None:
            self.sink.phase(round_id, phase)

    def round_total(self, round_id: int) -> None:
        self._round_id.set(round_id)
        if self.reporter is not None:
            self.reporter.begin_round(round_id)
        if self.sink is not None:
            self.sink.round_total(round_id)

    def message_accepted(self, round_id: int, phase: str) -> None:
        self._message(round_id, phase, "accepted")

    def message_rejected(self, round_id: int, phase: str) -> None:
        self._message(round_id, phase, "rejected")

    def message_discarded(self, round_id: int, phase: str) -> None:
        self._message(round_id, phase, "discarded")

    def message_purged(self, round_id: int, phase: str) -> None:
        """Phase-end purge (degraded-close stragglers included): its own
        outcome label so purge bursts don't pollute reject-rate panels."""
        self._message(round_id, phase, "purged")

    def _message(self, round_id: int, phase: str, outcome: str) -> None:
        self._messages.labels(phase=phase, outcome=outcome).inc()
        if self.reporter is not None:
            self.reporter.record_message(phase, outcome)
        if self.sink is not None:
            # sinks predating the purged outcome fold purges into rejects
            emit = getattr(self.sink, f"message_{outcome}", None) or self.sink.message_rejected
            emit(round_id, phase)

    def masks_total(self, round_id: int, count: int) -> None:
        self._masks.set(count)
        if self.reporter is not None:
            self.reporter.record_masks_total(count)
        if self.sink is not None:
            self.sink.masks_total(round_id, count)

    def phase_duration(self, round_id: int, phase: str, seconds: float) -> None:
        self._phase_duration.labels(phase=phase).observe(seconds)
        if self.reporter is not None:
            self.reporter.record_phase_duration(phase, seconds)
        if self.sink is not None:
            self.sink.phase_duration(round_id, phase, seconds)

    def event(self, round_id: int, kind: str, detail: str = "") -> None:
        self._events.labels(kind=kind).inc()
        if self.reporter is not None:
            self.reporter.record_event(kind, detail)
        if self.sink is not None:
            self.sink.event(round_id, kind, detail)

    # --- registry-only extensions (not part of the sink contract) ---------

    def request_handled(self, round_id: int, phase: str, seconds: float) -> None:
        """Per-request handler latency; too hot for the line-protocol sinks."""
        self._handle_duration.labels(phase=phase).observe(seconds)

    def close(self) -> None:
        """Flush the in-flight round report and drain the sink."""
        if self.reporter is not None:
            self.reporter.flush()
        if self.sink is not None:
            self.sink.close()
