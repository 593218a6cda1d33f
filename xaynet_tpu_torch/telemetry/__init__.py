"""Unified telemetry layer: registry, kernel profiling, round reports.

- ``registry``  — Prometheus-style in-process metrics (counters, gauges,
  histograms, labels, text exposition) behind ``GET /metrics``;
- ``profiling`` — device-synced kernel timing hooks for the aggregation
  hot path (``XAYNET_KERNEL_PROFILE=0`` disables the sync points);
- ``report``    — per-round JSON report emitter (JSONL artifact);
- ``bridge``    — the reference eight-measurement recorder surface on top
  of the registry, forwarding to the legacy Jsonl/Influx sinks;
- ``tracing``   — the distributed round-tracing span layer (trace ids,
  bounded buffers, Chrome-trace export — docs/DESIGN.md §16);
- ``timeline``  — the always-on round-wall profiler: a streaming fold
  over each flushed round's span buffer into the
  ``xaynet_round_wall_seconds{tenant}`` histogram and a per-phase
  self-time/overlap decomposition (docs/DESIGN.md §20);
- ``slo``       — per-tenant SLO engine: multi-window burn-rate alerts
  over registry deltas, ``GET /alerts`` payloads, flight-recorder pages
  (docs/DESIGN.md §20);
- ``recorder``  — the flight recorder dumping span ring + registry deltas
  on failure triggers;
- ``redact``    — runtime secret redaction: ``redact()`` (the sanctioned
  length/type-only projection the taint pass treats as a declassifier)
  and the deny-list ``scrub_attrs`` filter applied to flight dumps and
  Chrome-trace exports before they hit disk (docs/DESIGN.md §18).
"""

from .bridge import BridgedMetrics as BridgedMetrics
from .recorder import FlightRecorder as FlightRecorder, flight_dump as flight_dump
from .redact import redact as redact, scrub_attrs as scrub_attrs
from .registry import (
    DEFAULT_BUCKETS as DEFAULT_BUCKETS,
    MetricError as MetricError,
    MetricsRegistry as MetricsRegistry,
    get_registry as get_registry,
)
from .report import RoundReporter as RoundReporter
from .slo import SloEngine as SloEngine, get_engine as get_slo_engine
from .timeline import RoundTimeline as RoundTimeline, get_timeline as get_timeline
from .tracing import (
    TraceContext as TraceContext,
    Tracer as Tracer,
    declare_span as declare_span,
    get_tracer as get_tracer,
    round_trace_id as round_trace_id,
    to_chrome_trace as to_chrome_trace,
)
