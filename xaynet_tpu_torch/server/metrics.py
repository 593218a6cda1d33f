"""Metrics recorders.

Functional port of the reference's metrics subsystem (reference:
rust/xaynet-server/src/metrics/): eight measurements tagged with
(round_id, phase) — phase transitions, round counts, per-phase
accepted/rejected/discarded message counters, unique-mask totals — plus
free-form events for phase errors. Sinks: structured log lines or a JSONL
file (the line-protocol analogue; external collectors tail it).
"""

from __future__ import annotations

import json
import logging
import threading
import time

from ..telemetry.registry import get_registry

logger = logging.getLogger("xaynet.metrics")

# the dispatcher's own health, visible on GET /metrics: lines lost to
# backpressure, and backoff rounds against a down/slow sink
_DISPATCH_DROPPED = get_registry().counter(
    "xaynet_metrics_dispatcher_dropped_total",
    "Metric lines dropped by the Influx HTTP dispatcher (queue overflow or "
    "failed batches against a down sink).",
)
_DISPATCH_BACKOFF = get_registry().counter(
    "xaynet_metrics_dispatcher_backoff_total",
    "Backoff sleeps taken by the Influx HTTP dispatcher after a failed POST.",
)


class Metrics:
    """Recorder interface: the eight reference measurements dispatch to a
    sink's ``_emit``; the base sink is a no-op recorder."""

    def _emit(self, measurement: str, value, round_id: int, phase: str = "") -> None: ...

    def phase(self, round_id: int, phase: str) -> None:
        self._emit("phase", phase, round_id, phase)

    def round_total(self, round_id: int) -> None:
        self._emit("round_total_number", round_id, round_id)

    def message_accepted(self, round_id: int, phase: str) -> None:
        self._emit("message_accepted", 1, round_id, phase)

    def message_rejected(self, round_id: int, phase: str) -> None:
        self._emit("message_rejected", 1, round_id, phase)

    def message_discarded(self, round_id: int, phase: str) -> None:
        self._emit("message_discarded", 1, round_id, phase)

    def message_purged(self, round_id: int, phase: str) -> None:
        """A queued request rejected by the phase-end purge — NOT an
        in-window protocol reject (degraded closes purge every straggler;
        dashboards must be able to tell the two apart)."""
        self._emit("message_purged", 1, round_id, phase)

    def masks_total(self, round_id: int, count: int) -> None:
        self._emit("masks_total_number", count, round_id)

    def phase_duration(self, round_id: int, phase: str, seconds: float) -> None:
        self._emit("phase_duration_seconds", round(seconds, 4), round_id, phase)

    def event(self, round_id: int, kind: str, detail: str = "") -> None:
        self._emit("event_" + kind, detail, round_id)

    def close(self) -> None:
        """Flush/stop the sink; no-op for synchronous sinks."""


class LogMetrics(Metrics):
    def _emit(self, measurement: str, value, round_id: int, phase: str = "") -> None:
        logger.info("metric %s=%s round_id=%d phase=%s", measurement, value, round_id, phase)

    def event(self, round_id: int, kind: str, detail: str = "") -> None:
        logger.warning("event %s round_id=%d: %s", kind, round_id, detail)


class JsonlMetrics(Metrics):
    """Appends one JSON object per measurement (thread-safe)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def _emit(self, measurement: str, value, round_id: int, phase: str = "") -> None:
        record = {
            "ts": time.time(),
            "measurement": measurement,
            "value": value,
            "round_id": round_id,
        }
        if phase:
            record["phase"] = phase
        line = json.dumps(record)
        with self._lock, open(self.path, "a") as f:
            f.write(line + "\n")


def _influx_line(measurement: str, value, round_id: int, phase: str = "") -> str:
    tags = f",round_id={round_id}"
    if phase:
        tags += f",phase={phase}"
    if isinstance(value, (int, float)):
        field = f"value={value}"
    else:
        # line protocol: backslash BEFORE quote, and no raw newlines (a bad
        # value must never invalidate the rest of a batch)
        escaped = (
            str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", " ")
        )
        field = f'value="{escaped}"'
    return f"xaynet_{measurement}{tags} {field} {int(time.time() * 1e9)}"


class InfluxLineMetrics(JsonlMetrics):
    """InfluxDB line-protocol sink (append to a file; telegraf/collectors
    tail it). Same eight measurements as the reference's Influx recorder."""

    def _emit(self, measurement: str, value, round_id: int, phase: str = "") -> None:
        line = _influx_line(measurement, value, round_id, phase)
        with self._lock, open(self.path, "a") as f:
            f.write(line + "\n")


class InfluxHttpMetrics(Metrics):
    """Network dispatcher: line protocol pushed to an InfluxDB write endpoint
    over a dedicated background thread (reference:
    rust/xaynet-server/src/metrics/recorders/influxdb/dispatcher.rs).

    Backpressure contract: recording NEVER blocks the coordinator. Lines go
    into a bounded queue; when the sink falls behind and the queue fills,
    the oldest lines are dropped and counted (``dropped``) — the state
    machine's latency is never coupled to the metrics backend.
    """

    def __init__(
        self,
        url: str,
        database: str = "metrics",
        queue_size: int = 4096,
        batch_max: int = 256,
        flush_interval: float = 0.2,
    ):
        import queue as queue_mod

        self.url = url.rstrip("/") + f"/write?db={database}"
        self.dropped = 0
        self._queue: "queue_mod.Queue[str]" = queue_mod.Queue(maxsize=queue_size)
        self._batch_max = batch_max
        self._flush_interval = flush_interval
        self._stop = threading.Event()  # out-of-band: can't be lost to drops
        self._thread = threading.Thread(target=self._run, name="metrics-dispatch", daemon=True)
        self._thread.start()

    # --- dispatcher thread ----------------------------------------------

    def _run(self) -> None:
        import queue as queue_mod

        backoff = 0.1
        while True:
            lines: list[str] = []
            try:
                lines.append(self._queue.get(timeout=self._flush_interval))
            except queue_mod.Empty:
                if self._stop.is_set():
                    return  # closed and fully drained
                continue
            while len(lines) < self._batch_max:
                try:
                    lines.append(self._queue.get_nowait())
                except queue_mod.Empty:
                    break
            try:
                self._post(lines)
                backoff = 0.1
            except Exception:
                if self._stop.is_set():
                    return  # don't stall shutdown retrying a dead sink
                # sink down: drop this batch (bounded memory beats blocking)
                self.dropped += len(lines)
                _DISPATCH_DROPPED.inc(len(lines))
                _DISPATCH_BACKOFF.inc()
                time.sleep(backoff)
                backoff = min(backoff * 2, 5.0)

    def _post(self, lines: list[str]) -> None:
        import urllib.request

        req = urllib.request.Request(
            self.url, data=("\n".join(lines) + "\n").encode(), method="POST"
        )
        with urllib.request.urlopen(req, timeout=5):
            pass

    def close(self) -> None:
        """Stops the dispatcher after it drains whatever is queued."""
        self._stop.set()
        self._thread.join(timeout=10)

    # --- recording (non-blocking) ----------------------------------------

    def _emit(self, measurement: str, value, round_id: int, phase: str = "") -> None:
        import queue as queue_mod

        line = _influx_line(measurement, value, round_id, phase)
        try:
            self._queue.put_nowait(line)
            return
        except queue_mod.Full:
            pass
        # full: drop the OLDEST so fresh data survives; count every line
        # actually lost (the evicted one, and the new one if a concurrent
        # producer refills the freed slot before we take it)
        self.dropped += 1
        _DISPATCH_DROPPED.inc()
        try:
            self._queue.get_nowait()
        except queue_mod.Empty:
            pass
        try:
            self._queue.put_nowait(line)
        except queue_mod.Full:
            self.dropped += 1  # the new line was lost as well
            _DISPATCH_DROPPED.inc()
