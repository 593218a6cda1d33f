"""Prometheus-style in-process metrics registry (stdlib only).

The coordinator's single source of truth for operational numbers: counters,
gauges and histograms with labels, rendered in the Prometheus text
exposition format (v0.0.4) by ``GET /metrics`` on the REST server. The
reference ships its measurements straight to InfluxDB
(rust/xaynet-server/src/metrics/); here every measurement lands in this
registry first and the Influx/Jsonl sinks consume it through
``telemetry.bridge`` — one registry, many consumers, no new dependencies.

Concurrency: metric children carry their own lock, so the asyncio loop, the
message-pipeline thread pool and the metrics dispatcher thread can all
record without coordination. Family creation is idempotent — asking for an
existing (name, kind, labelnames) returns the same family, so modules can
declare their metrics at import time against the process registry.
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from typing import Iterable, Optional, Sequence

# Prometheus' defaults stop at 10s; phases can legitimately take minutes
# (time.max windows), so the tail extends to the reference's 600s ceiling.
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)


class MetricError(ValueError):
    """Invalid metric declaration or use (type conflict, bad label set, ...)."""


def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if value != value:  # NaN
        return "NaN"
    as_float = float(value)
    if as_float.is_integer() and abs(as_float) < 1e15:
        return str(int(as_float))
    return repr(as_float)


def _label_string(labelnames: Sequence[str], labelvalues: Sequence[str], extra: str = "") -> str:
    pairs = [
        f'{name}="{_escape_label_value(value)}"'
        for name, value in zip(labelnames, labelvalues)
    ]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Counter:
    """Monotonically increasing value."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise MetricError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def _render(self, lines: list[str], name: str, labelstr: str) -> None:
        lines.append(f"{name}{labelstr} {_format_value(self._value)}")


class _Gauge:
    """Value that can go up and down."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        return self._value

    def _render(self, lines: list[str], name: str, labelstr: str) -> None:
        lines.append(f"{name}{labelstr} {_format_value(self._value)}")


class _Histogram:
    """Cumulative-bucket histogram with ``_sum`` and ``_count`` series."""

    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, buckets: Sequence[float]):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise MetricError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last slot is +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            for i, bound in enumerate(self._bounds):
                if value <= bound:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @contextmanager
    def time(self):
        """Observe the wall time of the enclosed block."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def count(self) -> int:
        return self._count

    def bucket_counts(self) -> dict[float, int]:
        """Cumulative count per upper bound (``inf`` key == total count)."""
        out, running = {}, 0
        with self._lock:
            for bound, n in zip(self._bounds + (math.inf,), self._counts):
                running += n
                out[bound] = running
        return out

    def _render(self, lines: list[str], name: str, labelstr: str) -> None:
        with self._lock:
            counts = list(self._counts)
            total, sum_ = self._count, self._sum
        # labelstr is "{a=\"b\"}" or ""; splice le into the existing braces
        base = labelstr[1:-1] if labelstr else ""
        running = 0
        for bound, n in zip(self._bounds + (math.inf,), counts):
            running += n
            le = f'le="{_format_value(bound) if bound != math.inf else "+Inf"}"'
            joined = f"{base},{le}" if base else le
            lines.append(f"{name}_bucket{{{joined}}} {running}")
        lines.append(f"{name}_sum{labelstr} {_format_value(sum_)}")
        lines.append(f"{name}_count{labelstr} {total}")


_KINDS = {"counter": _Counter, "gauge": _Gauge, "histogram": _Histogram}


class MetricFamily:
    """One named metric with a fixed label schema and per-labelset children.

    A family with no labels proxies the child API (``inc``/``set``/
    ``observe``/...) directly, so ``registry.counter("x").inc()`` works.
    """

    def __init__(self, name: str, kind: str, help: str, labelnames: Sequence[str], **child_kwargs):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._child_kwargs = child_kwargs
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = _KINDS[kind](**child_kwargs)

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise MetricError(
                f"{self.name}: expected labels {self.labelnames}, got {tuple(labelvalues)}"
            )
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _KINDS[self.kind](**self._child_kwargs)
        return child

    def _default_child(self):
        if self.labelnames:
            raise MetricError(f"{self.name} has labels {self.labelnames}; use .labels(...)")
        return self._children[()]

    def children(self) -> list[tuple[tuple[str, ...], object]]:
        """Snapshot of the labeled children as ``(labelvalues, child)``
        pairs, sorted by label values — the public enumeration surface for
        readers that aggregate a family (/healthz sections, round
        reports), so they never touch the internal storage layout."""
        with self._lock:
            return sorted(self._children.items())

    # unlabeled convenience proxies ----------------------------------------

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    def time(self):
        return self._default_child().time()

    @property
    def value(self):
        return self._default_child().value

    @property
    def sum(self):
        return self._default_child().sum

    @property
    def count(self):
        return self._default_child().count

    def bucket_counts(self):
        return self._default_child().bucket_counts()

    # exposition ------------------------------------------------------------

    def render(self, lines: list[str]) -> None:
        lines.append(f"# HELP {self.name} {_escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            children = sorted(self._children.items())
        for labelvalues, child in children:
            child._render(lines, self.name, _label_string(self.labelnames, labelvalues))


class MetricsRegistry:
    """Thread-safe collection of metric families with text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, MetricFamily] = {}

    def _family(self, name: str, kind: str, help: str, labelnames, **kwargs) -> MetricFamily:
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._families.get(name)
            if existing is not None:
                if (
                    existing.kind != kind
                    or existing.labelnames != labelnames
                    or existing._child_kwargs != kwargs
                ):
                    raise MetricError(
                        f"metric {name} already registered as {existing.kind}"
                        f"{existing.labelnames} {existing._child_kwargs}, "
                        f"requested {kind}{labelnames} {kwargs}"
                    )
                return existing
            family = MetricFamily(name, kind, help, labelnames, **kwargs)
            self._families[name] = family
            return family

    def counter(self, name: str, help: str = "", labelnames: Iterable[str] = ()) -> MetricFamily:
        return self._family(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Iterable[str] = ()) -> MetricFamily:
        return self._family(name, "gauge", help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Iterable[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> MetricFamily:
        return self._family(name, "histogram", help, labelnames, buckets=buckets)

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def sample_value(self, name: str, labels: Optional[dict] = None):
        """Current value of one counter/gauge child, or ``None`` if absent
        (test/report convenience; histograms expose ``sum``/``count`` on the
        child instead)."""
        family = self.get(name)
        if family is None:
            return None
        key = tuple(str((labels or {}).get(n, "")) for n in family.labelnames)
        child = family._children.get(key)
        return None if child is None else child.value

    def render(self) -> str:
        """The full registry in Prometheus text exposition format."""
        with self._lock:
            families = sorted(self._families.values(), key=lambda f: f.name)
        lines: list[str] = []
        for family in families:
            family.render(lines)
        return "\n".join(lines) + "\n" if lines else ""


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem records into by default."""
    return _default_registry
