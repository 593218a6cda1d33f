"""Distributed round tracing: spans across coordinator, ingest, shard
workers, edge tier and SDK (docs/DESIGN.md §16).

The registry's telemetry is aggregate-only — counters and gauges with no causal
story. This module adds the causal layer: **spans** (name, trace id, span
id, optional parent, monotonic wall) recorded around every stage of a
round, so "where did batch 37 spend its time" is one artifact instead of a
print-debugging session. Stdlib only, same discipline as the registry.

Identity model
--------------

- The **round trace id** is derived deterministically from the round seed
  (``round_trace_id``): the coordinator, every edge, and every SDK
  participant compute the SAME id independently, so one two-tier round
  yields ONE stitched trace without a coordination protocol.
- Cross-process hops (SDK -> REST, edge -> coordinator) additionally carry
  an explicit ``trace_id-span_id`` pair — the ``X-Xaynet-Trace`` header
  and the ``XNEDGE1`` envelope ``trace`` field. The receiver ADOPTS the
  trace id and records the remote span id as a ``link`` attribute (not as
  ``parent``): within one process's export every ``parent`` resolves, so
  the validator can stay strict about orphans.
- Span NAMES are a closed set: every name is registered exactly once via
  :func:`declare_span` (duplicate registration raises), ``Tracer.span``
  refuses undeclared names, and the analysis framework cross-checks the
  declared set against the DESIGN §16 span table (rule ``span``).

Buffers and sampling
--------------------

Spans land in two bounded places:

- the **flight-recorder ring** (``deque(maxlen=ring_size)``) — always on
  while tracing isn't ``off``; this is the "what led up to this" forensic
  buffer the recorder dumps on failure triggers;
- the **per-round buffer** (bounded; overflow counted on
  ``xaynet_trace_spans_dropped_total``) — drained into a Chrome-trace
  (Perfetto-loadable) JSON per round when a ``trace_dir`` is configured.

``XAYNET_TRACE`` picks the mode: ``on`` (default — record + export),
``failure`` (ring only: spans exist for the flight recorder, no per-round
export), ``off`` (spans are no-ops). Failed/degraded rounds are always
covered by the ring regardless of sampling — the ring never samples.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import random
import threading
import time
from collections import deque
from typing import Iterable, Optional

from .registry import get_registry

logger = logging.getLogger("xaynet.telemetry")

TRACE_HEADER = "X-Xaynet-Trace"

_registry = get_registry()
SPANS_TOTAL = _registry.counter(
    "xaynet_trace_spans_total",
    "Spans finished, by subsystem (the prefix before the first dot of the "
    "span name — closed set, see docs/DESIGN.md §16).",
    ("subsystem",),
)
SPANS_DROPPED = _registry.counter(
    "xaynet_trace_spans_dropped_total",
    "Spans dropped because the per-round buffer hit its bound (the "
    "flight-recorder ring still keeps the most recent ones).",
)
TRACE_EXPORTS = _registry.counter(
    "xaynet_trace_exports_total",
    "Per-round Chrome-trace exports, by outcome (written | failed).",
    ("outcome",),
)


class SpanNameError(ValueError):
    """Span name declared twice, or used without a declaration."""


# the process-wide span-name registry: name -> declaring module (for the
# duplicate-declaration diagnostic). The analysis `span` pass mirrors this
# statically and cross-checks it against the DESIGN §16 table.
_SPAN_NAMES: dict[str, str] = {}
_names_lock = threading.Lock()


def declare_span(name: str) -> str:
    """Register one span name exactly once (module import time).

    Returns the name so modules can bind it: ``SPAN_X = declare_span("x.y")``.
    """
    if not name or any(c.isspace() for c in name):
        raise SpanNameError(f"bad span name {name!r}")
    import inspect

    frame = inspect.currentframe()
    module = "?"
    if frame is not None and frame.f_back is not None:
        module = frame.f_back.f_globals.get("__name__", "?")
    with _names_lock:
        owner = _SPAN_NAMES.get(name)
        if owner is not None and owner != module:
            raise SpanNameError(
                f"span name {name!r} already declared by {owner}; "
                "one module owns a span name — import its constant instead"
            )
        _SPAN_NAMES[name] = module
    return name


def declared_span_names() -> dict[str, str]:
    """Snapshot of the declared span names (tests, the analysis pass)."""
    with _names_lock:
        return dict(_SPAN_NAMES)


# the root span every phase span parents to; declared here because the
# tracer itself records it at round end
SPAN_ROUND = declare_span("round")


# span ids are correlation handles, not secrets: a module-level PRNG
# seeded from the OS beats uuid4 by ~25x per id (uuid4 dominated the
# original ~70 us/span cost on the bench box). getrandbits is one C call
# under the GIL, so concurrent recorders never tear it.
_id_rng = random.Random(int.from_bytes(os.urandom(16), "little"))


def new_id() -> str:
    """A fresh 16-hex trace/span id."""
    return f"{_id_rng.getrandbits(64):016x}"


_new_id = new_id


def round_trace_id(round_seed: bytes) -> str:
    """The deterministic per-round trace id every tier derives on its own
    from the public round seed — the stitching key of a distributed round."""
    import hashlib

    return hashlib.sha256(b"xaynet-trace\x00" + round_seed).hexdigest()[:16]


class TraceContext:
    """(trace_id, span_id) — what propagates, ambient or on the wire.

    An empty ``span_id`` pins the TRACE without claiming a parent span
    (e.g. the SDK's round-derived context): children adopt the trace id
    and record no ``parent``, so strict orphan validation holds.
    """

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str = ""):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"TraceContext({self.trace_id}-{self.span_id})"


def format_header(ctx: TraceContext) -> str:
    return f"{ctx.trace_id}-{ctx.span_id}"


def parse_header(value: str | None) -> Optional[TraceContext]:
    """Parse an ``X-Xaynet-Trace`` value; None on anything malformed (an
    attacker-controlled header must never raise out of the REST path)."""
    if not value:
        return None
    trace_id, _, span_id = value.strip().partition("-")
    if not (
        len(trace_id) == 16
        and len(span_id) == 16
        and all(c in "0123456789abcdef" for c in trace_id + span_id)
    ):
        return None
    return TraceContext(trace_id, span_id)


_ctx: contextvars.ContextVar[Optional[TraceContext]] = contextvars.ContextVar(
    "xaynet_trace_ctx", default=None
)


def current_ctx() -> Optional[TraceContext]:
    """The ambient trace context of this task/thread (None outside spans)."""
    return _ctx.get()


class Span:
    """One finished (or in-flight) span. Walls are monotonic."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start", "duration",
        "attrs", "error", "thread",
    )

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], start: float, attrs: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start  # time.monotonic()
        self.duration: float = 0.0
        self.attrs = attrs
        self.error: Optional[str] = None
        self.thread = threading.current_thread().name

    @property
    def subsystem(self) -> str:
        return self.name.split(".", 1)[0]

    def to_json(self, anchor: float = 0.0) -> dict:
        out = {
            "name": self.name,
            "trace": self.trace_id,
            "span": self.span_id,
            "ts": round(self.start - anchor, 6),
            "dur": round(self.duration, 6),
            "thread": self.thread,
        }
        if self.parent_id:
            out["parent"] = self.parent_id
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.error:
            out["error"] = self.error
        return out


class _SpanHandle:
    """Context manager for one span: enter/exit is the ONLY way a span
    opens and closes, so every enter has a matching exit on every
    exception path by construction (the analysis ``span`` pass rejects
    non-``with`` uses)."""

    __slots__ = ("_tracer", "_span", "_token")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span
        self._token = None

    @property
    def ctx(self) -> TraceContext:
        return TraceContext(self._span.trace_id, self._span.span_id)

    def set(self, **attrs) -> None:
        """Attach attributes mid-span (e.g. the outcome)."""
        self._span.attrs.update(attrs)

    def __enter__(self) -> "_SpanHandle":
        self._token = _ctx.set(self.ctx)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _ctx.reset(self._token)
        self._span.duration = time.monotonic() - self._span.start
        if exc is not None:
            self._span.error = f"{type(exc).__name__}: {exc}"
        self._tracer._finish(self._span)


class _NullSpan:
    """The ``off``-mode span: no allocation beyond the singleton, no ctx."""

    __slots__ = ()
    ctx = None

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()

_MODES = ("on", "failure", "off")


class Tracer:
    """Process-wide span recorder: bounded ring + per-round export buffer.

    Thread-safe: producers on the event loop, fold workers, and the SDK's
    private loops all record through one lock-guarded append.
    """

    def __init__(
        self,
        mode: str | None = None,
        ring_size: int = 4096,
        round_cap: int = 8192,
        trace_dir: str | None = None,
    ):
        mode = mode or os.environ.get("XAYNET_TRACE", "on")
        if mode not in _MODES:
            logger.warning("unknown XAYNET_TRACE=%r; tracing on", mode)
            mode = "on"
        self.mode = mode
        self.trace_dir = (
            trace_dir if trace_dir is not None else os.environ.get("XAYNET_TRACE_DIR", "")
        )
        self._lock = threading.Lock()
        self._ring: deque[Span] = deque(maxlen=ring_size)  # guarded-by: _lock
        self._round_cap = round_cap
        self._round_spans: list[Span] = []  # guarded-by: _lock
        self._round_id: Optional[int] = None  # guarded-by: _lock
        self._round_trace: Optional[str] = None  # guarded-by: _lock
        self._round_root: Optional[str] = None  # guarded-by: _lock
        self._round_start: float = 0.0  # guarded-by: _lock
        # monotonic anchor for export timestamps (one per process)
        self.anchor = time.monotonic()
        # round-boundary listeners (the flight recorder snapshots registry
        # counters here); fail-soft by contract
        self._round_hooks: list = []
        # round-flush listeners: called with (round_id, spans) when a round
        # window closes (the timeline fold consumes the span buffer here);
        # fail-soft by contract
        self._flush_hooks: list = []

    # -- configuration -----------------------------------------------------

    def configure(self, mode: str | None = None, trace_dir: str | None = None,
                  ring_size: int | None = None) -> None:
        """Runtime (re)configuration — the runner applies settings here."""
        if mode is not None:
            if mode not in _MODES:
                raise ValueError(f"trace mode must be one of {_MODES}, got {mode!r}")
            self.mode = mode
        if trace_dir is not None:
            self.trace_dir = trace_dir
        if ring_size is not None:
            with self._lock:
                self._ring = deque(self._ring, maxlen=ring_size)

    def add_round_hook(self, hook) -> None:
        if hook not in self._round_hooks:
            self._round_hooks.append(hook)

    def add_flush_hook(self, hook) -> None:
        """Register ``hook(round_id, spans)``, called every time a round
        window flushes (``end_round``) with the round's span buffer —
        parents already resolved, ready for in-process analysis."""
        if hook not in self._flush_hooks:
            self._flush_hooks.append(hook)

    # -- recording ---------------------------------------------------------

    def span(self, name: str, ctx: Optional[TraceContext] = None,
             link: Optional[TraceContext] = None, **attrs):
        """Open one span as a context manager.

        Parentage: explicit ``ctx`` wins (worker threads, whose ambient
        context is empty), else the ambient context, else the current
        round's root; a span with no context at all starts a fresh trace.
        ``link`` is a REMOTE context (header/envelope hop): its trace id is
        adopted but the remote span rides in the ``link`` attribute instead
        of ``parent`` — within one process's export every parent resolves.
        """
        if self.mode == "off":
            return _NULL_SPAN
        if name not in _SPAN_NAMES:
            raise SpanNameError(
                f"span name {name!r} was never declared (declare_span)"
            )
        if link is not None:
            attrs["link"] = link.span_id
            span = Span(name, link.trace_id, _new_id(), None, time.monotonic(), attrs)
            return _SpanHandle(self, span)
        parent = ctx if ctx is not None else _ctx.get()
        if parent is None:
            parent = self.round_ctx()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id or None
        else:
            trace_id, parent_id = _new_id(), None
        span = Span(name, trace_id, _new_id(), parent_id, time.monotonic(), attrs)
        return _SpanHandle(self, span)

    def record_span(self, name: str, start: float, duration: float,
                    ctx: Optional[TraceContext] = None, **attrs) -> None:
        """Record a retroactive span (a wait measured across tasks — e.g.
        the intake queue wait — where enter/exit bracketing is impossible).
        ``start`` is a ``time.monotonic()`` reading."""
        if self.mode == "off":
            return
        if name not in _SPAN_NAMES:
            raise SpanNameError(f"span name {name!r} was never declared (declare_span)")
        parent = ctx if ctx is not None else _ctx.get()
        if parent is None:
            parent = self.round_ctx()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id or None
        else:
            trace_id, parent_id = _new_id(), None
        span = Span(name, trace_id, _new_id(), parent_id, start, attrs)
        span.duration = max(0.0, duration)
        self._finish(span)

    def _finish(self, span: Span) -> None:
        SPANS_TOTAL.labels(subsystem=span.subsystem).inc()
        with self._lock:
            self._ring.append(span)
            # the round buffer only accumulates while a round window is
            # open: a process that never calls begin_round (SDK client
            # side) keeps just the bounded ring instead of permanently
            # retaining cap spans and counting phantom drops
            if self._round_id is None:
                return
            if len(self._round_spans) < self._round_cap:
                self._round_spans.append(span)
            else:
                SPANS_DROPPED.inc()

    # -- round windows -----------------------------------------------------

    def begin_round(self, round_id: int, trace_id: str) -> None:
        """Open a round window (flushing the previous round's export) and
        pin the round's trace id + root span. Idempotent for the SAME
        (round, trace): in-process multi-tier tests run the coordinator
        and the edge tier on one tracer, and the edge's round sync must
        not reset the window the coordinator already opened."""
        with self._lock:
            if self._round_id == round_id and self._round_trace == trace_id:
                return
        self.end_round()
        if self.mode == "off":
            return
        with self._lock:
            self._round_id = round_id
            self._round_trace = trace_id
            self._round_root = _new_id()
            self._round_start = time.monotonic()
            self._round_spans = []
        for hook in self._round_hooks:
            try:
                hook(round_id)
            except Exception:  # a telemetry consumer must never fail a round
                logger.exception("trace round hook failed")

    def round_ctx(self) -> Optional[TraceContext]:
        """The current round's root context (worker threads parent here)."""
        with self._lock:
            if self._round_trace is None:
                return None
            return TraceContext(self._round_trace, self._round_root)

    def end_round(self) -> list[Span]:
        """Close the round window: record the root ``round`` span, export
        the Chrome trace when configured, and return the round's spans."""
        with self._lock:
            if self._round_id is None:
                return []
            root = Span(
                SPAN_ROUND,
                self._round_trace,
                self._round_root,
                None,
                self._round_start,
                {"round_id": self._round_id},
            )
            root.duration = time.monotonic() - self._round_start
            self._ring.append(root)
            # the root always lands (it anchors the export), even when the
            # round buffer hit its cap
            self._round_spans.append(root)
            spans, self._round_spans = self._round_spans, []
            round_id = self._round_id
            self._round_id = None
            self._round_trace = None
            self._round_root = None
        SPANS_TOTAL.labels(subsystem=root.subsystem).inc()
        # export contract: every `parent` resolves WITHIN the bundle. A span
        # that started under the previous window (its parent was exported
        # there) demotes the dangling parent to a `link` attribute — same
        # representation as a cross-process hop
        ids = {s.span_id for s in spans}
        for s in spans:
            if s.parent_id and s.parent_id not in ids:
                s.attrs.setdefault("link", s.parent_id)
                s.parent_id = None
        for hook in self._flush_hooks:
            try:
                hook(round_id, spans)
            except Exception:  # a telemetry consumer must never fail a round
                logger.exception("trace flush hook failed")
        if self.trace_dir and self.mode == "on":
            self._export(round_id, spans)
        return spans

    def ring_spans(self) -> list[Span]:
        """Snapshot of the flight-recorder ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def round_spans_snapshot(self) -> tuple[Optional[int], list[Span]]:
        """The open round window's id and a copy of its buffered spans —
        for in-process consumers that need the buffer BEFORE the window
        flushes (the round report's timeline section fires one phase
        earlier than ``end_round``). ``(None, [])`` outside a window."""
        with self._lock:
            if self._round_id is None:
                return None, []
            return self._round_id, list(self._round_spans)

    # -- export ------------------------------------------------------------

    def _export(self, round_id: int, spans: list[Span]) -> None:
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            # pid discriminator: a coordinator and its edge processes may
            # share one trace_dir (env-inherited in soaks) and both export
            # the SAME round id — without it, last writer wins
            path = os.path.join(
                self.trace_dir, f"round_{round_id}.{os.getpid()}.trace.json"
            )
            with open(path, "w") as f:
                json.dump(to_chrome_trace(spans, anchor=self.anchor), f)
            TRACE_EXPORTS.labels(outcome="written").inc()
            logger.info("[trace] round %d trace written: %s", round_id, path)
        except OSError as err:
            TRACE_EXPORTS.labels(outcome="failed").inc()
            logger.warning("round trace export failed: %s", err)


def to_chrome_trace(spans: Iterable[Span], anchor: float = 0.0) -> dict:
    """Spans -> ``chrome://tracing`` / Perfetto JSON object format.

    One complete (``ph: "X"``) event per span; ``pid`` is the subsystem,
    ``tid`` the recording thread, and the span/trace/parent identities ride
    in ``args`` so the text report and the CI validator can rebuild the
    tree from the export alone.
    """
    from .redact import scrub_attrs

    pids: dict[str, int] = {}
    tids: dict[tuple[int, str], int] = {}
    events: list[dict] = []
    for span in spans:
        pid = pids.setdefault(span.subsystem, len(pids) + 1)
        tid = tids.setdefault((pid, span.thread), len(tids) + 1)
        args = {"trace": span.trace_id, "span": span.span_id}
        if span.parent_id:
            args["parent"] = span.parent_id
        # deny-list scrub before the export hits disk (DESIGN §18): span
        # attrs whose key names secret material leave only a redacted
        # length/digest projection in the Chrome trace
        args.update(scrub_attrs(span.attrs, "trace"))
        if span.error:
            args["error"] = span.error
        events.append(
            {
                "name": span.name,
                "cat": span.subsystem,
                "ph": "X",
                "ts": round((span.start - anchor) * 1e6, 1),
                "dur": round(span.duration * 1e6, 1),
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )
    for subsystem, pid in pids.items():
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": subsystem},
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer every subsystem records into by default."""
    return _tracer
