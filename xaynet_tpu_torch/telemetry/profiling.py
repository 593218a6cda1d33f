"""Hot-path profiling hooks.

Timing device work honestly means syncing the device: CUDA launches are
asynchronous, so a wall clock around the call alone measures the launch,
not the kernel. ``timed_kernel`` runs an op, waits for the CUDA device it
ran on (``torch.cuda.synchronize`` on the ``device`` the caller names and on
every CUDA tensor in the result; nothing for host numpy results) and
records device-synced seconds, element counts and derived elements/sec
into the process registry, plus a per-round accumulator the round report
drains.

The sync point serializes dispatch pipelining (e.g. the wire-ingest path
deliberately overlaps the fold with the acceptance-vector fetch), so the
hooks can be disabled wholesale with ``XAYNET_KERNEL_PROFILE=0`` — the ops
then run exactly as before, with zero added synchronization.

Ops recorded by the stack today: ``mask_expand`` (PRNG seed -> mask limbs),
``masked_add`` (the fold), ``wire_unpack``/``wire_ingest`` (device wire
paths), ``unmask`` (modular subtract + decode).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, TypeVar

from .registry import get_registry

T = TypeVar("T")

# sub-millisecond kernels up to minute-scale 25M-element folds
_KERNEL_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_registry = get_registry()
KERNEL_SECONDS = _registry.histogram(
    "xaynet_kernel_seconds",
    "Device-synced wall time of one aggregation kernel invocation.",
    ("op",),
    buckets=_KERNEL_BUCKETS,
)
KERNEL_CALLS = _registry.counter(
    "xaynet_kernel_calls_total", "Aggregation kernel invocations.", ("op",)
)
KERNEL_ELEMENTS = _registry.counter(
    "xaynet_kernel_elements_total", "Group elements processed by kernel.", ("op",)
)
KERNEL_RATE = _registry.gauge(
    "xaynet_kernel_elements_per_second",
    "Throughput of the most recent invocation of each kernel.",
    ("op",),
)
KERNEL_CALIBRATION = _registry.gauge(
    "xaynet_kernel_calibration_seconds",
    "Steady-state fold time per candidate measured by kernel auto-calibration.",
    ("kernel",),
)
KERNEL_FIRST_CALL = _registry.gauge(
    "xaynet_kernel_first_call_seconds",
    "Wall time of each op's first invocation this process — on device "
    "paths this includes the kernel build and load, so subtract it from "
    "histogram aggregates for steady-state analysis.",
    ("op",),
)

_round_lock = threading.Lock()
_round_stats: dict[str, dict[str, float]] = {}
_seen_ops: set[str] = set()


def enabled() -> bool:
    """Hot-path sync profiling toggle (``XAYNET_KERNEL_PROFILE=0`` disables)."""
    return os.environ.get("XAYNET_KERNEL_PROFILE", "1") != "0"


def _cuda_devices(result, out: set) -> set:
    """The CUDA devices of the tensors in ``result`` (nested lists, tuples
    and dict values)."""
    if isinstance(result, (list, tuple)):
        for item in result:
            _cuda_devices(item, out)
    elif isinstance(result, dict):
        for item in result.values():
            _cuda_devices(item, out)
    elif getattr(result, "is_cuda", False):
        out.add(result.device)
    return out


def _block(result: T, device=None) -> T:
    """Wait for the CUDA work behind ``result`` and on ``device``.

    A device error surfacing at the sync point PROPAGATES: the caller sees
    the kernel's failure, not a silently short timing."""
    devices = _cuda_devices(result, set())
    if device is not None and getattr(device, "type", None) == "cuda":
        devices.add(device)
    if devices:
        import torch

        for dev in devices:
            torch.cuda.synchronize(dev)
    return result


def record(op: str, seconds: float, elements: int) -> None:
    """Record one kernel invocation into the registry and the round window."""
    KERNEL_SECONDS.labels(op=op).observe(seconds)
    KERNEL_CALLS.labels(op=op).inc()
    KERNEL_ELEMENTS.labels(op=op).inc(elements)
    if seconds > 0:
        KERNEL_RATE.labels(op=op).set(elements / seconds)
    with _round_lock:
        if op not in _seen_ops:
            _seen_ops.add(op)
            KERNEL_FIRST_CALL.labels(op=op).set(seconds)
        stats = _round_stats.setdefault(
            op, {"calls": 0, "seconds": 0.0, "elements": 0}
        )
        stats["calls"] += 1
        stats["seconds"] += seconds
        stats["elements"] += elements


def timed_kernel(op: str, elements: int, fn: Callable[[], T], device=None) -> T:
    """Run ``fn``, sync its outputs and ``device`` (the torch device the op
    runs on), record the timing; pass-through (no sync, no record) when
    profiling is disabled."""
    if not enabled():
        return fn()
    t0 = time.perf_counter()
    result = _block(fn(), device)
    record(op, time.perf_counter() - t0, elements)
    return result


def measure(fn: Callable[[], T], device=None) -> tuple[T, float]:
    """(result, device-synced seconds) — for callers that need the number
    itself rather than a registry record."""
    t0 = time.perf_counter()
    result = _block(fn(), device)
    return result, time.perf_counter() - t0


def record_calibration(kernel: str, seconds: float) -> None:
    KERNEL_CALIBRATION.labels(kernel=kernel).set(seconds)


def drain_round_stats() -> dict[str, dict[str, float]]:
    """Per-op stats accumulated since the last drain (with derived
    elements/sec); resets the window. Consumed by the round report."""
    with _round_lock:
        stats = dict(_round_stats)
        _round_stats.clear()
    out = {}
    for op, s in stats.items():
        out[op] = dict(s)
        out[op]["elements_per_sec"] = (
            round(s["elements"] / s["seconds"], 3) if s["seconds"] > 0 else 0.0
        )
    return out
