"""Admission control: watermark hysteresis, shedding, and its telemetry.

The port's copy of ``xaynet_tpu/ingest/admission.py``.

The controller is the single authority on whether the coordinator accepts
one more encrypted message. It tracks total intake occupancy against a
high/low watermark pair (fractions of total capacity): crossing the high
watermark flips the pipeline into a *saturated* state where every new
arrival is shed (HTTP 429 + Retry-After upstream); the state clears only
once drain brings occupancy back under the low watermark — hysteresis, so
a loaded coordinator sheds in contiguous windows instead of flapping
per-message.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum

from ..telemetry.registry import get_registry

_ADMITTED = get_registry().counter(
    "xaynet_ingest_admitted_total",
    "Messages admitted into the intake shards.",
)
_SHED = get_registry().counter(
    "xaynet_ingest_shed_total",
    "Messages shed by admission control (intake saturated or shard full).",
)
_REJECTED = get_registry().counter(
    "xaynet_ingest_rejected_total",
    "Messages dropped by the ingest pipeline, by stage (pre-filter = cheap "
    "checks before decryption; decrypt/parse/phase-filter/task-validator = "
    "pipeline stages; state-machine = protocol rejection).",
    ("stage",),
)
_SATURATED = get_registry().gauge(
    "xaynet_ingest_saturated",
    "1 while admission control is shedding (watermark hysteresis), else 0.",
)
BATCH_SIZE_HIST = get_registry().histogram(
    "xaynet_ingest_batch_size",
    "Messages per ingest batch, by stage (decrypt = one thread-pool hop; "
    "coalesce = one state-machine envelope / stacked fold dispatch).",
    ("stage",),
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)


class Verdict(Enum):
    ADMITTED = "admitted"
    SHED = "shed"
    DROPPED = "dropped"  # pre-filter rejection (REST still answers 200)


@dataclass
class Admission:
    """What the REST layer needs to answer one POST /message."""

    verdict: Verdict
    retry_after: float = 0.0

    @property
    def shed(self) -> bool:
        return self.verdict is Verdict.SHED


class AdmissionController:
    """Watermark-based load shedding over a fixed total capacity."""

    def __init__(
        self,
        capacity: int,
        high_watermark: float = 0.8,
        low_watermark: float = 0.5,
        retry_after_seconds: float = 1.0,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if not (0.0 < low_watermark <= high_watermark <= 1.0):
            raise ValueError("watermarks must satisfy 0 < low <= high <= 1")
        self.capacity = capacity
        # ceil: a high watermark of 1.0 must mean "full", never capacity+1
        self.high_mark = min(capacity, math.ceil(high_watermark * capacity))
        self.low_mark = math.floor(low_watermark * capacity)
        self.retry_after_seconds = retry_after_seconds
        self._saturated = False  # guarded-by: event-loop
        _SATURATED.set(0)

    @property
    def saturated(self) -> bool:
        return self._saturated

    def observe(self, occupancy: int) -> None:
        """Update the hysteresis state from current total occupancy (called
        on both enqueue and drain so recovery needs no new arrivals)."""
        if self._saturated:
            if occupancy <= self.low_mark:
                self._saturated = False
                _SATURATED.set(0)
        elif occupancy >= self.high_mark:
            self._saturated = True
            _SATURATED.set(1)

    def admit(self, occupancy: int) -> Admission:
        """Admission verdict for one arrival given current total occupancy.

        ``occupancy >= capacity`` needs no separate check: ``high_mark <=
        capacity``, so ``observe`` has already flipped the saturated state.
        The admitted counter is incremented by the caller once the message
        actually lands in a shard (``count_admitted``), so a full-shard
        fallback shed can never double-count.
        """
        self.observe(occupancy)
        if self._saturated:
            _SHED.inc()
            return Admission(Verdict.SHED, retry_after=self.retry_after(occupancy))
        return Admission(Verdict.ADMITTED)

    def shed_shard_full(self, occupancy: int) -> Admission:
        """A shard's hard bound rejected the put (capacity race)."""
        _SHED.inc()
        return Admission(Verdict.SHED, retry_after=self.retry_after(occupancy))

    @staticmethod
    def count_admitted() -> None:
        """Count one message that actually landed in an intake shard."""
        _ADMITTED.inc()

    def retry_after(self, occupancy: int) -> float:
        """Back-off hint: the configured floor, scaled up with overload depth
        so deeply saturated intakes spread the retry storm out further."""
        overload = max(0.0, occupancy - self.low_mark) / max(1, self.capacity)
        return self.retry_after_seconds * (1.0 + 3.0 * overload)

    @staticmethod
    def dropped(stage: str) -> Admission:
        """Count a pre-admission drop (cheap pre-filter rejection)."""
        _REJECTED.labels(stage=stage).inc()
        return Admission(Verdict.DROPPED)

    @staticmethod
    def count_rejection(stage: str) -> None:
        """Count a post-admission drop (decrypt/parse/state-machine...)."""
        _REJECTED.labels(stage=stage).inc()
