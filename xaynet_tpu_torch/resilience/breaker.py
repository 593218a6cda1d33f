"""Circuit breaker for storage backends.

A backend that fails every call should not absorb a full retry schedule
per request — that turns one outage into a pile-up of blocked phases and
hammered reconnects. The breaker counts consecutive failures; at the
threshold it OPENS and fail-fasts every call for ``reset_timeout_s``, then
lets a bounded number of HALF-OPEN probes through. A probe success closes
the circuit, a probe failure re-opens it.

State is exported on ``xaynet_resilience_breaker_state`` (0 = closed,
1 = half-open, 2 = open) so an open breaker is visible on ``/metrics``
before anyone reads the logs.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable

from ..telemetry.registry import get_registry

logger = logging.getLogger("xaynet.resilience")

_registry = get_registry()
BREAKER_STATE = _registry.gauge(
    "xaynet_resilience_breaker_state",
    "Circuit breaker state per component (0 = closed, 1 = half-open, 2 = open).",
    ("component",),
)
BREAKER_TRANSITIONS = _registry.counter(
    "xaynet_resilience_breaker_transitions_total",
    "Breaker state transitions, by component and target state.",
    ("component", "to"),
)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"
_STATE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class BreakerOpen(RuntimeError):
    """Fail-fast: the breaker is open and the call was not attempted.

    Deliberately NOT transient for the in-place retry policy — the point
    of the breaker is to stop hammering a dead backend; recovery goes
    through the half-open probe (``is_ready`` checks bypass the gate).
    """

    transient = False

    def __init__(self, component: str, retry_in: float):
        super().__init__(
            f"{component}: circuit open, retry in {max(retry_in, 0.0):.1f}s"
        )
        self.component = component


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing.

    Thread-safe: storage calls come from the asyncio loop, but chaos tests
    and the streaming worker may record from other threads. ``clock`` is
    injectable so lifecycle tests don't sleep.
    """

    def __init__(
        self,
        component: str = "store",
        failure_threshold: int = 5,
        reset_timeout_s: float = 10.0,
        half_open_max: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if reset_timeout_s <= 0:
            raise ValueError("reset_timeout_s must be > 0")
        if half_open_max < 1:
            raise ValueError("half_open_max must be >= 1")
        self.component = component
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.half_open_max = half_open_max
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._half_open_inflight = 0
        BREAKER_STATE.labels(component=component).set(0)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _set_state_locked(self, state: str) -> None:
        if state == self._state:
            return
        self._state = state
        BREAKER_STATE.labels(component=self.component).set(_STATE_VALUE[state])
        BREAKER_TRANSITIONS.labels(component=self.component, to=state).inc()
        logger.warning("breaker %s -> %s", self.component, state)
        if state == OPEN:
            # forensic bundle: which calls burned the failure budget is in
            # the span ring / metric deltas (rate-limited + fail-soft, so
            # the write never extends the outage it documents)
            from ..telemetry.recorder import flight_dump

            flight_dump(
                "breaker-open",
                f"component {self.component} opened after "
                f"{self._failures} consecutive failures",
                component=self.component,
            )

    def _maybe_half_open_locked(self) -> None:
        if self._state == OPEN and self._clock() - self._opened_at >= self.reset_timeout_s:
            self._set_state_locked(HALF_OPEN)
            self._half_open_inflight = 0

    def guard(self, probe: bool = False) -> bool:
        """Raise :class:`BreakerOpen` unless a call may proceed.

        ``probe=True`` (readiness checks) always passes — it IS the
        recovery path, and its outcome still feeds :meth:`record`.
        Returns True when a half-open slot was consumed: the caller must
        hand that back via ``record(..., held_slot=True)`` (or
        ``release(True)`` on cancellation) — only the call that took a
        slot may free one, otherwise probes and pre-transition stragglers
        would let extra traffic hit a recovering backend.
        """
        with self._lock:
            self._maybe_half_open_locked()
            if probe or self._state == CLOSED:
                return False
            if self._state == HALF_OPEN:
                if self._half_open_inflight < self.half_open_max:
                    self._half_open_inflight += 1
                    return True
                raise BreakerOpen(self.component, self.reset_timeout_s)
            raise BreakerOpen(
                self.component,
                self.reset_timeout_s - (self._clock() - self._opened_at),
            )

    def release(self, held_slot: bool = True) -> None:
        """Release a guard-acquired half-open slot with NO verdict (the
        call was cancelled, not answered) — half-open must not leak slots."""
        with self._lock:
            if held_slot and self._half_open_inflight > 0:
                self._half_open_inflight -= 1

    def record(self, success: bool, held_slot: bool = False) -> None:
        with self._lock:
            if held_slot and self._half_open_inflight > 0:
                self._half_open_inflight -= 1
            if success:
                self._failures = 0
                self._set_state_locked(CLOSED)
                return
            self._failures += 1
            if self._state == HALF_OPEN or self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._set_state_locked(OPEN)
