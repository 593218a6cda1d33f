"""Adaptive count/time windows: the round liveness controller.

A mis-sized deployment — ``count.min`` above the participant load a
population actually offers — fails every round forever: the window times
out, the Failure phase restarts the round, and the same too-high threshold
times out again. The :class:`RoundController` closes that loop. It observes
every phase's request-window outcome (accepted arrivals, full / degraded /
timeout, seconds in phase) and, across rounds, re-sizes the NEXT round's
``count.min`` and ``time.max`` within hard bounds:

- **shrink** after ``liveness.shrink_after`` consecutive non-full rounds
  (degraded or failed): ``count.min`` drops toward what the deployment
  demonstrably offers — ``min(count.min * shrink_factor, max observed
  arrivals)`` — never below the protocol floor (or the configured quorum),
  and ``time.max`` is relaxed by ``time_relax_factor`` up to
  ``time_max_ceil_s`` so stragglers get a longer window;
- **regrow** after ``liveness.grow_after`` consecutive full rounds:
  ``count.min`` climbs back by ``grow_factor``, never past the originally
  configured ``count.min`` (the operator's intent is the ceiling). When
  the observed arrivals exceed the current ``min`` (possible while
  ``time.min`` keeps the window open toward ``count.max``) they cap the
  step too; an observation EQUAL to ``min`` is censored — the window
  closes the moment ``min`` is reached, so it says nothing about headroom
  — and the controller probes upward anyway, relying on the shrink streak
  to take back an overshoot (AIMD-style). ``time.max`` decays back toward
  its configured value, floored by the window durations recently observed.

The two streak counters are the hysteresis: one lucky full round resets
the shrink streak (and vice versa), so the windows converge instead of
oscillating on noisy arrivals. Every adjustment is logged, counted on
``xaynet_liveness_adjustments_total{phase,direction}`` and visible on the
``xaynet_count_min{phase}`` gauge.

The controller mutates the live ``Settings.pet`` sections in place — the
phases re-read them at every window, and Idle persists coordinator state
(not settings), so adjustments are process-local and reset on restart.
"""

from __future__ import annotations

import logging
import math
from collections import deque

from ..core.message import SUM_COUNT_MIN, UPDATE_COUNT_MIN
from ..telemetry.registry import get_registry
from .settings import Settings

logger = logging.getLogger("xaynet.coordinator")

_registry = get_registry()
ADJUSTMENTS = _registry.counter(
    "xaynet_liveness_adjustments_total",
    "Round-controller count-window adjustments, by phase and direction.",
    ("phase", "direction"),
)
COUNT_MIN = _registry.gauge(
    "xaynet_count_min",
    "Effective per-phase count.min after controller adjustments.",
    ("phase",),
)
ROUND_OUTCOMES = _registry.counter(
    "xaynet_round_outcome_total",
    "Rounds finished, by outcome (full | degraded | failed).",
    ("outcome",),
)

_FLOORS = {"sum": SUM_COUNT_MIN, "update": UPDATE_COUNT_MIN, "sum2": SUM_COUNT_MIN}


class RoundController:
    """Hysteresis-driven re-sizing of the per-phase request windows."""

    def __init__(self, settings: Settings):
        self.settings = settings
        self.liveness = settings.liveness
        self._sections = {
            "sum": settings.pet.sum,
            "update": settings.pet.update,
            "sum2": settings.pet.sum2,
        }
        # the operator's configuration is the hard ceiling the controller
        # may never exceed (and the target regrowth converges back to)
        self._ceil_min = {n: s.count.min for n, s in self._sections.items()}
        self._orig_time_max = {n: s.time.max for n, s in self._sections.items()}
        self._floor = {
            n: max(_FLOORS[n], s.count.quorum or 0) for n, s in self._sections.items()
        }
        window = self.liveness.window
        self._arrivals: dict[str, deque] = {n: deque(maxlen=window) for n in self._sections}
        self._latency: dict[str, deque] = {n: deque(maxlen=window) for n in self._sections}
        self._full_streak = 0
        self._nonfull_streak = 0
        self._round_degraded = False
        for name, section in self._sections.items():
            COUNT_MIN.labels(phase=name).set(section.count.min)

    # --- observations (called by the phases) -------------------------------

    def observe_phase(self, phase: str, accepted: int, outcome: str, seconds: float) -> None:
        """One request window closed: record arrivals + latency and whether
        the round is still on a full-completion track."""
        if phase not in self._sections:
            return
        self._arrivals[phase].append(int(accepted))
        if outcome != "timeout" and seconds < self._sections[phase].time.max:
            # a window that burned its whole (possibly relaxed) time.max —
            # a timeout, or a degraded close that only fired because
            # time.max expired at quorum — measures the CEILING, not the
            # demand; recording it would floor the decay at the inflated
            # ceiling forever. Only windows that closed early tell us how
            # long rounds genuinely need.
            self._latency[phase].append(float(seconds))
        if outcome != "full":
            self._round_degraded = True

    def round_completed(self) -> None:
        """The round reached Unmask successfully (Idle is next)."""
        outcome = "degraded" if self._round_degraded else "full"
        ROUND_OUTCOMES.labels(outcome=outcome).inc()
        if self._round_degraded:
            self._nonfull()
        else:
            self._full_streak += 1
            self._nonfull_streak = 0
            if self._full_streak >= self.liveness.grow_after:
                self._full_streak = 0
                self._grow()
        self._round_degraded = False

    def round_failed(self) -> None:
        """The round died in Failure (timeout or infrastructure error)."""
        ROUND_OUTCOMES.labels(outcome="failed").inc()
        self._nonfull()
        self._round_degraded = False

    def _nonfull(self) -> None:
        self._nonfull_streak += 1
        self._full_streak = 0
        if self._nonfull_streak >= self.liveness.shrink_after:
            self._nonfull_streak = 0
            self._shrink()

    # --- adjustments --------------------------------------------------------

    def _shrink(self) -> None:
        for name, section in self._sections.items():
            count = section.count
            if not self._arrivals[name]:
                continue  # never observed (an earlier phase starved first)
            # judge by the FAILING streak only: readings from the healthy
            # era before the load dropped would mask the starved phase for
            # up to `window` thrown-away rounds
            recent = list(self._arrivals[name])[-self.liveness.shrink_after:]
            observed = max(recent)
            if observed >= count.min:
                continue  # this phase meets its window; it isn't the problem
            target = min(
                math.floor(count.min * self.liveness.shrink_factor), observed
            )
            new_min = max(self._floor[name], target)
            if new_min >= count.min:
                # factor/observed didn't move it: step down by one so a
                # repeatedly-failing deployment still converges to the floor
                new_min = max(self._floor[name], count.min - 1)
            new_time = min(
                self.liveness.time_max_ceil_s,
                section.time.max * self.liveness.time_relax_factor,
            )
            if new_min == count.min and new_time == section.time.max:
                continue
            logger.warning(
                "liveness: shrinking %s window — count.min %d -> %d "
                "(observed arrivals %d, floor %d), time.max %.1fs -> %.1fs",
                name, count.min, new_min, observed, self._floor[name],
                section.time.max, new_time,
            )
            self._apply(name, new_min, new_time, "shrink")

    def _grow(self) -> None:
        for name, section in self._sections.items():
            count = section.count
            if not self._arrivals[name]:
                continue
            observed = max(self._arrivals[name])
            target = min(
                self._ceil_min[name],
                max(count.min + 1, math.ceil(count.min * self.liveness.grow_factor)),
            )
            if observed > count.min:
                # the window saw MORE than it demanded (time.min > 0 lets
                # accepted run past min toward max): a true load reading —
                # no point regrowing past it
                target = min(target, observed)
            # else the reading is CENSORED at count.min (the window closes
            # the moment min is reached), so it says nothing about headroom:
            # probe upward anyway — an overshoot degrades a few rounds and
            # the shrink streak takes it right back (AIMD-style)
            new_min = max(count.min, target)
            new_time = max(
                self._orig_time_max[name],
                section.time.max / self.liveness.time_relax_factor,
                # never decay below what recent windows demonstrably took —
                # cutting under the observed duration would re-induce the
                # very timeouts the relax was for
                max(self._latency[name], default=0.0),
            )
            if new_min == count.min and new_time == section.time.max:
                continue
            logger.info(
                "liveness: regrowing %s window — count.min %d -> %d "
                "(observed arrivals %d, ceiling %d), time.max %.1fs -> %.1fs",
                name, count.min, new_min, observed, self._ceil_min[name],
                section.time.max, new_time,
            )
            self._apply(name, new_min, new_time, "grow")

    def _apply(self, name: str, new_min: int, new_time: float, direction: str) -> None:
        section = self._sections[name]
        section.count.min = new_min
        # count.quorum <= min is re-established by CountSettings.
        # effective_quorum when the phase window reads it; time.min <=
        # time.max stays true because time.max only moves within
        # [configured, ceil] and configured was already valid
        section.time.max = new_time
        ADJUSTMENTS.labels(phase=name, direction=direction).inc()
        COUNT_MIN.labels(phase=name).set(new_min)
