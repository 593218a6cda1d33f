"""Replay schedules: who sends when, who never does, who is late.

Port of ``xaynet_tpu/loadgen/schedule.py`` (the same code, on the port's
``sdk.simulation.plan_churn``).

A soak is only as honest as its arrival process. The schedule turns a
forged population into a deterministic EVENT LIST — ``(send_offset_s,
participant_index)`` — with three chaos knobs layered on the same
``plan_churn`` assignment the in-process flood uses (``sdk.simulation``),
so a loadgen run and its byte-identity control agree on the exact
survivor set:

- **ramp**: arrivals spread uniformly over ``ramp_s`` (with deterministic
  per-participant jitter) instead of a thundering herd at t=0;
- **dropout**: that fraction of participants trained and vanished — their
  uploads never happen (the coordinator's quorum logic is what's under
  test);
- **straggle**: that many of the survivors send ``straggle_delay_s`` after
  their slot — late-but-valid arrivals that must still be accepted while
  the update window is open.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..sdk.simulation import plan_churn


@dataclass(frozen=True)
class ChurnSpec:
    """Chaos knobs for one replay; all deterministic per ``seed``."""

    dropout_rate: float = 0.0
    stragglers: int = 0
    straggle_delay_s: float = 0.0
    seed: int = 1


class ReplaySchedule:
    """Deterministic arrival plan for ``n`` forged participants."""

    def __init__(self, n: int, churn: ChurnSpec = ChurnSpec(), ramp_s: float = 0.0):
        if n < 1:
            raise ValueError("need at least one participant")
        if ramp_s < 0:
            raise ValueError("ramp must be >= 0")
        self.n = n
        self.churn = churn
        self.ramp_s = ramp_s
        self.dropped, self.straggled = plan_churn(
            n, churn.dropout_rate, churn.stragglers, churn.seed
        )
        rng = np.random.default_rng(churn.seed)
        # uniform arrival offsets over the ramp window; drawn for ALL n so
        # the offsets of surviving participants do not depend on who
        # dropped (control runs with dropout 0 replay the same timeline)
        offsets = rng.uniform(0.0, ramp_s, n) if ramp_s > 0 else np.zeros(n)
        self._events = sorted(
            (
                float(offsets[i])
                + (churn.straggle_delay_s if i in self.straggled else 0.0),
                i,
            )
            for i in range(n)
            if i not in self.dropped
        )

    def events(self) -> list[tuple[float, int]]:
        """``(send_offset_s, index)`` ascending — the replay's event feed."""
        return list(self._events)

    @property
    def senders(self) -> int:
        return len(self._events)
