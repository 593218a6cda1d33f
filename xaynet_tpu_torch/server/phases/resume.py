"""Journal resume dispatch: one validated entry -> the phase it re-enters.

Shared by the boot restore (``state_machine.StateMachineInitializer``) and
the in-process Failure recovery (docs/DESIGN.md §9). The entry's phase tag
decides the re-entry point:

- ``sum``     — a fresh :class:`SumPhase` with a store-offset window;
- ``update``  — :class:`UpdatePhase` with the aggregate restored;
- ``sum2``    — a fresh :class:`StagedAggregator` restored from the entry
  (shard-exact for packed device planes), then :class:`Sum2Phase` with the
  journaled votes re-seeded;
- ``unmask``  — the restored aggregator finalized straight into
  :class:`Unmask` (the publish window: the model is recomputed and
  republished idempotently; the journal retires after the publish).
"""

from __future__ import annotations

from ...resilience.checkpoint import RoundCheckpoint
from .base import PhaseState, Shared


def resume_phase(shared: Shared, ckpt: RoundCheckpoint) -> PhaseState:
    """Build the phase a VALIDATED journal entry re-enters. Raises on an
    unknown tag — callers run ``checkpoint.validate`` first, which rejects
    anything outside ``RESUMABLE_PHASES``."""
    from ..aggregation import build_staged_aggregator
    from .sum import SumPhase
    from .sum2 import Sum2Phase
    from .unmask import Unmask
    from .update import UpdatePhase

    if ckpt.phase == "sum":
        return SumPhase(shared, resume_from=ckpt)
    if ckpt.phase == "update":
        return UpdatePhase(shared, resume_from=ckpt)
    if ckpt.phase == "sum2":
        agg = build_staged_aggregator(shared)
        agg.restore_journal(ckpt)
        return Sum2Phase(shared, agg, resume_from=ckpt)
    if ckpt.phase == "unmask":
        agg = build_staged_aggregator(shared)
        agg.restore_journal(ckpt)
        return Unmask(shared, agg.finalize_inplace())
    raise ValueError(f"unresumable journal phase {ckpt.phase!r}")
