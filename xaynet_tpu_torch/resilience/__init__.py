"""Resilience subsystem: retries, circuit breaking, durable mid-round
checkpoints, and deterministic fault injection.

- ``policy``     — :class:`RetryPolicy` (decorrelated-jitter backoff,
  attempt/deadline caps) and transient/permanent error classification;
- ``breaker``    — :class:`CircuitBreaker` with half-open probing;
- ``store``      — :class:`ResilientStore`, the decorator wrapping every
  ``CoordinatorStorage``/``ModelStorage``/``TrustAnchor`` call;
- ``checkpoint`` — :class:`RoundCheckpoint` (the phase-tagged round
  journal) + the update-phase :class:`CheckpointManager` and resume
  validation;
- ``chaos``      — the ``XAYNET_KILL_POINT`` SIGKILL hook the kill-matrix
  harness drives;
- ``faults``     — seeded :class:`FaultPlan` driving reproducible chaos
  through storage, ingest and the streaming fold pipeline.
"""

from .breaker import BreakerOpen as BreakerOpen, CircuitBreaker as CircuitBreaker
from .chaos import maybe_kill as maybe_kill
from .checkpoint import (
    AggSnapshot as AggSnapshot,
    CheckpointManager as CheckpointManager,
    RoundCheckpoint as RoundCheckpoint,
)
from .faults import (
    FaultPlan as FaultPlan,
    InjectedFault as InjectedFault,
    clear_plan as clear_plan,
    current_plan as current_plan,
    install_plan as install_plan,
)
from .policy import RetryPolicy as RetryPolicy, is_transient as is_transient
from .store import ResilientStore as ResilientStore, wrap_store as wrap_store
