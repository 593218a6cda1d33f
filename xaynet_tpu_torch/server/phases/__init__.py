"""Coordinator phase implementations (the PET round state machine).

Reference surface: rust/xaynet-server/src/state_machine/phases/.
"""

from .base import PhaseError, PhaseState, Shared
from .failure import Failure
from .idle import Idle
from .shutdown import Shutdown
from .sum import SumPhase
from .sum2 import Sum2Phase
from .unmask import Unmask
from .update import UpdatePhase

__all__ = [
    "PhaseError",
    "PhaseState",
    "Shared",
    "Failure",
    "Idle",
    "Shutdown",
    "SumPhase",
    "Sum2Phase",
    "Unmask",
    "UpdatePhase",
]
