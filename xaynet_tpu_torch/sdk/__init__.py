"""Participant SDK: state machine, clients, embeddable + high-level APIs.

Reference surface: rust/xaynet-sdk/ (FSM, client, encoder),
rust/xaynet-mobile/ (tick-driven Participant), bindings/python/xaynet_sdk
(ParticipantABC / AsyncParticipant / spawn_*).

Copy of ``xaynet_tpu/sdk/`` with the same names, on this package's host
modules; the participant masks its update (K2 + K1) and sums the Sum2
masks (K2) on a torch device, CUDA unless it is given another one.
"""

from .api import (
    AsyncParticipant,
    InternalParticipant,
    ParticipantABC,
    spawn_async_participant,
    spawn_participant,
)
from .client import (
    ClientError,
    ClientPermanentError,
    ClientShedError,
    ClientTransientError,
    HttpClient,
    InProcessClient,
    ResilientClient,
)
from .participant import Participant
from .state_machine import PetSettings, PhaseKind, StateMachine, Task, TransitionOutcome
from .traits import ModelStore, Notify, XaynetClient

__all__ = [
    "AsyncParticipant",
    "InternalParticipant",
    "ParticipantABC",
    "spawn_async_participant",
    "spawn_participant",
    "ClientError",
    "ClientPermanentError",
    "ClientShedError",
    "ClientTransientError",
    "HttpClient",
    "InProcessClient",
    "ResilientClient",
    "Participant",
    "PetSettings",
    "PhaseKind",
    "StateMachine",
    "Task",
    "TransitionOutcome",
    "ModelStore",
    "Notify",
    "XaynetClient",
]
