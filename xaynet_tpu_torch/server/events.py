"""Watch-channel event bus between the state machine and the services.

Functional port of the reference's event system (reference:
rust/xaynet-server/src/state_machine/events.rs:17-247): the state machine is
the single writer; services read the *latest* value of each channel
(round-id-stamped) without consuming it, and can await changes. Built on
asyncio's single-loop execution (no locks needed).
"""

from __future__ import annotations

import asyncio
import copy
from dataclasses import dataclass
from enum import Enum
from typing import Generic, Optional, TypeVar

from ..core.common import RoundParameters

T = TypeVar("T")


class PhaseName(str, Enum):
    IDLE = "idle"
    SUM = "sum"
    UPDATE = "update"
    SUM2 = "sum2"
    UNMASK = "unmask"
    FAILURE = "failure"
    SHUTDOWN = "shutdown"


@dataclass
class Event(Generic[T]):
    """A round-stamped event value."""

    round_id: int
    event: T


class ModelUpdate:
    """Latest global model announcement: invalidated or a new model."""

    __slots__ = ("model",)

    def __init__(self, model=None):
        self.model = model  # None == Invalidate

    @classmethod
    def invalidate(cls) -> "ModelUpdate":
        return cls(None)

    @classmethod
    def new(cls, model) -> "ModelUpdate":
        return cls(model)


class DictionaryUpdate:
    """Latest dictionary announcement: invalidated or a new dictionary."""

    __slots__ = ("dict",)

    def __init__(self, value=None):
        self.dict = value

    @classmethod
    def invalidate(cls) -> "DictionaryUpdate":
        return cls(None)

    @classmethod
    def new(cls, value) -> "DictionaryUpdate":
        return cls(value)


class _Watch(Generic[T]):
    """Single-writer watch cell: latest value + change notification."""

    def __init__(self, initial: Event):
        self._latest: Event = initial
        self._changed = asyncio.Event()

    def publish(self, event: Event) -> None:
        self._latest = event
        self._changed.set()
        self._changed = asyncio.Event()

    def get_latest(self) -> Event:
        return self._latest

    async def changed(self) -> Event:
        await self._changed.wait()
        return self._latest


class EventPublisher:
    """The state machine's writing end of the event bus."""

    def __init__(
        self,
        round_id: int,
        keys,
        params: RoundParameters,
        phase: PhaseName,
        model: Optional[ModelUpdate] = None,
    ):
        self._round_id = round_id
        self.keys = _Watch(Event(round_id, keys))
        # round_params is mutated in place by the Idle phase; events must
        # carry snapshots so subscribers can detect changes
        self.params = _Watch(Event(round_id, copy.copy(params)))
        self.phase = _Watch(Event(round_id, phase))
        self.model = _Watch(Event(round_id, model or ModelUpdate.invalidate()))
        self.sum_dict = _Watch(Event(round_id, DictionaryUpdate.invalidate()))
        self.seed_dict = _Watch(Event(round_id, DictionaryUpdate.invalidate()))

    def set_round_id(self, round_id: int) -> None:
        self._round_id = round_id

    @property
    def round_id(self) -> int:
        return self._round_id

    def broadcast_keys(self, keys) -> None:
        self.keys.publish(Event(self._round_id, keys))

    def broadcast_params(self, params: RoundParameters) -> None:
        self.params.publish(Event(self._round_id, copy.copy(params)))

    def broadcast_phase(self, phase: PhaseName) -> None:
        self.phase.publish(Event(self._round_id, phase))

    def broadcast_model(self, update: ModelUpdate) -> None:
        self.model.publish(Event(self._round_id, update))

    def broadcast_sum_dict(self, update: DictionaryUpdate) -> None:
        self.sum_dict.publish(Event(self._round_id, update))

    def broadcast_seed_dict(self, update: DictionaryUpdate) -> None:
        self.seed_dict.publish(Event(self._round_id, update))

    def subscribe(self) -> "EventSubscriber":
        return EventSubscriber(self)


class EventSubscriber:
    """Read-only view of the event bus (cloneable/shareable)."""

    def __init__(self, publisher: EventPublisher):
        self._pub = publisher

    @property
    def keys(self) -> _Watch:
        return self._pub.keys

    @property
    def params(self) -> _Watch:
        return self._pub.params

    @property
    def phase(self) -> _Watch:
        return self._pub.phase

    @property
    def model(self) -> _Watch:
        return self._pub.model

    @property
    def sum_dict(self) -> _Watch:
        return self._pub.sum_dict

    @property
    def seed_dict(self) -> _Watch:
        return self._pub.seed_dict
