"""High-level participant API: the user-facing training integration.

Functional port of the reference's Python binding surface (reference:
bindings/python/xaynet_sdk/__init__.py, participant.py:20-243,
async_participant.py:15-140):

- ``ParticipantABC``: subclass and implement ``train_round`` (plus optional
  (de)serialization hooks); ``spawn_participant`` runs the PET protocol on a
  background thread and calls back into your trainer;
- ``AsyncParticipant``: no subclassing — a handle to set the next model at
  any time and fetch the latest global model.

Copy of ``xaynet_tpu/sdk/api.py``; ``device`` reaches the ``Participant``
(None: CUDA). ``train_round`` stays a numpy hook.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from abc import ABC, abstractmethod
from fractions import Fraction
from typing import Optional

import numpy as np

from .participant import Participant, coerce_model_array

logger = logging.getLogger("xaynet.sdk")


class ParticipantABC(ABC):
    """Implement your local training against this interface."""

    @abstractmethod
    def train_round(self, training_input: Optional[np.ndarray]) -> np.ndarray:
        """One round of local training; input is the current global model
        (None in the first round)."""

    def serialize_training_result(self, result) -> np.ndarray:
        return np.asarray(result, dtype=np.float32)

    def deserialize_training_input(self, global_model: np.ndarray):
        return global_model

    def on_new_global_model(self, model) -> None:
        """Called whenever a new global model is available."""

    def participate_in_update_task(self) -> bool:
        return True

    def on_stop(self) -> None:
        """Called when the participant thread exits."""


class InternalParticipant(threading.Thread):
    """Drives the tick loop and the user's trainer on a background thread."""

    def __init__(
        self,
        coordinator_url: str,
        participant: ParticipantABC,
        state: Optional[bytes],
        scalar: Fraction,
        tick_interval: float = 0.1,
        keys=None,
        device=None,
    ):
        super().__init__(daemon=True)
        self._participant = participant
        self._inner = Participant(
            coordinator_url, scalar=scalar, state=state, keys=keys, device=device
        )
        self._exit = threading.Event()
        self._tick_interval = tick_interval
        self._global_model: Optional[np.ndarray] = None

    def run(self) -> None:
        try:
            while not self._exit.is_set():
                self._inner.tick()
                if self._inner.new_global_model():
                    # new round: the previous round's local model is stale
                    self._inner.clear_model()
                    model = self._inner.global_model()
                    if model is not None and (
                        self._global_model is None
                        or not np.array_equal(model, self._global_model)
                    ):
                        self._global_model = model
                        self._participant.on_new_global_model(
                            self._participant.deserialize_training_input(model)
                        )
                if self._inner.should_set_model() and self._participant.participate_in_update_task():
                    training_input = (
                        self._participant.deserialize_training_input(self._global_model)
                        if self._global_model is not None
                        else None
                    )
                    result = self._participant.train_round(training_input)
                    self._inner.set_model(self._participant.serialize_training_result(result))
                if not self._inner.made_progress():
                    time.sleep(self._tick_interval)
        finally:
            self._participant.on_stop()

    def stop(self) -> Optional[bytes]:
        """Stops the thread and returns the serialized participant state."""
        self._exit.set()
        self.join(timeout=10)
        return self._inner.save()


def spawn_participant(
    coordinator_url: str,
    participant_class: type[ParticipantABC],
    args: tuple = (),
    kwargs: Optional[dict] = None,
    state: Optional[bytes] = None,
    scalar: Fraction = Fraction(1),
    keys=None,
    device=None,
) -> InternalParticipant:
    """Spawns and starts a participant driving ``participant_class``.

    ``keys`` pins the signing keypair (simulations need deterministic
    roles); omitted in production, where keys are generated per participant.
    ``device`` is the torch device of its masking (None: CUDA).
    """
    participant = participant_class(*args, **(kwargs or {}))
    thread = InternalParticipant(
        coordinator_url, participant, state, scalar, keys=keys, device=device
    )
    thread.start()
    return thread


class AsyncParticipant(threading.Thread):
    """Set a model whenever you like; the FSM picks the latest one up."""

    def __init__(
        self,
        coordinator_url: str,
        state: Optional[bytes],
        scalar: Fraction,
        tick_interval: float = 0.1,
        device=None,
    ):
        super().__init__(daemon=True)
        self._inner = Participant(
            coordinator_url, scalar=scalar, state=state, device=device
        )
        self._exit = threading.Event()
        self._tick_interval = tick_interval
        self._model_queue: "queue.Queue[np.ndarray]" = queue.Queue()
        self._global_model: Optional[np.ndarray] = None
        self._new_global = threading.Event()

    def run(self) -> None:
        while not self._exit.is_set():
            try:
                while True:
                    self._inner.set_model(self._model_queue.get_nowait())
            except queue.Empty:
                pass
            self._inner.tick()
            if self._inner.new_global_model():
                model = self._inner.global_model()
                if model is not None and (
                    self._global_model is None
                    or not np.array_equal(model, self._global_model)
                ):
                    self._global_model = model
                    self._new_global.set()
            if not self._inner.made_progress():
                time.sleep(self._tick_interval)

    def set_model(self, model) -> None:
        self._model_queue.put(coerce_model_array(model))

    def get_global_model(self, timeout: Optional[float] = None) -> Optional[np.ndarray]:
        self._new_global.wait(timeout)
        self._new_global.clear()
        return self._global_model

    def stop(self) -> Optional[bytes]:
        self._exit.set()
        self.join(timeout=10)
        return self._inner.save()


def spawn_async_participant(
    coordinator_url: str,
    state: Optional[bytes] = None,
    scalar: Fraction = Fraction(1),
    device=None,
) -> AsyncParticipant:
    thread = AsyncParticipant(coordinator_url, state, scalar, device=device)
    thread.start()
    return thread
