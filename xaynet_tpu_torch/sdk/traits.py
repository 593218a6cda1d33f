"""Participant-side interfaces.

Reference surface: rust/xaynet-sdk/src/traits.rs:15-73 — the coordinator
client (five endpoints), the model store (hands the locally trained model to
the FSM) and the notifier (progress callbacks into the embedding
application).

Copy of ``xaynet_tpu/sdk/traits.py``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

import numpy as np

from ..core.common import RoundParameters, UpdateSeedDict


class XaynetClient(ABC):
    """Transport to the coordinator (HTTP in production, in-process in tests)."""

    @abstractmethod
    async def get_round_params(self) -> RoundParameters: ...

    @abstractmethod
    async def get_sums(self) -> Optional[dict]:
        """The sum dictionary, or None while unavailable."""

    @abstractmethod
    async def get_seeds(self, pk: bytes) -> Optional[UpdateSeedDict]:
        """This sum participant's seed slice, or None while unavailable."""

    @abstractmethod
    async def get_model(self) -> Optional[np.ndarray]:
        """The latest global model, or None while unavailable."""

    @abstractmethod
    async def send_message(self, encrypted: bytes) -> None: ...


class ModelStore(ABC):
    """Hands the locally trained model to the FSM when it is needed."""

    @abstractmethod
    async def load_model(self) -> Optional[np.ndarray]:
        """The trained model as a float array, or None when not ready yet."""


class Notify:
    """Progress callbacks; override what the application cares about."""

    def new_round(self) -> None: ...

    def sum(self) -> None: ...

    def update(self) -> None: ...

    def idle(self) -> None: ...

    def load_model(self) -> None:
        """The FSM needs a trained model (the store returned None)."""

    def new_model(self, model) -> None:
        """A new global model was fetched."""
