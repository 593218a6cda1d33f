"""Caller-driven participant: the embeddable tick-based wrapper.

Functional port of the reference's mobile participant (reference:
rust/xaynet-mobile/src/participant.rs:129-353): the embedding application
owns the control flow and calls ``tick()``; between ticks it can inspect
``task()``, ``made_progress()``, ``should_set_model()`` and
``new_global_model()``, provide the trained model via ``set_model()``, and
suspend/resume the whole participant with ``save()`` / ``restore()``.

The reference wraps a tokio current-thread runtime; this wraps a private
asyncio event loop, so ``tick()`` is synchronous for the caller.

Copy of ``xaynet_tpu/sdk/participant.py`` with a ``device``: the torch
device the state machine masks and sums masks on (None: CUDA, and
``DeviceUnavailable`` without one; "cpu" runs the plain versions).
"""

from __future__ import annotations

import asyncio
from fractions import Fraction
from typing import Optional, Union

import numpy as np

from ..core.crypto.sign import SigningKeyPair
from .client import HttpClient, ResilientClient
from .state_machine import PetSettings, StateMachine, Task, TransitionOutcome
from .traits import ModelStore, Notify, XaynetClient


class _Events(Notify):
    def __init__(self):
        self.reset()

    def reset(self):
        self.got_new_round = False
        self.wants_model = False
        self.new_global = False

    def new_round(self):
        self.got_new_round = True

    def load_model(self):
        self.wants_model = True

    def new_model(self, model):
        self.new_global = True


def coerce_model_array(model) -> np.ndarray:
    """Staging dtype for a local model: floats go to f32; integer arrays
    keep their dtype (coercing quantized ints to f32 would corrupt values
    beyond 2^24). The float-vs-int decision against the round's mask config
    happens at mask time (`StateMachine._step_update`), where the config is
    actually known."""
    arr = np.asarray(model)
    if not np.issubdtype(arr.dtype, np.integer):
        arr = np.asarray(arr, dtype=np.float32)
    return arr


class _SettableModelStore(ModelStore):
    def __init__(self):
        self.model: Optional[np.ndarray] = None

    async def load_model(self):
        return self.model


class Participant:
    """Tick-driven PET participant."""

    def __init__(
        self,
        client: Union[str, XaynetClient],
        scalar: Fraction = Fraction(1),
        state: Optional[bytes] = None,
        keys: Optional[SigningKeyPair] = None,
        max_message_size: Optional[int] = 4096,
        # kept for the JAX package's callers; see PetSettings.device_sum2
        device_sum2: Optional[bool] = None,
        # Sum2 route name (see PetSettings.mask_kernel)
        mask_kernel: str = "auto",
        # wrap URL clients in the retrying ResilientClient (one flaky 429 or
        # dropped connection must not turn a participant into a dropout);
        # pass False to talk raw HTTP, or hand in a pre-built client
        retries: bool = True,
        # deterministic Update-task mask seed (oracle/replay only — see
        # PetSettings.mask_seed; None = the reference's random draw)
        mask_seed: Optional[bytes] = None,
        # the torch device of the masking and the Sum2 mask sum (None: CUDA)
        device=None,
    ):
        if isinstance(client, str):
            client = HttpClient(client)
            if retries:
                client = ResilientClient(client)
        self._client = client
        self._loop = asyncio.new_event_loop()
        self._events = _Events()
        self._store = _SettableModelStore()
        if state is not None:
            self._sm = StateMachine.restore(
                state, client, self._store, self._events, device=device
            )
        else:
            settings = PetSettings(
                keys=keys or SigningKeyPair.generate(),
                scalar=scalar,
                max_message_size=max_message_size,
                device_sum2=device_sum2,
                mask_kernel=mask_kernel,
                mask_seed=mask_seed,
                device=device,
            )
            self._sm = StateMachine(settings, client, self._store, self._events)
        self._made_progress = False

    # --- driving ----------------------------------------------------------

    def tick(self) -> None:
        """Runs one state-machine transition."""
        self._events.wants_model = False
        outcome = self._loop.run_until_complete(self._guarded_transition())
        self._made_progress = outcome == TransitionOutcome.COMPLETE

    async def _guarded_transition(self) -> TransitionOutcome:
        try:
            return await self._sm.transition()
        except Exception:
            return TransitionOutcome.PENDING

    # --- inspection -------------------------------------------------------

    def made_progress(self) -> bool:
        return self._made_progress

    def task(self) -> Task:
        return self._sm.task

    def should_set_model(self) -> bool:
        return self._events.wants_model

    def new_global_model(self) -> bool:
        """True once per round start (a fresh global model may be ready)."""
        flag = self._events.got_new_round
        self._events.got_new_round = False
        return flag

    # --- model exchange ---------------------------------------------------

    def set_model(self, model) -> None:
        self._store.model = coerce_model_array(model)

    def clear_model(self) -> None:
        """Forget the staged local model (typically at round start)."""
        self._store.model = None

    def global_model(self) -> Optional[np.ndarray]:
        return self._loop.run_until_complete(self._sm.client.get_model())

    # --- persistence ------------------------------------------------------

    def save(self) -> bytes:
        """Serializes the participant; the instance must not be used after."""
        state = self._sm.save()
        self.close()
        return state

    def close(self) -> None:
        """Releases the private event loop and any pooled transport
        connections (idempotent)."""
        # unwrap retry decorators down to the transport (keep-alive pool)
        client = getattr(self, "_client", None)
        while client is not None:
            if hasattr(client, "close"):
                try:
                    client.close()
                except Exception:
                    pass
                break
            client = getattr(client, "inner", None)
        if not self._loop.is_closed():
            self._loop.close()

    def __del__(self):  # noqa: D105 — deterministic teardown beats GC races
        try:
            self.close()
        except Exception:
            pass

    @classmethod
    def restore(
        cls, state: bytes, client: Union[str, XaynetClient], device=None
    ) -> "Participant":
        return cls(client, state=state, device=device)
