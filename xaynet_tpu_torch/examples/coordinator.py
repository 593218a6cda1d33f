"""The examples' in-process coordinator and round bookkeeping.

Each example runs this package's coordinator (REST on a free port of
127.0.0.1, in-memory stores) on a daemon thread, then pins role-matched
participants per round: task eligibility re-draws every round (fresh
seed), so a simulation spawns participants whose keys hold the wanted role
for the round's seed (``sdk.simulation.keys_for_task``).
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Optional

import numpy as np

from ..server.rest import RestServer
from ..server.services import Fetcher, PetMessageHandler
from ..server.settings import (
    CountSettings,
    PetSettings,
    PhaseSettings,
    Settings,
    Sum2Settings,
    TimeSettings,
)
from ..server.state_machine import StateMachineInitializer
from ..storage.memory import InMemoryCoordinatorStorage, InMemoryModelStorage, NoOpTrustAnchor
from ..storage.traits import Store
from ..sdk.client import HttpClient


def round_settings(sum_prob: float, update_prob: float, n_sum: int, n_update: int,
                   timeout: float, model_length: int) -> Settings:  # fmt: skip
    """Count windows of exactly ``n_sum`` sum, ``n_update`` update and
    ``n_sum`` sum2 messages, each phase open at most ``timeout`` seconds."""

    def window(n: int) -> dict:
        return dict(count=CountSettings(n, n), time=TimeSettings(0, timeout))

    settings = Settings(
        pet=PetSettings(
            sum=PhaseSettings(prob=sum_prob, **window(n_sum)),
            update=PhaseSettings(prob=update_prob, **window(n_update)),
            sum2=Sum2Settings(**window(n_sum)),
        )
    )
    settings.model.length = model_length
    return settings


def start_coordinator(settings: Settings, device) -> str:
    """Starts the coordinator on ``device`` on a daemon thread (it runs
    until the process exits); returns its URL."""
    info, started = {}, threading.Event()

    def run():
        async def main():
            store = Store(InMemoryCoordinatorStorage(), InMemoryModelStorage(), NoOpTrustAnchor())
            machine, tx, events = await StateMachineInitializer(settings, store, device=device).init()
            rest = RestServer(Fetcher(events), PetMessageHandler(events, tx))
            host, port = await rest.start("127.0.0.1", 0)
            info["url"] = f"http://{host}:{port}"
            started.set()
            await machine.run()

        asyncio.run(main())

    threading.Thread(target=run, daemon=True).start()
    if not started.wait(30):
        raise RuntimeError("the coordinator did not start")
    return info["url"]


def sync(coro):
    return asyncio.run(coro)


def next_round_seed(probe: HttpClient, last_seed: Optional[bytes]) -> bytes:
    """The seed of the round after the one seeded ``last_seed`` (None: the
    current round's)."""
    params = sync(probe.get_round_params())
    while last_seed is not None and params.seed.as_bytes() == last_seed:
        time.sleep(0.2)
        params = sync(probe.get_round_params())
    return params.seed.as_bytes()


def wait_for_model(probe: HttpClient, seed: bytes, timeout: float = float("inf")) -> np.ndarray:
    """The global model of the round seeded ``seed``. The next round's
    parameters appear only after that round's unmask published its model,
    so the model is fetched once they do (until then ``GET /model`` serves
    the previous round's)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if sync(probe.get_round_params()).seed.as_bytes() != seed:
            model = sync(probe.get_model())
            if model is not None:
                return model
        time.sleep(0.2)
    raise TimeoutError(f"no global model within {timeout:.0f} s")
