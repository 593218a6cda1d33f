"""LocalFederation: a one-call federated simulation harness.

Runs a coordinator (REST, background thread) and per-round role-pinned
participants driving user trainers — the pattern every simulation needs,
packaged: handle task-eligibility re-draws, round boundaries and
thread lifecycle.

    fed = LocalFederation(model_length=..., n_sum=2, n_update=6)
    trainers = [MyTrainer(shard) for shard in shards]
    for result in fed.rounds(trainers, n_rounds=3):
        print(result.round_id, result.global_model[:4])
    fed.stop()

Mind the mask config's weight bound: the default (B0) clamps weights to
|w| <= 1 — larger weights silently saturate, exactly as the protocol
specifies. Pick B2/B4/B6 (bounds 100 / 1e4 / 1e6) in
``Settings.mask.bound_type`` for bigger weight ranges.

Copy of ``xaynet_tpu/sdk/federation.py`` on this package's coordinator
(``server``, ``storage.memory``): one torch ``device`` (None: CUDA, and
``DeviceUnavailable`` without one) folds the coordinator's round and masks
every participant's update and Sum2 mask.
"""

from __future__ import annotations

import asyncio
import threading
import time
from dataclasses import dataclass
from fractions import Fraction
from typing import Iterator, Optional, Sequence

import numpy as np

from ..server.rest import RestServer
from ..server.services import Fetcher, PetMessageHandler
from ..server.settings import (
    CountSettings,
    PhaseSettings,
    PetSettings,
    Settings,
    Sum2Settings,
    TimeSettings,
)
from ..device import resolve_device
from ..server.state_machine import StateMachineInitializer
from ..storage.memory import (
    InMemoryCoordinatorStorage,
    InMemoryModelStorage,
    NoOpTrustAnchor,
)
from ..storage.traits import Store
from .api import ParticipantABC
from .client import HttpClient
from .participant import Participant
from .simulation import keys_for_task


@dataclass
class RoundResult:
    round_id: int
    global_model: np.ndarray
    wall_seconds: float


class LocalFederation:
    """In-process coordinator + per-round participant management."""

    def __init__(
        self,
        model_length: int,
        n_sum: int = 1,
        n_update: int = 3,
        sum_prob: float = 0.3,
        update_prob: float = 0.6,
        phase_timeout: float = 300.0,
        settings: Optional[Settings] = None,
        # written to [aggregation] device for the JAX package's callers;
        # the round folds on ``device`` whatever it says
        device_aggregation: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.n_sum, self.n_update = n_sum, n_update
        self.sum_prob, self.update_prob = sum_prob, update_prob
        if settings is None:
            settings = Settings(
                pet=PetSettings(
                    sum=PhaseSettings(
                        prob=sum_prob,
                        count=CountSettings(n_sum, n_sum),
                        time=TimeSettings(0, phase_timeout),
                    ),
                    update=PhaseSettings(
                        prob=update_prob,
                        count=CountSettings(n_update, n_update),
                        time=TimeSettings(0, phase_timeout),
                    ),
                    sum2=Sum2Settings(
                        count=CountSettings(n_sum, n_sum),
                        time=TimeSettings(0, phase_timeout),
                    ),
                )
            )
        settings.model.length = model_length
        settings.aggregation.device = device_aggregation
        self.settings = settings
        self._threads: list = []
        self._started = threading.Event()
        self.url: str = ""
        self._runner = threading.Thread(target=self._serve, daemon=True)
        self._runner.start()
        if not self._started.wait(15):
            raise RuntimeError("coordinator failed to start")
        self._probe = HttpClient(self.url)

    def _serve(self) -> None:
        async def main():
            store = Store(InMemoryCoordinatorStorage(), InMemoryModelStorage(), NoOpTrustAnchor())
            machine, tx, events = await StateMachineInitializer(
                self.settings, store, device=self.device
            ).init()
            rest = RestServer(Fetcher(events), PetMessageHandler(events, tx))
            host, port = await rest.start("127.0.0.1", 0)
            self.url = f"http://{host}:{port}"
            self._loop = asyncio.get_running_loop()
            self._machine_task = asyncio.create_task(machine.run())
            self._started.set()
            try:
                await self._machine_task
            except asyncio.CancelledError:
                pass
            finally:
                await rest.stop()

        asyncio.run(main())

    def _sync(self, coro):
        return asyncio.run(coro)

    def rounds(
        self,
        trainers: Sequence[ParticipantABC],
        n_rounds: int = 1,
        round_timeout: float = 300.0,
    ) -> Iterator[RoundResult]:
        """Runs rounds; yields each new global model.

        ``trainers[:n_sum]`` back the sum participants of every round (their
        ``train_round`` is never called); the rest are cycled through the
        update slots.
        """
        if len(trainers) < self.n_sum + self.n_update:
            raise ValueError("need at least n_sum + n_update trainers")
        last_seed: Optional[bytes] = None
        for round_no in range(n_rounds):
            t0 = time.time()
            params = self._sync(self._probe.get_round_params())
            while last_seed is not None and params.seed.as_bytes() == last_seed:
                time.sleep(0.05)
                params = self._sync(self._probe.get_round_params())
            seed = params.seed.as_bytes()

            # Deterministic, single-threaded drive: fresh role-pinned
            # participants each round (participants from prior rounds are
            # dropped, so re-drawn eligibility can never steal round slots).
            members: list[tuple[Participant, ParticipantABC]] = []
            for i in range(self.n_sum):
                keys = keys_for_task(seed, self.sum_prob, self.update_prob, "sum", start=i * 1000)
                members.append(
                    (Participant(self.url, keys=keys, device=self.device), trainers[i])
                )
            for i in range(self.n_update):
                keys = keys_for_task(
                    seed, self.sum_prob, self.update_prob, "update", start=(1000 + i) * 1000
                )
                trainer = trainers[
                    self.n_sum + (round_no * self.n_update + i) % (len(trainers) - self.n_sum)
                ]
                members.append(
                    (
                        Participant(
                            self.url,
                            keys=keys,
                            scalar=Fraction(1, self.n_update),
                            device=self.device,
                        ),
                        trainer,
                    )
                )

            global_model = self._sync(self._probe.get_model())
            deadline = time.time() + round_timeout
            while time.time() < deadline:
                progressed = False
                for participant, trainer in members:
                    participant.tick()
                    progressed = progressed or participant.made_progress()
                    if participant.should_set_model() and trainer.participate_in_update_task():
                        training_input = (
                            trainer.deserialize_training_input(global_model)
                            if global_model is not None
                            else None
                        )
                        result = trainer.train_round(training_input)
                        participant.set_model(trainer.serialize_training_result(result))
                model = self._sync(self._probe.get_model())
                fresh = self._sync(self._probe.get_round_params())
                # the next round's parameters only appear after this round's
                # unmask published its model (identical consecutive models
                # are legal, so the model itself is no progress signal)
                if model is not None and fresh.seed.as_bytes() != seed:
                    break
                if not progressed:
                    time.sleep(0.05)
            else:
                raise TimeoutError(f"round {round_no + 1} did not complete")
            last_seed = seed
            for trainer in {id(t): t for _, t in members}.values():
                trainer.on_new_global_model(trainer.deserialize_training_input(np.asarray(model)))
            yield RoundResult(
                round_id=round_no + 1,
                global_model=np.asarray(model),
                wall_seconds=time.time() - t0,
            )

    def global_model(self) -> Optional[np.ndarray]:
        return self._sync(self._probe.get_model())

    def stop(self) -> None:
        """Stops the coordinator loop (participants are per-round, already gone)."""
        loop = getattr(self, "_loop", None)
        task = getattr(self, "_machine_task", None)
        if loop is not None and task is not None:
            loop.call_soon_threadsafe(task.cancel)
            self._runner.join(timeout=5)
        self._threads.clear()
