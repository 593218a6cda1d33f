"""Differential oracle: sim round vs in-process production coordinator round.

Port of ``xaynet_tpu/sim/oracle.py``. The simulation (``sim.round``) and
the coordinator compute the same function of (mask config, participant
mask seeds, local models, scalar): the round's unmasked global model. This
module replays ONE seeded round through both and requires the results to
be **byte-identical** (``float64`` buffer bytes, not approximate).

The production leg is the port's stack: its coordinator (phase state
machine, PET message pipeline, seed dictionary, the aggregator on the
oracle's device) and its SDK participants (``StateMachine`` over
``InProcessClient``, masking and Sum2 on the same device), with only the
network replaced by in-process calls and each update participant's mask
seed pinned through ``PetSettings.mask_seed``. The sim leg reruns the same
population through ``SimRound``. Both run on CUDA unless given a device.
"""

from __future__ import annotations

import asyncio
import hashlib
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Optional

import numpy as np

from ..core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType

SUM_PROB = 0.4
UPDATE_PROB = 0.5


class OracleMismatch(AssertionError):
    """The sim and production rounds produced different global models."""


@dataclass(frozen=True)
class OracleCase:
    """One seeded (mask config x model size x participant count) combination."""

    group_type: GroupType = GroupType.INTEGER
    data_type: DataType = DataType.F32
    bound_type: BoundType = BoundType.B0
    model_type: ModelType = ModelType.M3
    model_length: int = 13
    n_update: int = 3
    n_sum: int = 2
    seed: int = 0  # roots the weights RNG and the injected mask seeds
    block_size: int = 4  # sim participants per block
    time_max: float = 60.0
    # the JAX package's Sum2 route name; the port's sum participants sum the
    # masks on K2 on their device, and "auto" is the only name taken
    mask_kernel: str = "auto"

    def __post_init__(self):
        if self.mask_kernel != "auto":
            raise ValueError(
                f"mask_kernel = {self.mask_kernel!r}: the port's oracle drives its "
                'participants\' Sum2 on K2 only and takes "auto" (ROADMAP Queue 2)'
            )

    @property
    def mask_config(self) -> MaskConfig:
        return MaskConfig(self.group_type, self.data_type, self.bound_type, self.model_type)

    def describe(self) -> str:
        return (
            f"{self.group_type.name}/{self.data_type.name}/{self.bound_type.name}/"
            f"{self.model_type.name} n={self.model_length} P={self.n_update} seed={self.seed}"
        )

    def population(self) -> tuple[list[bytes], np.ndarray]:
        """The deterministic (mask seeds, local models) both legs replay."""
        rng = np.random.default_rng(self.seed)
        seeds = [rng.bytes(32) for _ in range(self.n_update)]
        weights = rng.uniform(-1, 1, (self.n_update, self.model_length)).astype(np.float32)
        return seeds, weights


@dataclass
class OracleReport:
    case: OracleCase
    identical: bool
    max_abs_diff: float
    production_sha: str
    sim_sha: str
    legs: dict = field(default_factory=dict)


def _production_settings(case: OracleCase):
    """The coordinator settings of ``case``'s production round: count
    windows min = max (``n_sum``, ``n_update``, ``n_sum``), its mask config
    and model length, everything else the defaults."""
    from ..server.settings import (
        CountSettings,
        PetSettings as ServerPet,
        PhaseSettings,
        Settings,
        Sum2Settings,
        TimeSettings,
    )

    def window(n: int) -> dict:
        time = TimeSettings(min=0.0, max=case.time_max)
        return dict(count=CountSettings(min=n, max=n), time=time)

    settings = Settings(
        pet=ServerPet(
            sum=PhaseSettings(prob=SUM_PROB, **window(case.n_sum)),
            update=PhaseSettings(prob=UPDATE_PROB, **window(case.n_update)),
            sum2=Sum2Settings(**window(case.n_sum)),
        )
    )
    settings.model.length = case.model_length
    settings.mask.group_type = case.group_type
    settings.mask.data_type = case.data_type
    settings.mask.bound_type = case.bound_type
    settings.mask.model_type = case.model_type
    return settings


async def _drive_production_round(case: OracleCase, device) -> np.ndarray:
    """One in-process production round with pinned mask seeds; returns the
    float64 global model exactly as the Unmask phase broadcast it."""
    from ..sdk.client import InProcessClient
    from ..sdk.simulation import keys_for_task
    from ..sdk.state_machine import PetSettings, StateMachine as ParticipantSM
    from ..sdk.traits import ModelStore
    from ..server.services import Fetcher, PetMessageHandler
    from ..server.state_machine import StateMachineInitializer
    from ..storage.memory import InMemoryCoordinatorStorage, InMemoryModelStorage, NoOpTrustAnchor
    from ..storage.traits import Store

    class _ArrayModelStore(ModelStore):
        def __init__(self, model):
            self.model = model

        async def load_model(self):
            return self.model

    mask_seeds, weights = case.population()
    store = Store(InMemoryCoordinatorStorage(), InMemoryModelStorage(), NoOpTrustAnchor())
    initializer = StateMachineInitializer(_production_settings(case), store, device=device)
    machine, request_tx, events = await initializer.init()
    handler = PetMessageHandler(events, request_tx)
    fetcher = Fetcher(events)
    machine_task = asyncio.create_task(machine.run())
    # transition() raising is routine (a participant polling ahead of the
    # phase), so drive() retries, but the LAST error is kept: if the round
    # never completes, its cause surfaces instead of an opaque timeout
    last_errors: list[BaseException] = []
    try:
        while fetcher.phase().value != "sum":
            await asyncio.sleep(0.01)
        round_seed = fetcher.round_params().seed.as_bytes()

        participants = []
        for i in range(case.n_sum):
            keys = keys_for_task(round_seed, SUM_PROB, UPDATE_PROB, "sum", start=i * 1000)
            pet = PetSettings(keys=keys, device=device)
            participants.append(
                ParticipantSM(pet, InProcessClient(fetcher, handler), _ArrayModelStore(None))
            )
        for i in range(case.n_update):
            keys = keys_for_task(
                round_seed, SUM_PROB, UPDATE_PROB, "update", start=(10 + i) * 1000
            )
            pet = PetSettings(keys=keys, scalar=Fraction(1, case.n_update),
                              mask_seed=mask_seeds[i], device=device)  # fmt: skip
            participants.append(
                ParticipantSM(pet, InProcessClient(fetcher, handler), _ArrayModelStore(weights[i]))
            )

        async def drive(sm):
            for _ in range(1000):
                try:
                    await sm.transition()
                except asyncio.CancelledError:
                    raise
                except Exception as err:
                    last_errors.append(err)
                # the model exists only once every message of the round's
                # windows was accepted; a participant that already took a
                # role in the next round would never come back to awaiting
                if fetcher.model() is not None:
                    return
                await asyncio.sleep(0.01)

        await asyncio.gather(*(drive(p) for p in participants))
        while fetcher.model() is None:
            await asyncio.sleep(0.01)
        return np.asarray(fetcher.model(), dtype=np.float64)
    except asyncio.CancelledError:
        if fetcher.model() is None and last_errors:
            raise RuntimeError(
                f"production round never completed; last participant error: "
                f"{type(last_errors[-1]).__name__}: {last_errors[-1]}"
            ) from last_errors[-1]
        raise
    finally:
        machine_task.cancel()
        await asyncio.gather(machine_task, return_exceptions=True)


def run_production_round(case: OracleCase, timeout: float = 120.0, device=None) -> np.ndarray:
    """Synchronous wrapper around the in-process production round."""
    return asyncio.run(asyncio.wait_for(_drive_production_round(case, device), timeout=timeout))


def run_sim_round(case: OracleCase, mesh=None, device=None):
    """The same population through ``SimRound``."""
    from .round import SimRound, SimSpec

    seeds, weights = case.population()
    spec = SimSpec(
        config=case.mask_config.pair(),
        model_length=case.model_length,
        block_size=case.block_size,
    )
    sim = SimRound(spec, mesh=mesh, device=device)
    return sim.run(seeds, weights, scalar=Fraction(1, case.n_update))


def run_oracle_case(
    case: OracleCase,
    mesh=None,
    production_model: Optional[np.ndarray] = None,
    timeout: float = 120.0,
    device=None,
) -> OracleReport:
    """Replay ``case`` through both paths; raise ``OracleMismatch`` unless
    the global models are byte-identical.

    ``production_model`` short-circuits the (slow) coordinator leg so
    several sim variants can be checked against one production run.
    """
    if production_model is None:
        production_model = run_production_round(case, timeout=timeout, device=device)
    sim_result = run_sim_round(case, mesh=mesh, device=device)
    prod = np.asarray(production_model, dtype=np.float64)
    simm = np.asarray(sim_result.global_model, dtype=np.float64)
    p_sha = hashlib.sha256(prod.tobytes()).hexdigest()
    s_sha = hashlib.sha256(simm.tobytes()).hexdigest()
    identical = prod.shape == simm.shape and prod.tobytes() == simm.tobytes()
    max_diff = float(np.max(np.abs(prod - simm))) if prod.shape == simm.shape else float("inf")
    report = OracleReport(
        case=case,
        identical=identical,
        max_abs_diff=max_diff,
        production_sha=p_sha,
        sim_sha=s_sha,
        legs={"mesh": None if mesh is None else len(mesh), "nb_models": sim_result.nb_models},
    )
    if not identical:
        raise OracleMismatch(
            f"sim diverged from production for {case.describe()}: "
            f"sha {s_sha[:16]} != {p_sha[:16]}, max |diff| {max_diff:.3e}"
        )
    return report
