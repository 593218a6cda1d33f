"""Sim-fed load generation: update traffic for a coordinator, on the port.

Port of ``xaynet_tpu/loadgen``. The population engine derives masks for
blocks of participants on the device, each seed into its own row by K2
(``population``); the forge wraps each row in the byte-exact production
message encoding: fixed-point encode, wire v1/v2 element layout, seed-dict
sealed boxes, Ed25519 signatures, sealed envelope (``build``); the
event-driven replay driver plays the uploads against a coordinator's REST
boundary under churn/dropout/straggle schedules (``schedule``,
``driver``), process-sharded for scale (``runner``).

Everything is deterministic per seed: a loadgen round's global model is
byte-identical to ``sim.SimRound`` over the forged population's seeds,
models and scalar.
"""

from .build import ForgedPopulation, UpdateForge, forge_population
from .driver import DriverStats, ReplayDriver
from .population import PopulationEngine
from .schedule import ChurnSpec, ReplaySchedule

__all__ = [
    "ChurnSpec",
    "DriverStats",
    "ForgedPopulation",
    "PopulationEngine",
    "ReplayDriver",
    "ReplaySchedule",
    "UpdateForge",
    "forge_population",
]
