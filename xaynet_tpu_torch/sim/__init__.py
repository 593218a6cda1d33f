"""Whole-round PET simulation on the device, and the differential oracle.

Port of ``xaynet_tpu/sim``. ``SimRound`` computes an entire PET round
(per-participant mask derivation, masked-model fold, sum-mask
reconstruction, unmask) from seeds and local models, with no server,
sockets or phases in between, on K2 and K1; ``sim.oracle`` replays one
seeded round through the port's coordinator and SDK and through the sim,
and requires byte-identical global models. ``SimRound(spec, mesh=...)``
shards the participant axis over a mesh of devices, as the JAX package's
does.
"""

from .oracle import OracleCase, OracleMismatch, run_oracle_case, run_production_round
from .round import SimResult, SimRound, SimSpec, seeds_for

__all__ = [
    "SimResult",
    "SimRound",
    "SimSpec",
    "seeds_for",
    "OracleCase",
    "OracleMismatch",
    "run_oracle_case",
    "run_production_round",
]
