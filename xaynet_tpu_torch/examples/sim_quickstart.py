"""Simulate a whole PET round with the sim — no coordinator.

Port of ``examples/sim_quickstart.py``, the research face of
``xaynet_tpu_torch.sim``: thousands of simulated participants per call,
exact protocol arithmetic (the global model is byte-identical to what the
production coordinator computes for the same seeds), on ``--device``
(default ``cuda``; ``cpu`` runs the plain versions). ``--mesh`` shards the
participants over every visible card, as the JAX example does over its
devices; ``--mesh N`` over the device repeated N times (one card, or the
CPU).

    python -m xaynet_tpu_torch.examples.sim_quickstart -p 1024 -l 1000
    python -m xaynet_tpu_torch.examples.sim_quickstart -p 4096 -l 1000 --mesh --rounds 3
    python -m xaynet_tpu_torch.examples.sim_quickstart -p 64 -l 100 --device cpu --mesh 2
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import time
from fractions import Fraction

import numpy as np

from ..core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
from ..device import resolve_device
from ..parallel.mesh import make_mesh, serve_mesh
from ..sim import SimRound, SimSpec, seeds_for

# M6 allows up to 1e6 aggregated models; B0 bounds weights to [-1, 1]
CONFIG = MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6)


def population(participants: int, length: int, rounds: int):
    """Each round's (seeds, local models), as the JAX example draws them:
    fresh seeds ``seeds_for(p, root=round)`` and weights from one
    ``default_rng(0)`` stream."""
    rng = np.random.default_rng(0)
    for rnd in range(rounds):
        yield seeds_for(participants, root=rnd), rng.uniform(
            -1, 1, (participants, length)
        ).astype(np.float32)


def simulate(participants: int, length: int, block: int, rounds: int, device,
             mesh=None) -> list:
    """Runs the rounds; returns ``(SimResult, weights, seconds)`` per round."""
    sim = SimRound(SimSpec(CONFIG.pair(), length, block_size=block), mesh=mesh,
                   device=None if mesh is not None else device)  # fmt: skip
    out = []
    for seeds, weights in population(participants, length, rounds):
        t0 = time.perf_counter()
        result = sim.run(seeds, weights, scalar=Fraction(1, participants))
        out.append((result, weights, time.perf_counter() - t0))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-p", "--participants", type=int, default=1024)
    ap.add_argument("-l", "--length", type=int, default=1000, help="model length")
    ap.add_argument("-b", "--block", type=int, default=128, help="participants per block")
    ap.add_argument("--rounds", type=int, default=2, help="simulated rounds (1st builds the kernels)")
    ap.add_argument("--mesh", type=int, nargs="?", const=0, default=None, metavar="N",
                    help="shard participants over every visible card (or over the "
                         "device repeated N times)")
    ap.add_argument("--device", default="cuda", help="torch device of the sim")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = None
    if args.mesh is not None:
        mesh = make_mesh([device] * args.mesh) if args.mesh > 0 else serve_mesh(device)
        print(f"mesh: {len(mesh)} devices (participant-axis sharding)")
    p = args.participants
    for rnd, (result, weights, dt) in enumerate(
        simulate(p, args.length, args.block, args.rounds, device, mesh)
    ):
        model = np.asarray(result.global_model, dtype=np.float64)
        mean_err = float(np.max(np.abs(model - weights.astype(np.float64).mean(axis=0))))
        note = " (includes the kernels' build)" if rnd == 0 else ""
        print(
            f"round {rnd}: {p} participants x {args.length} params in {dt:.2f}s "
            f"= {p / dt:,.0f} participants/s{note}; "
            f"max |global - float mean| = {mean_err:.2e} (fixed-point quantization); "
            f"model sha256 {hashlib.sha256(model.tobytes()).hexdigest()}"
        )
    print(f"sim runs: {args.rounds} (one per round — no per-participant loop)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
