"""Differential oracle sweep: replay seeded rounds through the sim AND the
in-process production coordinator; fail on any byte mismatch.

Port of ``tools/sim_check.py``. Every combination drives ONE production
round (the port's coordinator state machine and SDK participants,
in-process transport, pinned mask seeds) and then checks ``SimRound``
against it, byte for byte on the float64 global model, on ``--device``
(default ``cuda``; ``cpu`` runs the plain versions).

Usage:
  python -m xaynet_tpu_torch.tools.sim_check [--combos N] [--seed S] [--json]

``--combos N`` draws N (mask config x model size x participant count)
combinations from the JAX tool's seeded menu, the same draws in the same
order, so a ``--seed`` names the same combinations in both packages. The
JAX menu also draws a Sum2 route for its production leg; the port's sum
participants always sum the masks on K2, and the drawn name is reported
as ``jax_sum2_route``. The mesh-sharded leg (``--mesh``) needs several
devices and is refused (ROADMAP Queue 1 item 10); ``--no-mesh`` is
accepted for the JAX tool's command lines.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

GROUPS = ("INTEGER", "PRIME", "POWER2")
LENGTHS = (13, 64, 257, 600)
POPULATIONS = (3, 4, 5, 7)
# the JAX menu's Sum2 routes (its production leg's MASK_KERNELS names)
SUM2_ROUTES = (None, None, "batch", "fused-pallas-interpret", "host-threaded")


def menu(combos: int, seed: int) -> list:
    """The seeded combinations ``(OracleCase, jax_sum2_route)``, drawn as
    the JAX tool draws them."""
    import numpy as np

    from ..core.mask.config import GroupType
    from ..sim import OracleCase

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(combos):
        route = SUM2_ROUTES[int(rng.integers(len(SUM2_ROUTES)))]
        case = OracleCase(
            group_type=GroupType[GROUPS[int(rng.integers(len(GROUPS)))]],
            model_length=int(LENGTHS[int(rng.integers(len(LENGTHS)))]),
            n_update=int(POPULATIONS[int(rng.integers(len(POPULATIONS)))]),
            seed=int(rng.integers(1 << 30)),
            block_size=int(rng.choice([2, 3, 4, 8])),
        )
        out.append((case, route))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--combos", type=int, default=3, help="seeded combinations to replay")
    ap.add_argument("--seed", type=int, default=0, help="menu + population root seed")
    ap.add_argument("--mesh", action="store_true",
                    help="also check the mesh-sharded sim (not in this package)")
    ap.add_argument("--no-mesh", action="store_true", help="skip the mesh leg (the default)")
    ap.add_argument("--json", action="store_true", help="one JSON line per combination")
    ap.add_argument("--device", default="cuda", help="torch device of both legs")
    args = ap.parse_args(argv)
    if args.mesh:
        ap.error("the mesh-sharded sim leg needs several devices, which xaynet_tpu_torch "
                 "does not have yet (ROADMAP Queue 1 item 10, several GPUs)")

    from ..device import resolve_device
    from ..sim import OracleMismatch, run_oracle_case, run_production_round

    device = resolve_device(args.device)
    failures = 0
    for i, (case, route) in enumerate(menu(args.combos, args.seed)):
        t0 = time.time()
        outcome = {"case": case.describe(), "block": case.block_size}
        if route is not None:
            outcome["jax_sum2_route"] = route
        try:
            production = run_production_round(case, device=device)
            report = run_oracle_case(case, production_model=production, device=device)
            outcome["single_device"] = "byte-identical"
            outcome["sha256"] = report.sim_sha[:16]
            outcome["seconds"] = round(time.time() - t0, 1)
            outcome["result"] = "ok"
        except OracleMismatch as err:
            outcome["result"] = "MISMATCH"
            outcome["error"] = str(err)
            failures += 1
        except Exception as err:  # infra failure: report, still fail the run
            outcome["result"] = "ERROR"
            outcome["error"] = f"{type(err).__name__}: {err}"
            failures += 1
        if args.json:
            print(json.dumps(outcome), flush=True)
        else:
            extra = outcome.get("error", outcome.get("seconds", ""))
            print(f"[{i + 1}/{args.combos}] {outcome['case']}: {outcome['result']} {extra}",
                  flush=True)  # fmt: skip

    if failures:
        print(f"sim-check: {failures}/{args.combos} combination(s) FAILED", file=sys.stderr)
        return 1
    print(f"sim-check: {args.combos} combination(s) byte-identical", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
