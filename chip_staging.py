#!/usr/bin/env python3
"""Update-phase walls of the port's ``StagedAggregator`` on one NVIDIA GPU.

    python3 chip_staging.py --batch 8 --updates 16           # this checkout
    python3 chip_staging.py --root build/parent --batch 64   # another checkout

Runs ``--rounds`` Update phases in one process, each through a fresh
``StagedAggregator`` (25,000,000 parameters, prime/f32/b0/m3, packed
staging) of the ``xaynet_tpu_torch`` found under ``--root``: ``--updates``
pre-made masked updates (random group elements from ``--seed``, made once
and reused by every round) each validated and aggregated, then
``finalize_inplace`` (on a checkout without it, ``finalize``, the same
Unmask handoff) and a device synchronize. It prints one JSON line per
round: the ``update_aggregate`` and ``finalize`` walls, and where the
checkout stages through a pinned ring, the ring's bytes, the seconds its
new buffers took to pin and how many it reused pinned (a checkout with
the page pool: how many leases landed in a slab the pool had locked
before), and the process's peak host RSS so far.
Each round's aggregate is checked against python big-int sums at 2,048
positions; a mismatch exits non-zero.

The first round of a process pays for pinning its ring; later rounds show
what a coordinator that runs round after round pays. A checkout from
before the pipeline uploads each flush from pageable memory instead.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from pathlib import Path

import numpy as np


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent),
                        help="checkout whose xaynet_tpu_torch to time")
    parser.add_argument("--length", type=int, default=25_000_000)
    parser.add_argument("--updates", type=int, default=16)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import xaynet_tpu_torch

    if Path(xaynet_tpu_torch.__file__).resolve().parent.parent != root:
        print(f"chip_staging: xaynet_tpu_torch did not load from {root}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_staging: no CUDA device", file=sys.stderr)
        return 2
    from xaynet_tpu_torch.core.mask.config import (
        BoundType, DataType, GroupType, MaskConfig, ModelType,
    )  # fmt: skip
    from xaynet_tpu_torch.core.mask.object import MaskObject, MaskUnit, MaskVect
    from xaynet_tpu_torch.ops import limbs
    from xaynet_tpu_torch.server.aggregation import StagedAggregator

    pair = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3).pair()
    n_limb = limbs.n_limbs_for_order(pair.vect.order)
    if pair.vect.order >= 1 << 63 or n_limb != 2:
        raise SystemExit("chip_staging: expects a two-limb order below 2^63")
    rng = np.random.default_rng(args.seed)
    t = time.perf_counter()
    updates = []
    for _ in range(args.updates):
        # group elements as little-endian uint32 limb pairs: the wire layout
        wire = rng.integers(0, pair.vect.order, args.length, dtype=np.uint64)
        unit = rng.integers(0, pair.unit.order, 1, dtype=np.uint64)
        updates.append(MaskObject(
            MaskVect(pair.vect, wire.view(np.uint32).reshape(args.length, 2)),
            MaskUnit(pair.unit, unit.view(np.uint32)[: limbs.n_limbs_for_order(pair.unit.order)]),
        ))  # fmt: skip
    make_s = time.perf_counter() - t
    idx = np.sort(rng.choice(args.length, size=2048, replace=False))
    want = [sum(v) % pair.vect.order
            for v in zip(*(limbs.limbs_to_ints(u.vect.data[idx]) for u in updates))]

    for r in range(args.rounds):
        agg = StagedAggregator(pair, args.length, batch_size=args.batch, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        for obj in updates:
            agg.validate_aggregation(obj)
            agg.aggregate(obj)
        update_s = time.perf_counter() - t
        stream = getattr(agg, "_stream", None)
        rings = {}
        if stream is not None:  # finalize closes the pipeline: keep its rings
            close = stream.close
            stream.close = lambda: (rings.update(stream._rings), close())
        t = time.perf_counter()
        view = agg.finalize_inplace() if hasattr(agg, "finalize_inplace") else agg.finalize()
        torch.cuda.synchronize()
        finalize_s = time.perf_counter() - t
        ring = rings.get("packed")
        got = limbs.limbs_to_ints(view.object.vect.data[idx])
        ok = got == want and view.nb_models == args.updates
        print(json.dumps({
            "root": str(root), "batch": args.batch, "updates": args.updates,
            "length": args.length, "round": r + 1, "update_aggregate_s": update_s,
            "finalize_s": finalize_s, "correct": ok, "make_updates_s": make_s,
            "ring_bytes": None if ring is None else ring.nbytes,
            "ring_pin_s": None if ring is None else ring.pin_seconds,
            "ring_reused": None if ring is None else getattr(ring, "reused", None),
            "peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
        }), flush=True)  # fmt: skip
        if not ok:
            print("chip_staging: aggregate or count wrong", file=sys.stderr)
            return 1
        getattr(view, "release_pool", lambda: None)()  # the Unmask tail's release
        del agg, view
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
