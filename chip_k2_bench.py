#!/usr/bin/env python3
"""Times of kernel K2's two entries (and K5 where a checkout has it) on one
NVIDIA GPU, at the shapes the port's paths give them.

    python3 chip_k2_bench.py                       # this checkout
    python3 chip_k2_bench.py --root build/parent   # another checkout

Builds the kernels of the ``xaynet_tpu_torch`` found under ``--root`` and
times, with CUDA events over ``--reps`` calls after one warm-up call:
``mask_fold`` (one seed, 25,000,000 elements of prime/f32/b0/m3: a Sum2
seed at ResNet-50's size), ``mask_fold_rows`` at Phase S's two shapes of
``chip_smoke.py`` (s1: 8 seeds into ``uint32[8,2,25M]``; s2: 256 seeds into
``uint32[256,2,1000]``, integer/f32/b0/m6) and, where the checkout has
it, ``unit_draws`` over 2,048 seeds of s2's config. Every call includes
its wrapper's host work (the trip's acceptance read). The seeds come from
``--seed``, so two checkouts time the same inputs, and their results can
be held against each other by digest (``k2_digest``: a hash of K2's
accumulator and row bytes and end cursors; ``k5_digest``: of K5's units
and cursors). It prints the card's name and power limit, then one JSON
line.

Compare two checkouts in one chip call, in turns: parent, this, this,
parent.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent),
                        help="checkout whose xaynet_tpu_torch to time")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import xaynet_tpu_torch

    if Path(xaynet_tpu_torch.__file__).resolve().parent.parent != root:
        print(f"chip_k2_bench: xaynet_tpu_torch did not load from {root}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_k2_bench: no CUDA device", file=sys.stderr)
        return 2
    from xaynet_tpu_torch.core.mask.config import (
        BoundType, DataType, GroupType, MaskConfig, ModelType,
    )  # fmt: skip
    from xaynet_tpu_torch.ops import kernels, limbs
    from xaynet_tpu_torch.ops.fold import to_device_u32, zeros_u32

    dev = torch.device("cuda")
    kernels.build()
    rng = np.random.default_rng(args.seed)
    digests = {"k2_digest": hashlib.sha256(), "k5_digest": hashlib.sha256()}

    def key_words(b: int) -> torch.Tensor:
        return to_device_u32(rng.integers(0, 1 << 32, (b, 8), dtype=np.uint64).astype(np.uint32),
                             dev)  # fmt: skip

    def time_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def record(key: str, *tensors: torch.Tensor) -> None:
        for t in tensors:
            host = t.view(torch.int32) if t.dtype == torch.uint32 else t
            digests[key].update(host.cpu().numpy().tobytes())

    m3 = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3).order
    m6 = MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6).order
    out: dict = {}
    n = 25_000_000

    kws = key_words(1)
    acc = zeros_u32((2, n), dev)
    record("k2_digest", *kernels.mask_fold(acc, kws, [6], n, m3))
    out["mask_fold_25M_ms"] = time_ms(lambda: kernels.mask_fold(acc, kws, [6], n, m3), args.reps)
    del acc

    for tag, order, b, count, reps in (("s1", m3, 8, n, max(2, args.reps // 2)),
                                       ("s2", m6, 256, 1000, 5 * args.reps)):
        kws = key_words(b)
        offs = [13 * i + 6 for i in range(b)]  # cursors that differ by seed, mid-block
        rows = zeros_u32((b, limbs.n_limbs_for_order(order), count), dev)
        record("k2_digest", *kernels.mask_fold_rows(rows, kws, offs, count, order))
        out[f"mask_fold_rows_{tag}_ms"] = time_ms(
            lambda: kernels.mask_fold_rows(rows, kws, offs, count, order), reps
        )
        del rows

    if hasattr(kernels, "unit_draws"):
        kws = key_words(2048)
        record("k5_digest", *kernels.unit_draws(kws, m6))
        out["unit_draws_2048_ms"] = time_ms(lambda: kernels.unit_draws(kws, m6), 5 * args.reps)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()  # fmt: skip
    print(card)
    print(json.dumps({"root": str(root), "card": card, "reps": args.reps, **out,
                      **{k: d.hexdigest()[:16] for k, d in digests.items()}}))  # fmt: skip
    return 0


if __name__ == "__main__":
    sys.exit(main())
