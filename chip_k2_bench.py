#!/usr/bin/env python3
"""Times of kernels K2 and K6 (and K5 where a checkout has it) on one NVIDIA
GPU, at the shapes the port's paths give them.

    python3 chip_k2_bench.py                       # this checkout
    python3 chip_k2_bench.py --root build/parent   # another checkout
    python3 chip_k2_bench.py --sass                # also count K6's loads

Builds the kernels of the ``xaynet_tpu_torch`` found under ``--root`` and
times, with CUDA events over ``--reps`` calls after one warm-up call:
``mask_fold`` (one seed, 25,000,000 elements of prime/f32/b0/m3: a Sum2
seed at ResNet-50's size), ``mask_fold_rows`` at Phase S's two shapes of
``chip_smoke.py`` (s1: 8 seeds into ``uint32[8,2,25M]``; s2: 256 seeds into
``uint32[256,2,1000]``, integer/f32/b0/m6) and, where the checkout has
it, ``unit_draws`` over 2,048 seeds of s2's config and over 1, 8, 256
and 2,048 seeds of prime/f32/b0/m3 (there also its device time a call,
from a ``torch.profiler`` window). Every call includes its wrapper's host
work (the trip's acceptance read).

The handoff leg times the mask derivations through ``ops/masking.py``:
``derive_mask_limbs`` (one seed, 25M, prime/f32/b0/m3) and
``sum_masks_planar`` (8 seeds x 25M), each as host walls ending in
``torch.cuda.synchronize()``, and reads from one profiler window a leg
the gap on the stream from K5's end to K2's start (``gap_ms``; of it
``busy_ms`` on other device work, ``idle_ms`` the card idle).

K6's legs, over v1 wire blocks of prime/f32/b0/m3 (6 bytes an element)
at 25,000,000 elements: ``wire_fold`` of 8 valid members
(``uint8[8,150M]``); of Phase W's fused batches, 2 valid members and 3
with one rejected; of 5 members with one rejected; and ``wire_unfold``
over a shard's slice of Phase X (6,250,000 elements) of 3 and of 5
members, one flagged. Each leg's line has its bound: the members' bytes
read once and the accumulator read and written once (for ``wire_unfold``
the flagged member's bytes), at 3.35 TB/s.

The inputs come from ``--seed``, so two checkouts time the same inputs,
and their results can be held against each other by digest
(``k2_digest``: a hash of K2's accumulator and row bytes and end cursors;
``k5_digest``: of K5's units and cursors; ``k6_digest``: of K6's
accumulators and verdicts, one call of each leg from the same
accumulator). ``--sass`` counts, in the built fold library's machine code
(``cuobjdump -sass``), the load instructions of each K6 kernel by kind. It
prints the card's name and power limit, then one JSON line.

Compare two checkouts in one chip call, in turns: parent, this, this,
parent.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
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
    parser.add_argument("--sass", action="store_true", help="count K6's load instructions")
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
    libs = kernels.build()
    rng = np.random.default_rng(args.seed)
    digests = {k: hashlib.sha256() for k in ("k2_digest", "k5_digest", "k6_digest")}

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
        out["unit_draws_m3"] = k5_sizes(torch, kernels, key_words, m3, time_ms, record,
                                        5 * args.reps)  # fmt: skip
        from xaynet_tpu_torch.ops import masking

        pair = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3).pair()
        out["handoff"] = handoff_legs(torch, masking, pair, n, rng, args.reps, digests)

    if hasattr(kernels, "wire_fold"):
        out.update(k6_legs(torch, kernels, to_device_u32, zeros_u32, m3, n, rng, dev, time_ms,
                           record, args.reps))
    if args.sass:
        out["k6_sass"] = k6_sass(libs["fold"])

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()  # fmt: skip
    print(card)
    print(json.dumps({"root": str(root), "card": card, "reps": args.reps, **out,
                      **{k: d.hexdigest()[:16] for k, d in digests.items()}}))  # fmt: skip
    return 0


MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
K5_SYMBOL, K2_SYMBOL = "mf_unit_draws_kernel", "mf_mask_fold_kernel"


def device_events(torch, fn) -> list:
    """``(start_us, end_us, name)`` of every device event (kernels, copies,
    fills) in one ``torch.profiler`` window around ``fn`` (CUDA activity
    only), in order of start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted((ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
                  if "CUDA" in str(ev.device_type))  # fmt: skip


def k5_sizes(torch, kernels, key_words, order, time_ms, record, reps) -> dict:
    """K5 at 1, 8, 256 and 2,048 seeds of ``order``: ms a call by CUDA
    events over ``reps`` calls, and the kernel's own device time a call
    from a profiler window of ``reps`` calls."""
    out = {}
    for b in (1, 8, 256, 2048):
        kws = key_words(b)
        record("k5_digest", *kernels.unit_draws(kws, order))
        ms = time_ms(lambda: kernels.unit_draws(kws, order), reps)

        def calls():
            for _ in range(reps):
                kernels.unit_draws(kws, order)

        spans = [e - s for s, e, name in device_events(torch, calls) if K5_SYMBOL in name]
        out[str(b)] = {"ms": ms, "device_ms": sum(spans) / len(spans) / 1e3 if spans else None,
                       "device_calls": len(spans)}  # fmt: skip
    return out


def k5_to_k2_gap(events: list) -> list:
    """For each K5 launch in ``events``, the stream's gap to the next K2
    launch: ``gap_ms`` from K5's end to K2's start, ``busy_ms`` of it spent
    on other device work (the cursor copy, the fills and memsets K2's
    wrapper queues), ``idle_ms`` the rest."""
    out = []
    for i, (_, k5_end, name) in enumerate(events):
        if K5_SYMBOL not in name:
            continue
        k2 = next((ev for ev in events[i + 1:] if K2_SYMBOL in ev[2]), None)
        if k2 is None:
            continue
        busy, reach = 0.0, k5_end
        for start, end, _ in events[i + 1:]:
            if start >= k2[0]:
                break
            start, end = max(start, reach), min(end, k2[0])
            if end > start:
                busy += end - start
                reach = end
        gap = k2[0] - k5_end
        out.append({"gap_ms": gap / 1e3, "busy_ms": busy / 1e3, "idle_ms": (gap - busy) / 1e3})
    return out


def handoff_legs(torch, masking, pair, n, rng, reps, digests) -> dict:
    """The mask derivations that hand K5's cursors to K2, through the
    checkout's own entry points: ``derive_mask_limbs`` (one seed, ``n``
    elements) and ``sum_masks_planar`` (8 seeds x ``n``). Each leg's host
    walls (a call ending in ``torch.cuda.synchronize()``, ``reps`` times)
    and, from one profiler window of three calls, the gap on the stream
    from each K5's end to the next K2's start. Results go into
    ``k2_digest`` (the accumulator) and ``k5_digest`` (the units)."""
    import time

    seeds = [rng.bytes(32) for _ in range(9)]
    legs = {
        "derive_mask_limbs_25M": lambda: masking.derive_mask_limbs(seeds[0], n, pair),
        "sum_masks_planar_8x25M": lambda: masking.sum_masks_planar(seeds[1:], n, pair),
    }
    out = {}
    for name, fn in legs.items():
        unit, acc = fn()
        torch.cuda.synchronize()
        digests["k5_digest"].update(np.ascontiguousarray(unit).tobytes())
        digests["k2_digest"].update(acc.view(torch.int32).cpu().numpy().tobytes())
        del acc
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _, acc = fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            del acc

        def three():
            for _ in range(3):
                fn()
                torch.cuda.synchronize()

        out[name] = {"wall_ms": walls, "wall_ms_median": float(np.median(walls)),
                     "k5_to_k2": k5_to_k2_gap(device_events(torch, three))}  # fmt: skip
    torch.cuda.empty_cache()
    return out


def k6_legs(torch, kernels, to_device_u32, zeros_u32, order, n, rng, dev, time_ms, record,
            reps) -> dict:
    """K6's legs (module docstring): each one's ms, bound_ms and share."""
    bpn, n_limb = 6, 2
    top = order >> (8 * (bpn - 1))  # an element is valid when its top byte is below this

    def members(k: int, count: int, reject: tuple = ()) -> torch.Tensor:
        x = np.frombuffer(rng.bytes(k * count * bpn), np.uint8).reshape(k, count, bpn).copy()
        x[:, :, bpn - 1] %= top
        for i in reject:  # one element at the order: a rejected member
            x[i, count // 2] = np.frombuffer(order.to_bytes(8, "little")[:bpn], np.uint8)
        return torch.from_numpy(x.reshape(k, count * bpn)).to(dev)

    legs = {}

    def leg(name: str, fn, acc0: torch.Tensor, nbytes: int) -> None:
        record("k6_digest", *fn(acc0.clone()))
        acc = acc0.clone()
        ms = time_ms(lambda: fn(acc), reps)
        bound = nbytes / MEM_BYTES_PER_S * 1e3
        legs[name] = {"ms": ms, "bound_ms": bound, "share": bound / ms}

    acc0 = zeros_u32((n_limb, n), dev)
    for k, reject in ((8, ()), (2, ()), (3, (1,)), (5, (2,))):
        raw = members(k, n, reject)
        leg(f"wire_fold_k{k}" + ("_one_rejected" if reject else ""),
            lambda acc, raw=raw: kernels.wire_fold(acc, raw, order), acc0,
            raw.numel() + 8 * n_limb * n + 4 * k)  # fmt: skip
        del raw
    shard = n // 4  # Phase X's slice of four shards
    limbs = rng.integers(0, 1 << 32, (n_limb, shard), dtype=np.uint64).astype(np.uint32)
    limbs[0] %= 0xFFFFFFFF
    limbs[1] %= top << 8  # below the order
    acc0 = to_device_u32(limbs, dev)
    for k in (3, 5):
        raw = members(k, shard)
        drop = torch.zeros(k, dtype=torch.bool, device=dev)
        drop[-1] = True
        leg(f"wire_unfold_k{k}",
            lambda acc, raw=raw, drop=drop: (kernels.wire_unfold(acc, raw, drop, order),), acc0,
            shard * bpn + 8 * n_limb * shard + k)  # fmt: skip
        del raw
    w_batches = (legs["wire_fold_k2"]["ms"], legs["wire_fold_k3_one_rejected"]["ms"])
    legs["wire_fold_w_mean_ms"] = sum(w_batches) / len(w_batches)
    torch.cuda.empty_cache()
    return legs


def k6_sass(lib: Path) -> dict:
    """Load instructions of each K6 kernel in ``lib``'s machine code, by
    opcode (global loads LDG, shared loads LDS, asynchronous global-to-shared
    copies LDGSTS, local memory LDL)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    counts = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0]
        kernel = re.search(r"(wire_(?:un)?fold_kernel)ILi(\d+)E", name)
        if kernel is None:
            continue
        ops: dict[str, int] = {}
        for op in re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", body):
            if op.split(".")[0] in ("LDG", "LDS", "LDGSTS", "LDL"):
                ops[op] = ops.get(op, 0) + 1
        counts[f"{kernel.group(1)}<{kernel.group(2)}>"] = dict(sorted(ops.items()))
    return counts


if __name__ == "__main__":
    sys.exit(main())
