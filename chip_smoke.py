#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xaynet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run: 25M-element round, 16 updates

Builds the hand-written CUDA kernels from ``xaynet_tpu_torch/csrc`` with
``nvcc`` (one process per source, started together, into
``build/xaynet_tpu_torch/``, timed as set-up), then:

- **Phase A** holds every kernel byte-exact against its plain torch version
  on the card: K1 (the batch fold, planar and packed) over K in {1, 8, 64}
  and K = 65535, limb counts 2, 3, 10, 66 and 67, prime and 2^(32L) orders
  and a ragged model length; K2 (the Sum2 mask fold) over seed groups with
  mid-block start cursors, forced multi-trip runs, draw widths above the
  wire width and the widest orders, plus K2's mask against the host
  ``StreamSampler``; then the edges of K2's decoupled look-back (the
  count-th acceptance in tile 0 and at tile boundaries, count 1, the early
  exit, seven trips, cursors past 2^31 bytes and 2^32 blocks, 16 seeds,
  twenty launches into one accumulator). Each kernel is then timed at the
  shapes the main path gives it, beside its plain version, and checked
  there too. K2's bound counts the xors and rotates its ChaCha20 blocks
  need, on the ALU pipe; the built keystream loop's instructions per pipe
  (from its SASS) are recorded beside it. K3 (the v1 wire unpack + validity
  check) and K4 (the v2 byte-planar validity check) are held byte-exact,
  planar rows and per-update verdicts, on the shipped config and three more
  (the 2^96 boundary among them) at K in {1, 3, 8, 64} and a ragged length,
  with invalid elements (all 0xFF bytes, the order itself) at the first, a
  middle and the last element of chosen updates and ``order - 1`` (valid)
  at the edges of the others; then both on one 64-update batch at the main
  length (9.6e9 bytes, so every offset past 2^32 is exercised), made on the
  card, each update against the plain version alone; K4 also on elements
  that tie the order's bytes down to each plane.
- **Phase P** holds the Update fold's streaming pipeline
  (``parallel/streaming.py``) on the card at small sizes, shipped config:
  (p1) streamed and plain sequential folds of the same batches give
  byte-identical aggregates and model counts, equal to big-int sums,
  packed and planar staging; (p2) ``staging_buffers=4, dispatch_ahead=3``
  with a jittered fold seam over 32 batches: each batch folds once, in
  order, nothing stays in flight and every ring buffer comes back; (p3) a
  ``streaming.fold`` fault injected once degrades the pipeline to the
  synchronous path and leaves the aggregate byte-identical; (p4) a fault on
  both tries (the fault site, then the retry's upload) poisons it, and every
  later drain and submit raises ``StreamingError``.
- **Phase B** drives one PET round through the port's entry points at the
  size of ResNet-50 (25,000,000 parameters), the shipped mask config
  prime/f32/b0/m3, 16 update participants (each masks on the card: mask
  derived by K2, weights added by K1), ``StagedAggregator`` with batch 8 and
  packed staging: each flush submits into the streaming pipeline (two K1
  flushes, folded by its worker on the accumulator's stream while the next
  updates are masked and staged), ``finalize_inplace`` (the drain: the
  round's only synchronization of the folds), the Sum2 ``sum_masks`` over
  the 16 seeds (K2), ``validate_unmasking`` and ``unmask_array``. It checks
  the aggregate against python big-int sums at 2,048 positions, the unit
  part and model count, the decoded model against the f32 mean within
  16/exp_shift + 1e-6, and that the launch counters show every kernel ran.
  It reports each flush's stage and fold seconds, the pipeline's overlap
  ratio, K1 packed's device time inside the pipeline and what pinning the
  staging ring cost. Outside its timed walls it serializes each masked
  update for Phase W: even-indexed ones in wire format v1, odd ones in v2.
- **Phase W** is the Update phase with device wire ingest, on Phase B's 16
  updates plus a 17th whose element block holds one all-0xFF element (in
  the middle of the second group): each message parses lazily
  (``parse_mask_object(lazy_vect=True)``), ``prevalidate_wire_batch`` runs
  per group of ``batch`` updates (K3 over the v1 members, K4 over the v2
  ones), then ``validate_aggregation`` + ``aggregate`` per update (flushes
  fold the device rows with K1 on the caller's thread, packed and planar),
  then ``finalize_inplace`` and ``unmask_array`` with Phase B's mask. It
  checks that the corrupted update is rejected with ``InvalidObject``, that
  ``nb_models == 16``, that the accumulator and the decoded model are
  byte-identical to Phase B's, that K3, K4 and both K1 variants ran as many
  times as the groups and flush chunks need, and that no update was parsed
  on the host; and prints its walls beside Phase B's. Then, on the same
  uploaded blocks, K3 and K4 are held byte-exact against their plain
  versions at each shape the phase launched them (4-5 updates), and timed
  there: the kernel line's K3 and K4 times and bounds are the means over
  Phase W's launches, K4's bound counting only the bytes its verdict needs
  from this data (every top byte, and the sectors of lower planes where an
  element still ties the order).

Prints what it found on earlier lines; on its last lines the card's name
and power limit, the kernel table as one JSON object, and
``{"ok": true, "device": {...}}``. Any failure exits non-zero without that
last line, as does a machine without CUDA. Longer records (compiler
reports, every check) go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from fractions import Fraction
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
OUT_DIR = Path("chiprun_out")

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# Hopper SM: 64 lanes a clock on each integer pipe, the ALU pipe (logic,
# shifts, IADD3, compares) and the FMA pipe's IMAD side (H100 architecture
# white paper: 64 INT32 units per SM; CUDA C++ Programming Guide,
# arithmetic instruction throughput)
INT32_LANES_PER_SM = 64
# ChaCha20 block: 10 double rounds x 8 quarter rounds x 12 ops (4 add, 4 xor,
# 4 rotate; a rotate is one funnel shift) + 16 final adds
CHACHA_OPS_PER_BLOCK = 10 * 8 * 12 + 16
# its xors and rotates, which only the ALU pipe runs: K2's bound (the adds
# can go to the FMA pipe's IMAD side, which then carries fewer)
CHACHA_ALU_OPS_PER_BLOCK = 10 * 8 * 8
# SASS opcodes (before the first '.') by Hopper pipe; VIADD is counted on
# the FMA side, where it cannot make the busier pipe busier
ALU_OPCODES = {"LOP3", "SHF", "IADD3", "LEA", "SEL", "ISETP", "PRMT", "FLO", "POPC", "IABS",
               "IMNMX", "VIMNMX", "BMSK", "SGXT", "PLOP3", "MOV", "P2R", "R2P"}
FMA_OPCODES = {"IMAD", "IMUL", "VIADD"}


def log(msg: str) -> None:
    print(msg, flush=True)


class Failure(RuntimeError):
    """A check of this run failed."""


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )  # fmt: skip
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )  # fmt: skip
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def k2_keystream_sass(lib: Path, n_limb: int) -> dict | None:
    """Instructions per ChaCha20 block of K2's keystream loop, by pipe, read
    from the built library's SASS (``cuobjdump -sass``) of
    ``mf_mask_fold_kernel<n_limb>``. The round loop is the innermost
    backward branch holding a double round's 32 xors (LOP3); when it holds
    fewer than a block's 320, it runs 320 / (its LOP3) times inside the
    innermost loop around it, the block loop. None if the tool or the loops
    are not found."""
    import re
    from collections import Counter

    from xaynet_tpu_torch.ops import kernels

    tool = Path(kernels.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120).stdout
    fns = [c for c in text.split("Function : ")[1:]
           if f"mf_mask_fold_kernelILi{n_limb}E" in c.split(None, 1)[0]]
    if not fns:
        return None
    pat = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
    ins = [(int(a, 16), op, args) for a, op, args in pat.findall(fns[0])]
    loops = []  # (first, last address) of each backward branch
    for addr, op, args in ins:
        target = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if target and int(target.group(1), 16) < addr:
            loops.append((int(target.group(1), 16), addr))

    def body(loop):
        return Counter(o for a, o, _ in ins if loop[0] <= a <= loop[1])

    def lop3(loop):
        return sum(n for o, n in body(loop).items() if o.startswith("LOP3"))

    rounds = [lp for lp in loops if lop3(lp) >= 32]
    if not rounds:
        return None
    inner = min(rounds, key=lambda lp: lp[1] - lp[0])
    per_block = body(inner)
    if lop3(inner) < 320:
        trips, rest = divmod(320, lop3(inner))
        outer = [lp for lp in loops if lp[0] <= inner[0] and inner[1] <= lp[1] and lp != inner]
        if rest or not outer:
            return None
        per_block = body(min(outer, key=lambda lp: lp[1] - lp[0]))
        for op, n in body(inner).items():
            per_block[op] += (trips - 1) * n
    kinds = Counter()
    for op, n in per_block.items():
        base = op.split(".")[0]
        kinds["alu" if base in ALU_OPCODES else "fma" if base in FMA_OPCODES else "other"] += n
    return {"alu": kinds["alu"], "fma": kinds["fma"], "other": kinds["other"],
            "by_opcode": dict(per_block.most_common())}


class Smoke:
    def __init__(self, args):
        import torch

        self.torch = torch
        self.args = args
        self.dev = torch.device(args.device)
        self.cuda = self.dev.type == "cuda"
        self.rng = np.random.default_rng(args.seed)
        self.records: dict = {"checks": []}
        self.max_err = dict.fromkeys(
            ("fold_planar", "fold_packed", "mask_fold", "wire_unpack", "packed_check"), 0
        )
        self.sass = None
        self.phase_b_out: dict | None = None  # Phase B's wires and results, for Phase W

    # -- helpers ------------------------------------------------------------

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def sync_current_stream(self) -> None:
        if self.cuda:
            self.torch.cuda.current_stream().synchronize()

    def check(self, ok: bool, what: str) -> None:
        self.records["checks"].append({"check": what, "ok": bool(ok)})
        if not ok:
            raise Failure(what)

    def compare(self, name: str, got, want, what: str) -> None:
        """Byte-exact comparison of two uint32/int64 tensors; records the
        largest absolute difference for the kernel table."""
        from xaynet_tpu_torch.ops.fold import widen

        torch = self.torch
        g = widen(got) if got.dtype == torch.uint32 else got.to(torch.int64)
        w = widen(want) if want.dtype == torch.uint32 else want.to(torch.int64)
        err = int((g - w).abs().max()) if g.numel() else 0
        self.max_err[name] = max(self.max_err[name], err)
        self.check(g.shape == w.shape and err == 0, f"{name}: {what} (max |diff| {err})")

    def time_ms(self, fn, reps: int) -> float:
        """Mean milliseconds per call of ``fn`` after one warm-up call, from
        CUDA events around ``reps`` calls (host clock around a synchronize
        on the CPU rehearsal)."""
        torch = self.torch
        fn()
        self.sync()
        if not self.cuda:
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t) * 1e3 / reps
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def elements(self, order: int, n_limb: int, shape: tuple[int, ...]) -> np.ndarray:
        """Random group elements as planar limbs ``uint32[*shape[:-1], L, n]``
        (top limb below the order's, so every element is valid; every 97th
        column is order - 1 to drive the carries)."""
        from xaynet_tpu_torch.ops import limbs

        *lead, n = shape
        out = self.rng.integers(0, 1 << 32, size=(*lead, n_limb, n), dtype=np.uint64)
        out = out.astype(np.uint32)
        if order != 1 << (32 * n_limb):
            top = int(limbs.int_to_limbs(order, n_limb)[-1])
            out[..., n_limb - 1, :] = self.rng.integers(0, top, size=(*lead, n), dtype=np.uint64)
            out[..., ::97] = limbs.int_to_limbs(order - 1, n_limb)[:, None]
        return out

    # -- set-up -------------------------------------------------------------

    def build(self) -> None:
        from xaynet_tpu_torch.ops import kernels

        t = time.perf_counter()
        libs = kernels.build()
        for name in libs:
            kernels.load(name)
        dt = time.perf_counter() - t
        logs = {name: lib.with_suffix(".log").read_text() for name, lib in libs.items()}
        self.records["build"] = {"seconds": dt, "nvcc_logs": logs,
                                 "libraries": {n: str(p) for n, p in libs.items()}}
        log(f"[setup] built {sorted(libs)} with nvcc in {dt:.1f} s (into {kernels.build_dir()})")
        self.sass = k2_keystream_sass(libs["mask_fold"], n_limb=2)
        self.records["k2_sass"] = self.sass
        if self.sass:
            log(f"[setup] K2 keystream loop in SASS, per ChaCha block: ALU pipe {self.sass['alu']}, "
                f"FMA pipe {self.sass['fma']}, other {self.sass['other']} instructions")
        else:
            log("[setup] K2 keystream loop not found in SASS")

    # -- phase A: each kernel against its plain version ---------------------

    def phase_a_fold(self) -> None:
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.ops import kernels, limbs
        from xaynet_tpu_torch.ops.fold import to_device_u32

        torch = self.torch
        cfgs = [
            ("L2 prime", MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)),
            ("L3", MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M9)),
            ("L3 2^96", MaskConfig(GroupType.POWER2, DataType.I32, BoundType.BMAX, ModelType.M9)),
            ("L10", MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.BMAX, ModelType.M3)),
            ("L66 2^2112", MaskConfig(GroupType.POWER2, DataType.F64, BoundType.BMAX, ModelType.M3)),
            ("L67", MaskConfig(GroupType.INTEGER, DataType.F64, BoundType.BMAX, ModelType.M12)),
        ]
        cases = []
        for label, cfg in cfgs:
            n = 100_003 if "L6" not in label else 20_011  # ragged: no multiple of the block
            for k in (1, 8, 64):
                cases.append((label, cfg.order, k, n))
        cases.append(("L2 prime", cfgs[0][1].order, 65535, 64))
        cases.append(("L3 2^96", cfgs[2][1].order, 65535, 64))
        for label, order, k, n in cases:
            n_limb = limbs.n_limbs_for_order(order)
            bpn = limbs.wire_width_for(order)
            acc0 = self.elements(order, n_limb, (n,))
            stack = self.elements(order, n_limb, (k, n))
            acc_dev = to_device_u32(acc0, self.dev)
            stack_dev = to_device_u32(stack, self.dev)
            got = kernels.fold_planar(acc_dev.clone(), stack_dev, order)
            want = kernels.fold_planar_plain(acc_dev.clone(), stack_dev, order)
            self.compare("fold_planar", got, want, f"planar {label} K={k} n={n}")
            packed = torch.from_numpy(limbs.pack_planar(stack, bpn)).to(self.dev)
            got = kernels.fold_packed(acc_dev.clone(), packed, order)
            want = kernels.fold_packed_plain(acc_dev.clone(), packed, order)
            self.compare("fold_packed", got, want, f"packed {label} K={k} n={n} bpn={bpn}")
            del acc_dev, stack_dev, packed, got, want
        self.sync()
        log(f"[phase A] K1 planar and packed byte-exact vs plain in {len(cases)} cases each")

    def phase_a_mask_fold(self) -> None:
        from xaynet_tpu_torch.core.crypto.prng import StreamSampler
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.ops import kernels, limbs
        from xaynet_tpu_torch.ops.fold import to_device_u32, to_numpy_u32, zeros_u32

        cfgs = [
            ("prime L2 draw6", MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)),
            ("L2 draw8", MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B2, ModelType.M6)),
            ("L3 wire11 draw12", MaskConfig(GroupType.POWER2, DataType.F32, BoundType.B4, ModelType.M12)),
            ("L4 wire16 draw17", MaskConfig(GroupType.POWER2, DataType.F64, BoundType.B6, ModelType.M12)),
            ("L10 draw37", MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.BMAX, ModelType.M3)),
            ("L67 draw268", MaskConfig(GroupType.INTEGER, DataType.F64, BoundType.BMAX, ModelType.M12)),
        ]
        n_cases = 0
        for label, cfg in cfgs:
            order = cfg.order
            n_limb = limbs.n_limbs_for_order(order)
            bpn = limbs.draw_width_for(order)
            count = 3000 if n_limb < 60 else 300
            seeds = [self.rng.bytes(32) for _ in range(3)]
            kws = to_device_u32(np.stack([np.frombuffer(s, "<u4") for s in seeds]), self.dev)
            # unit-draw cursors, pushed mid-block
            offs = []
            for i, s in enumerate(seeds):
                sampler = StreamSampler(s)
                sampler.draw_limbs(1, order)
                offs.append(sampler.consumed_bytes + 17 * i + 5)
            expected = count * (1 << (8 * bpn)) // order
            for chunk in (None, max(7, expected // 5)):
                acc0 = self.elements(order, n_limb, (count,))
                got_acc, got_end = kernels.mask_fold(
                    to_device_u32(acc0, self.dev), kws, offs, count, order, chunk
                )
                want_acc, want_end = kernels.mask_fold_plain(
                    to_device_u32(acc0, self.dev), kws, offs, count, order, chunk
                )
                what = f"{label} B=3 count={count} chunk={chunk}"
                self.compare("mask_fold", got_acc, want_acc, what + " acc")
                self.compare("mask_fold", got_end, want_end, what + " end cursors")
                n_cases += 1
            # the mask itself, against the host sampler: one seed into a zero acc
            small = 200
            acc, end = kernels.mask_fold(zeros_u32((n_limb, small), self.dev), kws[:1], offs[:1],
                                         small, order)
            sampler = StreamSampler(seeds[0])
            sampler.skip_bytes(offs[0])
            host = sampler.draw_limbs(small, order)
            self.check(
                np.array_equal(to_numpy_u32(acc).T, host) and int(end[0]) == sampler.consumed_bytes,
                f"mask_fold: {label} mask and cursor == host StreamSampler",
            )
        self.sync()
        log(f"[phase A] K2 byte-exact vs plain in {n_cases} group cases; masks == host sampler")

    def phase_a_look_back(self) -> None:
        """K2's single pass where its decoupled look-back and early exit
        have edges, on the main order (draw width 6): the count-th
        acceptance inside tile 0, as the last of tile 0 or 1 and the first
        of tile 1; count 1; a trip 200 tiles long for 300 elements (the
        done flag); seven trips; cursors past 2^31 bytes and 2^32 blocks; a
        16-seed group from mid-block cursors; and twenty launches in a row
        into one accumulator (a stale status word would shift a prefix).
        Each against the plain version (acc and end cursors), and the first
        seed's mask and cursor against the host ``StreamSampler``."""
        from xaynet_tpu_torch.core.crypto.prng import StreamSampler
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.ops import chacha, kernels, limbs
        from xaynet_tpu_torch.ops.fold import to_device_u32, to_numpy_u32, zeros_u32

        order = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3).order
        bpn, tile = limbs.draw_width_for(order), kernels.plan_trips(1, order).tile
        seed = self.rng.bytes(32)
        kw = np.frombuffer(seed, "<u4")
        cand = chacha.chop_candidates(chacha.keystream_bytes(kw.tolist(), 6, 2 * tile * bpn),
                                      2 * tile, bpn)
        order_cl = tuple(int(x) for x in limbs.int_to_limbs(order, cand.shape[1]))
        acc0, acc1 = chacha.accept_mask(cand, order_cl).view(2, tile).sum(1).tolist()
        group = [self.rng.bytes(32) for _ in range(16)]
        cases = [  # (label, seeds, start cursors, count, chunk_candidates)
            ("count in tile 0", [seed], [6], acc0 // 2, None),
            ("last of tile 0", [seed], [6], acc0, None),
            ("first of tile 1", [seed], [6], acc0 + 1, None),
            ("last of tile 1", [seed], [6], acc0 + acc1, None),
            ("count 1", [seed], [6], 1, None),
            ("early exit", [seed], [6], 300, 200 * tile),
            ("seven trips", [seed], [6], 3000, 3000 * (1 << 8 * bpn) // order // 7 + 13),
            ("cursor above 2^31", [seed], [2**31 + 12345], 2000, None),
            ("block counter above 2^32", [seed], [2**38 + 7], 2000, None),
            ("B=16 mid-block", group, [13 * i + 5 for i in range(16)], 5000, None),
        ]
        for label, seeds, offs, count, chunk in cases:
            kws = to_device_u32(np.stack([np.frombuffer(s, "<u4") for s in seeds]), self.dev)
            acc = to_device_u32(self.elements(order, 2, (count,)), self.dev)
            got, ends = kernels.mask_fold(acc.clone(), kws, offs, count, order, chunk)
            want, want_ends = kernels.mask_fold_plain(acc.clone(), kws, offs, count, order, chunk)
            what = f"look-back: {label} (count={count}, chunk={chunk})"
            self.compare("mask_fold", got, want, what + " acc")
            self.compare("mask_fold", ends, want_ends, what + " end cursors")
            mask, end = kernels.mask_fold(zeros_u32((2, count), self.dev), kws[:1], offs[:1],
                                          count, order, chunk)
            sampler = StreamSampler(seeds[0])
            sampler.skip_bytes(offs[0])
            host = sampler.draw_limbs(count, order)
            self.check(
                np.array_equal(to_numpy_u32(mask).T, host) and int(end[0]) == sampler.consumed_bytes,
                f"{what}: mask and cursor == host StreamSampler",
            )
        count = 20_000
        acc = to_device_u32(self.elements(order, 2, (count,)), self.dev)
        want = acc.clone()
        for i in range(20):
            kws = to_device_u32(np.frombuffer(self.rng.bytes(32), "<u4")[None].copy(), self.dev)
            _, end = kernels.mask_fold(acc, kws, [7 * i], count, order)
            _, want_end = kernels.mask_fold_plain(want, kws, [7 * i], count, order)
            self.compare("mask_fold", end, want_end, f"look-back: launch {i + 1} of 20 end cursor")
        self.compare("mask_fold", acc, want, "look-back: 20 launches into one acc")
        self.sync()
        log(f"[phase A] K2 look-back edge cases byte-exact vs plain and host sampler "
            f"({len(cases)} cases, tile {tile} candidates; 20 launches into one acc)")

    def phase_a_main_shapes(self) -> dict:
        """Each kernel at the main path's shapes: checked against its plain
        version there, and timed (kernel and plain) with CUDA events."""
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.core.crypto.prng import StreamSampler
        from xaynet_tpu_torch.ops import chacha, kernels, limbs
        from xaynet_tpu_torch.ops.fold import to_device_u32

        torch = self.torch
        args = self.args
        order = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3).order
        n, k = args.length, args.batch
        n_limb, bpn = limbs.n_limbs_for_order(order), limbs.wire_width_for(order)
        timings = {}

        acc0 = to_device_u32(self.elements(order, n_limb, (n,)), self.dev)
        stack = self.elements(order, n_limb, (k, n))
        packed = torch.from_numpy(limbs.pack_planar(stack, bpn)).to(self.dev)
        del stack
        got = kernels.fold_packed(acc0.clone(), packed, order)
        want = kernels.fold_packed_plain(acc0.clone(), packed, order)
        self.compare("fold_packed", got, want, f"main shape uint8[{k}, {bpn}, {n}]")
        del got, want
        acc = acc0.clone()
        timings["fold_packed"] = {
            "ms": self.time_ms(lambda: kernels.fold_packed(acc, packed, order), 10),
            "plain_ms": self.time_ms(lambda: kernels.fold_packed_plain(acc, packed, order), 2),
            "bytes": packed.numel() + 2 * acc.numel() * 4,
            "shape": f"uint8[{k},{bpn},{n}] into uint32[{n_limb},{n}]",
        }
        del packed

        one = to_device_u32(self.elements(order, n_limb, (1, n)), self.dev)
        got = kernels.fold_planar(acc0.clone(), one, order)
        want = kernels.fold_planar_plain(acc0.clone(), one, order)
        self.compare("fold_planar", got, want, f"main shape uint32[1, {n_limb}, {n}]")
        del got, want
        timings["fold_planar"] = {
            "ms": self.time_ms(lambda: kernels.fold_planar(acc, one, order), 10),
            "plain_ms": self.time_ms(lambda: kernels.fold_planar_plain(acc, one, order), 2),
            "bytes": one.numel() * 4 + 2 * acc.numel() * 4,
            "shape": f"uint32[1,{n_limb},{n}] into uint32[{n_limb},{n}]",
        }
        del one, acc

        seeds = [self.rng.bytes(32) for _ in range(2)]
        kws = to_device_u32(np.stack([np.frombuffer(s, "<u4") for s in seeds]), self.dev)
        offs = []
        for s in seeds:
            sampler = StreamSampler(s)
            sampler.draw_limbs(1, order)
            offs.append(sampler.consumed_bytes)
        got_acc, got_end = kernels.mask_fold(acc0.clone(), kws, offs, n, order)
        t = time.perf_counter()
        want_acc, want_end = kernels.mask_fold_plain(acc0.clone(), kws, offs, n, order)
        self.sync()
        plain_s = (time.perf_counter() - t) / len(seeds)
        self.compare("mask_fold", got_acc, want_acc, f"main shape count={n} B={len(seeds)} acc")
        self.compare("mask_fold", got_end, want_end, f"main shape count={n} end cursors")
        del got_acc, want_acc
        acc = acc0.clone()
        ms = self.time_ms(lambda: kernels.mask_fold(acc, kws[:1], offs[:1], n, order), 5)
        # the keystream this seed's data needs: start cursor to end cursor
        blocks = (int(got_end[0]) - offs[0]) / 64
        timings["mask_fold"] = {
            "ms": ms,
            "plain_ms": plain_s * 1e3,
            "blocks": blocks,
            "bytes": 2 * acc.numel() * 4,
            "candidates": chacha.provision_candidates(n, order),
            "shape": f"one seed, count={n} into uint32[{n_limb},{n}]",
        }
        del acc, acc0
        if self.cuda:
            torch.cuda.empty_cache()
        for name, t in timings.items():
            log(f"[phase A] {name} at main shape {t['shape']}: {t['ms']:.3f} ms (plain {t['plain_ms']:.1f} ms)")
        return timings

    def phase_a_wire(self) -> None:
        """K3 and K4 against their plain versions over four configs and K in
        {1, 3, 8, 64} at a ragged length, with planted invalid elements
        (module docstring). The verdicts are also held against the planted
        pattern: updates 0, K/2 and K-1 rejected (K >= 3), the others not;
        at the 2^96 boundary none. With K >= 8, update 1 also holds
        ``order + 256^b`` and update 2 ``order - 256^b`` for every plane b,
        so K4 decides elements at each plane (update 1 rejected)."""
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.ops import kernels, limbs

        torch = self.torch
        cfgs = [
            ("prime L2 bpn6", MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)),
            ("L2 bpn7", MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6)),
            ("L3 2^96", MaskConfig(GroupType.POWER2, DataType.I32, BoundType.BMAX, ModelType.M9)),
            ("prime L4 bpn13", MaskConfig(GroupType.PRIME, DataType.F64, BoundType.B6, ModelType.M3)),
        ]
        n = 100_003  # ragged: no multiple of the block, rows not 16-byte aligned
        n_cases = 0
        for label, cfg in cfgs:
            order, bpn = cfg.order, cfg.bytes_per_number
            n_limb = limbs.n_limbs_for_order(order)
            pow2 = order == 1 << (32 * n_limb)
            for k in (1, 3, 8, 64):
                stack = self.elements(order, n_limb, (k, n))  # planar [K, L, n]
                edge = limbs.int_to_limbs(order - 1, n_limb)
                stack[:, :, 0] = stack[:, :, n - 1] = edge  # valid edges
                want_bad = set()
                if k >= 3:
                    ones = limbs.int_to_limbs((1 << (8 * bpn)) - 1, n_limb)
                    stack[0, :, 0] = ones
                    stack[k - 1, :, n - 1] = ones
                    if not pow2:
                        stack[k // 2, :, n // 2] = limbs.int_to_limbs(order, n_limb)
                        want_bad = {0, k // 2, k - 1}
                if k >= 8 and order < 1 << (8 * bpn):
                    # decided at plane b, the planes above tying the order's:
                    # order + 256^b (invalid) in update 1, order - 256^b in 2
                    for b in range(bpn):
                        up = order + (1 << (8 * b))
                        if up < 1 << (8 * bpn):
                            stack[1, :, 1 + b] = limbs.int_to_limbs(up, n_limb)
                            want_bad.add(1)
                        stack[2, :, 1 + b] = limbs.int_to_limbs(order - (1 << (8 * b)), n_limb)
                packed_np = limbs.pack_planar(stack, bpn)  # [K, bpn, n]
                wire_np = np.ascontiguousarray(packed_np.transpose(0, 2, 1)).reshape(k, n * bpn)
                del stack
                raw = torch.from_numpy(wire_np).to(self.dev)
                packed = torch.from_numpy(packed_np).to(self.dev)
                what = f"{label} K={k} n={n}"
                planar, bad = kernels.wire_unpack(raw, order)
                want_planar, want = kernels.wire_unpack_plain(raw, order)
                self.compare("wire_unpack", planar, want_planar, what + " planar")
                self.compare("wire_unpack", bad, want, what + " verdicts")
                got = kernels.packed_check(packed, order)
                self.compare("packed_check", got, kernels.packed_check_plain(packed, order),
                             what + " verdicts")
                rejected = {i for i, b in enumerate(bad.view(torch.int32).tolist()) if b}
                self.check(rejected == want_bad, f"wire: {what} rejects updates {sorted(want_bad)}")
                self.check(torch.equal(got.view(torch.int32), bad.view(torch.int32)),
                           f"wire: {what} K4 and K3 agree")
                if k == 8:  # K4 from bases that are not 16-byte aligned
                    buf = torch.empty(packed.numel() + 16, dtype=torch.uint8, device=self.dev)
                    for off in (1, 7, 15):
                        shifted = buf[off : off + packed.numel()].view(packed.shape)
                        shifted.copy_(packed)
                        self.compare("packed_check", kernels.packed_check(shifted, order), got,
                                     f"{what} verdicts, base + {off} bytes")
                    del buf, shifted
                del raw, packed, planar, bad, want_planar, want, got
                n_cases += 1
        self.sync()
        log(f"[phase A] K3 and K4 byte-exact vs plain in {n_cases} cases "
            "(planted invalid elements rejected, order - 1 accepted)")

    def phase_a_wire_main(self) -> None:
        """One batch of 64 updates at the main length, made on the card with
        valid elements (top byte below the order's) plus three planted
        invalid ones: K3 over it as interleaved blocks ``uint8[64, n * bpn]``
        and K4 over the same bytes as planes ``uint8[64, bpn, n]`` (valid
        either way), each update against the plain version alone. Then both
        kernels timed over its first ``batch`` updates beside their plain
        versions: no element there ties the order's top byte, so K4 reads
        the top plane only (a reading kept in the records; the kernel line
        times K3 and K4 at Phase W's launches, on its data)."""
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.ops import kernels, limbs

        torch = self.torch
        cfg = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)
        order, bpn = cfg.order, cfg.bytes_per_number
        n_limb = limbs.n_limbs_for_order(order)
        n, k_all, k = self.args.length, 64, self.args.batch
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.args.seed)
        raw = torch.randint(0, 256, (k_all, n * bpn), dtype=torch.uint8, device=self.dev,
                            generator=gen)
        # below the order's top byte, as an element's top byte (K3) and as
        # the top plane (K4)
        top = order.to_bytes(bpn, "little")[-1]
        low = (1 << (top.bit_length() - 1)) - 1
        raw.view(k_all, n, bpn)[:, :, bpn - 1].bitwise_and_(low)
        raw.view(k_all, bpn, n)[:, bpn - 1].bitwise_and_(low)
        plants = {0: 0, k_all // 2: n // 2, k_all - 1: n - 1}  # update -> element
        for row, col in plants.items():
            value = (1 << (8 * bpn)) - 1 if row != k_all // 2 else order
            raw[row, col * bpn : (col + 1) * bpn] = torch.tensor(
                list(value.to_bytes(bpn, "little")), dtype=torch.uint8)
        planar, bad = kernels.wire_unpack(raw, order)
        packed = raw.view(k_all, bpn, n)
        bad4 = kernels.packed_check(packed, order)
        what = f"64 updates x {n} ({raw.numel()} bytes)"
        for r in range(k_all):
            want_planar, want = kernels.wire_unpack_plain(raw[r : r + 1], order)
            self.compare("wire_unpack", planar[r : r + 1], want_planar, f"{what}: update {r} planar")
            self.compare("wire_unpack", bad[r : r + 1], want, f"{what}: update {r} verdict")
            self.compare("packed_check", bad4[r : r + 1],
                         kernels.packed_check_plain(packed[r : r + 1], order),
                         f"{what}: update {r} K4 verdict")
            del want_planar, want
        rejected = {i for i, b in enumerate(bad.view(torch.int32).tolist()) if b}
        self.check(rejected == set(plants), f"wire: {what} rejects exactly updates {sorted(plants)}")
        del planar, bad, bad4
        if self.cuda:
            torch.cuda.empty_cache()
        past = " (byte offsets past 2^32)" if raw.numel() > 1 << 32 else ""
        log(f"[phase A] K3 and K4 byte-exact vs plain over {what}{past}")

        batch = raw[:k]  # the main path's group: contiguous, valid
        got_planar, got_bad = kernels.wire_unpack(batch, order)
        want_planar, want_bad = kernels.wire_unpack_plain(batch, order)
        self.compare("wire_unpack", got_planar, want_planar, f"main shape uint8[{k}, {n * bpn}]")
        self.compare("wire_unpack", got_bad, want_bad, f"main shape uint8[{k}, {n * bpn}] verdicts")
        del got_planar, want_planar
        planes = batch.view(k, bpn, n)
        self.compare("packed_check", kernels.packed_check(planes, order),
                     kernels.packed_check_plain(planes, order), f"main shape uint8[{k}, {bpn}, {n}]")
        timed = self.records["wire_synthetic"] = {}
        timed["wire_unpack"] = {
            "ms": self.time_ms(lambda: kernels.wire_unpack(batch, order), 10),
            "plain_ms": self.time_ms(lambda: kernels.wire_unpack_plain(batch, order), 2),
            "bytes": batch.numel() + k * n_limb * n * 4 + 4 * k,
            "shape": f"uint8[{k},{n * bpn}] into uint32[{k},{n_limb},{n}]",
        }
        timed["packed_check"] = {
            "ms": self.time_ms(lambda: kernels.packed_check(planes, order), 10),
            "plain_ms": self.time_ms(lambda: kernels.packed_check_plain(planes, order), 2),
            "bytes": planes.numel() // bpn + 4 * k,  # the top plane decides
            "shape": f"uint8[{k},{bpn},{n}]",
        }
        del raw, batch, planes
        if self.cuda:
            torch.cuda.empty_cache()
        for name, t in timed.items():
            log(f"[phase A] {name} over {t['shape']}, no ties with the order's top byte: "
                f"{t['ms']:.3f} ms (plain {t['plain_ms']:.1f} ms)")

    # -- phase P: the streaming pipeline ------------------------------------

    def phase_pipeline(self) -> dict:
        """The Update fold's streaming pipeline on the card (checks (p1)-(p4),
        module docstring), on the shipped config, each against the plain
        sequential fold of the same batches on the CPU."""
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.ops import limbs
        from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator
        from xaynet_tpu_torch.parallel.streaming import StreamingAggregator, StreamingError
        from xaynet_tpu_torch.resilience import faults

        cfg = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)
        order = cfg.order
        found: dict = {}

        def batches(n: int, count: int, k: int) -> list[np.ndarray]:
            """``count`` wire-layout batches ``uint32[k, n, L]``."""
            return [np.ascontiguousarray(self.elements(order, 2, (k, n)).transpose(0, 2, 1))
                    for _ in range(count)]

        def plain(n: int, wires: list) -> DeviceAggregator:
            ref = DeviceAggregator(cfg, n, device="cpu")
            for w in wires:
                ref.add_batch(w)
            return ref

        def streamed(n: int, wires: list, **kw):
            agg = DeviceAggregator(cfg, n, device=self.dev)
            return agg, StreamingAggregator(agg, max_batch=wires[0].shape[0], **kw)

        def same(agg, ref, what: str) -> None:
            self.check(np.array_equal(agg.snapshot(), ref.snapshot())
                       and agg.nb_models == ref.nb_models, what)

        def poisoned(call, what: str) -> None:
            try:
                call()
            except StreamingError:
                self.check(True, what)
                return
            self.check(False, what)

        # (p1) streamed == plain sequential == big-int sums, both layouts
        n, k, count = 1_000_003, 8, 6
        wires = batches(n, count, k)
        ref = plain(n, wires)
        idx = np.sort(self.rng.choice(n, size=2048, replace=False))
        want = [0] * len(idx)
        for w in wires:
            for row in w:
                want = [(a + b) % order for a, b in zip(want, limbs.limbs_to_ints(row[idx]))]
        for packed in (True, False):
            kind = "packed" if packed else "planar"
            agg, stream = streamed(n, wires, packed=packed)
            self.check(stream._packed == packed, f"(p1) {kind} staging in use")
            for w in wires:
                stream.submit_batch(w)
            stream.drain()
            same(agg, ref, f"(p1) {kind}: streamed == plain sequential fold, "
                           f"{count} batches of {k} x {n}, equal nb_models")
            self.check(limbs.limbs_to_ints(agg.snapshot()[idx]) == want,
                       f"(p1) {kind}: aggregate == big-int sums at {len(idx)} positions")
            stream.close()

        # (p2) dispatch-ahead stress with a jittered fold seam
        n, k, count = 262_147, 4, 32
        wires = batches(n, count, k)
        ref = plain(n, wires)
        agg, stream = streamed(n, wires, staging_buffers=4, dispatch_ahead=3)
        real_fold = agg._packed_fold_fn
        jitter = iter(self.rng.uniform(0.0, 0.004, size=count))
        sizes, in_flight = [], []

        def slow_fold(acc, staged):
            time.sleep(float(next(jitter)))
            sizes.append(int(staged.shape[0]))
            in_flight.append(stream.in_flight_models)
            return real_fold(acc, staged)

        agg._packed_fold_fn = slow_fold
        for w in wires:
            stream.submit_batch(w)
        stream.drain()
        same(agg, ref, f"(p2) depth 3, 4 buffers, jittered seam: streamed == plain over "
                       f"{count} batches of {k} x {n}")
        self.check(sizes == [k] * count, "(p2) every batch folded once, in order")
        self.check(stream.in_flight_models == 0
                   and all(r.in_use == 0 for r in stream._rings.values()),
                   "(p2) nothing in flight, every ring buffer back")
        found["p2_max_in_flight_models"] = max(in_flight)
        found["p2_ring_buffers"] = stream._rings["packed"].allocated
        stream.close()

        # (p3) one streaming.fold fault: degrade, stay exact
        n, k, count = 65_537, 4, 6
        wires = batches(n, count, k)
        ref = plain(n, wires)
        faults.install_plan(faults.FaultPlan.parse("streaming.fold:error,nth=2"))
        try:
            agg, stream = streamed(n, wires)
            for w in wires:
                stream.submit_batch(w)
            stream.drain()
            self.check(stream.degraded, "(p3) a streaming.fold fault degraded the pipeline")
            same(agg, ref, "(p3) degraded pipeline: aggregate == plain sequential fold")
            stream.close()

            # (p4) the fault site, then the retry's upload: poisoned for good
            faults.install_plan(faults.FaultPlan.parse("streaming.fold:error,nth=2"))
            agg, stream = streamed(n, wires)
            stream.submit_batch(wires[0])
            stream.drain()

            def failed_copy(payload):
                raise RuntimeError("host-to-device copy failed (injected)")

            stream._upload = failed_copy
            stream.submit_batch(wires[1])
            poisoned(stream.drain, "(p4) fault on both tries: drain raises StreamingError")
            poisoned(stream.drain, "(p4) a later drain raises StreamingError again")
            poisoned(lambda: stream.submit_batch(wires[2]), "(p4) a later submit raises")
            self.check(stream.degraded and agg.nb_models == k and stream.in_flight_models == 0,
                       "(p4) the lost batch left flight uncounted")
            stream.close()
        finally:
            faults.clear_plan()
        self.sync()
        log(f"[phase P] pipeline checks (p1)-(p4) passed; (p2) producer ran up to "
            f"{found['p2_max_in_flight_models']} models ahead of the folds, "
            f"{found['p2_ring_buffers']} ring buffers")
        return found

    # -- phase B: the main path ---------------------------------------------

    def phase_b(self) -> dict:
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.core.mask.model import Scalar
        from xaynet_tpu_torch.core.mask.object import MaskObject, MaskUnit, MaskVect
        from xaynet_tpu_torch.core.mask.serialization import serialize_mask_object
        from xaynet_tpu_torch.ops import kernels, limbs, masking
        from xaynet_tpu_torch.server.aggregation import StagedAggregator

        args = self.args
        cfg = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)
        pair = cfg.pair()
        order, length, n_up = cfg.order, args.length, args.updates
        rng = np.random.default_rng(args.seed + 1)
        seeds = [rng.bytes(32) for _ in range(n_up)]
        scalar = Scalar(Fraction(1, n_up))
        idx = np.sort(rng.choice(length, size=min(2048, length), replace=False))
        walls = {"participants_mask": 0.0, "update_aggregate": 0.0}
        sampled, units, wires = [], [], []
        serialize_s = 0.0
        wsum = np.zeros(length, dtype=np.float64)

        torch = self.torch
        kernels.reset_launches()
        t_round = time.perf_counter()
        agg = StagedAggregator(pair, length, batch_size=args.batch, device=self.dev)
        # K1 packed's device time inside the pipeline: CUDA events around
        # the fold seam, on the stream the worker folds on
        fold_events = []
        pipeline_fold = agg._device._packed_fold_fn

        def timed_fold(acc, staged):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            pipeline_fold(acc, staged)
            end.record()
            fold_events.append((start, end))

        if self.cuda:
            agg._device._packed_fold_fn = timed_fold
        for i in range(n_up):
            weights = rng.uniform(-0.9, 0.9, length).astype(np.float32)
            wsum += weights
            t = time.perf_counter()
            obj = masking.mask_update(seeds[i], scalar, weights, pair, device=self.dev)
            self.sync_current_stream()  # the folds in flight on their own stream run on
            walls["participants_mask"] += time.perf_counter() - t
            sampled.append(obj.vect.data[idx].copy())
            units.append(obj.unit.data.copy())
            # Phase W's input, outside the walls: v1 for even, v2 for odd updates
            t = time.perf_counter()
            wires.append(serialize_mask_object(obj, planar_vect=i % 2 == 1))
            serialize_s += time.perf_counter() - t
            t = time.perf_counter()
            agg.validate_aggregation(obj)
            agg.aggregate(obj)  # every batch-th update: flush submits, does not fold
            walls["update_aggregate"] += time.perf_counter() - t
            del obj, weights
        ring = agg._stream._rings.get("packed")
        pipeline = agg._stream
        t = time.perf_counter()
        final = agg.finalize_inplace()  # the drain
        self.sync()
        walls["finalize"] = time.perf_counter() - t
        t = time.perf_counter()
        unit_m, vect_m = masking.sum_masks(seeds, length, pair, seed_batch=args.batch, device=self.dev)
        self.sync()
        walls["sum2_sum_masks"] = time.perf_counter() - t
        mask = MaskObject(MaskVect(pair.vect, vect_m), MaskUnit(pair.unit, unit_m))
        t = time.perf_counter()
        final.validate_unmasking(mask)
        walls["validate_unmasking"] = time.perf_counter() - t
        t = time.perf_counter()
        model = final.unmask_array(mask)
        self.sync()
        walls["unmask_array"] = time.perf_counter() - t
        # the serialization for Phase W is not part of Phase B's round
        walls["round_total"] = time.perf_counter() - t_round - serialize_s
        launches = dict(kernels.LAUNCHES)

        # (a) aggregate == python big-int modular sums at sampled positions
        got = final.object
        agg_ints = limbs.limbs_to_ints(got.vect.data[idx])
        want_ints = [0] * len(idx)
        for rows in sampled:
            for j, v in enumerate(limbs.limbs_to_ints(rows)):
                want_ints[j] = (want_ints[j] + v) % order
        self.check(agg_ints == want_ints, f"(a) aggregate == big-int sums at {len(idx)} positions")
        # (b) unit part and model count
        unit_want = sum(limbs.limbs_to_int(u) for u in units) % pair.unit.order
        self.check(limbs.limbs_to_int(got.unit.data) == unit_want, "(b) unit aggregate")
        self.check(final.nb_models == n_up, f"(b) nb_models == {n_up}")
        # (c) decoded model within the protocol tolerance of the f32 mean
        self.check(model.shape == (length,) and bool(np.all(np.isfinite(model))),
                   "(c) model finite, of the model length")
        tol = n_up / cfg.exp_shift + 1e-6
        err = float(np.max(np.abs(model - wsum / n_up)))
        self.check(err <= tol, f"(c) |model - mean| = {err:.3e} <= {tol:.3e}")
        # (d) the main path went through the kernels
        flushes = -(-n_up // args.batch)
        if self.cuda:
            self.check(launches["fold_packed"] == flushes, f"(d) K1 packed ran for {flushes} flushes")
            self.check(launches["fold_planar"] == n_up, f"(d) K1 planar added {n_up} masks")
            self.check(launches["mask_fold"] == 2 * n_up,
                       f"(d) K2 derived {2 * n_up} masks (one launch per seed and trip)")
        log(f"[phase B] round of {n_up} updates x {length} params: checks (a)-(d) passed; "
            f"decode max err {err:.3e} <= {tol:.3e}")
        log(f"[phase B] launches {launches}")
        log("[phase B] wall seconds: "
            + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
        stream = self.pipeline_record(pipeline, ring, fold_events)
        log(f"[phase B] serialized the {n_up} updates for Phase W in {serialize_s:.3f} s "
            "(outside the walls)")
        self.phase_b_out = {"wires": wires, "vect": got.vect.data, "unit": got.unit.data,
                            "model": model, "mask": mask}
        return {"walls": walls, "launches": launches, "decode_max_err": err, "pipeline": stream,
                "serialize_s": serialize_s}

    # -- phase W: the Update phase with device wire ingest --------------------

    def phase_w(self, walls_b: dict, timings: dict) -> dict:
        """Phase B's updates again, from their wire bytes through device wire
        ingest (module docstring), checked against Phase B's results; then
        K3 and K4 at the shapes the phase launched them (into ``timings``)."""
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.core.mask.masking import AggregationError
        from xaynet_tpu_torch.core.mask.serialization import VECT_HEADER_LENGTH, parse_mask_object
        from xaynet_tpu_torch.ops import kernels
        from xaynet_tpu_torch.server.aggregation import StagedAggregator

        args = self.args
        b, self.phase_b_out = self.phase_b_out, None
        cfg = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)
        pair, length, bpn, batch = cfg.pair(), args.length, cfg.bytes_per_number, args.batch
        wires = b["wires"]
        n_up = len(wires)
        # the 17th update: update 0's v1 wire with its middle element all 0xFF
        corrupt = bytearray(wires[0])
        at = VECT_HEADER_LENGTH + bpn * (length // 2)
        corrupt[at : at + bpn] = b"\xff" * bpn
        groups = [list(range(s, min(s + batch, n_up))) for s in range(0, n_up, batch)]
        groups[-1].insert(len(groups[-1]) // 2, n_up)  # inside the last group
        messages = [*wires, bytes(corrupt)]
        del corrupt

        walls = dict.fromkeys(("parse", "prevalidate", "update_aggregate"), 0.0)
        objs, rejected = {}, []
        kernels.reset_launches()
        agg = StagedAggregator(pair, length, batch_size=batch, device=self.dev)
        for group in groups:
            t = time.perf_counter()
            for i in group:
                objs[i] = parse_mask_object(messages[i], lazy_vect=True)[0]
            walls["parse"] += time.perf_counter() - t
            t = time.perf_counter()
            agg.prevalidate_wire_batch([objs[i] for i in group])
            walls["prevalidate"] += time.perf_counter() - t
            t = time.perf_counter()
            for i in group:
                try:
                    agg.validate_aggregation(objs[i])
                except AggregationError as e:
                    rejected.append((i, e.kind))
                    continue
                agg.aggregate(objs[i])
            walls["update_aggregate"] += time.perf_counter() - t
        t = time.perf_counter()
        final = agg.finalize_inplace()
        self.sync()
        walls["finalize"] = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        model = final.unmask_array(b["mask"])
        self.sync()
        walls["unmask_array"] = time.perf_counter() - t

        self.check(rejected == [(n_up, "InvalidObject")],
                   f"(w1) the corrupted update alone rejected with InvalidObject ({rejected})")
        self.check(final.nb_models == n_up, f"(w2) nb_models == {n_up}")
        got = final.object
        self.check(np.array_equal(got.vect.data, b["vect"]) and np.array_equal(got.unit.data, b["unit"]),
                   "(w3) accumulator byte-identical to Phase B's")
        self.check(model.dtype == b["model"].dtype and model.tobytes() == b["model"].tobytes(),
                   "(w4) unmask_array with Phase B's mask == Phase B's model, byte for byte")
        self.check(not any(o.vect.materialized for o in objs.values()),
                   "(w5) no update was parsed on the host")
        # launches: one K3 / K4 per group and batch-sized chunk of its v1 / v2
        # members; one K1 per flush and 8-row chunk of its planar / packed rows
        v2 = {i for i in range(n_up) if i % 2 == 1}
        want = dict.fromkeys(kernels.LAUNCHES, 0)
        for group in groups:
            n2 = sum(i in v2 for i in group)
            want["wire_unpack"] += -(-(len(group) - n2) // batch)
            want["packed_check"] += -(-n2 // batch)
        staged = []
        for i in [i for g in groups for i in g if i < n_up] + [None]:
            if i is not None:
                staged.append(i in v2)
            if staged and (len(staged) == batch or i is None):
                want["fold_packed"] += -(-sum(staged) // 8)
                want["fold_planar"] += -(-(len(staged) - sum(staged)) // 8)
                staged = []
        if self.cuda:
            self.check(launches == want, f"(w6) launches {launches} == {want}")
            self.check(all(launches[k] > 0 for k in
                           ("wire_unpack", "packed_check", "fold_planar", "fold_packed")),
                       "(w6) K3, K4 and both K1 variants ran on Phase W's path")
        walls["ingest_total"] = walls["prevalidate"] + walls["update_aggregate"] + walls["finalize"]
        parts = self.phase_w_kernels([[objs[i] for i in g] for g in groups], cfg.order, timings)
        if self.cuda:
            self.check(all(len(timings[k]["launches"]) == launches[k]
                           for k in ("wire_unpack", "packed_check")),
                       "(w7) K3 and K4 held against plain at every shape Phase W launched them")
        log(f"[phase W] {n_up} wire updates + 1 corrupted, groups {[len(g) for g in groups]}: "
            "checks (w1)-(w6) passed")
        log(f"[phase W] launches {launches}")
        log("[phase W] wall seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
            + f"; Phase B in this run: update_aggregate {walls_b['update_aggregate']:.3f}, "
            f"finalize {walls_b['finalize']:.3f}")
        for layout, part in parts.items():
            log(f"[phase W] prevalidate of group 1's {part['members']} {layout} members, again "
                f"outside the walls: np.stack {part['stack_s']:.3f} s, upload of {part['bytes']} "
                f"bytes {part['upload_s']:.3f} s, kernel + verdict fetch {part['kernel_fetch_s']:.4f} s")
        for name in ("wire_unpack", "packed_check"):
            for r in timings[name]["launches"]:
                log(f"[phase W] {name} at group {r['group']}'s {r['shape']}: {r['ms']:.3f} ms, device "
                    f"{r['device_ms'] or float('nan'):.3f} ms, bound {r['bytes'] / MEM_BYTES_PER_S * 1e3:.3f} "
                    f"ms ({r['bytes']} bytes), plain {r['plain_ms']:.1f} ms")
        return {"walls": walls, "launches": launches, "groups": [len(g) for g in groups],
                "prevalidate_parts": parts}

    def phase_w_kernels(self, groups: list[list], order: int, timings: dict) -> dict:
        """K3 and K4 at every shape Phase W launched them, on its data: each
        group's v1 and v2 members stacked and uploaded as
        ``DeviceAggregator.validate_wire_updates`` / ``validate_planar_updates``
        do (this mirrors their steps to time them apart: host ``np.stack``,
        pageable upload, kernel and verdict fetch; returned for group 1),
        the launch held byte-exact against its plain version (planar rows
        and verdicts), timed beside it (CUDA events, and device time from the
        profiler), and its bytes counted from these inputs (K4: only those
        its verdict needs, :meth:`k4_bytes`). ``timings`` gets each kernel's
        launches and their means, which the kernel line reads."""
        from xaynet_tpu_torch.ops import kernels

        torch = self.torch
        runs = {"wire_unpack": [], "packed_check": []}
        parts = {}
        for g, objs in enumerate(groups, 1):
            for planar in (False, True):
                blocks = [o.vect.planar_block if planar else np.asarray(o.vect.wire_block)
                          for o in objs if o.vect.planar is planar]
                if not blocks:
                    continue
                t = time.perf_counter()
                block = np.stack(blocks)
                stack_s = time.perf_counter() - t
                t = time.perf_counter()
                staged = torch.from_numpy(block).to(self.dev)
                self.sync()
                upload_s = time.perf_counter() - t
                t = time.perf_counter()
                name = "packed_check" if planar else "wire_unpack"
                what = f"Phase W group {g}'s {len(blocks)} {'v2' if planar else 'v1'} members"
                if planar:
                    bad = kernels.packed_check(staged, order)
                    bad.view(torch.int32).tolist()
                    fetch_s = time.perf_counter() - t
                    self.compare(name, bad, kernels.packed_check_plain(staged, order), what)
                    run, plain = (lambda: kernels.packed_check(staged, order),
                                  lambda: kernels.packed_check_plain(staged, order))
                    need = self.k4_bytes(staged, order)
                else:
                    rows, bad = kernels.wire_unpack(staged, order)
                    bad.view(torch.int32).tolist()
                    fetch_s = time.perf_counter() - t
                    want_rows, want_bad = kernels.wire_unpack_plain(staged, order)
                    self.compare(name, rows, want_rows, what + ": planar rows")
                    self.compare(name, bad, want_bad, what + ": verdicts")
                    need = {"bytes": staged.numel() + 4 * rows.numel() + 4 * len(blocks)}
                    del rows, want_rows
                    run, plain = (lambda: kernels.wire_unpack(staged, order),
                                  lambda: kernels.wire_unpack_plain(staged, order))
                runs[name].append({
                    "group": g, "shape": list(staged.shape), **need,
                    "ms": self.time_ms(run, 10), "plain_ms": self.time_ms(plain, 2),
                    "device_ms": self.device_ms(run, name + "_kernel"),
                })  # fmt: skip
                if g == 1:
                    parts["v2" if planar else "v1"] = {
                        "members": len(blocks), "bytes": block.nbytes, "stack_s": stack_s,
                        "upload_s": upload_s, "kernel_fetch_s": fetch_s,
                    }  # fmt: skip
                del block, staged, bad, run, plain
        for name, launched in runs.items():
            if not launched:
                continue

            def mean(key, launched=launched):
                return sum(r[key] for r in launched) / len(launched)

            timings[name] = {"ms": mean("ms"), "plain_ms": mean("plain_ms"), "bytes": mean("bytes"),
                             "shape": " and ".join(str(r["shape"]) for r in launched),
                             "launches": launched}
            if all(r["device_ms"] is not None for r in launched):
                timings[name]["device_ms"] = mean("device_ms")
        if self.cuda:
            torch.cuda.empty_cache()
        return parts

    def k4_bytes(self, planes, order: int) -> dict:
        """The bytes K4's verdict needs from ``planes`` (``uint8[K, bpn, n]``):
        every element's top byte, and on each lower plane the 32-byte sectors
        (the least a read from device memory moves) that hold an element
        whose bytes above that plane all equal the order's, so that it is
        decided there or below; plus the verdicts written. ``all_bytes``
        counts every byte, as a kernel without the early exit reads them."""
        torch = self.torch
        k, bpn, n = planes.shape
        order_bytes = order.to_bytes(bpn, "little")
        tied = planes[:, bpn - 1] == order_bytes[-1]
        elements, sectors = [], []
        for b in range(bpn - 2, -1, -1):
            at = tied.nonzero()
            elements.append(len(at))
            addr = planes.data_ptr() + (at[:, 0] * bpn + b) * n + at[:, 1]
            sectors.append(int(torch.unique(addr // 32).numel()))
            tied &= planes[:, b] == order_bytes[b]
        top = k * n
        return {"bytes": top + 32 * sum(sectors) + 4 * k, "top_plane_bytes": top,
                "lower_plane_elements": elements, "lower_plane_sectors": sectors,
                "all_bytes": planes.numel() + 4 * k}

    def device_ms(self, fn, kernel: str) -> float | None:
        """Device time of the kernels whose name holds ``kernel`` over one
        call of ``fn`` (torch.profiler / CUPTI); None off the card or where
        the profiler shows none (an extra reading, not a check)."""
        if not self.cuda:
            return None
        from torch.profiler import ProfilerActivity, profile

        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                self.torch.cuda.synchronize()
        except Exception as exc:
            log(f"[profile] {kernel} unavailable: {exc}")
            return None
        us = sum(_device_us(ev) for ev in prof.key_averages() if kernel in ev.key)
        return us / 1e3 if us else None

    def pipeline_record(self, pipeline, ring, fold_events) -> dict:
        """What the pipeline's last drain window saw in Phase B: per flush,
        the stage leg (packing into the ring, on the caller's thread) and
        the fold leg (the worker: upload out of the pinned ring and K1's
        launch, until the copy completed), how long after ``flush``
        returned the fold leg ended, K1 packed's device time (CUDA events),
        the overlap ratio, and the staging ring's buffers, how many came
        from the process's pinned pool and what pinning the others cost."""
        import resource

        window = pipeline.last_window or {}
        folds = {seq: (s, e) for seq, s, e in window.get("fold", [])}
        flushes = []
        for i, (seq, s, e) in enumerate(window.get("stage", [])):
            fs, fe = folds.get(seq, (None, None))
            flushes.append({
                "batch": seq, "stage_s": e - s,
                "fold_s": None if fs is None else fe - fs,
                "fold_ended_after_submit_s": None if fe is None else fe - e,
                "k1_device_ms": (fold_events[i][0].elapsed_time(fold_events[i][1])
                                 if i < len(fold_events) else None),
            })  # fmt: skip
        memlock = resource.getrlimit(resource.RLIMIT_MEMLOCK)[0]
        record = {
            "flushes": flushes,
            "overlap_ratio": window.get("overlap_ratio"),
            "window_wall_s": window.get("wall_seconds"),
            "stage_s": window.get("stage_seconds"),
            "fold_s": window.get("fold_seconds"),
            "ring_buffers": None if ring is None else ring.allocated,
            "ring_bytes": None if ring is None else ring.nbytes,
            "ring_pin_s": None if ring is None else ring.pin_seconds,
            "ring_reused": None if ring is None else ring.reused,
            "rlimit_memlock": None if memlock == resource.RLIM_INFINITY else memlock,
        }
        for f in flushes:
            log(f"[phase B] flush {f['batch']}: stage {f['stage_s']:.3f} s, fold leg "
                f"{f['fold_s']:.3f} s, ended {f['fold_ended_after_submit_s']:.3f} s after "
                f"submit returned; K1 packed {f['k1_device_ms'] or float('nan'):.3f} ms on device")
        ratio = record["overlap_ratio"]
        log(f"[phase B] pipeline overlap ratio {'none' if ratio is None else f'{ratio:.3f}'} "
            f"(window {record['window_wall_s']:.3f} s); staging ring {record['ring_buffers']} "
            f"buffer(s), {record['ring_bytes']} bytes, {record['ring_reused']} reused from the "
            f"process's pinned pool, new ones pinned in {record['ring_pin_s']:.3f} s (RLIMIT_MEMLOCK "
            f"{record['rlimit_memlock'] or 'unlimited'})")
        return record

    # -- device kernel times on the main path -------------------------------

    def kernel_table(self, timings: dict, launches: dict) -> list[dict]:
        torch = self.torch
        props = torch.cuda.get_device_properties(0)
        int_rate = props.multi_processor_count * INT32_LANES_PER_SM * max_sm_clock_hz()
        rows = []
        meta = {
            "fold_packed": ("xaynet_tpu_torch/csrc/fold.cu", "xaynet_tpu/ops/fold_pallas.py:125"),
            "fold_planar": ("xaynet_tpu_torch/csrc/fold.cu", "xaynet_tpu/ops/fold_pallas.py:125"),
            "mask_fold": ("xaynet_tpu_torch/csrc/mask_fold.cu", "xaynet_tpu/ops/fold_pallas.py:201"),
            # the XLA program X4 of the JAX package's wire ingest
            "wire_unpack": ("xaynet_tpu_torch/csrc/wire.cu", "xaynet_tpu/parallel/aggregator.py:99"),
            "packed_check": ("xaynet_tpu_torch/csrc/wire.cu", "xaynet_tpu/parallel/aggregator.py:122"),
        }
        # K2's operations: the xors and rotates of each ChaCha block the
        # data needs, on the ALU pipe
        k2 = timings["mask_fold"]
        k2["ops"] = k2["blocks"] * CHACHA_ALU_OPS_PER_BLOCK
        self.records["k2_bound"] = {
            "blocks": k2["blocks"],
            "ops_per_block": CHACHA_ALU_OPS_PER_BLOCK,
            # every op of the block on one 64-lane pipe, the bound's earlier form
            "one_pipe_ops_per_block": CHACHA_OPS_PER_BLOCK,
            "one_pipe_ms": k2["blocks"] * CHACHA_OPS_PER_BLOCK / int_rate * 1e3,
        }
        if self.sass:  # what the built loop issues on its busier pipe: a diagnostic
            issued = max(self.sass["alu"], self.sass["fma"])
            self.records["k2_bound"]["sass_busier_pipe_ms"] = k2["blocks"] * issued / int_rate * 1e3
        for name in meta:
            t = timings[name]
            bytes_ms = t["bytes"] / MEM_BYTES_PER_S * 1e3
            ops_ms = t.get("ops", 0) / int_rate * 1e3
            source, replaces = meta[name]
            rows.append({
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": self.max_err[name],
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
                "library_ms": None,
            })  # fmt: skip
        self.records["int32_ops_per_s"] = int_rate
        return rows

    def device_profile(self, timings: dict) -> None:
        """Device time of each kernel (and fill) by name over one call of
        each at the main shapes: K1 packed (8 updates) and planar (1), one
        K2 seed (torch.profiler / CUPTI). K3 and K4 are profiled at Phase
        W's launches (:meth:`phase_w_kernels`)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.ops import kernels
        from xaynet_tpu_torch.ops.fold import zeros_u32

        n, k = self.args.length, self.args.batch
        order = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3).order
        acc = zeros_u32((2, n), self.dev)
        packed = torch.zeros((k, 6, n), dtype=torch.uint8, device=self.dev)
        one = zeros_u32((1, 2, n), self.dev)
        kws = torch.zeros((1, 8), dtype=torch.int32, device=self.dev).view(torch.uint32)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            kernels.fold_packed(acc, packed, order)
            kernels.fold_planar(acc, one, order)
            kernels.mask_fold(acc, kws, [6], n, order)
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            dev_us = _device_us(ev)
            if dev_us and any(k in ev.key for k in ("kernel", "mf_", "fold", "Memset")):
                rows.append({"kernel": ev.key, "device_ms": dev_us / 1e3, "calls": ev.count})
        self.records["profile"] = rows
        for r in rows:
            log(f"[profile] {r['kernel'][:60]}: {r['device_ms']:.3f} ms over {r['calls']} call(s)")
        names = {"fold_packed": "fold_packed_kernel", "fold_planar": "fold_planar_kernel",
                 "mask_fold": "mf_mask_fold_kernel"}
        for name, kernel in names.items():
            hits = [r["device_ms"] for r in rows if kernel in r["kernel"]]
            if hits and name in timings:
                timings[name]["device_ms"] = sum(hits)
        del acc, packed, one


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--length", type=int, default=25_000_000, help="model length")
    parser.add_argument("--updates", type=int, default=16, help="update participants")
    parser.add_argument("--batch", type=int, default=8, help="aggregation batch size")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="'cpu' rehearses the control flow with the plain versions "
                             "(no kernels, no result line)")
    args = parser.parse_args()

    sys.path.insert(0, str(HERE))
    try:
        import torch
        import xaynet_tpu_torch
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port: {exc}", file=sys.stderr)
        return 2
    if Path(xaynet_tpu_torch.__file__).resolve().parent.parent != HERE:
        print("chip_smoke: xaynet_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    smoke = Smoke(args)
    t0 = time.perf_counter()
    try:
        if smoke.cuda:
            smoke_name = gpu_name_and_power()
            log(f"[setup] {smoke_name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
                f"{torch.cuda.device_count()} device(s)")
            smoke.build()
        smoke.phase_a_fold()
        smoke.phase_a_mask_fold()
        smoke.phase_a_look_back()
        smoke.phase_a_wire()
        timings = smoke.phase_a_main_shapes()
        smoke.phase_a_wire_main()
        pipeline = smoke.phase_pipeline()
        result = smoke.phase_b()
        wire = smoke.phase_w(result["walls"], timings)
    except Exception as exc:  # every phase failure ends the run without a result
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        _write_records(smoke.records)
        return 1
    if smoke.cuda:
        try:
            smoke.device_profile(timings)
        except Exception as exc:  # an extra reading, not a phase: record why it is missing
            smoke.records["profile"] = f"unavailable: {type(exc).__name__}: {exc}"
            log(f"[profile] unavailable: {exc}")
    smoke.records.update(timings=timings, pipeline=pipeline, round=result, wire_round=wire,
                         seconds=time.perf_counter() - t0)
    if not smoke.cuda:
        _write_records(smoke.records)
        log(f"chip_smoke: rehearsal on {args.device} passed in {time.perf_counter() - t0:.1f} s")
        return 0
    # launches per path: K1 and K2 on Phase B's round, K3 and K4 on Phase W's
    launches = {**result["launches"],
                **{k: wire["launches"][k] for k in ("wire_unpack", "packed_check")}}
    table = smoke.kernel_table(timings, launches)
    smoke.records["kernels"] = table
    _write_records(smoke.records)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(gpu_name_and_power())
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))  # fmt: skip
    return 0


def _device_us(ev) -> float:
    """Device microseconds of a profiler row (the attribute's name moved
    between torch versions)."""
    us = getattr(ev, "device_time_total", None)
    return getattr(ev, "cuda_time_total", 0) if us is None else us


def _write_records(records: dict) -> None:
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(records, indent=1, default=str))


if __name__ == "__main__":
    sys.exit(main())
