#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xaynet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run: 25M-element round, 8 updates

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
  twenty launches into one accumulator); K2's per-row entry
  (``mask_fold_rows``: seed b into row b, one launch a trip for the block)
  at B in {1, 8, 256}, a ragged length, mid-block cursors, one and several
  trips, the shipped and the widest orders; K5 (``unit_draws``: each
  seed's unit draw and the cursor its vector draw starts at) at the
  configs and seed counts of Phases B, S and L, draw widths 37 and 268 and
  a 2^128 order, also against the host ``StreamSampler``. Each kernel is
  then timed at the shapes the main path gives it, beside its plain
  version, and checked there too (``mask_fold_rows`` at Phase S's two
  shapes, from K5's cursors on the card, the plain version over the first
  of s1's 8 rows and all of s2's 256; K5 at B's Sum2 and over s2's 2,048
  seeds). K2's and K5's bounds count the xors and rotates their
  ChaCha20 blocks need, on the ALU pipe; the built keystream loop's
  instructions per pipe (from its SASS) are recorded beside it. K3 (the v1 wire unpack + validity
  check) and K4 (the v2 byte-planar validity check) are held byte-exact,
  planar rows and per-update verdicts, on the shipped config and three more
  (the 2^96 boundary among them) at K in {1, 3, 8, 64} and a ragged length,
  with invalid elements (all 0xFF bytes, the order itself) at the first, a
  middle and the last element of chosen updates and ``order - 1`` (valid)
  at the edges of the others; then both on one 64-update batch at the main
  length (9.6e9 bytes, so every offset past 2^32 is exercised), made on the
  card, each update against the plain version alone; K4 also on elements
  that tie the order's bytes down to each plane. K6 (the fused wire
  ingest: the fold of v1 element blocks with the rejected members left
  out) is held against ``wire_fold_plain`` on the same blocks, into a
  non-zero accumulator, accumulator and acceptance byte-exact.
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
  prime/f32/b0/m3, 8 update participants (each masks on the card: mask
  derived by K2, weights added by K1), ``StagedAggregator`` with batch 8 and
  packed staging: each flush submits into the streaming pipeline (one K1
  flush of 8, folded by its worker on the accumulator's stream while the
  caller goes on), ``finalize_inplace`` (the drain: the
  round's only synchronization of the folds), the Sum2 ``sum_masks`` over
  the 8 seeds (K2), ``validate_unmasking`` and ``unmask_array``. It checks
  the aggregate against python big-int sums at 2,048 positions, the unit
  part and model count, the decoded model against the f32 mean within
  8/exp_shift + 1e-6, and that the launch counters show every kernel ran.
  It reports each flush's stage and fold seconds, the pipeline's overlap
  ratio, K1 packed's device time inside the pipeline and what pinning the
  staging ring cost. Outside its timed walls it serializes each masked
  update for Phase W: even-indexed ones in wire format v1, odd ones in v2.
  Then the speculative Sum2 (``ops.speculation``): a session on B's config
  with a ``TenantScheduler`` is offered 7 of B's 8 seeds and one that
  never arrives, folds all 8 in its worker (K5, K2, K1 planar) and
  settles on B's 8: byte-identical to B's ``sum_masks``, outcomes 7
  hits, 1 miss, 1 discard, no worker error; its seconds are printed.
- **Phase W** is the Update phase with device wire ingest, on Phase B's 8
  updates plus one more whose element block holds one all-0xFF element (in
  the middle of the last group): each message parses lazily
  (``parse_mask_object(lazy_vect=True)``), ``prevalidate_wire_batch`` runs
  per group of ``batch`` updates (K3 over the v1 members, K4 over the v2
  ones), then ``validate_aggregation`` + ``aggregate`` per update (flushes
  fold the device rows with K1 on the caller's thread, packed and planar),
  then ``finalize_inplace`` and ``unmask_array`` with Phase B's mask. It
  checks that the corrupted update is rejected with ``InvalidObject``, that
  ``nb_models == 8``, that the accumulator and the decoded model are
  byte-identical to Phase B's, that K3, K4 and both K1 variants ran as many
  times as the groups and flush chunks need, and that no update was parsed
  on the host; and prints its walls beside Phase B's. Then, on the same
  uploaded blocks, K3 and K4 are held byte-exact against their plain
  versions at each shape the phase launched them (4-5 updates), and timed
  there: the kernel line's K3 and K4 times and bounds are the means over
  Phase W's launches, K4's bound counting only the bytes its verdict needs
  from this data (every top byte, and the sectors of lower planes where an
  element still ties the order). Its fused leg: the 4 v1 wires and the
  corrupted one as raw element blocks in two batches, through
  ``DeviceAggregator.add_wire_batch`` and through
  ``StreamingAggregator.submit_wire_batch`` + ``drain`` (K6, one launch a
  batch): both accumulators byte-identical to the fold of the same 4
  updates as Phase B masked them, the corrupted one alone
  rejected, ``nb_models`` 8; K6 against ``wire_fold_plain`` at both
  shapes and timed there and at ``uint8[8, n * bpn]``. The reference for
  those 8 is folded during Phase B from B's own masked updates (K1
  planar, after B's launches are read).
- **Phase X** is the model-axis mesh on the card: a mesh of the card
  repeated 4 times (``make_mesh([cuda:0] * 4)``: 4 shards, each its own
  accumulator slice, stream, staging ring and fold worker), at Phase B's
  25M, from the 8 updates Phase B serialized (their wire rows and v1
  blocks, no new encode or masking). (x1) A ``StagedAggregator`` on the
  mesh stages B's 8 updates and flushes them through the shard-parallel
  pipeline (one packed flush: K1 packed once a shard), then
  ``finalize_inplace(defer_drain=True)`` and ``unmask_array`` with B's mask,
  which stages the unmask per shard behind the folds (the eager per-shard
  unmask): the model must be B's one-shard model byte for byte. (x2) The
  journal entry (``snapshot_journal``: one plane per shard) restores into
  a 1-shard and a 4-shard aggregator, each holding B's accumulator. (x3)
  The 4 even (v1) updates as raw element blocks in two wire batches
  (``submit_wire_batch``), the first with a member whose last element,
  in the last shard's slice alone, is all 0xFF: K6 on each shard's byte
  slice, the verdicts settled at each batch's commit and the rejected
  member taken back from shards 0-2 by K6's subtract-back pass
  (``kernels.wire_unfold``, held against its plain version at this shape
  and timed there); the verdicts, ``nb_models`` and the accumulator must
  be those of B's even updates on one shard. (x4) The same wire leg with
  a fault at shard 2's first fold: the shard retries, the pipeline
  degrades, the result is the same. Where several cards are visible,
  (x5) runs x1 on a mesh of every card. It prints K1 and K6 by shard, the
  per-shard overlap gauges and the walls of the submit, the drain and the
  unmask beside Phase B's.
- **Phase H** is the multi-process ingest: two processes of this script
  (``--h-worker``) share the card, each with its own CUDA context, and
  form a ``torch.distributed`` gloo group over 127.0.0.1; each folds its
  half of a 25M model with ``parallel.multihost.MultiHostAggregator``: a
  raw wire batch of 8 whose last member has an invalid element in rank 1's
  slice (``add_local_wire_batch``: K6, the verdict all-reduced, rank 0
  taking the member back), a planar batch of the 8 (``add_local_batch``,
  K1 planar), then ``unmask_local``. Each rank's slice must equal a numpy
  limb oracle and the acceptance vector must be the same on both ranks.
  ``python3 chip_smoke.py --only H`` runs it alone.
- **Phase S** is the whole-round simulation (``sim.SimRound``): (s1)
  Phase B's first 2 participants (a quarter of its flush: their seeds and
  models, scalar 1/8 as B encoded them) at the main length in one block, the units drawn
  by K5, the masks derived into zero rows by K2 per row (one launch) and
  folded by K1 planar; its
  aggregates, unmasked limbs and float64 model must be, byte for byte,
  those of the same 4 through the round's own path: K1's fold of the
  masked wires Phase B serialized for them, ``sum_masks`` over their
  seeds, the unmask and decode (the oracle's identity at full width). (s2) The JAX package's bench sim shape: 2,048 participants
  x 1,000 parameters, integer/f32/b0/m6, blocks of 256, a warm-up and three
  timed runs (median participants/s with min and max), the model within
  1e-6 of the f32 mean, one K5 and one K2-per-row launch a block, and K5's
  time over the 2,048 seeds. **Phase S-mesh** runs s2 on a participant-axis
  mesh of 2 shards of the card (each shard its blocks on its own stream,
  the partials combined by K1 planar): the model must be s2's byte for
  byte; its participants/s print beside s2's.
- **Phase R** is a round through the port's coordinator: ``serve()`` on an
  event loop in a thread, no device given (CUDA), a temporary config with
  the shipped mask config and aggregation knobs (batch 64, packed staging,
  no wire ingest), count windows of 1 sum, 3 updates and 1 sum2, the
  filesystem model store, 25,000,000 parameters, bound to a free port on
  127.0.0.1. The port's participant SDK drives it over the socket
  (``sdk_round``): one sum and three update participants, each a
  ``StateMachine`` with an ``HttpClient`` and no device (CUDA), roles
  pinned with ``keys_for_task``; each update participant masks on the card
  (K2 + K1) and sends in 64 MiB parts, the sum participant sums the masks
  (K2). It checks the decoded model byte-identical to the updates and mask
  the participants sent, folded and unmasked by the plain versions on the
  CPU, and within ``n_updates / exp_shift + 1e-6`` of the mean; that the
  update phase's aggregator folded on CUDA and its flush launched K1
  packed once; and the participants' launches (K1 planar 3, K2 6). It
  prints the walls from the first update POST (update phase closed, sum2
  closed, model available), the per-part POST seconds and the process's
  CPU seconds meanwhile, the flush's staging buffer (rows, bytes, pinning
  seconds), the coordinator's decrypt/parse seconds, whether the
  ``cryptography`` wheel is present and the process's peak host RSS.
- **Phase R-wire** is the same round (R's local models) with device wire
  ingest, the packed upload format (the SDK sends wire v2), the ``file``
  coordinator store and the round journal: its model must be R's, byte
  for byte; it also checks that the coordinator's K4 checked
  each update (K3 not launched) and that journal entries and the store's
  state file were written. Each of the two rounds runs inside a
  ``torch.profiler`` window (CUDA activity, every thread of this process):
  the device time by kernel, copy and fill, and the card's idle share of
  the window, beside the estimate from launches x per-launch times.
- **Phase L** is a forged round through the coordinator: ``serve()`` as in
  Phase R with prime/f32/b0/m6 (capacity 10^6 updates), model length 256,
  batch 64, wire ingest with packed uploads, count windows of 1 sum, 2,000
  updates and 1 sum2, and the ingest pipeline at the JAX loadgen soak's
  settings (``[ingest] enabled``, 2 shards of 4,096, Retry-After 0.2 s;
  coalescing at the shipped 32 members and 2 ms); one sum participant on
  the port's SDK; then ``loadgen.runner.run`` forges and replays the 2,000
  updates over REST from two spawned driver processes (blocks of 512, 64
  POSTs in flight each; K5 and K2 per row once a block in their engines);
  then the Sum2 (K5 once over its 2,000 seeds, K2 a seed). It checks every
  update accepted, the model byte-identical to ``SimRound`` over the
  drivers' ground truth (seeds, models and scalar, rebuilt from the run's
  seeds) and within 2000 / exp_shift + 1e-6 of the mean; that the
  coalescer sent all 2,000 members, the intake stayed within its bound
  and ``xaynet_ingest_admitted_total`` counted every POST that was not
  shed; K4 launched fewer times than there were updates, once per
  prevalidated chunk or member check the round's aggregator counted, K1
  on the device rows and K5 and K2 in the drivers and in Sum2; that
  ``/healthz`` carries the ``ingest`` and ``pipeline`` sections and ``GET
  /statusz`` renders the ingress and streaming sections. It prints the
  accepted updates/s over the replay window, the per-POST p50, p99 and
  max, the coalesced envelopes' sizes, K4's launches, the forge seconds
  and the ingest workers' decrypt/parse seconds, and traces the round like
  Phase R; the drivers' device work runs in their own processes, outside
  that trace, so Phase L's idle share is that of the coordinator's
  process, not the card's. **Phase L-shed** is the same coordinator with
  a small intake (1 shard of 16, watermarks 0.8 / 0.5, Retry-After 0.2 s)
  and 256 updates from one driver with 64 POSTs in flight, each shed
  upload retried after its Retry-After: the driver must see 429s, each
  with a Retry-After and as many as ``xaynet_ingest_shed_total`` counts,
  every update accepted in the end and the model byte-identical to
  ``SimRound``'s. **Phase E-fanin** is the JAX soak's ``--edges 2``
  topology at Phase L's config: the coordinator with ``[edge] enabled``,
  two ``python -m xaynet_tpu_torch.edge.runner`` processes of 64 members a
  window, 512 forged updates from one driver sent to the edges' URLs with
  ``shared_round``: the model byte-identical to ``SimRound``, every update
  folded through envelopes, as many as the edges sealed, one K1 launch
  each.
- **Phase D** is the durable round at full width: Phase R's config and
  local models with ``coordinator = "redis"``, ``backend = "s3"``, the round journal and
  ``[restore] enable``, against an in-process RESP server (its ``EVAL``
  runs the scripts' text through the port's ``lua_mini``) and an S3
  endpoint that checks every SigV4 signature, both on a thread of this
  process. The coordinator is ``python -m xaynet_tpu_torch.server.runner
  -c <cfg>`` in a subprocess, driven by the port's SDK from this process:
  process 1 takes the sum message and the 3 updates (K1 packed folds the
  flush); once it is in Sum2 with the journal entry tagged ``sum2``, it is
  SIGKILLed; process 2, the same command on the same port, resumes Sum2
  from the journal (the accumulator uploaded onto the card and read back
  byte-identical to the journaled one), the sum participant's Sum2 runs
  K5 and K2, Unmask publishes the model to S3. It checks the resumed
  round's id and seed, the model read through
  ``examples.download_global_model`` against the S3 object, ``GET
  /model`` and R's model (alone: the plain CPU fold and unmask), a refused second
  conditional put, the launches (process 1's from its ``GET /metrics``),
  no "not resumable" line, and process 2's exit 0 with "coordinator
  stopped" on SIGTERM; it prints process 1's walls, the kill-to-``GET
  /params`` gap, the journal's bytes and its SETs' and GETs' seconds, the
  restore's upload seconds and the model's wall. Then ``python -m
  xaynet_tpu_torch.tools.sim_check --combos 2`` (production rounds and
  sims byte-identical) and ``python -m
  xaynet_tpu_torch.examples.sim_quickstart -p 1024 -l 1000`` (models
  within the fixed-point tolerance of the mean) on the card.
- **Phase T** is local training on the port (``models``): (t1) ResNet-50
  at full width (1000 classes, stages (3, 4, 6, 3), bf16 activations,
  25,557,032 parameters) from a seeded ``torch.Generator``, on synthetic
  64x64 NHWC images: the parameter count, ``unflatten_params`` of
  ``flatten_params`` byte for byte on the card, one SGD step on the card
  against the same step on the CPU in f32 (TF32 off) and in bf16, and the
  bf16 step's milliseconds at batch 32 (CUDA events, median of 10) and
  images/s. (t2) One round of ResNet-50 federated through the
  coordinator (Phase R's config at the model's length): a sum participant
  and three update participants, each ``spawn_participant(url,
  FederatedTrainer, ...)`` training on the card (2 batches of 32); the
  global model within 3 /
  exp_shift + 1e-6 of the mean of the vectors the trainers returned, the
  fold on CUDA, K1 planar 3 and K2 3 in the participants' masking, K2 3 in
  Sum2, K1 packed 1 in the flush; per round the training and masking
  seconds, the walls from the first update POST and the peak RSS. (t3)
  The four training examples at their defaults, ``python -m
  xaynet_tpu_torch.examples.<name> --check-loss``, started together: each
  exits 0 and prints its eval loss.
- **Phase E** is the edge tier at full width: Phase R's coordinator
  config with ``[edge] enabled`` at ResNet-50's 25,557,032 parameters, two
  edge runners (``max_members = 2``, ``linger_s = 30``) and the port's SDK
  participants pointed at them (1 sum, 4 updates, 2 per edge, 1 sum2):
  the coordinator folded 2 envelopes of 2 members with one K1 launch
  each, ``nb_models`` 4, the model within ``n_updates / exp_shift +
  1e-6`` of the mean; it prints the walls from the first update POST, as
  R does.
- **Phase M** is the multi-tenant coordinator: one ``serve()`` (in a
  thread, no device: CUDA) with ``[tenancy] enabled``, tenants ``resnet``
  (Phase T's 25,557,032 parameters, the shipped prime/f32/b0/m3, batch 64,
  packed staging, 1 sum, 3 updates, 1 sum2) and ``lenet``
  (``cifar_lenet``'s 136,886, integer/f32/b0/m3, wire ingest with v2
  uploads, the ``file`` store, its messages through its own ingest
  pipeline, 1 sum, 8 updates, 1 sum2), each from its own
  file in the ``config_dir``, and an admin token. The port's SDK drives
  both rounds at once over the socket at ``/t/resnet`` and ``/t/lenet``
  inside one profiler window; then ``mlp`` (``house_prices``' 3,009) is
  onboarded through ``POST /admin/tenants``, runs one round and is drained
  through ``DELETE`` at its next round boundary. It checks each model
  within ``n / exp_shift + 1e-6`` of the mean and, but for ``resnet``'s
  (Phase R holds that path at 25M), byte-identical to the plain CPU fold
  and unmask of what the participants sent, the bare
  ``/params`` (resnet's) and ``/t/nope/params`` (404), every fold on CUDA
  and each path's launches (lenet's K4 and K1 packed as its coalesced
  flushes need), the scheduler's split over both round tenants, the pool
  balanced for all three tenants in both arenas, mlp's routes 404 after
  the drain, lenet's pipeline charging the per-tenant admission budget
  during its round and holding none after, and ``/t/lenet/healthz``'s
  ``ingest`` section (resnet's direct path has none); it prints each tenant's walls from its first update
  POST, the pool's page-locked bytes and each flush's pin seconds, the
  device ledger's pages per tenant, the peak host RSS and the window's idle
  share.

Prints what it found on earlier lines; on its last lines the card's name
and power limit, the kernel table as one JSON object, and
``{"ok": true, "device": {...}}``. Any failure exits non-zero without that
last line, as does a machine without CUDA. Longer records (compiler
reports, every check) go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys
import time
import traceback
from fractions import Fraction
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
OUT_DIR = Path("chiprun_out")

# Phase R's participants split a message into parts of at most this many
# bytes: a 150 MB update goes as 3 parts, through the multipart reader
PHASE_R_PART_BYTES = 64 << 20
# Phase E's edges seal a window at 2 members or after this many seconds
PHASE_E_LINGER_S = 30.0
# Phase D's S3 endpoint (StoreServers) checks every request's signature
S3_ACCESS, S3_SECRET, S3_REGION, S3_BUCKET = "smoke-access", "smoke-secret", "us-east-1", "models"
RESNET50_PARAMS = 25_557_032  # flax ResNet-50, 1000 classes (xaynet_tpu/models/resnet.py)
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


def phase_b_population(seed: int, n_up: int, length: int):
    """Phase B's participants, from ``seed``: their mask seeds, the model
    positions its checks sample, and an iterator over their f32 models (one
    at a time: 100 MB each at the main length). Phase S replays them."""
    rng = np.random.default_rng(seed + 1)
    seeds = [rng.bytes(32) for _ in range(n_up)]
    idx = np.sort(rng.choice(length, size=min(2048, length), replace=False))
    models = (rng.uniform(-0.9, 0.9, length).astype(np.float32) for _ in range(n_up))
    return seeds, idx, models


# -- Phase R: the port's coordinator, and a minimal participant over HTTP ----


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def toml_value(value) -> str:
    if isinstance(value, bool):
        return str(value).lower()
    return f'"{value}"' if isinstance(value, str) else repr(value)


def write_coordinator_config(path: Path, port: int, length: int, model_dir: Path,
                             n_updates: int = 3,
                             wire: bool = False, journal: bool | None = None,
                             model_type: str = "m3", probs: tuple = (0.01, 0.1),
                             ingest: dict | None = None, edge: bool = False,
                             durable: tuple[int, int] | None = None) -> Path:
    """A coordinator config: the shipped mask config, probabilities and
    aggregation knobs (``configs/config.toml``; batch 64, packed staging),
    the device fold on, count windows with min = max (1 sum, ``n_updates``
    updates, 1 sum2), the filesystem model store (and the flight recorder's
    dumps) in ``model_dir``. With ``wire``: device wire ingest and the
    packed upload format (wire v2, so participants send byte planes); with
    ``journal`` (default: ``wire``) the ``file`` coordinator store and the
    round journal in ``model_dir``. ``model_type`` sets the mask's capacity
    (m3: 10^3 updates), ``probs`` the sum and update probabilities,
    ``ingest`` further ``[ingest]`` keys (``enabled = true`` puts the
    ingest pipeline in front of the round); ``edge`` serves the edge tier
    (``[edge] enabled``: ``/edge/round``, ``/edge/envelope``). ``durable``
    (the Redis and S3 ports of :class:`StoreServers`) keeps the round's
    state in Redis (``coordinator = "redis"``) and its models in S3
    (``backend = "s3"``), with the round journal (``[resilience]
    checkpoint_enabled``) and ``[restore] enable``: a restarted
    coordinator resumes the round."""
    if journal is None:
        journal = wire
    window = 'time = {{ min = 0.0, max = 900.0 }}\ncount = {{ min = {n}, max = {n} }}'
    ingest = {**({"wire_format": "packed"} if wire else {}), **(ingest or {})}
    wire_keys = "wire_ingest = true\n" if wire else ""
    if ingest:
        wire_keys += "[ingest]\n" + "".join(f"{k} = {toml_value(v)}\n" for k, v in ingest.items())
    wire_keys += "[resilience]\ncheckpoint_enabled = true\n" if journal else ""
    store = 'coordinator = "file"\n' if journal else ""
    wire_keys += "[edge]\nenabled = true\n" if edge else ""
    backend = "filesystem"
    if durable is not None:
        backend = "s3"
        store = (f'coordinator = "redis"\nredis_port = {durable[0]}\n'
                 f's3_endpoint = "http://127.0.0.1:{durable[1]}"\ns3_bucket = "{S3_BUCKET}"\n'
                 f's3_access_key = "{S3_ACCESS}"\ns3_secret_key = "{S3_SECRET}"\n'
                 f's3_region = "{S3_REGION}"\n')  # fmt: skip
        wire_keys += "[resilience]\ncheckpoint_enabled = true\n[restore]\nenable = true\n"
    path.write_text(
        f'[api]\nbind_address = "127.0.0.1:{port}"\n'
        f'[pet.sum]\nprob = {probs[0]}\n{window.format(n=1)}\n'
        f'[pet.update]\nprob = {probs[1]}\n{window.format(n=n_updates)}\n'
        f'[pet.sum2]\n{window.format(n=1)}\n'
        '[mask]\ngroup_type = "prime"\ndata_type = "f32"\nbound_type = "b0"\n'
        f'model_type = "{model_type}"\n'
        f"[model]\nlength = {length}\n"
        "[aggregation]\ndevice = true\nbatch_size = 64\n"
        "packed_staging = true\n"
        f"{wire_keys}"
        f'[storage]\nbackend = "{backend}"\n{store}model_dir = "{model_dir}"\n'
        f'[metrics]\nflight_dir = "{model_dir / "flight"}"\n'
    )
    return path


def http_call(base: str, method: str, path: str, body: bytes = b"",
              timeout: float = 900.0, headers: dict | None = None) -> tuple[int, bytes]:
    """One request to ``base`` + ``path`` (a tenant route's base,
    ``.../t/<id>``, prefixes its path)."""
    import http.client
    from urllib.parse import urlparse

    url = urlparse(base)
    conn = http.client.HTTPConnection(url.hostname, url.port, timeout=timeout)
    try:
        conn.request(method, url.path.rstrip("/") + path, body=body or None,
                     headers={"Connection": "close", **(headers or {})})  # fmt: skip
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def coordinator_phase(base: str) -> str | None:
    """The phase ``GET /healthz`` reports (None while nothing answers)."""
    try:
        status, body = http_call(base, "GET", "/healthz", timeout=60)
    except OSError:
        return None
    return json.loads(body)["phase"] if status == 200 else None


def wait_for(pred, timeout: float, what: str, poll: float = 0.01):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        value = pred()
        if value:
            return value
        time.sleep(poll)
    raise Failure(f"timed out after {timeout:.0f} s waiting for {what}")


def pipeline_counters() -> dict:
    """The coordinator's message-pipeline seconds (decrypt and parse, one
    message at a time and in the ingest workers' batches, and all of the
    direct path's handling) and its journal writes, from its registry."""
    from xaynet_tpu_torch.telemetry.registry import get_registry

    registry = get_registry()
    family = registry.get("xaynet_message_pipeline_seconds")
    out = {stage: family.labels(stage=stage).sum
           for stage in ("decrypt_parse", "decrypt_parse_batch", "total")}
    journal = registry.get("xaynet_resilience_checkpoints_total")
    out["journal_writes"] = sum(child.value for _, child in journal.children())
    return out


class PhaseMarks(logging.Handler):
    """The coordinator's phase transitions, on this process's clock:
    ``(perf_counter, message, snapshot())`` (``snapshot``: what else to read
    at the transition, on the coordinator's thread)."""

    def __init__(self, snapshot=lambda: None):
        super().__init__()
        self.marks: list = []
        self.snapshot = snapshot

    def emit(self, record):
        msg = record.getMessage()
        if "entering" in msg or "full close" in msg:
            self.marks.append((time.perf_counter(), msg, self.snapshot()))

    def first(self, prefix: str, text: str):
        """The first mark whose message starts with ``prefix`` and holds ``text``."""
        hits = [m for m in self.marks if m[1].startswith(prefix) and text in m[1]]
        return hits[0] if hits else None


class InProcessCoordinator:
    """The port's ``serve(settings, device=device)`` on an event loop in a
    thread of this process; :meth:`stop` cancels it (its clean shutdown)."""

    def __init__(self, settings, device=None):
        import asyncio
        import threading

        from xaynet_tpu_torch.server import runner

        self.error: BaseException | None = None
        self._loop = asyncio.new_event_loop()
        self._task = None
        ready = threading.Event()

        def run() -> None:
            import torch

            if torch.cuda.is_available():
                torch.cuda.set_device(0)  # the thread's current device
            asyncio.set_event_loop(self._loop)
            self._task = self._loop.create_task(runner.serve(settings, device=device))
            ready.set()
            try:
                self._loop.run_until_complete(self._task)
            except BaseException as exc:  # re-raised by stop()
                self.error = exc
            finally:
                self._loop.run_until_complete(self._loop.shutdown_default_executor())
                self._loop.close()

        self._thread = threading.Thread(target=run, name="xn-coordinator", daemon=True)
        self._thread.start()
        ready.wait()

    def stop(self, timeout: float = 120.0) -> None:
        if self._thread.is_alive():
            self._loop.call_soon_threadsafe(self._task.cancel)
            self._thread.join(timeout)
        if self._thread.is_alive():
            raise Failure(f"the coordinator did not stop within {timeout:.0f} s")
        if self.error is not None:
            raise self.error


class ArrayModelStore:
    """The SDK's model store over one fixed local model."""

    def __init__(self, model):
        self.model = model

    async def load_model(self):
        return self.model


class GatedClient:
    """A participant's ``HttpClient`` whose POSTs wait for ``gate`` and are
    timed one by one (``post_s``); every other call goes straight through."""

    def __init__(self, inner):
        import asyncio

        self.inner = inner
        self.gate = asyncio.Event()
        self.waiting = False
        self.post_s: list[float] = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    async def send_message(self, encrypted: bytes) -> None:
        self.waiting = True
        await self.gate.wait()
        t = time.perf_counter()
        await self.inner.send_message(encrypted)
        self.post_s.append(time.perf_counter() - t)


def sdk_round(base: str, weights: list, device, max_message_size: int | None,
              timeout: float = 900.0, update_bases: list | None = None,
              sum_base: str | None = None, before_posts=None, before_sum2=None) -> dict:
    """One PET round against the coordinator at ``base`` through the port's
    participant SDK: one sum participant and one update participant per
    entry of ``weights``, each a ``StateMachine`` with an ``HttpClient`` on
    ``device`` (None: CUDA), roles pinned with ``keys_for_task``.

    The update participants' steps run as tasks on one event loop: each
    masks its model (K2 + K1), seals its first part and waits at its
    client's gate; once all have masked, the gates open one after another,
    so the walls from the first update POST are the coordinator's and the
    SDK's sealing of the later parts. The sum participant's Sum2 step
    (``GET /seeds``, ``sum_masks`` on K2, sealing and posting the mask) is
    timed alone. Returns the decoded global model, the masked updates (and
    their participants' public keys) and the Sum2 mask the participants
    sent (read at their ``_send``), and the walls. ``update_bases`` (the
    update participants' URLs, round-robin) and ``sum_base`` point the
    participants elsewhere than ``base`` (edges in front of the
    coordinator); ``before_posts`` (a blocking callable) runs once every
    update participant has masked, before the first POST; ``before_sum2``
    (another) once the update phase has closed, before the sum participant
    takes its Sum2 step."""
    import asyncio

    return asyncio.run(_sdk_round(base, weights, device, max_message_size, timeout,
                                  update_bases or [base], sum_base or base, before_posts,
                                  before_sum2))  # fmt: skip


async def _sdk_round(base, weights, device, max_message_size, timeout, update_bases, sum_base,
                     before_posts, before_sum2) -> dict:
    import asyncio

    from xaynet_tpu_torch.sdk.client import HttpClient
    from xaynet_tpu_torch.sdk.simulation import keys_for_task
    from xaynet_tpu_torch.sdk.state_machine import PetSettings, StateMachine, TransitionOutcome

    async def until(pred, what: str, poll: float = 0.02):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if await pred():
                return
            await asyncio.sleep(poll)
        raise Failure(f"timed out after {timeout:.0f} s waiting for {what}")

    async def in_phase(want: str, negate: bool = False):
        phase = await asyncio.to_thread(coordinator_phase, base)
        return (phase != want) if negate else (phase == want)

    walls: dict = {}
    sent: dict = {"update": [], "sum2": [], "update_pk": []}
    seeds_seen: list[int] = []
    probe = HttpClient(base, timeout=timeout)
    params = await probe.get_round_params()
    seed, n_up = params.seed.as_bytes(), len(weights)
    if params.model_length != len(weights[0]):
        raise Failure(f"round model length {params.model_length} != {len(weights[0])}")

    def participant(keys, model, scalar, url):
        client = GatedClient(HttpClient(url, timeout=timeout))
        sm = StateMachine(PetSettings(keys=keys, scalar=scalar, max_message_size=max_message_size,
                                      device=device),
                          client, ArrayModelStore(model))  # fmt: skip
        real_send, real_aggregate = sm._send, sm._aggregate_masks

        async def send(payload, next_phase):
            for kind, attr in (("update", "masked_model"), ("sum2", "model_mask")):
                if hasattr(payload, attr):
                    sent[kind].append(payload)
            if hasattr(payload, "masked_model"):
                sent["update_pk"].append(keys.public)
            return await real_send(payload, next_phase)

        def aggregate(mask_seeds, length, config):
            seeds_seen.append(len(mask_seeds))
            return real_aggregate(mask_seeds, length, config)

        sm._send, sm._aggregate_masks = send, aggregate
        return sm, client

    summer, summer_client = participant(
        keys_for_task(seed, params.sum, params.update, "sum", start=0), None, Fraction(1), sum_base)
    summer_client.gate.set()
    updaters = [participant(keys_for_task(seed, params.sum, params.update, "update",
                                          start=(20 + i) * 1000),
                            w, Fraction(1, n_up), update_bases[i % len(update_bases)])
                for i, w in enumerate(weights)]  # fmt: skip
    clients = [summer_client] + [c for _, c in updaters]
    try:
        async def summer_in(phase: str) -> bool:
            """One step of the sum participant; True once it is in ``phase``."""
            await summer.transition()
            return summer.phase.value == phase

        # the sum participant's ephemeral key; the sum phase closes on it
        await until(lambda: summer_in("sum2"), "the sum participant's sum message")
        await until(lambda: in_phase("update"), "the update phase")
        for sm, _ in updaters:
            await sm.transition()  # the round's task: update
            if sm.phase.value != "update":
                raise Failure(f"an update participant drew {sm.phase.value}")

        t = time.perf_counter()
        steps = [asyncio.create_task(sm.transition()) for sm, _ in updaters]
        await until(lambda: _all_waiting([c for _, c in updaters], steps), "the participants' masking")
        walls["participants_mask"] = time.perf_counter() - t
        if before_posts is not None:
            await asyncio.to_thread(before_posts)

        cpu0 = time.process_time()
        walls["t0_epoch"] = time.time()  # the same instant on the logs' clock
        t0 = walls["t0"] = time.perf_counter()
        for (sm, client), step in zip(updaters, steps):
            client.gate.set()
            if await step != TransitionOutcome.COMPLETE or sm.phase.value != "awaiting":
                raise Failure(f"an update participant ended its step in {sm.phase.value}")
        walls["update_posts"] = time.perf_counter() - t0
        # this process's CPU seconds (every thread: the participants and an
        # in-process coordinator) while the updates went in
        walls["update_posts_process_cpu"] = time.process_time() - cpu0
        walls["update_part_posts"] = [c.post_s for _, c in updaters]
        await until(lambda: in_phase("update", negate=True), "the update phase to close")
        if before_sum2 is not None:
            await asyncio.to_thread(before_sum2)

        # the sum participant: its seeds, sum_masks on the card (K2), its
        # upload; the step that found the seeds is timed
        started = []

        async def sum2_sent() -> bool:
            started.append(time.perf_counter())
            return await summer_in("awaiting")

        await until(sum2_sent, "the sum participant's Sum2 step")
        walls["sum2_participant"] = time.perf_counter() - started[-1]
        await until(lambda: in_phase("sum2", negate=True), "the sum2 phase to close")

        model = None

        async def model_ready():
            nonlocal model
            model = await probe.get_model()
            return model is not None

        await until(model_ready, "the global model", poll=0.05)
        walls["model_available"] = time.perf_counter() - t0
    finally:
        for client in clients + [probe]:
            client.close()
    return {"model": np.array(model), "updates": [p.masked_model for p in sent["update"]],
            "update_pks": sent["update_pk"],
            "wire_planar": [p.wire_planar for p in sent["update"]],
            "mask": sent["sum2"][0].model_mask, "walls": walls,
            "parts_per_update": [len(c.post_s) for _, c in updaters],
            "n_seeds": seeds_seen[0] if seeds_seen else 0}


async def _all_waiting(clients, steps) -> bool:
    for step in steps:
        if step.done():
            step.result()  # a step that ended before its gate: raise its error
            raise Failure("an update participant finished its step before posting")
    return all(c.waiting for c in clients)


class EdgeProcesses:
    """``count`` edge aggregators of the port, each ``python -m
    xaynet_tpu_torch.edge.runner -c <its config>`` in a process of its own
    (from this checkout), in front of the coordinator at ``upstream`` port;
    each with ``max_members`` and ``linger_s``, polling every 0.1 s (the JAX
    soak's edge config, ``tools/loadgen_soak.py``). Logs go to
    ``chiprun_out/<tag>_edge<i>.log``. :meth:`stop` SIGTERMs them and waits
    (a kill after 30 s)."""

    def __init__(self, tag: str, count: int, upstream: int, work: Path, max_members: int,
                 linger_s: float):
        import os

        self.urls, self.procs, self._logs = [], [], []
        OUT_DIR.mkdir(exist_ok=True)
        env = dict(os.environ, PYTHONPATH=str(HERE))
        try:
            for i in range(count):
                port = free_port()
                cfg = work / f"edge{i}.toml"
                cfg.write_text(
                    f'[api]\nbind_address = "127.0.0.1:{port}"\n'
                    f'[edge]\nupstream_url = "http://127.0.0.1:{upstream}"\n'
                    f'edge_id = "{tag}-edge-{i}"\nmax_members = {max_members}\n'
                    f"linger_s = {linger_s}\npoll_s = 0.1\n"
                    '[log]\nfilter = "info"\n'
                )
                log_file = open(OUT_DIR / f"{tag}_edge{i}.log", "w")
                self._logs.append(log_file)
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "xaynet_tpu_torch.edge.runner", "-c", str(cfg)],
                    cwd=HERE, env=env, stdout=log_file, stderr=subprocess.STDOUT))  # fmt: skip
                self.urls.append(f"http://127.0.0.1:{port}")
            for url, proc in zip(self.urls, self.procs):
                wait_for(lambda url=url, proc=proc: self._up(url, proc), 120, f"the edge at {url}")
        except BaseException:
            self.stop()
            raise

    @staticmethod
    def _up(url: str, proc) -> bool:
        if proc.poll() is not None:
            raise Failure(f"the edge runner at {url} exited with {proc.returncode}")
        try:
            return http_call(url, "GET", "/healthz", timeout=5)[0] == 200
        except OSError:
            return False

    def health(self) -> list[dict]:
        """Each edge's ``/healthz`` ``edge`` section."""
        return [json.loads(http_call(u, "GET", "/healthz", timeout=60)[1])["edge"]
                for u in self.urls]  # fmt: skip

    def wait_phase(self, phase: str, timeout: float = 120.0) -> None:
        wait_for(lambda: all(h["phase"] == phase for h in self.health()), timeout,
                 f"the edges to sync the {phase} phase", poll=0.05)  # fmt: skip

    def stop(self) -> list:
        """SIGTERM every edge, wait; returns their exit codes."""
        codes = []
        for proc in self.procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs:
            try:
                codes.append(proc.wait(timeout=30))
            except subprocess.TimeoutExpired:
                proc.kill()
                codes.append(proc.wait())
        for f in self._logs:
            f.close()
        self.procs = []
        return codes


def plain_round_model(out: dict, length: int) -> np.ndarray:
    """The model of an ``sdk_round`` recomputed by the plain versions on the
    CPU: the fold of the masked updates the participants sent and the
    unmask with the Sum2 mask they sent."""
    from xaynet_tpu_torch.server.aggregation import StagedAggregator

    ref = StagedAggregator(out["mask"].config, length, batch_size=len(out["updates"]),
                           device="cpu")  # fmt: skip
    for obj in out["updates"]:
        ref.validate_aggregation(obj)
        ref.aggregate(obj)
    return ref.finalize_inplace().unmask_array(out["mask"])


class StoreServers:
    """Phase D's stores, in this process on a thread and event loop of their
    own, so they outlive the coordinator processes (harness code, not the
    package's): a RESP2 server over dict state whose ``EVAL`` runs the
    scripts' text through the port's ``lua_mini`` (as the JAX tests'
    ``FakeRedis``), and a path-style S3 endpoint that recomputes every
    request's SigV4 signature with the port's ``sign_v4`` and honours the
    conditional put (as their ``FakeS3``). Records, server side, the bytes
    and seconds of each SET and GET of the round journal's key and of each
    S3 PUT and GET of an object: from the command's first byte to the
    reply's last handed to the socket."""

    JOURNAL_KEY = b"round_checkpoint"

    def __init__(self):
        import asyncio
        import threading

        self.strings: dict = {}
        self.hashes: dict = {}
        self.sets: dict = {}
        self.zsets: dict = {}
        self.buckets: dict = {}
        self.ops: list = []  # (store, op, key, bytes, seconds)
        self.lock = threading.Lock()
        self.loop = asyncio.new_event_loop()
        ready = threading.Event()
        failed: list = []

        def run() -> None:
            asyncio.set_event_loop(self.loop)
            try:
                self._servers = [
                    self.loop.run_until_complete(asyncio.start_server(handler, "127.0.0.1", 0))
                    for handler in (self._redis_conn, self._s3_conn)
                ]
            except BaseException as exc:  # surfaced by the constructor
                failed.append(exc)
                ready.set()
                return
            self.redis_port, self.s3_port = (
                srv.sockets[0].getsockname()[1] for srv in self._servers
            )
            ready.set()
            self.loop.run_forever()
            for srv in self._servers:
                srv.close()
            self.loop.close()

        self._thread = threading.Thread(target=run, name="xn-stores", daemon=True)
        self._thread.start()
        ready.wait()
        if failed:
            raise failed[0]

    def stop(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(30)

    def journal(self) -> bytes | None:
        with self.lock:
            return self.strings.get(self.JOURNAL_KEY)

    # -- Redis ---------------------------------------------------------------

    async def _redis_conn(self, reader, writer) -> None:
        import asyncio

        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                t0 = time.perf_counter()
                parts = []
                for _ in range(int(line[1:-2])):
                    size = int((await reader.readline())[1:-2])
                    parts.append((await reader.readexactly(size + 2))[:-2])
                with self.lock:
                    reply = self._redis_dispatch(parts)
                writer.write(reply)
                await writer.drain()
                cmd = parts[0].upper()
                if cmd in (b"SET", b"GET") and parts[1] == self.JOURNAL_KEY:
                    size = len(parts[2]) if cmd == b"SET" else len(reply)
                    self.ops.append(("redis", cmd.decode(), "journal", size,
                                     time.perf_counter() - t0))  # fmt: skip
        except (asyncio.IncompleteReadError, ConnectionError):
            pass  # a killed coordinator's connection
        finally:
            writer.close()

    @classmethod
    def _resp(cls, value) -> bytes:
        if value is None:
            return b"$-1\r\n"
        if isinstance(value, int):
            return b":%d\r\n" % value
        if isinstance(value, bytes):
            return b"$%d\r\n%s\r\n" % (len(value), value)
        return b"*%d\r\n" % len(value) + b"".join(cls._resp(v) for v in value)

    def _script_call(self, *parts):
        """The commands the Lua scripts send (``redis.call``)."""
        from xaynet_tpu_torch.utils import lua_mini

        cmd, key = parts[0].upper(), parts[1]
        if cmd == b"HSETNX":
            h = self.hashes.setdefault(key, {})
            if parts[2] in h:
                return 0
            h[parts[2]] = parts[3]
            return 1
        if cmd == b"HSET":
            h = self.hashes.setdefault(key, {})
            added = int(parts[2] not in h)
            h[parts[2]] = parts[3]
            return added
        if cmd == b"HLEN":
            return len(self.hashes.get(key, {}))
        if cmd == b"HEXISTS":
            return int(parts[2] in self.hashes.get(key, {}))
        if cmd == b"SISMEMBER":
            return int(parts[2] in self.sets.get(key, set()))
        if cmd == b"SADD":
            members = self.sets.setdefault(key, set())
            added = sum(m not in members for m in set(parts[2:]))
            members.update(parts[2:])
            return added
        if cmd == b"ZINCRBY":
            z = self.zsets.setdefault(key, {})
            z[parts[3]] = score = z.get(parts[3], 0.0) + float(parts[2])
            return b"%d" % score if score.is_integer() else repr(score).encode()
        raise lua_mini.LuaError(f"unsupported command in a script: {cmd!r}")

    def _redis_dispatch(self, parts: list) -> bytes:
        from xaynet_tpu_torch.utils import lua_mini

        cmd = parts[0].upper()
        spaces = (self.strings, self.hashes, self.sets, self.zsets)
        if cmd == b"PING":
            return b"+PONG\r\n"
        if cmd in (b"SELECT", b"FLUSHDB"):
            if cmd == b"FLUSHDB":
                for space in spaces:
                    space.clear()
            return b"+OK\r\n"
        if cmd == b"SET":
            self.strings[parts[1]] = parts[2]
            return b"+OK\r\n"
        if cmd == b"GET":
            return self._resp(self.strings.get(parts[1]))
        if cmd == b"DEL":
            return self._resp(sum(any(space.pop(key, None) is not None for space in spaces)
                                  for key in parts[1:]))  # fmt: skip
        if cmd == b"HGETALL":
            return self._resp([x for kv in self.hashes.get(parts[1], {}).items() for x in kv])
        if cmd == b"HKEYS":
            return self._resp(list(self.hashes.get(parts[1], {})))
        if cmd == b"HDEL":
            h = self.hashes.get(parts[1], {})
            n = sum(h.pop(f, None) is not None for f in parts[2:])
            if not h:
                self.hashes.pop(parts[1], None)
            return self._resp(n)
        if cmd == b"SMEMBERS":
            return self._resp(sorted(self.sets.get(parts[1], set())))
        if cmd == b"SREM":
            members = self.sets.get(parts[1], set())
            n = sum(m in members for m in set(parts[2:]))
            members.difference_update(parts[2:])
            if not members:
                self.sets.pop(parts[1], None)
            return self._resp(n)
        if cmd == b"ZCARD":
            return self._resp(len(self.zsets.get(parts[1], {})))
        if cmd == b"ZREVRANGE":
            # Redis orders equal scores by member, descending, in ZREVRANGE
            ranked = sorted(self.zsets.get(parts[1], {}).items(),
                            key=lambda kv: (kv[1], kv[0]), reverse=True)  # fmt: skip
            lo, hi = int(parts[2]), int(parts[3])
            flat = []
            for member, score in ranked[lo : (None if hi < 0 else hi + 1)]:
                flat += [member, b"%d" % score if score.is_integer() else repr(score).encode()]
            return self._resp(flat)
        if cmd == b"SCAN":
            prefix = parts[3][:-1]  # MATCH <prefix>*
            return self._resp([b"0", [k for space in spaces for k in space
                                      if k.startswith(prefix)]])  # fmt: skip
        if cmd == b"EVAL":
            nkeys = int(parts[2])
            try:
                result = lua_mini.run_script(parts[1], parts[3 : 3 + nkeys], parts[3 + nkeys :],
                                             self._script_call)  # fmt: skip
            except lua_mini.LuaError as err:
                return b"-ERR Error running script: %s\r\n" % str(err).encode()
            return self._resp(result)
        return b"-ERR unknown command '%s'\r\n" % cmd

    # -- S3 ------------------------------------------------------------------

    async def _s3_conn(self, reader, writer) -> None:
        import asyncio

        try:
            request = await reader.readline()
            t0 = time.perf_counter()
            method, path, _ = request.decode().split(" ", 2)
            headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode().partition(":")
                headers[name.strip().lower()] = value.strip()
            body = await reader.readexactly(int(headers.get("content-length", 0)))
            with self.lock:
                status, out = self._s3_dispatch(method, path, headers, body)
            writer.write(f"HTTP/1.1 {status} X\r\ncontent-length: {len(out)}\r\n"
                         "connection: close\r\n\r\n".encode() + out)  # fmt: skip
            await writer.drain()
            if method in ("PUT", "GET") and path.count("/") == 2:
                self.ops.append(("s3", method, path, len(body) or len(out),
                                 time.perf_counter() - t0))  # fmt: skip
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass
        finally:
            writer.close()

    def _s3_dispatch(self, method: str, path: str, headers: dict, body: bytes):
        import hashlib

        from xaynet_tpu_torch.storage import sign_v4

        want = sign_v4(method, headers.get("host", ""), path, access_key=S3_ACCESS,
                       secret_key=S3_SECRET, region=S3_REGION,
                       payload_hash=headers.get("x-amz-content-sha256", ""),
                       amz_date=headers.get("x-amz-date", ""))["authorization"]  # fmt: skip
        if (headers.get("authorization") != want
                or headers.get("x-amz-content-sha256") != hashlib.sha256(body).hexdigest()):
            return 403, b"<Error><Code>SignatureDoesNotMatch</Code></Error>"
        bucket, _, key = path.lstrip("/").partition("/")
        if not key:
            if method == "PUT":
                if bucket in self.buckets:
                    return 409, b"<Error><Code>BucketAlreadyOwnedByYou</Code></Error>"
                self.buckets[bucket] = {}
                return 200, b""
            if method == "HEAD":
                return (200, b"") if bucket in self.buckets else (404, b"")
            return 400, b"bad request"
        objects = self.buckets.get(bucket)
        if objects is None:
            return 404, b"<Error><Code>NoSuchBucket</Code></Error>"
        if method == "HEAD":
            return (200, b"") if key in objects else (404, b"")
        if method == "GET":
            return (200, objects[key]) if key in objects else (404, b"")
        if method == "PUT":
            if headers.get("if-none-match") == "*" and key in objects:
                return 412, b"<Error><Code>PreconditionFailed</Code></Error>"
            objects[key] = body
            return 200, b""
        return 400, b"bad request"


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
            ("fold_planar", "fold_packed", "mask_fold", "mask_fold_rows", "wire_unpack",
             "packed_check", "unit_draws", "wire_fold", "wire_unfold"), 0
        )  # fmt: skip
        self.sass = None
        self.t_start = time.perf_counter()
        self.phase_b_out: dict | None = None  # Phase B's wires and results, for Phase W
        self.phase_r_model = None  # Phase R's model, for R-wire and D (same local models)

    # -- helpers ------------------------------------------------------------

    def timed(self, phase: str, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, its wall seconds added to the phase's in
        ``records["phase_seconds"]`` and logged."""
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spent = self.records.setdefault("phase_seconds", {})
            spent[phase] = spent.get(phase, 0.0) + time.perf_counter() - t
            log(f"[seconds] {fn.__name__}: {time.perf_counter() - t:.1f} (phase {phase} so far "
                f"{spent[phase]:.1f})")

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
                # the cursors as K5 leaves them: an int64 tensor on the card,
                # which the kernel reads and the host does not
                cursors = self.torch.tensor(offs, dtype=self.torch.int64, device=self.dev)
                held_acc, held_end = kernels.mask_fold(
                    to_device_u32(acc0, self.dev), kws, cursors, count, order, chunk
                )
                self.compare("mask_fold", held_acc, want_acc, what + " acc, device cursors")
                self.compare("mask_fold", held_end, want_end, what + " end cursors, device cursors")
                self.check(cursors.tolist() == offs, f"mask_fold: {what} device cursors unchanged")
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
        log(f"[phase A] K2 byte-exact vs plain in {n_cases} group cases, cursors as a list and "
            f"on the device; masks == host sampler")

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

    def phase_a_mask_fold_rows(self) -> None:
        """K2 with one accumulator per seed (``mask_fold_rows``) against its
        plain version, rows and end cursors: B in {1, 8, 256} on the shipped
        order (draw width 6) at a ragged length, from mid-block cursors, in
        one trip and (B in {1, 8}) in forced multi-trip runs; B in {1, 8} on
        the widest orders of Phase A's K2 cases (draw widths 37 and 268)."""
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.ops import kernels, limbs
        from xaynet_tpu_torch.ops.fold import to_device_u32

        cfgs = [
            ("prime L2 draw6", MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3),
             (1, 8, 256), 1001),
            ("L10 draw37", MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.BMAX, ModelType.M3),
             (1, 8), 1001),
            ("L67 draw268", MaskConfig(GroupType.INTEGER, DataType.F64, BoundType.BMAX, ModelType.M12),
             (1, 8), 301),
        ]  # fmt: skip
        n_cases = 0
        for label, cfg, sizes, count in cfgs:
            order = cfg.order
            n_limb, bpn = limbs.n_limbs_for_order(order), limbs.draw_width_for(order)
            expected = count * (1 << (8 * bpn)) // order
            for b in sizes:
                seeds = [self.rng.bytes(32) for _ in range(b)]
                kws = to_device_u32(np.stack([np.frombuffer(x, "<u4") for x in seeds]), self.dev)
                offs = [13 * i + 5 for i in range(b)]  # mid-block cursors
                # the forced multi-trip run at B in {1, 8}; 256 seeds in one trip
                for chunk in (None, max(7, expected // 5))[: 1 if b > 8 else 2]:
                    rows = to_device_u32(self.elements(order, n_limb, (b, count)), self.dev)
                    got, ends = kernels.mask_fold_rows(rows.clone(), kws, offs, count, order, chunk)
                    want, want_ends = kernels.mask_fold_rows_plain(rows.clone(), kws, offs, count,
                                                                   order, chunk)  # fmt: skip
                    what = f"{label} B={b} count={count} chunk={chunk}"
                    self.compare("mask_fold_rows", got, want, what + " rows")
                    self.compare("mask_fold_rows", ends, want_ends, what + " end cursors")
                    n_cases += 1
        self.sync()
        log(f"[phase A] K2 per-row (mask_fold_rows) byte-exact vs plain in {n_cases} cases")

    def phase_a_unit_draws(self) -> dict:
        """K5 (``unit_draws``) against its plain version, units and cursors,
        at the configs and seed counts the paths give it: the shipped
        prime/f32/b0/m3 (Phase B, R, T: one seed a participant, B's
        updates in its Sum2), integer/f32/b0/m6 (Phase S s2: blocks of 256, 2,048 seeds),
        prime/f32/b0/m6 (Phase L: the drivers' blocks of 512, the Sum2's
        2,000), and the widest draws of Phase A's K2 cases (37, 268 bytes)
        and a 2^(32 L) order (17-byte draws); the first seeds also against
        the host ``StreamSampler``. Timed at B's Sum2 (the kernel line's
        entry) and over s2's 2,048 seeds. The bound counts the ChaCha blocks
        each seed generates (to the block holding its cursor's last byte) on
        the ALU pipe, and the key words read and units and cursors written."""
        from xaynet_tpu_torch.core.crypto.prng import StreamSampler
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.ops import kernels, limbs
        from xaynet_tpu_torch.ops.fold import to_device_u32, to_numpy_u32

        m3 = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3).order
        s2 = MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6).order
        cases = [  # (label, order, seed counts)
            ("prime/f32/b0/m3 draw6", m3, (1, self.args.updates)),
            ("integer/f32/b0/m6 draw7", s2, (256, 2048)),
            ("prime/f32/b0/m6 draw7",
             MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M6).order, (512, 2000)),
            ("integer/f32/bmax/m3 draw37",
             MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.BMAX, ModelType.M3).order, (8,)),
            ("integer/f64/bmax/m12 draw268",
             MaskConfig(GroupType.INTEGER, DataType.F64, BoundType.BMAX, ModelType.M12).order, (8,)),
            ("2^128 draw17",
             MaskConfig(GroupType.POWER2, DataType.F64, BoundType.B6, ModelType.M12).order, (257,)),
        ]  # fmt: skip
        n_cases = 0
        for label, order, sizes in cases:
            for b in sizes:
                seeds = [self.rng.bytes(32) for _ in range(b)]
                kws = to_device_u32(np.stack([np.frombuffer(x, "<u4") for x in seeds]), self.dev)
                units, cursors = kernels.unit_draws(kws, order)
                want_units, want_cursors = kernels.unit_draws_plain(kws, order)
                what = f"{label} B={b}"
                self.compare("unit_draws", units, want_units, what + " units")
                self.compare("unit_draws", cursors, want_cursors, what + " cursors")
                host = to_numpy_u32(units)
                for i in range(min(b, 4)):
                    sampler = StreamSampler(seeds[i])
                    unit = sampler.draw_limbs(1, order)[0]
                    self.check(np.array_equal(unit, host[i])
                               and sampler.consumed_bytes == int(cursors[i]),
                               f"unit_draws: {what} seed {i} == host StreamSampler")  # fmt: skip
                n_cases += 1
        self.sync()
        log(f"[phase A] K5 (unit_draws) byte-exact vs plain and host sampler in {n_cases} cases")

        out = {}
        for tag, order, b in (("main", m3, self.args.updates), ("s2", s2, 2048)):
            kws = to_device_u32(self.rng.integers(0, 1 << 32, (b, 8), dtype=np.uint64)
                                .astype(np.uint32), self.dev)  # fmt: skip
            _, cursors = kernels.unit_draws(kws, order)
            self.sync()
            t = time.perf_counter()
            kernels.unit_draws_plain(kws, order)
            self.sync()
            plain_ms = (time.perf_counter() - t) * 1e3
            ms = self.time_ms(lambda: kernels.unit_draws(kws, order), 20)
            blocks = float(int(((cursors + 63) // 64).sum()))
            n_limb = limbs.n_limbs_for_order(order)
            out[tag] = {
                "ms": ms,
                "plain_ms": plain_ms,
                "blocks": blocks,
                "ops": blocks * CHACHA_ALU_OPS_PER_BLOCK,
                "bytes": b * (32 + 4 * n_limb + 8),
                "shape": f"{b} seeds, draw width {limbs.draw_width_for(order)}",
            }
            log(f"[phase A] unit_draws over {out[tag]['shape']}: {ms:.4f} ms ({blocks:.0f} ChaCha "
                f"blocks; plain {plain_ms:.1f} ms)")
        return {**out["main"], "s2": out["s2"]}

    def phase_a_rows_main(self) -> dict:
        """``mask_fold_rows`` at Phase S's two shapes, checked against its
        plain version there and timed: (s1) 8 seeds into 8 rows of the main
        length, shipped order, the plain version on the first of them only
        (seed b goes into row b alone, and Phase S holds all 8 rows against
        the round's own path); (s2) 256 seeds into 256 rows of 1,000
        elements, integer/f32/b0/m6. The cursors are K5's, on the card. The
        kernel line's entry is s1's; s2's goes beside it, with the time of K5
        and K2 per row together (a block of the sim). The bound counts the
        ChaCha blocks these seeds' draws need (start to end cursor) on the
        ALU pipe, and the rows' bytes read and written once."""
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.ops import kernels, limbs
        from xaynet_tpu_torch.ops.fold import to_device_u32
        from xaynet_tpu_torch.ops.masking import seed_words

        torch = self.torch
        shapes = [  # tag, config, seeds, count, timing reps, rows held against plain
            ("s1", MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3), 8,
             self.args.length, 3, 1),
            ("s2", MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6), 256,
             1000, 10, 256),
        ]  # fmt: skip
        out = {}
        for tag, cfg, b, n, reps, plain_rows in shapes:
            order, n_limb = cfg.order, limbs.n_limbs_for_order(cfg.order)
            seeds = [self.rng.bytes(32) for _ in range(b)]
            kws = to_device_u32(seed_words(seeds), self.dev)
            _, offs = kernels.unit_draws(kws, order)
            rows = to_device_u32(self.elements(order, n_limb, (b, n)), self.dev)
            got, ends = kernels.mask_fold_rows(rows.clone(), kws, offs, n, order)
            self.sync()
            t = time.perf_counter()
            p = plain_rows
            want, want_ends = kernels.mask_fold_rows_plain(rows[:p].clone(), kws[:p], offs[:p],
                                                           n, order)  # fmt: skip
            self.sync()
            plain_ms = (time.perf_counter() - t) * 1e3
            what = f"{tag} shape B={b} count={n}" + (f", rows 0-{p - 1}" if p < b else "")
            self.compare("mask_fold_rows", got[:p], want, what + " rows")
            self.compare("mask_fold_rows", ends[:p], want_ends, what + " end cursors")
            del got, want
            work = rows.clone()
            ms = self.time_ms(lambda: kernels.mask_fold_rows(work, kws, offs, n, order), reps)

            def block_of_sim():
                _, starts = kernels.unit_draws(kws, order)
                kernels.mask_fold_rows(work, kws, starts, n, order)

            with_k5 = self.time_ms(block_of_sim, reps)
            blocks = float(int((ends - offs).sum())) / 64
            out[tag] = {
                "ms": ms,
                "ms_with_unit_draws": with_k5,
                "plain_ms": plain_ms,
                "plain_rows": plain_rows,
                "blocks": blocks,
                "ops": blocks * CHACHA_ALU_OPS_PER_BLOCK,
                "bytes": 2 * rows.numel() * 4,
                "shape": f"{b} seeds into uint32[{b},{n_limb},{n}]",
            }
            del rows, work
            if self.cuda:
                torch.cuda.empty_cache()
            log(f"[phase A] mask_fold_rows at {tag}'s shape {out[tag]['shape']}: {ms:.3f} ms "
                f"(with K5's unit draws before it {with_k5:.3f} ms; plain {plain_ms:.1f} ms "
                f"over {plain_rows} of its {b} rows)")
        return {**out["s1"], "s2": out["s2"]}

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
        (module docstring), and K6 over the same blocks into a non-zero
        accumulator against ``wire_fold_plain`` (the rejected members left
        out). The verdicts are also held against the planted
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
                # K6: the same blocks folded into a non-zero accumulator,
                # the rejected members left out
                from xaynet_tpu_torch.ops.fold import to_device_u32

                acc0 = to_device_u32(self.elements(order, n_limb, (n,)), self.dev)
                acc, ok = kernels.wire_fold(acc0.clone(), raw, order)
                want_acc, want_ok = kernels.wire_fold_plain(acc0.clone(), raw, order)
                self.compare("wire_fold", acc, want_acc, what + " accumulator")
                self.compare("wire_fold", ok, want_ok, what + " acceptance")
                self.check({i for i, v in enumerate(ok.tolist()) if not v} == want_bad,
                           f"wire: {what} K6 leaves out updates {sorted(want_bad)}")
                if k in (3, 64):
                    self.k6_staging_edges(raw, acc0, acc, ok, order, n_limb, bpn, what)
                del raw, packed, planar, bad, want_planar, want, got, acc0, acc, want_acc
                n_cases += 1
        self.sync()
        log(f"[phase A] K3, K4 and K6 byte-exact vs plain in {n_cases} cases "
            "(planted invalid elements rejected, order - 1 accepted)")

    def k6_staging_edges(self, raw, acc0, acc, ok, order: int, n_limb: int, bpn: int,
                         what: str) -> None:
        """K6 where its staged member tiles meet their edges: the same blocks
        from bases 1 and 15 bytes past a 16-byte boundary (the bytes of a
        ``raw[1:]`` view made contiguous) against the aligned result, and
        the subtract-back pass there against its plain version; then the
        first T - 1, T and T + 1 columns, T the kernel's tile at this width
        (``wire_cpt`` times ``wire_threads`` in ``csrc/fold.cu``), against
        the plain version."""
        from xaynet_tpu_torch.ops import kernels

        torch = self.torch
        k = raw.shape[0]
        drop = torch.zeros(k, dtype=torch.bool, device=self.dev)
        drop[0] = drop[-1] = True
        buf = torch.empty(raw.numel() + 16, dtype=torch.uint8, device=self.dev)
        for off in (1, 15):
            shifted = buf[off : off + raw.numel()].view(raw.shape)
            shifted.copy_(raw)
            got, got_ok = kernels.wire_fold(acc0.clone(), shifted, order)
            self.compare("wire_fold", got, acc, f"{what} base + {off} bytes: accumulator")
            self.compare("wire_fold", got_ok, ok, f"{what} base + {off} bytes: acceptance")
        self.compare("wire_unfold", kernels.wire_unfold(acc0.clone(), shifted, drop, order),
                     kernels.wire_unfold_plain(acc0.clone(), shifted, drop, order),
                     f"{what} base + 15 bytes: members 0 and K-1 taken back")  # fmt: skip
        del buf, shifted, got
        cpt = {2: 4, 3: 2, 4: 2}.get(n_limb, 1)
        threads = 256
        while threads > 32 and threads * cpt * bpn > 8192:
            threads //= 2
        tile = cpt * threads
        for m in (tile - 1, tile, tile + 1):
            part = raw[:, : m * bpn].contiguous()
            base = acc0[:, :m].contiguous()
            got, got_ok = kernels.wire_fold(base.clone(), part, order)
            want, want_ok = kernels.wire_fold_plain(base.clone(), part, order)
            self.compare("wire_fold", got, want, f"{what} first {m} columns (tile {tile}): accumulator")
            self.compare("wire_fold", got_ok, want_ok, f"{what} first {m} columns: acceptance")

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
        from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator
        from xaynet_tpu_torch.server.aggregation import StagedAggregator

        args = self.args
        cfg = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)
        pair = cfg.pair()
        order, length, n_up = cfg.order, args.length, args.updates
        seeds, idx, models = phase_b_population(args.seed, n_up, length)
        scalar = Scalar(Fraction(1, n_up))
        walls = {"participants_mask": 0.0, "update_aggregate": 0.0}
        sampled, units, wires, evens = [], [], [], []
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
        for i, weights in enumerate(models):
            wsum += weights
            t = time.perf_counter()
            obj = masking.mask_update(seeds[i], scalar, weights, pair, device=self.dev)
            self.sync_current_stream()  # the folds in flight on their own stream run on
            walls["participants_mask"] += time.perf_counter() - t
            sampled.append(obj.vect.data[idx].copy())
            units.append(obj.unit.data.copy())
            if i % 2 == 0:  # the v1 ones: W's fused leg folds them again
                evens.append(obj.vect.data)
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
            self.check(launches["unit_draws"] == n_up + 1,
                       f"(d) K5 drew the units: one launch a participant, one for the Sum2's "
                       f"{n_up} seeds ({launches['unit_draws']} == {n_up + 1})")
        log(f"[phase B] round of {n_up} updates x {length} params: checks (a)-(d) passed; "
            f"decode max err {err:.3e} <= {tol:.3e}")
        log(f"[phase B] launches {launches}")
        log("[phase B] wall seconds: "
            + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
        stream = self.pipeline_record(pipeline, ring, fold_events)
        log(f"[phase B] serialized the {n_up} updates for Phase W in {serialize_s:.3f} s "
            "(outside the walls)")
        # Phase W's fused-leg reference: the even (v1) updates folded as they
        # were masked, after B's launches were read (K1 planar, one a row)
        t = time.perf_counter()
        even_acc = DeviceAggregator(pair.vect, length, device=self.dev)
        while evens:
            even_acc.add_batch(evens.pop(0)[None])
        evens_vect, evens_s = even_acc.snapshot(), time.perf_counter() - t
        del even_acc
        log(f"[phase B] folded the {len(range(0, n_up, 2))} even updates for Phase W's fused leg "
            f"in {evens_s:.3f} s (outside the walls)")
        spec = self.phase_b_speculation(seeds, length, pair, unit_m, vect_m)
        self.phase_b_out = {"wires": wires, "vect": got.vect.data, "unit": got.unit.data,
                            "model": model, "mask": mask, "evens_vect": evens_vect,
                            "units": units}
        return {"walls": walls, "launches": launches, "decode_max_err": err, "pipeline": stream,
                "serialize_s": serialize_s, "speculation": spec}

    def phase_b_speculation(self, seeds: list, length: int, pair, unit_m, vect_m) -> dict:
        """The speculative Sum2 (``ops.speculation``) on Phase B's round: a
        session on B's config with a ``TenantScheduler`` (idle slots only) is
        offered all but one of B's Sum2 seeds and one seed that never
        arrives; once it has folded them all (K5, K2, K1 planar in its
        worker, groups of ``batch``), it settles on B's seeds. Checks: the result is
        byte-identical to B's ``sum_masks``, the outcomes are n - 1 hits, 1
        miss and 1 discard, and the worker failed nothing."""
        from xaynet_tpu_torch.ops import kernels
        from xaynet_tpu_torch.ops.speculation import SpeculativeMaskSession
        from xaynet_tpu_torch.telemetry.registry import get_registry
        from xaynet_tpu_torch.tenancy import TenantScheduler

        registry = get_registry()

        def outcomes() -> dict:
            return {k: registry.sample_value("xaynet_spec_derive_total", {"outcome": k}) or 0
                    for k in ("hit", "miss", "discard")}  # fmt: skip

        stray = bytes(self.rng.integers(0, 256, 32, dtype=np.uint8))
        offered = seeds[:-1] + [stray]
        before = outcomes()
        kernels.reset_launches()
        t0 = time.perf_counter()
        spec = SpeculativeMaskSession(length, pair, group=self.args.batch, tenant="phase-b",
                                      scheduler=TenantScheduler(), device=self.dev)  # fmt: skip
        spec.offer(offered)
        wait_for(lambda: spec.speculated() == len(offered) or spec.worker_error is not None,
                 300, "the speculative worker to fold the offered seeds")  # fmt: skip
        worker_s = time.perf_counter() - t0
        t = time.perf_counter()
        unit, vect = spec.settle(seeds)
        self.sync()
        settle_s = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
        after = outcomes()
        got = {k: after[k] - before[k] for k in after}
        self.check(spec.worker_error is None,
                   f"(b-spec1) the speculative worker failed nothing ({spec.worker_error!r})")
        self.check(vect.tobytes() == vect_m.tobytes() and unit.tobytes() == unit_m.tobytes(),
                   "(b-spec2) settle == Phase B's sum_masks over its seeds, byte for byte")
        self.check(got == {"hit": len(seeds) - 1, "miss": 1, "discard": 1},
                   f"(b-spec3) outcomes {got} == {len(seeds) - 1} hits, 1 miss, 1 discard")
        if self.cuda:
            groups = -(-len(offered) // self.args.batch)
            self.check(launches["fold_planar"] == groups + 1,
                       f"(b-spec4) K1 planar folded each of the {groups} derived groups and the "
                       f"miss ({launches['fold_planar']})")  # fmt: skip
        log(f"[phase B] speculative Sum2: checks (b-spec1)-(b-spec4) passed; the worker folded "
            f"{len(offered)} offered seeds in {worker_s:.3f} s, settle (1 miss derived, 1 "
            f"discard subtracted, the one download) {settle_s:.3f} s; launches {launches}")
        return {"worker_s": worker_s, "settle_s": settle_s, "outcomes": got, "launches": launches}

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
        b = self.phase_b_out  # Phase X reads it too, then lets it go
        cfg = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)
        pair, length, bpn, batch = cfg.pair(), args.length, cfg.bytes_per_number, args.batch
        wires = b["wires"]
        n_up = len(wires)
        # one more update: update 0's v1 wire with its middle element all 0xFF
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
        fused = self.phase_w_fused([objs[i] for i in range(n_up + 1)], pair, timings,
                                   b["evens_vect"])  # fmt: skip
        return {"walls": walls, "launches": launches, "groups": [len(g) for g in groups],
                "prevalidate_parts": parts, "fused": fused}

    def phase_w_fused(self, objs: list, pair, timings: dict, want: np.ndarray) -> dict:
        """Phase W's fused leg: the v1 wires (B's even updates) and the
        corrupted one as raw element blocks, in two batches (half of them,
        then the rest with the corrupted one in the middle), through
        ``DeviceAggregator.add_wire_batch`` and through
        ``StreamingAggregator.submit_wire_batch`` + ``drain`` (kernel K6,
        one launch a batch). Checks: both accumulators byte-identical to
        ``want``, the accepted updates as Phase B masked them, folded
        during Phase B (K1 planar); ``ok`` rejects the corrupted one alone
        and ``nb_models`` counts B's v1 updates; K6 bit for bit
        against ``wire_fold_plain`` at both shapes. Then K6 timed at both
        shapes (CUDA events; the kernel line's time and bound are their
        means, the bound counting one pass over the members' bytes and one
        read and write of the accumulator, whatever the verdicts; the
        subtract-back pass's extra bytes are logged apart) beside its plain
        version, and at ``uint8[8, n * bpn]`` (8 valid updates)."""
        from xaynet_tpu_torch.ops import kernels
        from xaynet_tpu_torch.ops.fold import zeros_u32
        from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator
        from xaynet_tpu_torch.parallel.streaming import StreamingAggregator

        torch = self.torch
        n_up = len(objs) - 1
        length, order = self.args.length, pair.vect.order
        from xaynet_tpu_torch.ops import limbs

        n_limb, bpn = limbs.n_limbs_for_order(order), pair.vect.bytes_per_number
        evens = list(range(0, n_up, 2))
        half = len(evens) // 2
        ids = [evens[:half], evens[half:half + 1] + [n_up] + evens[half + 1:]]
        blocks = {i: np.asarray(objs[i].vect.wire_block) for b in ids for i in b}
        batches = [np.stack([blocks[i] for i in b]) for b in ids]
        kernels.reset_launches()
        t = time.perf_counter()
        direct = DeviceAggregator(pair.vect, length, device=self.dev)
        oks = [direct.add_wire_batch(batch) for batch in batches]
        self.sync()
        direct_s = time.perf_counter() - t
        t = time.perf_counter()
        streamed = DeviceAggregator(pair.vect, length, device=self.dev)
        stream = StreamingAggregator(streamed, max_batch=max(len(b) for b in ids))
        tickets = [stream.submit_wire_batch(batch) for batch in batches]
        accepted = stream.drain()
        self.sync()
        stream_s = time.perf_counter() - t
        stream.close()
        launches = dict(kernels.LAUNCHES)
        corrupted = [[i == n_up for i in b] for b in ids]
        self.check([o.tolist() for o in oks] == [[not c for c in b] for b in corrupted]
                   and [t.accepted.tolist() for t in tickets] == [o.tolist() for o in oks],
                   "(wf1) ok rejects exactly the corrupted update, on both paths")  # fmt: skip
        self.check(direct.nb_models == streamed.nb_models == len(evens) == accepted,
                   f"(wf2) nb_models {direct.nb_models}, {streamed.nb_models} == {len(evens)}")
        self.check(np.array_equal(direct.snapshot(), want) and np.array_equal(streamed.snapshot(), want),
                   "(wf3) add_wire_batch's and the pipeline's accumulators byte-identical to the "
                   f"fold of the {len(evens)} accepted updates as Phase B masked them")  # fmt: skip
        if self.cuda:
            self.check(launches["wire_fold"] == 4 and launches["wire_unpack"] == 0
                       and launches["fold_planar"] == 0,
                       f"(wf4) K6 once a batch on each path, no K3 and no planar batch "
                       f"({launches})")  # fmt: skip
        del want, direct, streamed, stream
        runs = []
        for b, batch in zip(ids, batches):
            staged = torch.from_numpy(batch).to(self.dev)
            acc0 = zeros_u32((n_limb, length), self.dev)
            got, ok = kernels.wire_fold(acc0.clone(), staged, order)
            want_acc, want_ok = kernels.wire_fold_plain(acc0.clone(), staged, order)
            what = f"Phase W's fused batch of {len(b)}"
            self.compare("wire_fold", got, want_acc, what + ": accumulator")
            self.compare("wire_fold", ok, want_ok, what + ": acceptance")
            del got, want_acc
            rejected = len(b) - int(ok.sum())
            # the bound is the function's least traffic: every member's bytes
            # once, the accumulator read and written once, the verdicts; the
            # subtract-back pass over rejected members is this design's cost
            runs.append({
                "shape": list(staged.shape), "rejected": rejected,
                "bytes": staged.numel() + 8 * n_limb * length + 4 * len(b),
                "unfold_bytes": rejected * (length * bpn + 8 * n_limb * length),
                "ms": self.time_ms(lambda: kernels.wire_fold(acc0, staged, order), 10),
                "plain_ms": self.time_ms(lambda: kernels.wire_fold_plain(acc0, staged, order), 2),
                "device_ms": self.device_ms(lambda: kernels.wire_fold(acc0, staged, order), "wire_"),
            })  # fmt: skip
            del staged, acc0
        # 8 valid members (B's v1 blocks, repeated where B has fewer than 8)
        eight = torch.from_numpy(np.stack(([blocks[i] for i in evens] * 8)[:8])).to(self.dev)
        acc0 = zeros_u32((n_limb, length), self.dev)
        k8 = {"shape": list(eight.shape),
              "bytes": eight.numel() + 8 * n_limb * length + 4 * eight.shape[0],
              "ms": self.time_ms(lambda: kernels.wire_fold(acc0, eight, order), 10),
              "device_ms": self.device_ms(lambda: kernels.wire_fold(acc0, eight, order), "wire_")}
        k8["bound_ms"] = k8["bytes"] / MEM_BYTES_PER_S * 1e3
        del eight, acc0
        if self.cuda:
            torch.cuda.empty_cache()

        def mean(key):
            return sum(r[key] for r in runs) / len(runs)

        timings["wire_fold"] = {"ms": mean("ms"), "plain_ms": mean("plain_ms"),
                                "bytes": mean("bytes"), "launches": runs, "k8_shape": k8,
                                "shape": " and ".join(str(r["shape"]) for r in runs)}  # fmt: skip
        if all(r["device_ms"] is not None for r in runs):
            timings["wire_fold"]["device_ms"] = mean("device_ms")
        log(f"[phase W] fused leg: {len(evens)} v1 wires + the corrupted one in batches "
            f"{[len(b) for b in ids]}: checks (wf1)-(wf4) passed; add_wire_batch {direct_s:.3f} s, "
            f"submit_wire_batch + drain {stream_s:.3f} s; "
            f"launches {launches}")
        for r in runs + [k8]:
            log(f"[phase W] K6 at {r['shape']}: {r['ms']:.3f} ms, device "
                f"{r['device_ms'] or float('nan'):.3f} ms, bound "
                f"{r['bytes'] / MEM_BYTES_PER_S * 1e3:.3f} ms ({r['bytes']} bytes)"
                + (f", plain {r['plain_ms']:.1f} ms, {r['rejected']} rejected (the subtract-back "
                   f"pass moves {r['unfold_bytes']} bytes more)" if "plain_ms" in r else ""))
        return {"launches": launches, "direct_s": direct_s, "stream_s": stream_s}

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

    def traced(self, name: str, fn, settle_s: float = 0.5):
        """Run ``fn`` inside a ``torch.profiler`` window with CUDA activity
        only (CUPTI records every kernel, copy and fill this process puts on
        the card, from any thread: the coordinator's executors and the
        participants alike) and keep its summary in ``records["traces"]``
        (:func:`trace_summary`). ``settle_s`` seconds pass between the
        window's start and ``fn``, and between ``fn``'s end and the window's
        (not counted in its wall): device events near a window's edges can
        go missing (PERF.md §6). A reading that fails is recorded as
        such; an error of ``fn`` propagates."""
        if not self.cuda:
            return fn()
        from torch.profiler import ProfilerActivity, profile

        traces = self.records.setdefault("traces", {})
        try:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        except Exception as exc:  # an extra reading: record why it is missing
            traces[name] = f"unavailable: {type(exc).__name__}: {exc}"
            return fn()
        time.sleep(settle_s)
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            wall = time.perf_counter() - t0
            try:
                self.torch.cuda.synchronize()
                time.sleep(settle_s)
                prof.__exit__(None, None, None)
                traces[name] = trace_summary(prof, wall)
                traces[name]["settle_s"] = settle_s
                traces[name]["process_age_s"] = time.perf_counter() - self.t_start
            except Exception as exc:
                traces[name] = f"unavailable: {type(exc).__name__}: {exc}"

    def pipeline_record(self, pipeline, ring, fold_events) -> dict:
        """What the pipeline's last drain window saw in Phase B: per flush,
        the stage leg (packing into the ring, on the caller's thread) and
        the fold leg (the worker: upload out of the pinned ring and K1's
        launch, until the copy completed), how long after ``flush``
        returned the fold leg ended, K1 packed's device time (CUDA events),
        the overlap ratio, and the staging ring's buffers, how many landed
        in page-locked slabs of the page pool and what pinning the others'
        slabs cost."""
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
            f"buffer(s), {record['ring_bytes']} bytes, {record['ring_reused']} in pool slabs locked "
            f"before, the others' slabs pinned in {record['ring_pin_s']:.3f} s (RLIMIT_MEMLOCK "
            f"{record['rlimit_memlock'] or 'unlimited'})")
        return record

    # -- device kernel times on the main path -------------------------------

    # -- phase R: a round through the port's coordinator ----------------------

    # -- phase S: the whole-round simulation ----------------------------------

    def phase_s(self, wires: list) -> dict:
        """(s1) ``SimRound`` on Phase B's first participants (those whose
        wires ``wires`` holds: main passes a quarter of B's first flush; their
        seeds and f32 models, scalar 1/n as B encoded them,
        one block, ``fuse_mask_sum``) at the main length, against the same
        participants through the round's own path: K1's fold of their masked
        wires as B serialized them (``wires``; lazy parse, K3/K4, K1 on the
        device rows), ``sum_masks`` over their seeds (K2), the unmask and
        decode. Its aggregates, unmasked limbs and float64 model must be
        those, byte for byte. (s2) The shape of the JAX package's bench sim
        leg: 2,048 participants x 1,000 parameters, integer/f32/b0/m6,
        blocks of 256, one warm-up and three timed runs; the model within
        1e-6 of the f32 mean. Counts the sim's launches (K2 per row, K1
        planar); the reference's go beside them."""
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.core.mask.object import MaskObject, MaskUnit, MaskVect
        from xaynet_tpu_torch.core.mask.serialization import parse_mask_object
        from xaynet_tpu_torch.ops import kernels, limbs, masking
        from xaynet_tpu_torch.ops.fold import to_device_u32
        from xaynet_tpu_torch.server.aggregation import StagedAggregator
        from xaynet_tpu_torch.sim import SimRound, SimSpec, seeds_for

        args = self.args
        device = None if self.cuda else self.dev  # no device: CUDA
        cfg = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)
        pair, length, n_up, block = cfg.pair(), args.length, args.updates, args.batch
        k = len(wires)
        seeds, _, models = phase_b_population(args.seed, n_up, length)
        seeds = seeds[:k]

        # the reference: B's first k updates through the round's own path
        kernels.reset_launches()
        t = time.perf_counter()
        agg = StagedAggregator(pair, length, batch_size=k, device=self.dev)
        objs = [parse_mask_object(w, lazy_vect=True)[0] for w in wires]
        agg.prevalidate_wire_batch(objs)
        for obj in objs:
            agg.validate_aggregation(obj)
            agg.aggregate(obj)
        final = agg.finalize_inplace()
        unit_m, vect_m = masking.sum_masks(seeds, length, pair, seed_batch=k, device=self.dev)
        mask = MaskObject(MaskVect(pair.vect, vect_m), MaskUnit(pair.unit, unit_m))
        final.validate_unmasking(mask)
        ref_vect, ref_unit = final.object.vect.data, final.object.unit.data
        ref_model = final.unmask_array(mask)
        self.sync()
        ref_s = time.perf_counter() - t
        ref_launches = dict(kernels.LAUNCHES)
        del agg, objs, final

        weights = np.empty((k, length), dtype=np.float32)
        for i, w in zip(range(k), models):
            weights[i] = w
        kernels.reset_launches()
        t = time.perf_counter()
        spec = SimSpec(pair, length, block_size=block, return_internals=True)
        sim = SimRound(spec, device=device)
        res = sim.run(seeds, weights, scalar=Fraction(1, n_up))
        s1_s = time.perf_counter() - t
        s1_launches = dict(kernels.LAUNCHES)
        del weights
        inner = res.internals
        ol = limbs.order_limbs_for(cfg.order)
        ol_u = limbs.order_limbs_for(pair.unit.order)
        self.check(np.array_equal(inner["masked_vect_sum"], ref_vect)
                   and np.array_equal(inner["masked_unit_sum"], ref_unit),
                   f"(s1) sim's masked aggregate (vect and unit) == K1's fold of B's first {k} wires")
        self.check(np.array_equal(inner["mask_vect_sum"], mask.vect.data)
                   and np.array_equal(inner["mask_unit_sum"], mask.unit.data),
                   f"(s1) sim's mask sum == sum_masks over B's first {k} seeds")
        want_limbs = limbs.mod_sub(ref_vect, mask.vect.data, ol)
        self.check(np.array_equal(res.model_vect_limbs, want_limbs),
                   "(s1) sim's model_vect_limbs == the fold - the mask sum")
        want_unit = limbs.mod_sub(ref_unit[None], mask.unit.data[None], ol_u)[0]
        want_unit = limbs.limbs_to_int(want_unit)
        self.check(res.model_unit_int == want_unit, "(s1) sim's unmasked unit == the fold's")
        self.check(res.global_model.tobytes() == ref_model.tobytes(),
                   f"(s1) sim's float64 model == unmask_array of the fold, byte for byte "
                   f"({length} params)")
        blocks = -(-k // block)
        if self.cuda:
            got = s1_launches
            self.check(got["mask_fold_rows"] == blocks and got["unit_draws"] == blocks
                       and got["fold_planar"] == 3 * blocks and got["mask_fold"] == 0
                       and sim.program_calls == 1,
                       f"(s1) launches: K2 per row {got['mask_fold_rows']} == {blocks} (one a "
                       f"block of {k} seeds), K5 {got['unit_draws']} == {blocks}, K1 planar "
                       f"{got['fold_planar']} == {3 * blocks}, K2 mask_fold 0")  # fmt: skip
        del res, inner, want_limbs
        log(f"[phase S] (s1) SimRound of Phase B's first {k} participants (scalar 1/{n_up}) x "
            f"{length} params, blocks of {block}: byte-identical to K1's fold of their wires, "
            f"sum_masks, the limbs and unmask_array's model in {s1_s:.3f} s (the reference "
            f"{ref_s:.3f} s, launches {ref_launches}); launches {s1_launches}")

        # (s2) the bench sim leg's shape
        cfg2 = MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6)
        p, n, block2 = 2048, 1000, 256
        seeds2 = seeds_for(p, root=42)
        weights2 = np.random.default_rng(42).uniform(-1, 1, (p, n)).astype(np.float32)
        sim2 = SimRound(SimSpec(cfg2.pair(), n, block_size=block2), device=device)
        kernels.reset_launches()
        t = time.perf_counter()
        res2 = sim2.run(seeds2, weights2, scalar=Fraction(1, p))  # warm-up
        warm_s = time.perf_counter() - t
        runs = []
        for _ in range(3):
            t = time.perf_counter()
            res2 = sim2.run(seeds2, weights2, scalar=Fraction(1, p))
            runs.append(time.perf_counter() - t)
        s2_launches = dict(kernels.LAUNCHES)
        err = float(np.max(np.abs(res2.global_model - weights2.astype(np.float64).mean(axis=0))))
        self.check(res2.global_model.shape == (n,) and err <= 1e-6,
                   f"(s2) |model - f32 mean| = {err:.3e} <= 1e-6 ({p} x {n})")
        if self.cuda:
            self.check(s2_launches["mask_fold_rows"] == 4 * (p // block2)
                       and s2_launches["unit_draws"] == 4 * (p // block2)
                       and s2_launches["fold_planar"] == 4 * 3 * (p // block2),
                       f"(s2) launches over 4 runs: K2 per row {s2_launches['mask_fold_rows']} and "
                       f"K5 {s2_launches['unit_draws']} == {4 * (p // block2)} (one a block and "
                       f"trip), K1 planar {s2_launches['fold_planar']} == {12 * (p // block2)}")
        # the unit draws' share: K5 over the 2,048 seeds in one launch
        kw2 = to_device_u32(masking.seed_words(seeds2), self.dev)
        unit_draws_ms = self.time_ms(lambda: kernels.unit_draws(kw2, cfg2.order), 10)
        pps = sorted(p / r for r in runs)
        self.s2_model = res2.global_model  # Phase S-mesh's reference
        log(f"[phase S] (s2) SimRound {p} participants x {n} params, integer/f32/b0/m6, blocks "
            f"of {block2}: median {pps[1]:.1f} participants/s (min {pps[0]:.1f}, max {pps[2]:.1f}; "
            f"runs {[round(r, 3) for r in runs]} s; warm-up {warm_s:.3f} s); |model - mean| "
            f"{err:.3e}; launches {s2_launches}; K5 over the {p} seeds {unit_draws_ms:.4f} ms")
        launches = {k: s1_launches[k] + s2_launches[k] for k in s1_launches}
        return {"s1_seconds": s1_s, "s1_launches": s1_launches, "s1_participants": k,
                "s1_reference_s": ref_s, "s1_reference_launches": ref_launches, "s2_runs_s": runs,
                "s2_warmup_s": warm_s, "s2_participants_per_s": {"median": pps[1], "min": pps[0],
                                                                  "max": pps[2]},
                "s2_launches": s2_launches, "s2_mean_err": err, "s2_unit_draws_ms": unit_draws_ms,
                "launches": launches}

    def phase_r(self, wire: bool = False) -> dict:
        """One PET round through the port's coordinator (``serve()`` in a
        thread, CUDA) over the socket, at the main length, driven by the
        port's participant SDK (``sdk_round``: 3 update participants and one
        sum participant, no device passed, so CUDA); checks the model
        against the same inputs folded and unmasked by the plain versions
        on the CPU and against the mean, the kernels each side launched and
        that the coordinator's aggregator folded on CUDA. With ``wire``
        (Phase R-wire): device wire ingest, wire v2 uploads, the ``file``
        coordinator store and the round journal; the coordinator's K4
        checks every update."""
        import os
        import resource
        import shutil
        import tempfile

        from xaynet_tpu_torch.core.crypto import encrypt
        from xaynet_tpu_torch.ops import kernels
        from xaynet_tpu_torch.server import settings as settings_mod
        from xaynet_tpu_torch.server.phases import update as update_phase

        args = self.args
        tag, c = ("phase R-wire", "rw") if wire else ("phase R", "r")
        length, n_up = args.length, 3
        # R-wire (and Phase D) take R's local models: their model must be R's
        rng = np.random.default_rng(args.seed + 3)
        weights = [rng.uniform(-0.9, 0.9, length).astype(np.float32) for _ in range(n_up)]
        work = Path(tempfile.mkdtemp(prefix="xn_phase_r_"))
        built, rings = [], {}  # the update phase's aggregators, their staging rings
        real_build = update_phase.build_staged_aggregator

        def spy(shared):
            agg = real_build(shared)
            stream, close = agg._stream, agg._stream.close

            def keep_rings_then_close():  # close() hands the rings back to the pool
                rings.update(stream._rings)
                close()

            stream.close = keep_rings_then_close
            built.append(agg)
            return agg

        port = free_port()
        base = f"http://127.0.0.1:{port}"
        host_load = {"loadavg": os.getloadavg(), "cpus": len(os.sched_getaffinity(0))}
        cfg = write_coordinator_config(work / "config.toml", port, length, work / "models", n_up,
                                       wire=wire)  # fmt: skip
        settings = settings_mod.Settings.load(str(cfg), env={})
        agg_cfg = settings.aggregation
        self.check(agg_cfg.device and agg_cfg.batch_size == 64 and agg_cfg.packed_staging
                   and agg_cfg.wire_ingest == wire
                   and (settings.ingest.wire_format == "packed") == wire
                   and (settings.storage.coordinator == "file") == wire
                   and settings.resilience.checkpoint_enabled == wire,
                   f"({c}0) {tag}'s config: device fold, batch 64, packed staging, wire ingest "
                   f"{wire}, packed uploads {wire}, file store and journal {wire}")  # fmt: skip
        update_phase.build_staged_aggregator = spy
        marks = PhaseMarks()
        logging.getLogger("xaynet.coordinator").addHandler(marks)
        # no device: CUDA (the CPU rehearsal names its device)
        device = None if self.cuda else self.dev
        coordinator = InProcessCoordinator(settings, device)
        state_file = work / "models" / "coordinator_state.json"
        try:
            t = time.perf_counter()
            wait_for(lambda: coordinator_phase(base) == "sum", 120, "the coordinator's sum phase")
            start_s = time.perf_counter() - t
            before = pipeline_counters()
            kernels.reset_launches()
            out = self.traced(tag, lambda: sdk_round(base, weights, device, PHASE_R_PART_BYTES,
                                                     timeout=300))  # fmt: skip
            launches = dict(kernels.LAUNCHES)
            after = pipeline_counters()
            state_written = state_file.exists()
        finally:
            update_phase.build_staged_aggregator = real_build
            coordinator.stop()
            logging.getLogger("xaynet.coordinator").removeHandler(marks)
            shutil.rmtree(work, ignore_errors=True)
        peak_rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        model, walls = out["model"], out["walls"]
        pipeline = {k: after[k] - before[k] for k in after}

        def mark(prefix: str, text: str) -> float | None:
            """Seconds from the first update POST to the coordinator's log line."""
            hit = marks.first(prefix, text)
            return hit[0] - walls["t0"] if hit else None

        phases = {
            "update_full_close": mark("round 1", "update: full close"),
            # the flush is submitted; [overlap] sum2_drain runs the drain in sum2
            "update_closed": mark("round 1", "entering sum2 phase"),
            "sum2_closed": mark("round 1", "entering unmask phase"),
            "unmask_done": mark("round 2", "entering idle phase"),
            "model_available": walls["model_available"],
        }
        ring = rings.get("packed")
        window = (built[0]._stream.last_window or {}) if built else {}
        drain = {
            "ring_bytes": None if ring is None else ring.nbytes,
            "ring_buffer_rows": None if ring is None else list(ring.buffer_rows),
            "ring_pin_s": None if ring is None else ring.pin_seconds,
            "ring_reused": None if ring is None else ring.reused,
            "stage_s": window.get("stage_seconds"),
            "fold_s": window.get("fold_seconds"),
        }

        # R: the same inputs through the plain versions on the CPU (the fold
        # of the three masked updates, the unmask with the Sum2 mask); R-wire
        # took R's local models, so its model must be R's
        t = time.perf_counter()
        if wire:
            ref_model, what = self.phase_r_model, "Phase R's model from the same local models"
        else:
            ref_model = plain_round_model(out, length)
            what = "the plain CPU fold + unmask of the updates and the mask the SDK participants sent"
            self.phase_r_model = ref_model
        plain_s = time.perf_counter() - t
        self.check(model.shape == (length,) and bool(np.all(np.isfinite(model))),
                   f"({c}1) global model finite, of the model length")
        self.check(model.tobytes() == ref_model.tobytes(),
                   f"({c}2) global model byte-identical to {what}")
        mean = np.sum([w.astype(np.float64) for w in weights], axis=0) / n_up
        tol = n_up / out["mask"].config.vect.exp_shift + 1e-6
        err = float(np.max(np.abs(model - mean)))
        self.check(err <= tol, f"({c}3) |model - mean| = {err:.3e} <= {tol:.3e}")
        used = [a.kernel_used for a in built]
        self.check(used == ["cuda" if self.cuda else "plain"],
                   f"({c}4) the update phase folded on {self.dev.type} (kernel_used {used})")
        if self.cuda:
            self.check(launches["fold_packed"] == 1,
                       f"({c}5) the coordinator's flush launched K1 packed once "
                       f"({launches['fold_packed']})")
            self.check(launches["fold_planar"] == n_up and launches["mask_fold"] == 2 * n_up
                       and launches["unit_draws"] == n_up + 1,
                       f"({c}6) the SDK participants: K1 planar {launches['fold_planar']} == "
                       f"{n_up}, K2 {launches['mask_fold']} == {2 * n_up} (masking and Sum2), "
                       f"K5 {launches['unit_draws']} == {n_up + 1}")
            want_k4 = n_up if wire else 0
            self.check(launches["packed_check"] == want_k4 and launches["wire_unpack"] == 0,
                       f"({c}7) the coordinator's wire checks: K4 {launches['packed_check']} == "
                       f"{want_k4}, K3 {launches['wire_unpack']} == 0")
        self.check(out["n_seeds"] == n_up, f"({c}8) the sum participant summed {n_up} masks")
        self.check(out["wire_planar"] == [wire] * n_up,
                   f"({c}9) the SDK sent wire v{2 if wire else 1} updates ({out['wire_planar']})")
        if wire:
            self.check(pipeline["journal_writes"] > 0 and state_written,
                       f"({c}10) the round journal was written ({pipeline['journal_writes']:.0f} "
                       f"entries) and the file store kept its state ({state_written})")
        have_wheel = bool(encrypt._HAVE_CRYPTO)
        self.check(all(v is not None for v in phases.values()),
                   f"({c}11) the coordinator logged every phase of round 1 ({len(marks.marks)} lines)")
        log(f"[{tag}] round through the coordinator with the port's SDK, {n_up} updates x "
            f"{length} params: checks ({c}0)-({c}11) passed; decode max err {err:.3e} <= {tol:.3e}")
        log(f"[{tag}] walls from the first update POST (coordinator's log): update window full "
            f"{phases['update_full_close']:.3f} s, update phase closed (flush submitted; drain "
            f"overlapped into sum2) {phases['update_closed']:.3f} s, sum2 closed "
            f"{phases['sum2_closed']:.3f} s, unmask done {phases['unmask_done']:.3f} s, model "
            f"available (GET /model) {phases['model_available']:.3f} s; update POSTs "
            f"{walls['update_posts']:.3f} s, {out['parts_per_update']} parts each; the sum "
            f"participant's Sum2 step {walls['sum2_participant']:.3f} s inside")
        log(f"[{tag}] update POSTs per part (s): "
            f"{[[round(x, 3) for x in u] for u in walls['update_part_posts']]}; this process's "
            f"CPU seconds meanwhile {walls['update_posts_process_cpu']:.3f}; host load average "
            f"{host_load['loadavg']} on {host_load['cpus']} CPUs before the round")
        log(f"[{tag}] the update phase's flush: ring {drain['ring_bytes']} bytes in buffers of "
            f"{drain['ring_buffer_rows']} rows, pinned in {drain['ring_pin_s']} s (reused "
            f"{drain['ring_reused']}), stage {drain['stage_s']} s, fold {drain['fold_s']} s")
        log(f"[{tag}] coordinator message pipeline: decrypt_parse {pipeline['decrypt_parse']:.3f} s "
            f"of {pipeline['total']:.3f} s handling; participants: mask (K2 + K1) and seal the "
            f"first part {walls['participants_mask']:.3f} s; coordinator up in {start_s:.3f} s; "
            f"plain CPU reference {plain_s:.3f} s")
        log(f"[{tag}] cryptography wheel present: {have_wheel} "
            f"({'native' if have_wheel else 'pure-python fallback'} sealed boxes and signatures); "
            f"peak host RSS of this process so far {peak_rss_gib:.2f} GiB")
        log(f"[{tag}] launches {launches}")
        return {"walls": walls, "phases": phases, "drain": drain, "launches": launches,
                "host_load": host_load, "pipeline_seconds": pipeline,
                "cryptography_wheel": have_wheel, "decode_max_err": err,
                "parts_per_update": out["parts_per_update"], "peak_rss_gib": peak_rss_gib,
                "coordinator_start_s": start_s, "plain_reference_s": plain_s}

    # -- phase D: the durable round, killed in Sum2 and resumed ---------------

    def phase_d(self) -> dict:
        """The durable round at full width: Phase R's config and local
        models (the shipped prime/f32/b0/m3 at the main length, batch 64,
        packed staging, the device fold, 1 sum, 3 updates, 1 sum2) with ``coordinator =
        "redis"``, ``backend = "s3"``, the round journal and ``[restore]
        enable``, against :class:`StoreServers`. The coordinator is the CLI
        a user runs, ``python -m xaynet_tpu_torch.server.runner -c <cfg>``
        (no device: CUDA), in a subprocess; the port's SDK participants run
        in this process (``sdk_round``). Process 1 takes the sum message and
        the 3 updates (its flush: K1 packed). Once ``/healthz`` says
        ``sum2`` and the journal entry in Redis is tagged ``sum2``, before
        the sum participant's next step, it is SIGKILLed; the same command
        starts again on the same port (process 2), resumes Sum2 from the
        journal with the accumulator uploaded onto the card, and the sum
        participant sends its Sum2 (K5, K2); the model goes to S3.

        Checks: process 1 launched K1 packed once (its ``GET /metrics``); the
        journaled round is process 1's, with 3 models; process 2 answers
        ``/healthz`` in ``sum2`` with the same round id and ``GET /params``
        with the same seed; its log says it resumed Sum2 with 3 models and
        read the uploaded accumulator back byte-identical to the journaled
        one (the sha256 it logs is that of the journal's accumulator in
        Redis), and neither log says "not resumable"; the model read
        through ``examples.download_global_model.main`` is byte-identical
        to the S3 object under ``{round_id}_{hex(seed)}``, to the SDK's
        ``GET /model`` and to Phase R's model (run alone: the plain CPU fold
        and unmask of what the participants sent), within ``n / exp_shift
        + 1e-6`` of the mean; a
        second conditional put of that id is refused; the participants
        launched K1 planar 3, K2 6 and K5 4 times; process 2 stops on
        SIGTERM with exit 0 and "coordinator stopped". Records process
        1's walls, the kill-to-``GET /params`` gap, the journal's bytes and
        the seconds of its SETs and GETs, the restore's upload seconds and
        the model's wall from the first update POST."""
        import asyncio
        import hashlib
        import os
        import re
        import shutil
        import signal
        import tempfile

        from xaynet_tpu_torch.examples import download_global_model
        from xaynet_tpu_torch.ops import kernels
        from xaynet_tpu_torch.resilience.checkpoint import RoundCheckpoint
        from xaynet_tpu_torch.server import settings as settings_mod
        from xaynet_tpu_torch.storage import S3ModelStorage
        from xaynet_tpu_torch.storage.traits import StorageError

        args = self.args
        length, n_up = args.length, 3
        # R's local models: after R, its model is the reference (R holds it
        # against the plain CPU fold + unmask of what its participants sent)
        rng = np.random.default_rng(args.seed + 3)
        weights = [rng.uniform(-0.9, 0.9, length).astype(np.float32) for _ in range(n_up)]
        work = Path(tempfile.mkdtemp(prefix="xn_phase_d_"))
        OUT_DIR.mkdir(exist_ok=True)
        stores = StoreServers()
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        cfg = write_coordinator_config(work / "config.toml", port, length, work / "models", n_up,
                                       durable=(stores.redis_port, stores.s3_port))  # fmt: skip
        settings = settings_mod.Settings.load(str(cfg), env={})
        agg_cfg, st = settings.aggregation, settings.storage
        self.check(agg_cfg.device and agg_cfg.batch_size == 64 and agg_cfg.packed_staging
                   and not agg_cfg.wire_ingest and st.coordinator == "redis"
                   and st.backend == "s3" and settings.resilience.checkpoint_enabled
                   and settings.restore.enable and settings.model.length == length,
                   "(d0) phase D's config: R's (device fold, batch 64, packed staging), the "
                   "redis coordinator store, the s3 model store, the journal, restore on")  # fmt: skip
        # no device: CUDA (the CPU rehearsal names its device)
        cmd = [sys.executable, "-m", "xaynet_tpu_torch.server.runner", "-c", str(cfg)]
        cmd += [] if self.cuda else ["--device", "cpu"]
        env = dict(os.environ, PYTHONPATH=str(HERE))
        procs: list = []

        def start(i: int):
            log_path = OUT_DIR / f"phase_d_coordinator{i}.log"
            with open(log_path, "wb") as out:
                procs.append((subprocess.Popen(cmd, cwd=HERE, env=env, stdout=out,
                                               stderr=subprocess.STDOUT), log_path))  # fmt: skip
            return procs[-1][0]

        def health() -> dict | None:
            proc = procs[-1][0]
            if proc.poll() is not None:
                raise Failure(f"coordinator process {len(procs)} exited with {proc.returncode}")
            try:
                status, body = http_call(base, "GET", "/healthz", timeout=60)
            except OSError:
                return None
            return json.loads(body) if status == 200 else None

        def params_seed() -> bytes | None:
            try:
                status, body = http_call(base, "GET", "/params", timeout=60)
            except OSError:
                return None
            return bytes.fromhex(json.loads(body)["seed"]) if status == 200 else None

        def launches_of_process() -> dict:
            status, body = http_call(base, "GET", "/metrics", timeout=60)
            counts = dict.fromkeys(kernels.LAUNCHES, 0)
            for m in re.finditer(rb'^xaynet_kernel_launches_total\{kernel="(\w+)"\} (\S+)$',
                                 body, re.M):  # fmt: skip
                counts[m.group(1).decode()] = int(float(m.group(2)))
            return counts

        found: dict = {}

        def kill_and_resume() -> None:
            """Process 1 in Sum2 with the journal tagged sum2: SIGKILL, then
            process 2 until it serves the resumed Sum2."""
            h1 = wait_for(lambda: (h := health()) is not None and h["phase"] == "sum2" and h,
                          300, "process 1's sum2 phase")  # fmt: skip

            def tagged():
                blob = stores.journal()
                return blob is not None and RoundCheckpoint.from_bytes(blob).phase == "sum2" and blob

            blob = wait_for(tagged, 300, "the journal entry tagged sum2", poll=0.05)
            found.update(p1_health=h1, p1_seed=params_seed(), p1_launches=launches_of_process(),
                         journal_bytes=len(blob), journal=RoundCheckpoint.from_bytes(blob))
            t_kill = time.perf_counter()
            procs[0][0].send_signal(signal.SIGKILL)
            procs[0][0].wait(60)
            found["kill_t"] = t_kill
            start(2)
            found["p2_seed"] = wait_for(params_seed, 300, "process 2's GET /params", poll=0.05)
            found["kill_to_params_s"] = time.perf_counter() - t_kill
            found["p2_health"] = wait_for(health, 60, "process 2's /healthz")

        async def second_put(round_id: int, seed: bytes, data: bytes) -> str | None:
            """The S3 store's answer to a second put of the round's model."""
            store = S3ModelStorage(f"http://127.0.0.1:{stores.s3_port}", S3_BUCKET, S3_ACCESS,
                                   S3_SECRET, S3_REGION)  # fmt: skip
            try:
                await store.set_global_model(round_id, seed, data)
            except StorageError as err:
                return str(err)
            return None

        text = ["", ""]
        try:
            start(1)
            wait_for(lambda: (h := health()) is not None and h["phase"] == "sum", 300,
                     "process 1's sum phase")  # fmt: skip
            kernels.reset_launches()
            out = sdk_round(base, weights, None if self.cuda else self.dev, PHASE_R_PART_BYTES,
                            timeout=600, before_sum2=kill_and_resume)  # fmt: skip
            launches = dict(kernels.LAUNCHES)
            found["p2_launches"] = launches_of_process()
            t = time.perf_counter()
            read = download_global_model.main([base])
            download_s = time.perf_counter() - t
            model, walls, ckpt = out["model"], out["walls"], found["journal"]
            round_id, seed = found["p1_health"]["round_id"], found["p1_seed"]
            model_id = f"{round_id}_{seed.hex()}"
            with stores.lock:
                latest = stores.strings.get(b"latest_global_model_id", b"").decode()
                objects = dict(stores.buckets.get(S3_BUCKET, {}))
            refused = asyncio.run(second_put(round_id, seed, model.tobytes()))
            procs[1][0].send_signal(signal.SIGTERM)
            rc = procs[1][0].wait(120)
        finally:
            for proc, _ in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for i, (_, log_path) in enumerate(procs):
                text[i] = log_path.read_text(errors="replace")
            stores.stop()
            shutil.rmtree(work, ignore_errors=True)
        journal_ops = [op for op in stores.ops if op[0] == "redis"]
        s3_ops = [op for op in stores.ops if op[0] == "s3"]

        t = time.perf_counter()
        if self.phase_r_model is not None:
            ref_model, what = self.phase_r_model, "Phase R's model from the same local models"
        else:  # Phase D alone
            ref_model = plain_round_model(out, length)
            what = "the plain CPU fold + unmask of what the participants sent"
        plain_s = time.perf_counter() - t
        digest = hashlib.sha256(np.ascontiguousarray(ckpt.wire_vect(), dtype=np.uint32)).hexdigest()
        restored = re.search(r"journal restore: (\d+) models, (\d+) accumulator bytes uploaded "
                             r"to (\S+) in ([\d.]+) s and read back byte-identical "
                             r"\(sha256 ([0-9a-f]+)\)", text[1])  # fmt: skip

        p1 = found["p1_launches"]
        self.check(p1["fold_packed"] == (1 if self.cuda else 0)
                   and sum(v for k, v in p1.items() if k != "fold_packed") == 0,
                   f"(d1) process 1 folded the Update flush with K1 packed once ({p1})")
        self.check(ckpt.round_id == round_id and ckpt.round_seed == seed and ckpt.nb_models == n_up,
                   f"(d2) the journal tagged sum2 holds process 1's round {round_id} and its "
                   f"{n_up} models ({ckpt.nb_models})")  # fmt: skip
        self.check(found["p2_health"]["phase"] == "sum2"
                   and found["p2_health"]["round_id"] == round_id and found["p2_seed"] == seed,
                   f"(d3) process 2 serves the same round's Sum2, not Idle (phase "
                   f"{found['p2_health']['phase']}, round {found['p2_health']['round_id']}, "
                   "same seed)")  # fmt: skip
        self.check(f"resuming round {round_id} sum2 phase from journal ({n_up} models restored)"
                   in text[1] and restored is not None and restored.group(5) == digest
                   and int(restored.group(1)) == n_up
                   and restored.group(3).startswith(self.dev.type),
                   f"(d4) process 2 resumed Sum2 with {n_up} models, the accumulator uploaded to "
                   f"the {self.dev.type} device and read back byte-identical to the journaled one "
                   f"(sha256 {digest[:16]}...)")  # fmt: skip
        self.check(not any("not resumable" in t for t in text),
                   "(d5) neither process logged 'not resumable'")
        tol = n_up / out["mask"].config.vect.exp_shift + 1e-6
        err = float(np.max(np.abs(model - np.mean([w.astype(np.float64) for w in weights], 0))))
        self.check(read is not None and latest == model_id
                   and objects.get(model_id) == read.tobytes() == model.tobytes()
                   == ref_model.tobytes() and err <= tol,
                   f"(d6) the model read through download_global_model == the S3 object "
                   f"{model_id[:24]}... == GET /model == {what}; |model - mean| = {err:.3e} <= "
                   f"{tol:.3e}")  # fmt: skip
        self.check(refused is not None and "already exists" in refused,
                   f"(d7) a second conditional put of {model_id[:24]}... is refused ({refused})")
        if self.cuda:
            self.check(launches["fold_planar"] == n_up and launches["mask_fold"] == 2 * n_up
                       and launches["unit_draws"] == n_up + 1,
                       f"(d8) the SDK participants: K1 planar {launches['fold_planar']} == "
                       f"{n_up}, K2 {launches['mask_fold']} == {2 * n_up} (masking and Sum2), "
                       f"K5 {launches['unit_draws']} == {n_up + 1}")  # fmt: skip
        self.check(rc == 0 and "coordinator stopped" in text[1],
                   f"(d9) SIGTERM stops process 2: exit code {rc}, 'coordinator stopped' logged")

        def marks(log_text: str) -> dict:
            """Seconds from the first update POST to each phase line of a log."""
            import datetime

            out_marks = {}
            for m in re.finditer(r"^(\S+ \S+) xaynet\.coordinator \w+ \[[^\]]*\] (round \d+: "
                                 r"entering \w+ phase)", log_text, re.M):  # fmt: skip
                when = datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp()
                out_marks.setdefault(m.group(2), round(when - walls["t0_epoch"], 3))
            return out_marks

        sets = [op for op in journal_ops if op[1] == "SET"]
        gets = [op for op in journal_ops if op[1] == "GET" and op[3] > 8]
        record = {
            "walls": walls, "launches": launches, "process_launches": [p1, found["p2_launches"]],
            "process1_marks": marks(text[0]), "process2_marks": marks(text[1]),
            "kill_after_first_post_s": found["kill_t"] - walls["t0"],
            "kill_to_params_s": found["kill_to_params_s"],
            "journal_bytes": found["journal_bytes"],
            "journal_sets": [(n, s_) for _, _, _, n, s_ in sets],
            "journal_gets": [(n, s_) for _, _, _, n, s_ in gets],
            "restore_upload_s": float(restored.group(4)),
            "s3": [(op, n, s_) for _, op, _, n, s_ in s3_ops],
            "download_s": download_s, "plain_reference_s": plain_s, "decode_max_err": err,
            "model_available": walls["model_available"],
        }
        self.records["phase_d_logs"] = [t[-6000:] for t in text]
        log(f"[phase D] {n_up} updates x {length} params, redis + s3 stores, the coordinator "
            f"SIGKILLed in Sum2 and resumed: checks (d0)-(d9) passed; decode max err {err:.3e} "
            f"<= {tol:.3e}")
        log(f"[phase D] from the first update POST: process 1 {record['process1_marks']}, "
            f"killed at {record['kill_after_first_post_s']:.3f} s; process 2 answered GET /params "
            f"{found['kill_to_params_s']:.3f} s after the kill, {record['process2_marks']}; model "
            f"available {walls['model_available']:.3f} s; update POSTs {walls['update_posts']:.3f} "
            f"s; the sum participant's Sum2 step {walls['sum2_participant']:.3f} s")
        log(f"[phase D] journal {found['journal_bytes']} bytes; SETs (bytes, s) "
            f"{record['journal_sets']}; GETs {record['journal_gets']}; restore upload "
            f"{record['restore_upload_s']:.3f} s; S3 {record['s3']}; download_global_model "
            f"{download_s:.3f} s; the reference {plain_s:.3f} s")
        log(f"[phase D] launches: this process {launches}; process 1 {p1}; process 2 "
            f"{found['p2_launches']}")
        return record

    def phase_d_tools(self) -> dict:
        """The sim's two command lines on the device: ``python -m
        xaynet_tpu_torch.tools.sim_check --combos 2 --json`` (each seeded
        combination's production round through the port's coordinator and
        SDK, and ``SimRound``, must agree byte for byte) and ``python -m
        xaynet_tpu_torch.examples.sim_quickstart -p 1024 -l 1000`` (two
        rounds; each model within ``p / exp_shift + 1e-6`` of the float
        mean); each exits 0."""
        import os
        import re

        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip

        env = dict(os.environ, PYTHONPATH=str(HERE))
        device = [] if self.cuda else ["--device", "cpu"]
        p, n = (1024, 1000) if self.cuda else (64, 100)
        runs = {"sim_check": ["-m", "xaynet_tpu_torch.tools.sim_check", "--combos", "2", "--json"],
                "sim_quickstart": ["-m", "xaynet_tpu_torch.examples.sim_quickstart", "-p", str(p),
                                   "-l", str(n)]}  # fmt: skip
        found = {}
        for name, argv in runs.items():
            t = time.perf_counter()
            r = subprocess.run([sys.executable, *argv, *device], cwd=HERE, env=env,
                               capture_output=True, text=True, timeout=600)  # fmt: skip
            found[name] = {"seconds": time.perf_counter() - t, "rc": r.returncode,
                           "stdout": r.stdout[-3000:], "stderr": r.stderr[-3000:]}
            self.check(r.returncode == 0, f"(dt) {name} exits 0 ({r.returncode}): "
                                          f"{r.stderr[-500:]}")
        combos = [json.loads(line) for line in found["sim_check"]["stdout"].splitlines()
                  if line.startswith("{")]  # fmt: skip
        self.check(len(combos) == 2 and all(c["result"] == "ok"
                                            and c["single_device"] == "byte-identical"
                                            for c in combos),
                   f"(dt1) sim_check: both combinations' production round and sim "
                   f"byte-identical ({[c['case'] for c in combos]})")  # fmt: skip
        exp_shift = MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0,
                               ModelType.M6).pair().vect.exp_shift  # fmt: skip
        errs = [float(x) for x in re.findall(r"max \|global - float mean\| = (\S+) ",
                                             found["sim_quickstart"]["stdout"])]  # fmt: skip
        tol = p / exp_shift + 1e-6
        self.check(len(errs) == 2 and max(errs) <= tol,
                   f"(dt2) sim_quickstart -p {p} -l {n}: 2 rounds, max |model - mean| {errs} "
                   f"<= {tol:.3e}")  # fmt: skip
        log(f"[phase D tools] sim_check --combos 2 in {found['sim_check']['seconds']:.1f} s: "
            f"{[(c['case'], c['seconds']) for c in combos]}; sim_quickstart -p {p} -l {n} in "
            f"{found['sim_quickstart']['seconds']:.1f} s: "
            f"{found['sim_quickstart']['stdout'].strip().splitlines()[:2]}")
        return found

    # -- phase L: a forged 2,000-update round through the coordinator ---------

    # the JAX package's loadgen soak runs its coordinator with these ingest
    # keys (tools/loadgen_soak.py); coalescing keeps the shipped defaults
    # (32 members, 2 ms linger: configs/config.toml)
    SOAK_INGEST = {"enabled": True, "shards": 2, "queue_bound": 4096, "retry_after_seconds": 0.2}
    SHED_INGEST = {"enabled": True, "shards": 1, "queue_bound": 16, "high_watermark": 0.8,
                   "low_watermark": 0.5, "retry_after_seconds": 0.2}

    def forged_round(self, tag: str, n_up: int, drivers: int, ingest: dict,
                     max_shed_retries: int = 3, traced: bool = True, edges: int = 0,
                     edge_members: int = 64) -> dict:
        """A round of the port's coordinator (``serve()`` in a thread, no
        device: CUDA) fed by the port's load generator: prime/f32/b0/m6,
        model length 256, batch 64, wire ingest with packed (v2) uploads,
        the ``[ingest]`` keys ``ingest``, count windows of 1 sum, ``n_up``
        updates and 1 sum2. One sum participant on the port's SDK; then
        ``loadgen.runner.run`` forges and replays the updates from
        ``drivers`` spawned drivers (blocks of 512, 64 POSTs in flight
        each); then the sum participant's Sum2. Returns what the checks
        read: the drivers' stats and launches, the model, this process's
        launches, the ingest pipeline and its coalesced envelope sizes, the
        update phase's aggregator, the ingest counters' deltas over the
        replay, ``/healthz`` and ``/statusz`` after the round, and the
        ground truth rebuilt from the run's seeds with ``SimRound``'s model
        over it. With ``edges``, the coordinator serves the edge tier and
        that many edge runners (:class:`EdgeProcesses`, ``edge_members`` a
        window, 0.5 s linger) front it: the drivers send to the edges'
        URLs with ``shared_round`` (the JAX soak's ``--edges``), and the
        edges' health, the envelopes the coordinator folded and the members
        in them come back too."""
        import asyncio
        import shutil
        import tempfile

        import xaynet_tpu_torch.ingest as ingest_pkg
        from xaynet_tpu_torch.loadgen import runner as loadgen
        from xaynet_tpu_torch.ops import kernels
        from xaynet_tpu_torch.sdk.client import HttpClient
        from xaynet_tpu_torch.sdk.simulation import keys_for_task
        from xaynet_tpu_torch.sdk.state_machine import PetSettings, StateMachine
        from xaynet_tpu_torch.server import settings as settings_mod
        from xaynet_tpu_torch.server.phases import update as update_phase
        from xaynet_tpu_torch.sim import SimRound, SimSpec
        from xaynet_tpu_torch.telemetry.registry import get_registry

        length = 256
        device = None if self.cuda else self.dev  # no device: CUDA
        work = Path(tempfile.mkdtemp(prefix=f"xn_{tag}_"))
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        cfg_path = write_coordinator_config(work / "config.toml", port, length, work / "models",
                                            n_up, wire=True, journal=False, model_type="m6",
                                            probs=(0.5, 0.9), ingest=ingest,
                                            edge=bool(edges))  # fmt: skip
        settings = settings_mod.Settings.load(str(cfg_path), env={})
        pair = settings.mask.to_config().pair()
        lg_cfg = dict(loadgen.default_cfg(), url=base, participants=n_up, drivers=drivers,
                      block_size=512, concurrency=64, model_length=length, wire="auto",
                      device="cuda" if self.cuda else str(self.dev), sum_wait_s=120.0,
                      timeout=300.0, seed=self.args.seed + 5,
                      max_shed_retries=max_shed_retries)  # fmt: skip

        async def step_until(sm, phase: str, what: str, timeout: float = 300.0) -> None:
            deadline = time.perf_counter() + timeout
            while time.perf_counter() < deadline:
                await sm.transition()
                if sm.phase.value == phase:
                    return
                await asyncio.sleep(0.02)
            raise Failure(f"timed out after {timeout:.0f} s waiting for {what}")

        # the coordinator's ingest pipeline, each coalesced envelope's size,
        # and the round's aggregator (its device wire-check counts)
        pipes, envelopes, aggs = [], [], []
        real_pipeline, real_build = ingest_pkg.IngestPipeline, update_phase.build_staged_aggregator

        class SizedSender:
            def __init__(self, inner):
                self.inner = inner

            async def request(self, batch):
                envelopes.append(len(batch))
                return await self.inner.request(batch)

        class SpyPipeline(real_pipeline):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                if self.coalescer is not None:
                    self.coalescer.request_tx = SizedSender(self.coalescer.request_tx)
                pipes.append(self)

        def spy_build(shared):
            aggs.append(real_build(shared))
            return aggs[-1]

        registry = get_registry()

        def ingest_counts() -> dict:
            out = {k: registry.sample_value(f"xaynet_ingest_{k}_total") or 0
                   for k in ("admitted", "shed")}  # fmt: skip
            out["envelopes_folded"] = registry.sample_value(
                "xaynet_edge_envelopes_total", {"outcome": "accepted"}) or 0
            out["edge_members_folded"] = registry.sample_value(
                "xaynet_edge_members_folded_total") or 0
            return out

        walls: dict = {}
        edge_procs, edge_health, edge_codes = None, None, None
        ingest_pkg.IngestPipeline, update_phase.build_staged_aggregator = SpyPipeline, spy_build
        coordinator = InProcessCoordinator(settings, device)
        try:
            wait_for(lambda: coordinator_phase(base) == "sum", 120, "the coordinator's sum phase")
            if edges:
                t = time.perf_counter()
                edge_procs = EdgeProcesses(tag, edges, port, work, edge_members, 0.5)
                walls["edges_up"] = time.perf_counter() - t
                lg_cfg.update(targets=edge_procs.urls, shared_round=True)
            probe = HttpClient(base, timeout=300)
            params = asyncio.run(probe.get_round_params())
            keys = keys_for_task(params.seed.as_bytes(), params.sum, params.update, "sum")
            summer = StateMachine(PetSettings(keys=keys, device=device),
                                  HttpClient(base, timeout=300), ArrayModelStore(None))  # fmt: skip
            asyncio.run(step_until(summer, "sum2", "the sum participant's sum message"))
            wait_for(lambda: coordinator_phase(base) == "update", 120, "the update phase")
            if edge_procs is not None:
                edge_procs.wait_phase("update")
            before = pipeline_counters()
            kernels.reset_launches()
            counts: dict = {}

            def round_():
                t0 = time.perf_counter()
                c0 = ingest_counts()
                stats = loadgen.run(lg_cfg)
                c1 = ingest_counts()
                counts.update({k: c1[k] - c0[k] for k in c0})
                walls["loadgen_run"] = time.perf_counter() - t0
                wait_for(lambda: coordinator_phase(base) != "update", 300,
                         "the update phase to close")  # fmt: skip
                t = time.perf_counter()
                asyncio.run(step_until(summer, "awaiting", "the sum participant's Sum2"))
                walls["sum2_participant"] = time.perf_counter() - t

                def model_ready():
                    got = asyncio.run(probe.get_model())
                    return None if got is None else [np.asarray(got)]

                model = wait_for(model_ready, 300, "the global model", poll=0.05)[0]
                walls["model_after_run"] = time.perf_counter() - t0 - walls["loadgen_run"]
                return stats, model

            stats, model = self.traced(f"phase {tag}", round_) if traced else round_()
            launches = dict(kernels.LAUNCHES)
            after = pipeline_counters()
            health = json.loads(http_call(base, "GET", "/healthz", timeout=60)[1])
            statusz = http_call(base, "GET", "/statusz", timeout=60)
            if edge_procs is not None:
                edge_health = edge_procs.health()
            probe.close()
        finally:
            ingest_pkg.IngestPipeline, update_phase.build_staged_aggregator = real_pipeline, real_build
            if edge_procs is not None:
                edge_codes = edge_procs.stop()
            coordinator.stop()
            shutil.rmtree(work, ignore_errors=True)
        seeds, weights, scalar = loadgen.ground_truth(lg_cfg)
        t = time.perf_counter()
        sim = SimRound(SimSpec(pair, length, block_size=512), device=device).run(seeds, weights,
                                                                                scalar)  # fmt: skip
        return {"settings": settings, "pair": pair, "lg_cfg": lg_cfg, "stats": stats,
                "model": model, "launches": launches, "walls": walls,
                "pipeline_seconds": {k: after[k] - before[k] for k in after},
                "pipeline": pipes[0] if pipes else None, "envelopes": envelopes,
                "aggregator": aggs[0] if aggs else None, "ingest_counts": counts,
                "health": health, "statusz": statusz, "weights": weights,
                "sim_model": sim.global_model, "sim_s": time.perf_counter() - t,
                "edge_health": edge_health, "edge_exit_codes": edge_codes}  # fmt: skip

    def check_forged_model(self, tag: str, out: dict, n_up: int) -> float:
        """(2)-(4) of a forged round: every update accepted by the
        coordinator, the model finite and byte-identical to ``SimRound``
        over the drivers' ground truth, within the protocol tolerance of
        the mean; returns the decode error."""
        stats, model, pair = out["stats"], out["model"], out["pair"]
        self.check(stats["accepted"] == n_up and stats["errors"] == 0 and stats["abandoned"] == 0,
                   f"({tag}1) accepted {stats['accepted']} == {n_up} (errors {stats['errors']}, "
                   f"abandoned {stats['abandoned']}, shed {stats['shed']})")
        self.check(model.shape == (out["lg_cfg"]["model_length"],)
                   and bool(np.all(np.isfinite(model))),
                   f"({tag}2) global model finite, of the model length")  # fmt: skip
        self.check(model.tobytes() == out["sim_model"].tobytes(),
                   f"({tag}3) global model byte-identical to SimRound over the {n_up} forged "
                   "participants' seeds, models and scalar")  # fmt: skip
        tol = n_up / pair.vect.exp_shift + 1e-6
        err = float(np.max(np.abs(model - out["weights"].astype(np.float64).mean(axis=0))))
        self.check(err <= tol, f"({tag}4) |model - mean| = {err:.3e} <= {tol:.3e}")
        return err

    def phase_l(self) -> dict:
        """2,000 forged updates from 2 drivers through the coordinator
        (:meth:`forged_round`) at the JAX loadgen soak's ingest settings:
        the ingest pipeline on, 2 shards of 4,096, Retry-After 0.2 s, packed
        uploads, coalescing at the shipped defaults. Checks every update
        accepted, the model byte-identical to ``SimRound`` over the drivers'
        ground truth and within the protocol tolerance of the mean; the
        coalescer sent all 2,000 members, the intake stayed within its
        bound, ``xaynet_ingest_admitted_total`` counted every POST not shed;
        K4 launched fewer times than there were updates, once per
        prevalidated chunk or member check the aggregator counted, K1 on the
        device rows, K5 and K2 in the drivers and in Sum2; ``/healthz``
        carries the ``ingest`` and ``pipeline`` sections and ``/statusz``
        renders ingress and streaming."""
        n_up, drivers = 2000, 2
        out = self.forged_round("L", n_up, drivers, self.SOAK_INGEST)
        settings, stats, launches = out["settings"], out["stats"], out["launches"]
        ing = settings.ingest
        self.check(settings.mask.model_type.name == "M6" and out["pair"].vect.max_nb_models >= n_up
                   and settings.aggregation.wire_ingest and settings.aggregation.batch_size == 64
                   and ing.wire_format == "packed" and ing.enabled and ing.shards == 2
                   and ing.queue_bound == 4096 and ing.retry_after_seconds == 0.2
                   and ing.coalesce and ing.coalesce_max_batch == 32
                   and ing.coalesce_linger_ms == 2.0,
                   f"(l0) phase L's config: m6 (capacity {out['pair'].vect.max_nb_models}), wire "
                   "ingest, packed uploads, batch 64, the ingest pipeline at the soak's settings "
                   "(2 shards x 4096, Retry-After 0.2 s), coalescing 32 / 2 ms")  # fmt: skip
        err = self.check_forged_model("l", out, n_up)
        pipe, agg, sizes = out["pipeline"], out["aggregator"], out["envelopes"]
        self.check(pipe is not None and pipe.coalescer.members_sent == n_up
                   and sum(sizes) == n_up,
                   f"(l5) the coalescer sent {pipe.coalescer.members_sent if pipe else None} members "
                   f"== {n_up} in {len(sizes)} envelopes")  # fmt: skip
        self.check(0 < pipe.intake.max_occupancy <= ing.queue_bound,
                   f"(l6) the intake's max occupancy {pipe.intake.max_occupancy} <= its bound "
                   f"{ing.queue_bound}")  # fmt: skip
        counts = out["ingest_counts"]
        self.check(counts["admitted"] == stats["accepted"] and counts["shed"] == stats["shed"],
                   f"(l7) xaynet_ingest_admitted_total counted {counts['admitted']} == the "
                   f"{stats['accepted']} POSTs not shed (shed {counts['shed']} == the drivers' "
                   f"{stats['shed']})")  # fmt: skip
        checks = agg.prevalidated_chunks + agg.member_checks
        driver_launches = stats["launches"]
        if self.cuda:
            self.check(launches["packed_check"] < n_up and launches["packed_check"] == checks
                       and launches["wire_unpack"] == 0,
                       f"(l8) the coordinator's K4 launched {launches['packed_check']} < {n_up} "
                       f"times, == the aggregator's {agg.prevalidated_chunks} prevalidated chunks "
                       f"+ {agg.member_checks} member checks (K3 {launches['wire_unpack']})")
            self.check(launches["fold_packed"] >= -(-n_up // 8),
                       f"(l9) K1 folded the device rows ({launches['fold_packed']} launches, at "
                       f"most 8 rows each)")
            blocks = drivers * -(-(n_up // drivers) // out["lg_cfg"]["block_size"])
            self.check(driver_launches.get("unit_draws", 0) == blocks
                       and driver_launches.get("mask_fold_rows", 0) >= blocks
                       and launches["mask_fold"] >= n_up and launches["unit_draws"] == 1,
                       f"(l10) K5 and K2 per row in the drivers' engines "
                       f"{driver_launches.get('unit_draws')}, "
                       f"{driver_launches.get('mask_fold_rows')} (== {blocks} blocks, one trip "
                       f"each); the sum participant's Sum2: K5 {launches['unit_draws']} == 1 over "
                       f"its {n_up} seeds, K2 {launches['mask_fold']} >= {n_up}")
        health, (status, page) = out["health"], out["statusz"]
        self.check({"ingest", "ingress", "pipeline"} <= set(health)
                   and health["ingress"]["accepted_total"] >= n_up + 2,
                   f"(l11) /healthz carries the ingest and pipeline sections (ingest "
                   f"{health.get('ingest')}, pipeline {health.get('pipeline')})")  # fmt: skip
        self.check(status == 200 and b"<h2>ingress</h2>" in page
                   and b"<h2>streaming pipeline</h2>" in page,
                   f"(l12) GET /statusz answers {status} with the ingress and streaming sections")
        post = stats["post_s"]
        forge = {k: v.get("forge_s") for k, v in stats["drivers"].items()}
        sorted_sizes = sorted(sizes)
        batch_sizes = {"n": len(sizes), "min": sorted_sizes[0],
                       "median": sorted_sizes[len(sizes) // 2], "max": sorted_sizes[-1]}
        walls, pipeline = out["walls"], out["pipeline_seconds"]
        log(f"[phase L] {n_up} forged updates x 256 params through the ingest pipeline and the "
            f"coordinator from {drivers} drivers: checks (l0)-(l12) passed; decode max err "
            f"{err:.3e}")
        log(f"[phase L] accepted {stats['accepted_per_s']} updates/s over the tier's replay "
            f"window of {stats['wall_s']} s (the direct path without the ingest pipeline: 316.03 on an H100 80GB HBM3); POST seconds "
            f"p50 {post['p50']:.4f}, p99 {post['p99']:.4f}, max {post['max']:.4f}; coalesced "
            f"envelopes {batch_sizes}; K4 launches {launches['packed_check']} (one per update on the direct path: 2000); "
            f"intake max occupancy {pipe.intake.max_occupancy}; forge seconds by driver {forge}; "
            f"loadgen.run {walls['loadgen_run']:.3f} s (spawn, forge, replay)")
        log(f"[phase L] coordinator message pipeline: the ingest workers' batched decrypt and "
            f"parse {pipeline['decrypt_parse_batch']:.3f} s; the sum "
            f"participant's Sum2 step {walls['sum2_participant']:.3f} s; model "
            f"{walls['model_after_run']:.3f} s after the run returned; SimRound of the same "
            f"population {out['sim_s']:.3f} s")
        log(f"[phase L] launches: this process {launches}; the drivers {driver_launches}")
        return {"stats": stats, "walls": walls, "pipeline_seconds": pipeline,
                "launches": launches, "driver_launches": driver_launches,
                "decode_max_err": err, "sim_s": out["sim_s"], "coalesced": batch_sizes,
                "intake_max_occupancy": pipe.intake.max_occupancy,
                "prevalidated_chunks": agg.prevalidated_chunks,
                "member_checks": agg.member_checks, "ingest_counts": counts,
                "healthz": health}  # fmt: skip

    def phase_l_shed(self) -> dict:
        """A small forged round (:meth:`forged_round`) into a saturating
        intake: one shard of 16, watermarks 0.8 / 0.5, Retry-After 0.2 s;
        256 updates from one driver with 64 POSTs in flight, each shed
        upload retried after its Retry-After. Checks that the driver saw
        429s, each with a Retry-After, as many as the coordinator's
        ``xaynet_ingest_shed_total`` counted; every update accepted in the
        end and the model byte-identical to ``SimRound``'s."""
        n_up = 256
        out = self.forged_round("L-shed", n_up, 1, self.SHED_INGEST, max_shed_retries=1000,
                                traced=False)  # fmt: skip
        stats, counts = out["stats"], out["ingest_counts"]
        ing = out["settings"].ingest
        self.check(ing.enabled and ing.shards == 1 and ing.queue_bound == 16
                   and ing.high_watermark == 0.8 and ing.low_watermark == 0.5
                   and ing.retry_after_seconds == 0.2,
                   "(ls0) phase L-shed's ingest: 1 shard x 16, watermarks 0.8 / 0.5, "
                   "Retry-After 0.2 s")  # fmt: skip
        self.check(stats["shed"] > 0 and counts["shed"] == stats["shed"],
                   f"(ls5) the driver saw {stats['shed']} 429s == the coordinator's "
                   f"xaynet_ingest_shed_total {counts['shed']}")  # fmt: skip
        self.check(stats["shed_without_retry_after"] == 0,
                   f"(ls6) every 429 carried Retry-After ({stats['shed_without_retry_after']} "
                   "without)")  # fmt: skip
        err = self.check_forged_model("ls", out, n_up)
        pipe = out["pipeline"]
        self.check(pipe.intake.max_occupancy <= ing.queue_bound,
                   f"(ls7) the intake's max occupancy {pipe.intake.max_occupancy} <= its bound 16")
        post = stats["post_s"]
        log(f"[phase L-shed] {n_up} forged updates into 1 shard x 16: {stats['shed']} 429s "
            f"(all with Retry-After), every update accepted after retries; checks (ls0)-(ls7) "
            f"passed; {stats['accepted_per_s']} accepted updates/s over {stats['wall_s']} s; "
            f"POST seconds p50 {post['p50']:.4f}, max {post['max']:.4f}; decode max err "
            f"{err:.3e}")
        return {"stats": stats, "ingest_counts": counts, "launches": out["launches"],
                "driver_launches": stats["launches"], "walls": out["walls"],
                "decode_max_err": err, "intake_max_occupancy": pipe.intake.max_occupancy}

    # -- phases E and E-fanin: the edge tier ----------------------------------

    def phase_e_fanin(self) -> dict:
        """The JAX soak's ``--edges 2`` topology at Phase L's config
        (:meth:`forged_round`): the coordinator with ``[edge] enabled``, two
        edge runners of 64 members a window (0.5 s linger), 512 forged
        updates from one driver sent to the two edges' URLs with
        ``shared_round``. Checks: every update accepted and the model
        byte-identical to ``SimRound`` of the population (as L checks);
        the coordinator folded every update through envelopes, as many as
        the edges shipped, none refused or dropped, and one K1 launch each
        (``fold_partial``; K1's packed variant, the config stages packed)."""
        n_up = 512
        out = self.forged_round("E-fanin", n_up, 1, self.SOAK_INGEST, max_shed_retries=1_000_000,
                                traced=False, edges=2, edge_members=64)  # fmt: skip
        err = self.check_forged_model("ef", out, n_up)
        counts, launches, health = out["ingest_counts"], out["launches"], out["edge_health"]
        shipped = sum(h["shipped"] for h in health)
        folded = int(counts["envelopes_folded"])
        self.check(int(counts["edge_members_folded"]) == n_up,
                   f"(ef5) the coordinator folded all {n_up} updates through envelopes "
                   f"({counts['edge_members_folded']:.0f})")  # fmt: skip
        self.check(folded == shipped and folded >= n_up // 64
                   and all(h["rejected"] == h["dropped"] == 0 for h in health),
                   f"(ef6) envelopes sealed and shipped {shipped} == folded {folded}, none "
                   "refused or dropped")  # fmt: skip
        self.check(out["edge_exit_codes"] == [0, 0],
                   f"(ef7) the edge runners exit 0 on SIGTERM ({out['edge_exit_codes']})")
        if self.cuda:
            k1 = launches["fold_packed"] + launches["fold_planar"]
            self.check(k1 == folded and launches["packed_check"] == 0,
                       f"(ef8) one K1 launch per envelope ({k1} == {folded}), no wire check "
                       "at the coordinator")  # fmt: skip
        walls = out["walls"]
        log(f"[phase E-fanin] {n_up} forged updates through 2 edges (64 members a window) into "
            f"one coordinator round: checks (ef1)-(ef8) passed; envelopes sealed {shipped} "
            f"({[h['shipped'] for h in health]} per edge), folded {folded}, K1 launches for them "
            f"{launches['fold_packed'] + launches['fold_planar']}; loadgen.run "
            f"{walls['loadgen_run']:.3f} s, model {walls['model_after_run']:.3f} s after it, edges "
            f"up in {walls['edges_up']:.3f} s; {out['stats']['accepted_per_s']} accepted "
            f"updates/s at the edges; decode max err {err:.3e}")
        return {"stats": out["stats"], "launches": launches,
                "driver_launches": out["stats"]["launches"], "walls": walls,
                "envelopes_shipped": shipped, "envelopes_folded": folded,
                "edge_health": health, "decode_max_err": err}

    def phase_e(self, length: int) -> dict:
        """Phase R's coordinator config with ``[edge] enabled`` at ``length``
        (ResNet-50's 25,557,032), two edge runners (:class:`EdgeProcesses`,
        ``max_members = 2``, ``linger_s = PHASE_E_LINGER_S``), and the port's SDK
        participants pointed at the edges (``sdk_round``): the sum
        participant at edge 0 (its messages relayed upstream), 4 update
        participants, 2 per edge, in 64 MiB parts; the sum2 through edge
        0. Checks: the coordinator folded 2 envelopes of 2 members, with
        one K1 launch each (``fold_partial``; K1's packed variant, as R's
        config stages packed); ``nb_models`` is 4; the model within
        ``n_updates / exp_shift + 1e-6`` of the mean. Prints the walls from
        the first update POST, as R."""
        import shutil
        import tempfile

        from xaynet_tpu_torch.edge import api as edge_api
        from xaynet_tpu_torch.edge.envelope import PartialAggregateEnvelope
        from xaynet_tpu_torch.ops import kernels
        from xaynet_tpu_torch.server import settings as settings_mod
        from xaynet_tpu_torch.server.phases import update as update_phase
        from xaynet_tpu_torch.telemetry.registry import get_registry

        n_up = 4
        rng = np.random.default_rng(self.args.seed + 8)
        weights = [rng.uniform(-0.9, 0.9, length).astype(np.float32) for _ in range(n_up)]
        work = Path(tempfile.mkdtemp(prefix="xn_phase_e_"))
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        cfg = write_coordinator_config(work / "config.toml", port, length, work / "models", n_up,
                                       edge=True)  # fmt: skip
        settings = settings_mod.Settings.load(str(cfg), env={})
        self.check(settings.edge.enabled and settings.aggregation.packed_staging,
                   "(e0) phase E's config: R's, with [edge] enabled")
        envelopes, built = [], []
        real_submit, real_build = edge_api.EdgeCoordinatorApi.submit_envelope, \
            update_phase.build_staged_aggregator  # fmt: skip

        async def spy_submit(api, body: bytes):
            result = await real_submit(api, body)
            envelopes.append((PartialAggregateEnvelope.from_bytes(body), result))
            return result

        def spy_build(shared):
            built.append(real_build(shared))
            return built[-1]

        registry = get_registry()

        def folded() -> tuple:
            return (registry.sample_value("xaynet_edge_envelopes_total", {"outcome": "accepted"})
                    or 0, registry.sample_value("xaynet_edge_members_folded_total") or 0)

        edge_api.EdgeCoordinatorApi.submit_envelope = spy_submit
        update_phase.build_staged_aggregator = spy_build
        marks = PhaseMarks()
        logging.getLogger("xaynet.coordinator").addHandler(marks)
        device = None if self.cuda else self.dev
        coordinator = InProcessCoordinator(settings, device)
        edges = None
        try:
            wait_for(lambda: coordinator_phase(base) == "sum", 120, "the coordinator's sum phase")
            t = time.perf_counter()
            # a window seals on its 2 members: at 25M an update reaches an
            # edge 2.2-3.2 s after the one before it (the SDK posts one
            # after another), so a linger of 0.5 s sealed each update alone
            edges = EdgeProcesses("phase_e", 2, port, work, max_members=2, linger_s=PHASE_E_LINGER_S)
            edges_up_s = time.perf_counter() - t
            before = folded()
            kernels.reset_launches()
            out = sdk_round(base, weights, device, PHASE_R_PART_BYTES, timeout=300,
                            update_bases=edges.urls, sum_base=edges.urls[0],
                            before_posts=lambda: edges.wait_phase("update"))  # fmt: skip
            launches = dict(kernels.LAUNCHES)
            after = folded()
            health = edges.health()
        finally:
            edge_api.EdgeCoordinatorApi.submit_envelope = real_submit
            update_phase.build_staged_aggregator = real_build
            codes = edges.stop() if edges is not None else None
            coordinator.stop()
            logging.getLogger("xaynet.coordinator").removeHandler(marks)
            shutil.rmtree(work, ignore_errors=True)
        model, walls = out["model"], out["walls"]
        got = (after[0] - before[0], after[1] - before[1])
        self.check(got == (2, n_up) and [len(e) for e, _ in envelopes] == [2, 2]
                   and all(r == (True, None) for _, r in envelopes),
                   f"(e1) the coordinator folded 2 envelopes of 2 members (accepted, members "
                   f"folded: {got}; sizes {[len(e) for e, _ in envelopes]})")  # fmt: skip
        nb = [a.nb_models for a in built]
        self.check(nb == [n_up], f"(e2) the round's aggregator counted nb_models {nb} == [{n_up}]")
        pair = out["mask"].config
        mean = np.sum([w.astype(np.float64) for w in weights], axis=0) / n_up
        tol = n_up / pair.vect.exp_shift + 1e-6
        err = float(np.max(np.abs(model - mean)))
        self.check(model.shape == (length,) and bool(np.all(np.isfinite(model))) and err <= tol,
                   f"(e4) model finite, of the length; |model - mean| = {err:.3e} <= {tol:.3e}")
        self.check(codes == [0, 0], f"(e5) the edge runners exit 0 on SIGTERM ({codes})")
        if self.cuda:
            self.check(launches["fold_packed"] == 2 and launches["fold_planar"] == n_up,
                       f"(e6) K1: one launch per envelope in the coordinator's fold (packed "
                       f"{launches['fold_packed']} == 2), the participants' masking planar "
                       f"{launches['fold_planar']} == {n_up}")  # fmt: skip

        def mark(prefix: str, text: str) -> float | None:
            hit = marks.first(prefix, text)
            return hit[0] - walls["t0"] if hit else None

        phases = {"update_closed": mark("round 1", "entering sum2 phase"),
                  "sum2_closed": mark("round 1", "entering unmask phase"),
                  "model_available": walls["model_available"]}  # fmt: skip
        log(f"[phase E] {n_up} updates x {length} params through 2 edges (2 members a window) "
            f"into the coordinator: checks (e0)-(e2), (e4)-(e6) passed; decode max err {err:.3e} <= "
            f"{tol:.3e}")
        log(f"[phase E] walls from the first update POST: update POSTs {walls['update_posts']:.3f} "
            f"s ({out['parts_per_update']} parts each, to the edges), update phase closed "
            f"{phases['update_closed']}, sum2 closed {phases['sum2_closed']}, model available "
            f"{phases['model_available']:.3f} s; participants mask {walls['participants_mask']:.3f} "
            f"s; edges up in {edges_up_s:.3f} s")
        log(f"[phase E] edges {[{k: h[k] for k in ('edge_id', 'shipped', 'rejected', 'dropped')} for h in health]}; "
            f"launches {launches}")
        return {"walls": walls, "phases": phases, "launches": launches, "decode_max_err": err,
                "edge_health": health, "envelopes": [len(e) for e, _ in envelopes],
                "edges_up_s": edges_up_s}

    # -- phase T: local training on the port ----------------------------------

    def resnet_config(self) -> dict:
        """ResNet-50 at full width (1000 classes, stages (3, 4, 6, 3)) on the
        card; the CPU rehearsal runs the control flow on the stem, one block
        and 10 classes."""
        return {} if self.cuda else {"num_classes": 10, "stage_sizes": (1,)}

    def phase_t(self) -> dict:
        steps = self.phase_t_steps()
        rounds = self.phase_t_rounds(steps.pop("module"))
        return {"steps": steps, "rounds": rounds, "examples": self.phase_t_examples()}

    def phase_t_steps(self) -> dict:
        """(t1) ResNet-50 train steps (``resnet.make_train_step``: SGD with
        momentum 0.9 at lr 0.1) on synthetic 64x64 NHWC images. Checks the
        parameter count and ``model_length`` (25,557,032), that
        ``unflatten_params(flatten_params(m))`` round-trips byte for byte on
        the card, and one step on the card against the same step on the CPU
        (same weights, a batch of 4), in f32 (``dtype=float32``, TF32 off on
        the card) and in bf16 (as trained). The first SGD update of a
        50-layer GroupNorm network is ill-conditioned: on the CPU, f32 steps
        that differ only in summation order (one thread or eight) lie 6.5e-3
        of the update's norm apart, and 5.7e-3-8.8e-3 from the f64 step;
        bf16's lies ~0.45 from f32's. So each card step is held to three
        times the CPU step's own distance from the f64 step on the CPU (a
        ``double()`` module): its error and the CPU's add up to that when
        the card's rounding is no worse than twice the CPU's, while a wrong
        padding, layout or epsilon moves the update by O(1) of its norm.
        The loss is held to 1e-4 of itself in f32 and 2% in bf16.

        Then times the bf16 step at batch 32: CUDA events around each of 10
        steps after 3 warm-up steps, median ms and images/s."""
        import copy

        torch = self.torch
        from xaynet_tpu_torch.models import resnet
        from xaynet_tpu_torch.models.federated import model_length
        from xaynet_tpu_torch.models.mlp import flatten_params, unflatten_params

        args, cpu = self.args, torch.device("cpu")
        config = self.resnet_config()
        classes = config.get("num_classes", 1000)

        base = resnet.init_params(torch.Generator().manual_seed(args.seed), device=cpu, **config)

        def fresh(dtype, device):
            """``base``'s weights, computing in ``dtype`` (as ``init_params(dtype=...)``)."""
            m = copy.deepcopy(base)
            for module in m.modules():
                if isinstance(getattr(module, "dtype", None), torch.dtype):
                    module.dtype = dtype
            return m.to(device)

        model = fresh(torch.bfloat16, self.dev)
        n = model_length(model)
        flat = flatten_params(model)
        want_n = RESNET50_PARAMS if self.cuda else n
        self.check(n == want_n == flat.size == sum(p.numel() for p in model.parameters()),
                   f"(t1) ResNet-50: model_length {n} == {want_n} == len(flatten_params) "
                   f"{flat.size} == parameter count")  # fmt: skip
        other = resnet.init_params(torch.Generator().manual_seed(args.seed + 1), device=self.dev,
                                   **config)  # fmt: skip
        unflatten_params(other, flat)
        same = all(torch.equal(a, b) for a, b in zip(other.parameters(), model.parameters()))
        self.check(same and flatten_params(other).tobytes() == flat.tobytes(),
                   f"(t1) unflatten_params(flatten_params(m)) round-trips byte for byte on "
                   f"{self.dev.type}")  # fmt: skip
        del other

        rng = np.random.default_rng(args.seed + 11)
        x = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
        y = rng.integers(0, classes, size=4)
        steps = {}
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        legs = [(dtype, dev) for dtype in (torch.bfloat16, torch.float32) for dev in (self.dev, cpu)]
        for dtype, dev in [*legs, (torch.float64, cpu)]:
            m = fresh(dtype, dev)
            if dtype == torch.float64:
                m.double()
            _, optimizer_fn, step = resnet.make_train_step()
            if dtype == torch.float32:
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            try:
                loss = float(step(m, optimizer_fn(m.parameters()), x, y))
            finally:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
            steps[(str(dtype), dev.type)] = (flatten_params(m) - flat, loss)
            del m

        def rel(a, b):
            return float(np.linalg.norm(a - b) / np.linalg.norm(b))

        dev = self.dev.type
        (u32, l32), (c32, cl32) = steps[("torch.float32", dev)], steps[("torch.float32", "cpu")]
        (u16, l16), (c16, cl16) = steps[("torch.bfloat16", dev)], steps[("torch.bfloat16", "cpu")]
        c64 = steps[("torch.float64", "cpu")][0]
        f32_rel, bf16_rel = rel(u32, c32), rel(u16, c16)
        f32_noise, bf16_noise = rel(c32, c64), rel(c16, c64)
        self.check(f32_rel <= 3 * f32_noise and abs(l32 - cl32) <= 1e-4 * abs(cl32),
                   f"(t1) f32 step on {dev} vs CPU: update {f32_rel:.3e} of its norm <= 3 x the "
                   f"CPU's f32-to-f64 {f32_noise:.3e}; loss {l32:.6f} vs {cl32:.6f}")  # fmt: skip
        self.check(bf16_rel <= 3 * bf16_noise and abs(l16 - cl16) <= 0.02 * abs(cl16),
                   f"(t1) bf16 step on {dev} vs CPU: update {bf16_rel:.3e} of its norm <= 3 x "
                   f"the CPU's bf16-to-f64 {bf16_noise:.3e}; loss {l16:.4f} vs {cl16:.4f}")  # fmt: skip
        del steps, u32, c32, u16, c16, c64

        # ms per step at batch 32, bf16 (what a participant trains)
        xb = torch.as_tensor(rng.normal(size=(32, 64, 64, 3)).astype(np.float32), device=self.dev)
        yb = torch.as_tensor(rng.integers(0, classes, size=32), device=self.dev)
        _, optimizer_fn, step = resnet.make_train_step()
        optimizer = optimizer_fn(model.parameters())
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            step(model, optimizer, xb, yb)
        self.sync()
        times = []
        for _ in range(10 if self.cuda else 2):
            if self.cuda:
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))  # fmt: skip
                start.record()
                step(model, optimizer, xb, yb)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t = time.perf_counter()
                step(model, optimizer, xb, yb)
                times.append((time.perf_counter() - t) * 1e3)
        ms = float(np.median(times))
        peak = torch.cuda.max_memory_allocated() if self.cuda else None
        log(f"[phase T] (t1) ResNet-50 ({n} params, bf16 activations) train step at batch 32, "
            f"64x64: median {ms:.3f} ms (min {min(times):.3f}, max {max(times):.3f} over "
            f"{len(times)}; {'CUDA events' if self.cuda else 'host clock, CPU'}), "
            f"{32e3 / ms:.1f} images/s; peak device memory {peak} bytes")
        log(f"[phase T] (t1) one step on {dev} vs the CPU at batch 4: f32 update {f32_rel:.3e} "
            f"of its norm apart, bf16 {bf16_rel:.3e} (the CPU's f32 and bf16 steps are "
            f"{f32_noise:.3e} and {bf16_noise:.3e} from its f64 step)")
        del model, optimizer, xb, yb
        return {"params": n, "module": base, "step_ms": times, "step_ms_median": ms, "images_per_s": 32e3 / ms,
                "peak_device_bytes": peak, "f32_update_rel": f32_rel, "bf16_update_rel": bf16_rel,
                "f32_noise_rel": f32_noise, "bf16_noise_rel": bf16_noise, "losses": {"f32": [l32, cl32], "bf16": [l16, cl16]}}

    def phase_t_rounds(self, init) -> dict:
        """(t2) ResNet-50 federated through the port's coordinator:
        ``serve()`` in a thread with no device (CUDA), Phase R's config (the
        shipped mask config, batch 64, packed staging) at the model's
        length, one round of 1 sum, 3 updates and 1 sum2 (a second round
        repeated the first's path and was cut for the script's time). Every
        participant is ``spawn_participant(url, FederatedTrainer, ...)`` on
        the card (no device: CUDA), 64 MiB message parts, roles pinned with
        ``keys_for_task``; each update trainer takes 2 batches of 32 from a
        copy of ``init`` (t1's ResNet-50, on the CPU). Once the round's sum2
        closes its participants have done their part and are stopped (a
        participant left running re-draws its role on the next seed and
        could take a slot). Checks: the global model within 3 / exp_shift +
        1e-6 of the mean of the three vectors the trainers returned (each
        within 3, so scalar 1/3 keeps it inside B0's bound), the trainers
        starting from their init, the update phase folding on CUDA, and the
        launches: K1 planar 3 and K2 3 by the time the update phase closes
        (the participants' masking), then K2 3 more (Sum2) and K1 packed 1
        (the flush). The round runs in a ``torch.profiler`` window
        (:meth:`traced`), for the card's idle share while participants
        train, mask and federate."""
        import copy
        import resource
        import shutil
        import tempfile

        from xaynet_tpu_torch.examples.coordinator import next_round_seed, sync, wait_for_model
        from xaynet_tpu_torch.models import resnet
        from xaynet_tpu_torch.models.federated import FederatedTrainer, model_length
        from xaynet_tpu_torch.ops import kernels, masking
        from xaynet_tpu_torch.sdk import state_machine as sm_mod
        from xaynet_tpu_torch.sdk.api import spawn_participant
        from xaynet_tpu_torch.sdk.client import HttpClient
        from xaynet_tpu_torch.sdk.simulation import keys_for_task
        from xaynet_tpu_torch.server import settings as settings_mod
        from xaynet_tpu_torch.server.phases import update as update_phase
        from xaynet_tpu_torch.tenancy import get_pool

        args = self.args
        device = None if self.cuda else self.dev  # no device: CUDA
        classes = init.dense.out_features
        length = model_length(init)
        n_up = 3
        trained: list = []  # (tag, training input, returned vector, seconds)
        mask_s: list = []
        first_post: list = []

        class Trainer(FederatedTrainer):
            def __init__(self, tag: str, **kwargs):
                super().__init__(**kwargs)
                self.tag = tag

            def train_round(self, training_input):
                t = time.perf_counter()
                vector = super().train_round(training_input)  # flatten_params syncs
                trained.append((self.tag, training_input, vector, time.perf_counter() - t))
                return vector

        def trainer_kwargs(tag: str, seed: int) -> dict:
            rng = np.random.default_rng(seed)
            data = (rng.normal(size=(64, 64, 64, 3)).astype(np.float32),
                    rng.integers(0, classes, size=64))  # fmt: skip
            return dict(tag=tag, init_params_fn=lambda: copy.deepcopy(init),
                        make_step=resnet.make_train_step, data=data, batch_size=32, seed=seed,
                        device=device)  # fmt: skip

        real_build, real_mask, real_send = (update_phase.build_staged_aggregator,
                                            masking.mask_update, sm_mod.StateMachine._send)  # fmt: skip
        built = []

        def spy_build(shared):
            built.append(real_build(shared))
            return built[-1]

        def timed_mask(*a, **kw):
            t = time.perf_counter()
            obj = real_mask(*a, **kw)
            mask_s.append(time.perf_counter() - t)
            return obj

        async def marked_send(sm, payload, next_phase):
            if hasattr(payload, "masked_model"):
                first_post.append(time.perf_counter())
            return await real_send(sm, payload, next_phase)

        work = Path(tempfile.mkdtemp(prefix="xn_phase_t_"))
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        cfg = write_coordinator_config(work / "config.toml", port, length, work / "models", n_up)
        settings = settings_mod.Settings.load(str(cfg), env={})
        marks = PhaseMarks(snapshot=lambda: dict(kernels.LAUNCHES))
        update_phase.build_staged_aggregator = spy_build
        masking.mask_update = timed_mask
        sm_mod.StateMachine._send = marked_send
        logging.getLogger("xaynet.coordinator").addHandler(marks)
        coordinator = InProcessCoordinator(settings, device)
        rounds, threads = [], []
        probe = HttpClient(base, timeout=900)
        try:
            wait_for(lambda: coordinator_phase(base) == "sum", 120, "the coordinator's sum phase")
            seed, previous = None, None
            for r in (1,):  # one round: the second repeated the first's path (cut for time)
                seed = next_round_seed(probe, seed)
                params = sync(probe.get_round_params())
                trained.clear(), mask_s.clear(), first_post.clear(), built.clear()
                keys = [keys_for_task(seed, params.sum, params.update, "sum", start=0)]
                keys += [keys_for_task(seed, params.sum, params.update, "update",
                                       start=(20 + i) * 1000) for i in range(n_up)]  # fmt: skip

                def one_round():
                    for i, key in enumerate(keys):
                        tag = "sum" if i == 0 else f"update {i}"
                        threads.append(spawn_participant(
                            base, Trainer, kwargs=trainer_kwargs(tag, args.seed + 100 * r + i),
                            scalar=Fraction(1) if i == 0 else Fraction(1, n_up), keys=key,
                            device=device, max_message_size=PHASE_R_PART_BYTES))  # fmt: skip
                    wait_for(lambda: marks.first(f"round {r}", "entering unmask phase"), 900,
                             f"round {r}'s sum2 to close", poll=0.05)  # fmt: skip
                    # round r's aggregators: a participant not yet stopped can
                    # open round r + 1, whose update phase builds its own
                    in_round[:] = built
                    for thread in threads:
                        thread.stop()
                    threads.clear()
                    # the wall ends here, not after the profiler window closes
                    return wait_for_model(probe, seed, timeout=900), time.perf_counter()

                kernels.reset_launches()
                t_round = time.perf_counter()
                in_round = []
                pool = get_pool()
                pin0, slabs0 = pool.pin_seconds, pool.stats()["slabs"]
                model, t_model = self.traced(f"phase T round {r}", one_round)
                launches = dict(kernels.LAUNCHES)
                rounds.append(self.phase_t_round_checks(
                    r, model, previous, list(trained), list(mask_s), first_post, marks, in_round,
                    launches, t_round, t_model, settings.mask))  # fmt: skip
                # what the round's flush paid to page-lock pool slabs (0 when
                # its staging lease landed in a slab locked before)
                rounds[-1]["pool_pin_s"] = pool.pin_seconds - pin0
                rounds[-1]["pool_new_slabs"] = pool.stats()["slabs"] - slabs0
                rounds[-1]["pool_pinned_bytes"] = pool.pinned_bytes()
                log(f"[phase T] (t2) round {r}: the flush's staging lease page-locked pool slabs "
                    f"for {rounds[-1]['pool_pin_s']:.3f} s ({rounds[-1]['pool_new_slabs']} new "
                    f"slab(s); {rounds[-1]['pool_pinned_bytes']} bytes of the pool locked)")
                rounds[-1]["peak_rss_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
                log(f"[phase T] (t2) round {r}: peak host RSS of this process so far "
                    f"{rounds[-1]['peak_rss_gib']:.2f} GiB")
                previous = model
        finally:
            for thread in threads:
                thread.stop()
            probe.close()
            update_phase.build_staged_aggregator = real_build
            masking.mask_update = real_mask
            sm_mod.StateMachine._send = real_send
            coordinator.stop()
            logging.getLogger("xaynet.coordinator").removeHandler(marks)
            shutil.rmtree(work, ignore_errors=True)
        launches = {k: sum(r["launches"][k] for r in rounds) for k in rounds[0]["launches"]}
        return {"length": length, "rounds": rounds, "launches": launches}

    def phase_t_round_checks(self, r, model, previous, trained, mask_s, first_post, marks, built,
                             launches, t_round, t_model, mask_settings) -> dict:  # fmt: skip
        """Phase T (t2)'s checks and walls for round ``r`` (see ``phase_t_rounds``)."""
        from xaynet_tpu_torch.core.mask.config import MaskConfig

        cfg = MaskConfig(mask_settings.group_type, mask_settings.data_type,
                         mask_settings.bound_type, mask_settings.model_type)  # fmt: skip
        updates = sorted((t for t in trained if t[0] != "sum"), key=lambda t: t[0])
        vectors = [v for _, _, v, _ in updates]
        self.check(len(updates) == 3 and len(trained) == 3,
                   f"(t2) round {r}: the three update trainers trained, the sum one did not "
                   f"({[t[0] for t in trained]})")  # fmt: skip
        self.check(model.shape == vectors[0].shape and bool(np.all(np.isfinite(model))),
                   f"(t2) round {r}: global model finite, of the model length {model.shape}")
        biggest = max(float(np.abs(v).max()) for v in vectors)
        mean = np.sum([v.astype(np.float64) for v in vectors], axis=0) / 3
        tol = 3 / cfg.exp_shift + 1e-6
        err = float(np.max(np.abs(model - mean)))
        self.check(biggest <= 3 and err <= tol,
                   f"(t2) round {r}: |model - mean of the trainers' vectors| = {err:.3e} <= "
                   f"{tol:.3e} (largest weight {biggest:.4f} <= 3)")  # fmt: skip
        inputs = [i for _, i, _, _ in updates]
        if previous is None:
            ok = all(i is None for i in inputs)
        else:
            # the SDK fetches the model as float64; a trainer takes it as f32
            ok = all(i is not None and np.array_equal(i, previous.astype(np.float32))
                     for i in inputs)  # fmt: skip
        self.check(ok, f"(t2) round {r}: the trainers started from "
                       f"{'their init' if previous is None else 'round 1' + chr(39) + 's global model'}")
        used = [a.kernel_used for a in built]
        self.check(used == ["cuda" if self.cuda else "plain"],
                   f"(t2) round {r}: the update phase folded on {self.dev.type} ({used})")
        closed = marks.first(f"round {r}", "entering sum2 phase")
        if self.cuda:
            at_close = closed[2]
            self.check(at_close["fold_planar"] == 3 and at_close["mask_fold"] == 3,
                       f"(t2) round {r}: the participants' masking launched K1 planar "
                       f"{at_close['fold_planar']} == 3 and K2 {at_close['mask_fold']} == 3")
            self.check(launches["mask_fold"] - at_close["mask_fold"] == 3
                       and launches["fold_packed"] == 1 and launches["fold_planar"] == 3,
                       f"(t2) round {r}: then Sum2 K2 {launches['mask_fold'] - at_close['mask_fold']}"
                       f" == 3, the flush K1 packed {launches['fold_packed']} == 1")  # fmt: skip
        t0 = min(first_post)
        sum2 = marks.first(f"round {r}", "entering unmask phase")
        walls = {
            "train_s": {tag: s for tag, _, _, s in updates},
            "mask_s": mask_s,
            "spawn_to_first_update_post": t0 - t_round,
            "update_closed": closed[0] - t0,
            "sum2_closed": sum2[0] - t0,
            "model_available": t_model - t0,
        }
        log(f"[phase T] (t2) round {r}: ResNet-50 through the coordinator, 3 trainers: checks "
            f"passed; |model - mean| {err:.3e} <= {tol:.3e}; launches {launches}")
        log(f"[phase T] (t2) round {r}: training seconds per trainer "
            f"{[round(s, 3) for s in walls['train_s'].values()]}; masking seconds "
            f"{[round(s, 3) for s in mask_s]}; from the first update POST: update phase closed "
            f"{walls['update_closed']:.3f} s, sum2 closed {walls['sum2_closed']:.3f} s, model "
            f"available {walls['model_available']:.3f} s (spawn to first POST "
            f"{walls['spawn_to_first_update_post']:.3f} s)")
        return {"walls": walls, "launches": launches, "decode_max_err": err,
                "largest_weight": biggest}

    def phase_t_examples(self) -> dict:
        """(t3) The four training examples at their shipped defaults, as
        ``python -m xaynet_tpu_torch.examples.<name> --check-loss`` (on the
        card; ``--device cpu`` in the rehearsal), started together: each
        must exit 0 and print its ``eval loss``. Their output goes to
        ``chiprun_out/phase_t_<name>.log``."""
        names = ("house_prices", "cifar_lenet", "shakespeare_lstm", "lora_federated")
        OUT_DIR.mkdir(exist_ok=True)
        extra = [] if self.cuda else ["--device", "cpu"]
        procs, started = {}, time.perf_counter()
        try:
            for name in names:
                with open(OUT_DIR / f"phase_t_{name}.log", "wb") as out:
                    procs[name] = subprocess.Popen(
                        [sys.executable, "-m", f"xaynet_tpu_torch.examples.{name}",
                         "--check-loss", *extra],
                        cwd=HERE, stdout=out, stderr=subprocess.STDOUT,
                    )  # fmt: skip
            results = {}
            for name, proc in procs.items():
                rc = proc.wait(timeout=max(1.0, 600 - (time.perf_counter() - started)))
                text = (OUT_DIR / f"phase_t_{name}.log").read_text(errors="replace")
                lines = [line for line in text.splitlines() if "eval loss" in line]
                results[name] = {"rc": rc, "eval": lines, "seconds": time.perf_counter() - started}
                self.check(rc == 0 and bool(lines),
                           f"(t3) {name} --check-loss exits {rc} == 0 and prints its eval loss")
                log(f"[phase T] (t3) {name}: {lines[-1]} (done {results[name]['seconds']:.1f} s "
                    "after the four started)")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return results

    # -- phase M: the multi-tenant coordinator --------------------------------

    def phase_m(self, resnet_length: int) -> dict:
        """Several tenants on one card through one ``serve()`` (in a thread,
        no device: CUDA), ``[tenancy] enabled``, tenants ``resnet`` and
        ``lenet``, an admin token and a ``config_dir`` with one file per
        tenant: ``resnet`` at ``resnet_length`` (Phase T's ResNet-50 count)
        with the shipped prime/f32/b0/m3, batch 64 and packed staging;
        ``lenet`` at ``cifar_lenet``'s LeNet length (136,886) with
        integer/f32/b0/m3, wire ingest with v2 uploads, the ``file``
        store and its own ingest pipeline (``[ingest] enabled``); each 1
        sum, ``n`` updates (3 and 8), 1 sum2. The port's SDK
        drives both rounds at once over the socket (``sdk_round`` at
        ``/t/resnet`` and ``/t/lenet``, each in its own thread, inside one
        profiler window). Then a third tenant, ``mlp`` (``house_prices``'
        MLP, 3,009 parameters), is onboarded through ``POST
        /admin/tenants``, runs one round of 1 sum and 3 updates and is
        drained through ``DELETE /admin/tenants/mlp`` at its next round
        boundary (its file gives the sum phase a 10 s window, so the round
        after its first fails soon and closes the drain). Checks: each
        tenant's model within ``n / exp_shift + 1e-6`` of the mean and,
        but for ``resnet``'s (Phase R holds that path at 25M), byte-identical
        to the plain CPU fold and unmask of what its participants sent; the bare ``GET /params`` answers ``resnet``'s parameters
        and ``/t/nope/params`` 404; every tenant's aggregator folded on
        CUDA and the launches each path needs; the scheduler granted slots
        to both round tenants; the pool balanced for all three tenants in
        both arenas; ``mlp``'s routes 404 after the drain; ``lenet``'s
        pipeline charged the per-tenant admission budget during its round
        and holds none after, and ``/t/lenet/healthz`` carries its
        ``ingest`` section. Prints each
        tenant's walls from its first update POST, the pool's page-locked
        bytes and each flush's pin seconds, the ledger's device pages per
        tenant, the peak host RSS and the window's idle share."""
        import json as json_mod
        import os
        import resource
        import shutil
        import tempfile
        import threading

        import torch

        from xaynet_tpu_torch.examples import house_prices
        from xaynet_tpu_torch.models import lenet, mlp
        from xaynet_tpu_torch.models.federated import model_length
        from xaynet_tpu_torch.ops import kernels
        from xaynet_tpu_torch.server import settings as settings_mod
        from xaynet_tpu_torch.server.aggregation import StagedAggregator
        from xaynet_tpu_torch.server.phases import update as update_phase
        from xaynet_tpu_torch.tenancy import get_manager, get_pool, get_scheduler

        gen = torch.Generator().manual_seed(1)
        lengths = {
            "resnet": resnet_length,
            "lenet": model_length(lenet.init_params(gen, image_shape=(32, 32, 3), device="cpu")),
            "mlp": model_length(mlp.init_params(gen, house_prices.INPUT_DIM, device="cpu")),
        }
        n_updates = {"resnet": 3, "lenet": 8, "mlp": 3}
        groups = {"resnet": "prime", "lenet": "integer", "mlp": "prime"}
        token = "phase-m-admin-token"
        work = Path(tempfile.mkdtemp(prefix="xn_phase_m_"))
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        window = 'time = {{ min = 0.0, max = {t} }}\ncount = {{ min = {n}, max = {n} }}'
        for tenant, length in lengths.items():
            wire = tenant == "lenet"
            # lenet's messages go through its ingest pipeline, charging its
            # share of the process-wide admission budget; resnet's take the
            # direct path
            extra = '[ingest]\nenabled = true\nwire_format = "packed"\n' if wire else ""
            store = 'coordinator = "file"\n' if wire else ""
            # mlp's sum window is short: the round after its first fails
            # soon, which is the round boundary its drain waits for
            sum_t = 10.0 if tenant == "mlp" else 900.0
            (work / f"{tenant}.toml").write_text(
                f'[pet.sum]\nprob = 0.01\n{window.format(t=sum_t, n=1)}\n'
                f'[pet.update]\nprob = 0.1\n{window.format(t=900.0, n=n_updates[tenant])}\n'
                f'[pet.sum2]\n{window.format(t=900.0, n=1)}\n'
                f'[mask]\ngroup_type = "{groups[tenant]}"\ndata_type = "f32"\n'
                'bound_type = "b0"\nmodel_type = "m3"\n'
                f"[model]\nlength = {length}\n"
                "[aggregation]\ndevice = true\nbatch_size = 64\npacked_staging = true\n"
                f"wire_ingest = {str(wire).lower()}\n{extra}"
                f'[storage]\nbackend = "filesystem"\n{store}model_dir = "{work / "models"}"\n'
                f'[metrics]\nflight_dir = "{work / "flight"}"\n'
            )
        cfg = work / "config.toml"
        cfg.write_text(
            f'[api]\nbind_address = "127.0.0.1:{port}"\n'
            f'[tenancy]\nenabled = true\ntenants = "resnet,lenet"\nconfig_dir = "{work}"\n'
            f'admin_token = "{token}"\ndrain_timeout_s = 120.0\n'
            f'[metrics]\nflight_dir = "{work / "flight"}"\n'
        )
        settings = settings_mod.Settings.load(str(cfg), env={})
        self.check(settings.tenancy.enabled and settings.tenancy.tenants == ["resnet", "lenet"],
                   "(m0) Phase M's config: tenancy on, tenants resnet and lenet")
        built: dict = {}  # tenant -> (aggregator, its rings, ledger pages at build)
        flushed: dict = {}  # tenant -> rows of each flush that had any
        real_build = update_phase.build_staged_aggregator

        def spy(shared):
            agg = real_build(shared)
            stream, close, flush = agg._stream, agg._stream.close, agg.flush
            rings: dict = {}

            def counted_flush():
                if agg.pending:
                    flushed.setdefault(shared.tenant, []).append(agg.pending)
                flush()

            agg.flush = counted_flush

            def keep_rings_then_close():  # close() releases the rings' leases
                rings.update(stream._rings)
                close()

            stream.close = keep_rings_then_close
            ledger = sum(e["pages"] for e in get_pool().page_table(shared.tenant).values()
                         if e["arena"] == "device")  # fmt: skip
            built.setdefault(shared.tenant, []).append((agg, rings, ledger))
            return agg

        def admin(method: str, path: str, body: bytes = b"") -> tuple[int, dict | bytes]:
            status, payload = http_call(base, method, path, body, timeout=300,
                                        headers={"x-admin-token": token})  # fmt: skip
            try:
                return status, json_mod.loads(payload)
            except ValueError:
                return status, payload

        update_phase.build_staged_aggregator = spy
        device = None if self.cuda else self.dev  # no device: CUDA
        rng = np.random.default_rng(self.args.seed + 9)
        weights = {t: [rng.uniform(-0.9, 0.9, lengths[t]).astype(np.float32)
                       for _ in range(n_updates[t])] for t in lengths}  # fmt: skip
        outs: dict = {}
        coordinator = InProcessCoordinator(settings, device)
        try:
            t = time.perf_counter()
            for tenant in ("resnet", "lenet"):
                wait_for(lambda: coordinator_phase(f"{base}/t/{tenant}") == "sum", 120,
                         f"tenant {tenant}'s sum phase")  # fmt: skip
            start_s = time.perf_counter() - t
            bare = json_mod.loads(http_call(base, "GET", "/params")[1])
            tenant_params = {t: json_mod.loads(http_call(f"{base}/t/{t}", "GET", "/params")[1])
                             for t in ("resnet", "lenet")}  # fmt: skip
            nope = http_call(base, "GET", "/t/nope/params")[0]
            self.check(bare == tenant_params["resnet"] != tenant_params["lenet"] and nope == 404,
                       f"(m1) the bare GET /params answers resnet's round parameters "
                       f"(length {bare['model_length']}), /t/nope/params {nope}")
            # what each tenant's ingest pipeline charges to the budget
            budget = get_manager().budget
            charged: dict = {}
            real_charge = budget.charge

            def charge(tenant: str) -> bool:
                ok = real_charge(tenant)
                charged[tenant] = charged.get(tenant, 0) + ok
                return ok

            budget.charge = charge
            errors: dict = {}

            def drive(tenant: str) -> None:
                try:
                    outs[tenant] = sdk_round(f"{base}/t/{tenant}", weights[tenant], device,
                                             PHASE_R_PART_BYTES, timeout=600)  # fmt: skip
                except BaseException as exc:  # re-raised on this thread below
                    errors[tenant] = exc

            def both_rounds() -> None:
                threads = [threading.Thread(target=drive, args=(t,)) for t in ("resnet", "lenet")]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()

            pool = get_pool()
            pin0 = pool.pin_seconds
            kernels.reset_launches()
            self.traced("phase M", both_rounds)
            launches = dict(kernels.LAUNCHES)
            for tenant, exc in errors.items():
                raise Failure(f"tenant {tenant}'s round failed: {exc!r}") from exc
            split = get_scheduler().split()
            held = {t: budget.held(t) for t in ("resnet", "lenet")}
            tenant_health = {t: json_mod.loads(http_call(f"{base}/t/{t}", "GET", "/healthz")[1])
                             for t in ("resnet", "lenet")}  # fmt: skip
            # the third tenant's lifecycle: onboard, one round, drain
            status, onboarded = admin("POST", "/admin/tenants",
                                      json_mod.dumps({"tenant": "mlp"}).encode())  # fmt: skip
            self.check(status == 200 and onboarded["state"] == "serving",
                       f"(m2) POST /admin/tenants onboarded mlp ({status}, {onboarded})")
            kernels.reset_launches()
            outs["mlp"] = sdk_round(f"{base}/t/mlp", weights["mlp"], device, PHASE_R_PART_BYTES,
                                    timeout=300)  # fmt: skip
            launches_mlp = dict(kernels.LAUNCHES)
            t = time.perf_counter()
            status, drained = admin("DELETE", "/admin/tenants/mlp")
            drain_s = time.perf_counter() - t
            self.check(status == 200 and drained == {"tenant": "mlp", "state": "drained",
                                                     "outcome": "graceful"},
                       f"(m3) DELETE /admin/tenants/mlp drained it at its round boundary "
                       f"({status}, {drained}, {drain_s:.2f} s)")  # fmt: skip
            after = {path: http_call(base, "GET", path)[0]
                     for path in ("/t/mlp/params", "/t/mlp/healthz")}  # fmt: skip
            self.check(set(after.values()) == {404}, f"(m4) mlp's routes after the drain: {after}")
            states = admin("GET", "/admin/tenants")[1]
            health = json_mod.loads(http_call(base, "GET", "/healthz")[1])
            pool_end = {t: (pool.balanced(t), pool.page_table(t)) for t in lengths}
            stats_end = pool.stats()
            pinned_bytes = pool.pinned_bytes()
            pin_s = pool.pin_seconds - pin0
        finally:
            update_phase.build_staged_aggregator = real_build
            coordinator.stop()
            shutil.rmtree(work, ignore_errors=True)
        peak_rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        self.check(states == {"tenants": {"resnet": "serving", "lenet": "serving",
                                          "mlp": "drained"}},
                   f"(m5) the lifecycle's states: {states}")  # fmt: skip
        self.check(set(health["tenancy"]["tenants"]) == {"resnet", "lenet"},
                   "(m6) /healthz lists the two serving tenants and the pool")
        checks = {}
        for c, tenant in enumerate(lengths):
            out, n_up, length = outs[tenant], n_updates[tenant], lengths[tenant]
            model = out["model"]
            plain_s, same = None, True
            if tenant != "resnet":
                # resnet's plain CPU reference is left out: Phase R holds the
                # same path (shipped config, packed staging, the port's SDK)
                # against it at 25M, and it took 14 s of the script's limit
                t = time.perf_counter()
                ref = StagedAggregator(out["mask"].config, length, batch_size=n_up, device="cpu")
                for obj in out["updates"]:
                    ref.validate_aggregation(obj)
                    ref.aggregate(obj)
                ref_model = ref.finalize_inplace().unmask_array(out["mask"])
                plain_s = time.perf_counter() - t
                same = model.tobytes() == ref_model.tobytes()
            mean = np.sum([w.astype(np.float64) for w in weights[tenant]], axis=0) / n_up
            tol = n_up / out["mask"].config.vect.exp_shift + 1e-6
            err = float(np.max(np.abs(model - mean)))
            used = [a.kernel_used for a, _, _ in built.get(tenant, [])]
            self.check(model.shape == (length,) and same and err <= tol,
                       f"(m7.{c}) tenant {tenant}: model "
                       + ("" if plain_s is None else "byte-identical to the plain CPU fold + "
                          f"unmask of what its {n_up} participants sent; ")
                       + f"|model - mean| = {err:.3e} <= {tol:.3e}")  # fmt: skip
            self.check(used == ["cuda" if self.cuda else "plain"],
                       f"(m8.{c}) tenant {tenant}'s update phase folded on {self.dev.type} "
                       f"(kernel_used {used})")  # fmt: skip
            self.check(out["wire_planar"] == [tenant == "lenet"] * n_up,
                       f"(m9.{c}) tenant {tenant}'s SDK sent wire v{2 if tenant == 'lenet' else 1} "
                       f"updates")  # fmt: skip
            _, rings, ledger = built[tenant][0]
            ring = rings.get("packed")
            checks[tenant] = {
                "walls": out["walls"], "decode_max_err": err, "plain_reference_s": plain_s,
                "parts_per_update": out["parts_per_update"],
                "ledger_device_pages": ledger,
                "ring_buffer_rows": None if ring is None else list(ring.buffer_rows),
                "ring_bytes": None if ring is None else ring.nbytes,
                "ring_pin_s": None if ring is None else ring.pin_seconds,
                "ring_reused": None if ring is None else ring.reused,
                "balanced_at_end": pool_end[tenant][0],
            }  # fmt: skip
        self.check(all(balanced for balanced, _ in pool_end.values())
                   and stats_end["host_pages_in_use"] == stats_end["device_pages_in_use"] == 0,
                   f"(m10) the pool balanced for all three tenants, host and device arenas "
                   f"({stats_end})")  # fmt: skip
        self.check({"resnet", "lenet"} <= set(split) and split["resnet"] >= 1
                   and split["lenet"] >= 1,
                   f"(m11) the scheduler granted fold-batch slots to both round tenants "
                   f"({split})")  # fmt: skip
        lenet_ingest = tenant_health["lenet"].get("ingest") or {}
        self.check(charged.get("lenet", 0) >= n_updates["lenet"] and "resnet" not in charged
                   and held == {"resnet": 0, "lenet": 0},
                   f"(m14) lenet's ingest pipeline charged the admission budget "
                   f"{charged.get('lenet', 0)} times during its round, resnet's direct path "
                   f"{charged.get('resnet', 0)}; held after the rounds {held}")  # fmt: skip
        self.check(lenet_ingest.get("tenant") == "lenet" and lenet_ingest.get("budget_held") == 0
                   and "ingest" not in tenant_health["resnet"],
                   f"(m15) /t/lenet/healthz carries lenet's ingest section ({lenet_ingest}); "
                   "/t/resnet/healthz none")  # fmt: skip
        lenet_agg = built["lenet"][0][0]
        lenet_checks = lenet_agg.prevalidated_chunks + lenet_agg.member_checks
        lenet_flushes = flushed.get("lenet", [])
        if self.cuda:
            # the two rounds: K1 packed for resnet's flush and for lenet's
            # device rows (chunks of 8 of each coalesced flush), K4 once per
            # lenet micro-batch chunk or member check, and each participant's
            # masking (K5 + K2 + K1 planar) and Sum2 (K5 + K2 a seed)
            want = {"fold_packed": 1 + sum(-(-k // 8) for k in lenet_flushes),
                    "fold_planar": 11, "mask_fold": 22, "unit_draws": 13,
                    "packed_check": lenet_checks, "wire_unpack": 0}
            got = {k: launches[k] for k in want}
            self.check(got == want, f"(m12) the two rounds' launches {got} == {want}")
            want_mlp = {"fold_packed": 1, "fold_planar": 3, "mask_fold": 6, "unit_draws": 4,
                        "packed_check": 0, "wire_unpack": 0}
            got = {k: launches_mlp[k] for k in want_mlp}
            self.check(got == want_mlp, f"(m13) mlp's round launches {got} == {want_mlp}")
        for tenant, rec in checks.items():
            w = rec["walls"]
            log(f"[phase M] tenant {tenant} ({lengths[tenant]} params, {n_updates[tenant]} "
                f"updates): from its first update POST, update POSTs {w['update_posts']:.3f} s, "
                f"model available {w['model_available']:.3f} s; participants mask "
                f"{w['participants_mask']:.3f} s; the flush's ring {rec['ring_buffer_rows']} rows, "
                f"{rec['ring_bytes']} bytes, pinned in {rec['ring_pin_s']} s (reused "
                f"{rec['ring_reused']}); ledger {rec['ledger_device_pages']} device pages; plain "
                f"CPU reference {rec['plain_reference_s']} s")
        log(f"[phase M] pool: {pinned_bytes} bytes page-locked, {pin_s:.3f} s of pinning in the "
            f"phase; split {split}; coordinator up in {start_s:.3f} s; mlp onboarded in "
            f"{onboarded.get('onboard_s')} s, drained in {drain_s:.3f} s; peak host RSS of this "
            f"process so far {peak_rss_gib:.2f} GiB")
        log(f"[phase M] launches {launches}; mlp's round {launches_mlp}")
        log(f"[phase M] lenet's ingest: {charged.get('lenet', 0)} budget charges, held after "
            f"{held['lenet']}; coalesced flushes of {lenet_flushes} rows; K4 "
            f"{lenet_agg.prevalidated_chunks} prevalidated chunks + {lenet_agg.member_checks} "
            f"member checks")
        return {"tenants": checks, "launches": launches, "launches_mlp": launches_mlp,
                "lenet_ingest": {"charged": charged.get("lenet", 0), "held_after": held,
                                 "flushes": lenet_flushes, "healthz_ingest": lenet_ingest,
                                 "prevalidated_chunks": lenet_agg.prevalidated_chunks,
                                 "member_checks": lenet_agg.member_checks},
                "split": split, "pool_pinned_bytes": pinned_bytes, "pool_pin_s": pin_s,
                "pool_stats_end": stats_end, "onboard": onboarded, "drain": drained,
                "drain_s": drain_s, "peak_rss_gib": peak_rss_gib, "coordinator_start_s": start_s}

    # -- phase X: several shards on the card (the model-axis mesh) ------------

    def _x_rows(self) -> tuple[list, list]:
        """Phase B's staged updates from the wires B serialized (no encode,
        no masking): every update's host wire rows ``uint32[n, L]`` (v1
        element blocks and v2 byte planes widened to 8 bytes an element),
        and the even (v1) updates' raw element blocks."""
        from xaynet_tpu_torch.core.mask.serialization import parse_mask_object

        n = self.args.length
        rows, raws = [], []
        for w in self.phase_b_out["wires"]:
            vect = parse_mask_object(w, lazy_vect=True)[0].vect
            wide = np.zeros((n, 8), dtype=np.uint8)
            if vect.planar:
                for b, plane in enumerate(vect.planar_block):
                    wide[:, b] = plane
            else:
                raw = np.asarray(vect.wire_block)
                raws.append(raw)
                wide[:, : raw.size // n] = raw.reshape(n, -1)
            rows.append(wide.view(np.uint32))
        return rows, raws

    def _x_round(self, mesh, rows: list, tag: str, timed_legs: bool = False) -> dict:
        """B's round through a ``StagedAggregator`` on ``mesh``: B's host
        rows staged and flushed (packed flushes of ``batch``, shard-parallel),
        ``finalize_inplace(defer_drain=True)`` and ``unmask_array`` with B's
        mask (the eager per-shard unmask). Returns the model, the walls, the
        aggregator and the K1 launches by shard."""
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.core.mask.object import MaskObject, MaskUnit, MaskVect
        from xaynet_tpu_torch.server.aggregation import StagedAggregator

        b = self.phase_b_out
        pair = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3).pair()
        units = b["units"]
        agg = StagedAggregator(pair, self.args.length, batch_size=self.args.batch, mesh=mesh)
        dev, stream = agg._device, agg._stream
        plan = dev.ensure_plan()
        shard_of = {a.data_ptr(): d for d, a in enumerate(plan.accs)}
        by_shard = [0] * len(mesh)
        events = [[] for _ in mesh]  # CUDA events around each shard's K1, on its stream
        real_fold = dev._packed_fold_fn
        torch = self.torch

        def counted(acc, staged):
            d = shard_of[acc.data_ptr()]
            by_shard[d] += 1
            if not self.cuda:
                return real_fold(acc, staged)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            real_fold(acc, staged)
            end.record()
            events[d].append((start, end))

        dev._packed_fold_fn = counted
        walls = {}
        if timed_legs:  # the drain and the eager legs' collection, inside unmask_array
            for name in ("drain", "finish_unmask"):
                real = getattr(stream, name)

                def timed(*a, _real=real, _name=name):
                    t0 = time.perf_counter()
                    try:
                        return _real(*a)
                    finally:
                        walls[_name] = walls.get(_name, 0.0) + time.perf_counter() - t0

                setattr(stream, name, timed)
        t = time.perf_counter()
        for row, unit in zip(rows, units):
            obj = MaskObject(MaskVect(pair.vect, row), MaskUnit(pair.unit, unit))
            agg.validate_aggregation(obj)
            agg.aggregate(obj)
        walls["submit"] = time.perf_counter() - t
        t = time.perf_counter()
        view = agg.finalize_inplace(defer_drain=True)
        view.validate_unmasking(b["mask"])
        model = view.unmask_array(b["mask"])
        walls["drain_and_unmask"] = time.perf_counter() - t
        overlap = [w["overlap_ratio"] for w in (stream.last_window or {}).get("shards", [])]
        self.sync()
        fold_ms = [[s.elapsed_time(e) for s, e in ev] for ev in events]
        log(f"[phase X] {tag}: walls {', '.join(f'{k} {v:.3f} s' for k, v in walls.items())}; "
            f"K1 packed launches by shard {by_shard}, each fold's ms on its stream {fold_ms}; "
            f"overlap by shard {overlap}")
        return {"model": model, "walls": walls, "agg": agg, "k1_by_shard": by_shard,
                "k1_ms_by_shard": fold_ms, "overlap_by_shard": overlap,
                "degraded": stream.degraded}

    def _x_wire(self, mesh, batches: list, tag: str) -> dict:
        """B's even (v1) updates as raw element blocks through a 4-shard
        pipeline (``submit_wire_batch``, K6 on each shard's byte slice), the
        first batch with the member whose last element is invalid; checks
        the verdicts and the accumulator against B's even updates."""
        from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator
        from xaynet_tpu_torch.parallel.streaming import StreamingAggregator

        b, n = self.phase_b_out, self.args.length
        agg = DeviceAggregator(b["mask"].vect.config, n, mesh=mesh)
        stream = StreamingAggregator(agg, max_batch=self.args.batch)
        plan = agg.ensure_plan()
        shard_of = {a.data_ptr(): d for d, a in enumerate(plan.accs)}
        k6_by_shard = [0] * len(mesh)
        real_wire = agg._wire_fold_fn

        def counted_wire(acc, staged):
            k6_by_shard[shard_of[acc.data_ptr()]] += 1
            return real_wire(acc, staged)

        agg._wire_fold_fn = counted_wire
        t = time.perf_counter()
        tickets = [stream.submit_wire_batch(batch) for batch in batches]
        submit_s = time.perf_counter() - t
        t = time.perf_counter()
        stream.drain()
        drain_s = time.perf_counter() - t
        accepted = [t.accepted.tolist() for t in tickets]
        half = len(batches[0]) - 1
        want = [[True] * half + [False], [True] * len(batches[1])]
        self.check(accepted == want and agg.nb_models == half + len(batches[1]),
                   f"{tag} the member invalid on the last shard alone rejected on every shard: "
                   f"{accepted}")  # fmt: skip
        self.check(np.array_equal(agg.snapshot(), b["evens_vect"]),
                   f"{tag} the shards' accumulator == B's even updates folded on one shard")
        degraded = stream.degraded
        stream.close()
        log(f"[phase X] {tag} wire leg: submit {submit_s:.3f} s, drain {drain_s:.3f} s; K6 by "
            f"shard {k6_by_shard}; degraded {degraded}")
        return {"agg": agg, "k6_by_shard": k6_by_shard, "submit_s": submit_s,
                "drain_s": drain_s, "degraded": degraded}

    def phase_x(self, walls_b: dict) -> dict:
        """Phase X (module docstring): B's round on a 4-shard mesh of the
        card, its wire leg through K6 per shard, the journal's planes, and a
        shard fault."""
        torch = self.torch
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.ops import kernels
        from xaynet_tpu_torch.ops.fold import to_device_u32
        from xaynet_tpu_torch.parallel.mesh import make_mesh
        from xaynet_tpu_torch.parallel.streaming import SHARD_OVERLAP
        from xaynet_tpu_torch.resilience import faults
        from xaynet_tpu_torch.resilience.checkpoint import RoundCheckpoint
        from xaynet_tpu_torch.server.aggregation import StagedAggregator

        args, b = self.args, self.phase_b_out
        cfg = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)
        n, bpn, order = args.length, cfg.bytes_per_number, cfg.order
        mesh4 = make_mesh([self.dev] * 4)
        cards = torch.cuda.device_count() if self.cuda else 1
        log(f"[phase X] {cards} visible card(s); the 4-shard mesh repeats {self.dev}")
        t = time.perf_counter()
        rows, raws = self._x_rows()
        prep_s = time.perf_counter() - t
        log(f"[phase X] B's {len(rows)} staged updates from its wires (no encode) in {prep_s:.3f} s")

        # (x1) B's flush, packed, shard-parallel; the eager per-shard unmask
        kernels.reset_launches()
        x1 = self._x_round(mesh4, rows, "(x1) 4 shards", timed_legs=True)
        x1_launches = dict(kernels.LAUNCHES)
        self.check(x1["model"].tobytes() == b["model"].tobytes(),
                   "(x1) the 4-shard model == Phase B's one-shard model, byte for byte")
        flushes = -(-args.updates // args.batch)
        self.check(x1["k1_by_shard"] == [flushes] * 4
                   and (not self.cuda or x1_launches["fold_packed"] == 4 * flushes),
                   f"(x1) K1 packed once a shard a flush: {x1['k1_by_shard']}")
        gauges = [SHARD_OVERLAP.labels(shard=str(d)).value for d in range(4)]
        # (x2) the journal's planes restore into 1 and 4 shards, byte for byte
        agg = x1["agg"]
        snap = agg.snapshot_journal()
        self.check(snap.planes is not None and len(snap.planes) == 4,
                   "(x2) the 4-shard journal entry holds one plane per shard")
        entry = RoundCheckpoint(round_id=1, phase="sum2", round_seed=bytes(32), mask_config=[],
                                model_length=n, nb_models=snap.nb_models, seed_watermark=0,
                                vect=np.zeros((0, 0), np.uint32), unit=snap.unit,
                                planes=snap.planes)  # fmt: skip
        restored = {}
        for size in (1, 4):
            t = time.perf_counter()
            fresh = StagedAggregator(cfg.pair(), n, batch_size=args.batch, mesh=[self.dev] * size)
            fresh.restore_journal(entry)
            vect, unit, nb = fresh.snapshot_state()
            restored[size] = time.perf_counter() - t
            self.check(np.array_equal(vect, b["vect"]) and np.array_equal(unit, b["unit"])
                       and nb == args.updates,
                       f"(x2) the planes restored into {size} shard(s) == Phase B's accumulator")
            fresh.close()
            del fresh, vect
        agg.close()
        del agg, x1["agg"]

        # (x3) the wire leg: K6 on each shard's byte slice, one member invalid
        # in the last shard's slice alone, subtracted back from shards 0-2
        bad = raws[0].copy()
        bad[(n - 1) * bpn :] = 0xFF
        half = len(raws) // 2
        batches = [np.stack(raws[:half] + [bad]), np.stack(raws[half:])]
        kernels.reset_launches()
        x3 = self._x_wire(mesh4, batches, "(x3)")
        x3_launches = dict(kernels.LAUNCHES)
        wagg, k6_by_shard = x3["agg"], x3["k6_by_shard"]
        wire_submit_s, wire_drain_s = x3["submit_s"], x3["drain_s"]
        plan = wagg.ensure_plan()
        self.check(k6_by_shard == [2] * 4 and (not self.cuda or (
                       x3_launches["wire_fold"] == 8 and x3_launches["wire_unfold"] == 3)),
                   f"(x3) K6 once a shard a batch {k6_by_shard}, its subtract-back on shards 0-2 "
                   f"({x3_launches['wire_unfold']})")  # fmt: skip
        # wire_unfold at this shape against its plain version, and timed
        lo, hi = plan.slices[0]
        raw0 = torch.from_numpy(np.ascontiguousarray(batches[0][:, lo * bpn : hi * bpn])).to(self.dev)
        drop = torch.tensor([False] * half + [True], device=self.dev)
        base = to_device_u32(self.elements(order, 2, (hi - lo,)), self.dev)
        got = kernels.wire_unfold(base.clone(), raw0, drop, order)
        want = kernels.wire_unfold_plain(base.clone(), raw0, drop, order)
        self.compare("wire_unfold", got, want, f"one flagged member of 5 at {hi - lo} elements")
        acc = base.clone()
        timing = {"ms": self.time_ms(lambda: kernels.wire_unfold(acc, raw0, drop, order), 10),
                  "plain_ms": self.time_ms(lambda: kernels.wire_unfold_plain(acc, raw0, drop, order), 2),
                  # the flagged member's bytes and the accumulator's read and write
                  "bytes": (hi - lo) * bpn + 2 * 2 * 4 * (hi - lo) + 5,
                  "shape": [half + 1, (hi - lo) * bpn]}  # fmt: skip
        del wagg, raw0, base, acc, got, want

        # (x4) a fault on one shard's fold: degrade, then end byte-identical
        faults.install_plan(faults.FaultPlan.parse("streaming.shard2.fold:error,nth=1"))
        try:
            x4 = self._x_wire(mesh4, batches, "(x4) shard 2's first fold faulted:")
        finally:
            faults.clear_plan()
        self.check(x4["degraded"], "(x4) the faulted shard retried and the pipeline degraded")
        del x4["agg"]
        walls = dict(x1["walls"])
        walls.update(wire_submit=wire_submit_s, wire_drain=wire_drain_s)
        every = None
        if cards > 1:  # a mesh of every visible card
            every = self._x_round(make_mesh(), rows, f"(x5) every visible card ({cards})")
            self.check(every["model"].tobytes() == b["model"].tobytes(),
                       f"(x5) the model on {cards} cards == Phase B's")
            every["agg"].close()
            every = {k: v for k, v in every.items() if k not in ("agg", "model")}
        del rows, raws, batches
        log(f"[phase X] checks (x1)-(x4) passed; walls (4 shards): submit {walls['submit']:.3f} s "
            f"(B's one shard: update_aggregate {walls_b['update_aggregate']:.3f} s), drain "
            f"{walls.get('drain', 0.0):.3f} s, eager unmask legs "
            f"{walls.get('finish_unmask', 0.0):.3f} s, drain + unmask + decode "
            f"{walls['drain_and_unmask']:.3f} s (B's finalize {walls_b['finalize']:.3f} s + "
            f"unmask_array {walls_b['unmask_array']:.3f} s); wire leg submit "
            f"{wire_submit_s:.3f} s, drain {wire_drain_s:.3f} s; journal restore seconds "
            f"{restored}; per-shard overlap gauges {gauges}")
        log(f"[phase X] launches: (x1) {x1_launches}; (x3) {x3_launches}; K6 by shard "
            f"{k6_by_shard}; wire_unfold {timing['ms']:.4f} ms (plain {timing['plain_ms']:.4f} ms)")
        launches = {k: x1_launches[k] + x3_launches[k] for k in x1_launches}
        self.phase_b_out = None  # B's wires and results: no later phase reads them
        return {"walls": walls, "launches": launches, "x1_launches": x1_launches,
                "x3_launches": x3_launches, "k1_by_shard": x1["k1_by_shard"],
                "k1_ms_by_shard": x1["k1_ms_by_shard"],
                "k6_by_shard": k6_by_shard, "overlap_by_shard": x1["overlap_by_shard"],
                "overlap_gauges": gauges, "restore_s": restored, "prep_s": prep_s,
                "wire_unfold": timing, "fault_walls": {"submit": x4["submit_s"],
                                                       "drain": x4["drain_s"]}, "cards": cards,
                "every_card": every}

    # -- phase H: two processes, one card, one gloo group ----------------------

    def phase_h(self) -> dict:
        """Phase H (module docstring): two ``--h-worker`` processes of this
        script share the card, form a gloo group, and ingest their halves."""
        port = free_port()
        OUT_DIR.mkdir(exist_ok=True)
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), "--h-worker", str(r), "--h-port",
             str(port), "--length", str(self.args.length), "--seed", str(self.args.seed),
             "--device", str(self.dev)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ) for r in range(2)]  # fmt: skip
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t
        for r, out in enumerate(outs):
            (OUT_DIR / f"phase_h_rank{r}.log").write_text(out)
        self.check(all(p.returncode == 0 for p in procs),
                   f"(h) both workers exit 0 ({[p.returncode for p in procs]}; logs in "
                   f"chiprun_out/phase_h_rank*.log)")
        results = [json.loads((OUT_DIR / f"phase_h_rank{r}.json").read_text()) for r in range(2)]
        self.check(results[0]["ok"] == results[1]["ok"] == [True] * 7 + [False],
                   f"(h) the acceptance vector is the same on both ranks: {results[0]['ok']}")
        self.check(results[0]["slice"][1] == results[1]["slice"][0]
                   and results[1]["slice"][1] == self.args.length,
                   f"(h) the ranks' slices tile the model: {[r['slice'] for r in results]}")
        launches = {k: sum(r["launches"][k] for r in results) for k in results[0]["launches"]}
        if self.cuda:
            self.check(all(r["launches"]["wire_fold"] == 1 and r["launches"]["fold_planar"] == 1
                           for r in results)
                       and results[0]["launches"]["wire_unfold"] == 1
                       and results[1]["launches"]["wire_unfold"] == 0,
                       "(h) K6 and K1 planar once a rank; rank 0 took rank 1's rejected member "
                       f"back ({[r['launches'] for r in results]})")  # fmt: skip
        log(f"[phase H] 2 processes on one card, gloo: checks passed in {wall:.3f} s; per rank "
            + "; ".join(f"rank {r['rank']} slice {r['slice']} walls {r['walls']}" for r in results))
        return {"wall_s": wall, "ranks": results, "launches": launches}

    # -- phase S-mesh: the sim over a participant-axis mesh ----------------------

    def phase_s_mesh(self, sim: dict) -> dict:
        """Phase S-mesh (module docstring): s2's shape on 2 shards of the card,
        against Phase S's one-shard model."""
        from xaynet_tpu_torch.core.mask.config import (
            BoundType, DataType, GroupType, MaskConfig, ModelType,
        )  # fmt: skip
        from xaynet_tpu_torch.ops import kernels
        from xaynet_tpu_torch.parallel.mesh import make_mesh
        from xaynet_tpu_torch.sim import SimRound, SimSpec, seeds_for

        cfg2 = MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6)
        p, n, block2 = 2048, 1000, 256
        seeds2 = seeds_for(p, root=42)
        weights2 = np.random.default_rng(42).uniform(-1, 1, (p, n)).astype(np.float32)
        sim2 = SimRound(SimSpec(cfg2.pair(), n, block_size=block2), mesh=make_mesh([self.dev] * 2))
        kernels.reset_launches()
        t = time.perf_counter()
        res = sim2.run(seeds2, weights2, scalar=Fraction(1, p))  # warm-up
        warm_s = time.perf_counter() - t
        runs = []
        for _ in range(3):
            t = time.perf_counter()
            res = sim2.run(seeds2, weights2, scalar=Fraction(1, p))
            runs.append(time.perf_counter() - t)
        launches = dict(kernels.LAUNCHES)
        self.check(res.global_model.tobytes() == self.s2_model.tobytes(),
                   f"(s-mesh) the 2-shard sim's model == Phase S's one-shard model ({p} x {n})")
        blocks = p // block2
        if self.cuda:
            self.check(launches["mask_fold_rows"] == 4 * blocks and launches["unit_draws"] == 4 * blocks
                       and launches["fold_planar"] == 4 * (3 * blocks + 2),
                       f"(s-mesh) launches over 4 runs: K2 per row and K5 once a block "
                       f"({launches['mask_fold_rows']}, {launches['unit_draws']}), K1 planar 3 a "
                       f"block and 2 for the combine ({launches['fold_planar']})")  # fmt: skip
        pps = sorted(p / r for r in runs)
        one = sim["s2_participants_per_s"]
        log(f"[phase S-mesh] SimRound {p} x {n} on 2 shards of the card: median {pps[1]:.1f} "
            f"participants/s (min {pps[0]:.1f}, max {pps[2]:.1f}; warm-up {warm_s:.3f} s) beside "
            f"Phase S's one shard median {one['median']:.1f}; launches {launches}")
        return {"runs_s": runs, "warmup_s": warm_s,
                "participants_per_s": {"median": pps[1], "min": pps[0], "max": pps[2]},
                "one_shard_participants_per_s": one, "launches": launches}

    def kernel_table(self, timings: dict, launches: dict, paths: dict) -> list[dict]:
        """One row per kernel entry: ``launches`` from its main path's run,
        and beside it the launches of each other path in ``paths``."""
        torch = self.torch
        props = torch.cuda.get_device_properties(0)
        int_rate = props.multi_processor_count * INT32_LANES_PER_SM * max_sm_clock_hz()
        rows = []
        meta = {
            "fold_packed": ("xaynet_tpu_torch/csrc/fold.cu", "xaynet_tpu/ops/fold_pallas.py:125"),
            "fold_planar": ("xaynet_tpu_torch/csrc/fold.cu", "xaynet_tpu/ops/fold_pallas.py:125"),
            "mask_fold": ("xaynet_tpu_torch/csrc/mask_fold.cu", "xaynet_tpu/ops/fold_pallas.py:201"),
            # K2 per row: the JAX package's batched in-graph derivation (XLA)
            "mask_fold_rows": ("xaynet_tpu_torch/csrc/mask_fold.cu",
                               "xaynet_tpu/ops/masking_jax.py:131"),
            # the XLA program X4 of the JAX package's wire ingest
            "wire_unpack": ("xaynet_tpu_torch/csrc/wire.cu", "xaynet_tpu/parallel/aggregator.py:99"),
            "packed_check": ("xaynet_tpu_torch/csrc/wire.cu", "xaynet_tpu/parallel/aggregator.py:122"),
            # K5: the JAX package's batched in-graph unit draws (XLA)
            "unit_draws": ("xaynet_tpu_torch/csrc/mask_fold.cu", "xaynet_tpu/ops/masking_jax.py:141"),
            # K6: the JAX package's fused wire ingest (XLA, `_make_ingest_fn`)
            "wire_fold": ("xaynet_tpu_torch/csrc/fold.cu", "xaynet_tpu/parallel/aggregator.py:867"),
            # K6's subtract-back pass alone: the cross-shard verdict, where the
            # JAX mesh program psums the validity over the model axis
            "wire_unfold": ("xaynet_tpu_torch/csrc/fold.cu", "xaynet_tpu/parallel/aggregator.py:113"),
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
                # Phases R, R-wire, S, L and T (the training rounds)
                **{path: counts.get(name, 0) for path, counts in paths.items()},
                "max_abs_err": self.max_err[name],
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                # mask_fold_rows: the plain version ran over the first of s1's rows
                **({"plain_rows": t["plain_rows"]} if "plain_rows" in t else {}),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
                "library_ms": None,
            })  # fmt: skip
        self.records["int32_ops_per_s"] = int_rate
        for name in ("mask_fold_rows", "unit_draws"):
            s2 = timings[name]["s2"]
            s2["bound_ms"] = max(s2["bytes"] / MEM_BYTES_PER_S, s2["ops"] / int_rate) * 1e3
            rows[[r["name"] for r in rows].index(name)]["s2_shape"] = s2
        rows[[r["name"] for r in rows].index("wire_fold")]["k8_shape"] = timings["wire_fold"]["k8_shape"]
        return rows

    def idle_shares(self, timings: dict, launches: dict) -> None:
        """Each traced round's device idle share from its trace, beside the
        estimate from launches x per-launch times at the main shapes
        (Phases R, R-wire and T's rounds, whose estimate leaves out the
        training's own kernels; Phase L's kernels run at other shapes). The
        trace holds this process's device work only: in R, R-wire and T that
        is all the card does; in L the drivers' K2 runs in their own
        processes, so L's share is the coordinator process's."""
        for name, counts in launches.items():
            trace = self.records.get("traces", {}).get(name)
            if not isinstance(trace, dict):
                log(f"[trace] {name}: {trace}")
                continue
            trace["complete"] = trace_complete(trace, counts)
            trace["idle_share_of"] = "coordinator process" if name == "phase L" else "card"
            kernels = {k: round(v["device_ms"], 3) for k, v in list(trace["by_name"].items())[:6]}
            line = (f"[trace] {name}: window {trace['window_s']:.3f} s, device busy "
                    f"{trace['device_busy_s']:.4f} s, idle share of the "
                    f"{trace['idle_share_of']} {trace['idle_share']:.5f} "
                    f"({trace['device_events']} device events; every kernel launch of this "
                    f"process in the trace: {trace['complete']}); device ms by name {kernels}")
            if name != "phase L":
                est = sum(n * timings[k]["ms"] for k, n in counts.items() if k in timings) / 1e3
                trace["estimate_busy_s"] = est
                line += (f"; estimate from launches x main-shape times {est:.4f} s "
                         f"(idle share {1 - est / trace['window_s']:.5f})")
            log(line)

    def device_profile(self, timings: dict) -> None:
        """Device time of each kernel (and fill) by name over one call of
        each at the main shapes: K1 packed (8 updates) and planar (1), one
        K2 seed, K2 per row at Phase S's s1 shape (8 rows, one launch), K5
        over Phase B's Sum2 (its seeds), in profiler
        windows with CUDA activity only (:meth:`traced`); K3 and K4 are
        profiled at Phase W's launches (:meth:`phase_w_kernels`). The calls
        run twice: launched as the window opens (the window PRs 4-6 read),
        and 0.5 s after it opened; each window's device calls are held
        against the launch counters (``complete``), and the times are the
        second window's."""
        torch = self.torch
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
        rows = zeros_u32((k, 2, n), self.dev)
        kws = torch.zeros((k, 8), dtype=torch.int32, device=self.dev).view(torch.uint32)

        unit_kws = torch.zeros((self.args.updates, 8), dtype=torch.int32,
                               device=self.dev).view(torch.uint32)

        def work():
            kernels.fold_packed(acc, packed, order)
            kernels.fold_planar(acc, one, order)
            kernels.mask_fold(acc, kws[:1], [6], n, order)
            kernels.mask_fold_rows(rows, kws, [6] * k, n, order)
            kernels.unit_draws(unit_kws, order)

        names = KERNEL_SYMBOLS
        found = {}
        for window, settle in (("main shapes, at once", 0.0), ("main shapes, settled", 0.5)):
            torch.cuda.synchronize()
            kernels.reset_launches()
            self.traced(window, work, settle_s=settle)
            launched = dict(kernels.LAUNCHES)
            summary = self.records["traces"][window]
            if not isinstance(summary, dict):
                log(f"[profile] {window}: {summary}")
                continue
            found = summary["by_name"]
            summary["complete"] = trace_complete(summary, launched)
            calls = sum(r["calls"] for name, r in found.items()
                        if any(v in name for v in set(names.values())))  # fmt: skip
            log(f"[profile] {window} (settle {settle} s on each side): {calls} of "
                f"{sum(launched.values())} kernel launches in the trace; first device event "
                f"{summary['first_device_us']} us after the window opened; in order "
                f"{[n[:24] for n in summary['order'] or []]}")
        profile_rows = [{"kernel": name, **row} for name, row in found.items()]
        self.records["profile"] = profile_rows
        for r in profile_rows:
            log(f"[profile] {r['kernel'][:60]}: {r['device_ms']:.3f} ms over {r['calls']} call(s)")
        for name in ("fold_packed", "fold_planar", "mask_fold", "mask_fold_rows", "unit_draws"):
            hits = [r for r in profile_rows if names[name] in r["kernel"]]
            if sum(r["calls"] for r in hits) == 1 and name in timings:  # one launch each
                timings[name]["device_ms"] = sum(r["device_ms"] for r in hits)
        del acc, packed, one, rows, unit_kws


def h_worker(args) -> int:
    """One rank of Phase H (``--h-worker RANK --h-port PORT``): joins the
    two-process gloo group on 127.0.0.1, folds its half of the model on the
    card (``parallel.multihost.MultiHostAggregator``, mesh ``[cuda:0]``): a
    raw wire batch of 8 whose last member has an invalid element in rank
    1's slice (``add_local_wire_batch``: K6, the verdict all-reduced, the
    member taken back on rank 0), a planar batch of the 8 updates
    (``add_local_batch``: K1 planar), then ``unmask_local``. Its slice must
    equal a numpy oracle (the two limbs as one ``uint64``: the order is
    below 2^64). The data is seeded numpy, valid group elements, the same
    on both ranks (``tests/multihost_worker.py``'s way). Writes
    ``chiprun_out/phase_h_rank<RANK>.json``."""
    sys.path.insert(0, str(HERE))
    import torch

    from xaynet_tpu_torch.core.mask.config import (
        BoundType, DataType, GroupType, MaskConfig, ModelType,
    )  # fmt: skip
    from xaynet_tpu_torch.ops import kernels, limbs
    from xaynet_tpu_torch.parallel.multihost import MultiHostAggregator, initialize

    rank, k = args.h_worker, 8
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        kernels.build()  # built by the parent: this only finds the libraries
    walls = {}
    t = time.perf_counter()
    initialize(f"127.0.0.1:{args.h_port}", num_processes=2, process_id=rank, timeout_s=300)
    walls["group"] = time.perf_counter() - t
    cfg = MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6)
    order, n, bpn = cfg.order, args.length, cfg.bytes_per_number
    assert limbs.n_limbs_for_order(order) == 2 and order < 1 << 64
    t = time.perf_counter()
    rng = np.random.default_rng(args.seed + 123)
    values = rng.integers(0, order, size=(k + 1, n), dtype=np.uint64)  # 8 updates, the mask
    agg = MultiHostAggregator(cfg, n, mesh=[dev])
    lo, hi = agg.local_slice
    mine = np.ascontiguousarray(values[:, lo:hi])
    del values
    local = mine[:k].view(np.uint32).reshape(k, hi - lo, 2)  # little-endian limbs
    mask = mine[k].view(np.uint32).reshape(hi - lo, 2)
    raw = np.stack([np.frombuffer(limbs.limbs_to_bytes_le(local[i], bpn), np.uint8)
                    for i in range(k)])  # fmt: skip
    if hi == n:  # the last member's last element: invalid, in rank 1's slice only
        raw[k - 1, -bpn:] = 0xFF
    walls["data"] = time.perf_counter() - t
    kernels.reset_launches()
    t = time.perf_counter()
    ok = agg.add_local_wire_batch(raw)
    walls["wire_batch"] = time.perf_counter() - t
    t = time.perf_counter()
    agg.add_local_batch(local)
    walls["planar_batch"] = time.perf_counter() - t
    t = time.perf_counter()
    out = agg.unmask_local(mask)
    walls["unmask"] = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    t = time.perf_counter()
    m = np.uint64(order)
    want = np.zeros(hi - lo, dtype=np.uint64)
    for x in [*mine[: k - 1], *mine[:k]]:  # the 7 accepted wire members, the 8 planar
        s = want + x  # both below the order: one wrap at most
        want = np.where((s < want) | (s >= m), s - m, s)
    want = np.where(want >= mine[k], want - mine[k], want - mine[k] + m)
    walls["oracle"] = time.perf_counter() - t
    checks = {"slice == the numpy oracle": bool(np.array_equal(out.view(np.uint64)[:, 0], want)),
              "nb_models == 15": agg.nb_models == 2 * k - 1}  # fmt: skip
    torch.distributed.destroy_process_group()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"phase_h_rank{rank}.json").write_text(json.dumps(
        {"rank": rank, "slice": [lo, hi], "ok": ok.tolist(), "walls": walls,
         "launches": launches, "checks": checks}))  # fmt: skip
    print(f"rank {rank}: slice [{lo}, {hi}), acceptance {ok.tolist()}, checks {checks}, "
          f"walls {walls}, launches {launches}", flush=True)
    return 0 if all(checks.values()) else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--length", type=int, default=25_000_000, help="model length")
    parser.add_argument("--updates", type=int, default=8, help="update participants")
    parser.add_argument("--batch", type=int, default=8, help="aggregation batch size")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="'cpu' rehearses the control flow with the plain versions "
                             "(no kernels, no result line)")
    parser.add_argument("--only", choices=("D", "H"), default=None,
                        help="run one phase alone (Phase D and its tools, or Phase H; no "
                             "kernel line and no result line)")
    # Phase H's workers: this script again, one a rank
    parser.add_argument("--h-worker", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--h-port", type=int, default=None, help=argparse.SUPPRESS)
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
    if args.h_worker is not None:
        return h_worker(args)

    smoke = Smoke(args)
    t0 = time.perf_counter()
    try:
        if smoke.cuda:
            smoke_name = gpu_name_and_power()
            log(f"[setup] {smoke_name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
                f"{torch.cuda.device_count()} device(s)")
            smoke.build()
        if args.only == "D":
            durable = smoke.timed("D", smoke.phase_d)
            durable["tools"] = smoke.timed("D tools", smoke.phase_d_tools)
            smoke.records.update(durable_round=durable, seconds=time.perf_counter() - t0)
            _write_records(smoke.records)
            log(f"chip_smoke: Phase D alone on {args.device} passed in "
                f"{time.perf_counter() - t0:.1f} s")
            return 0
        if args.only == "H":
            smoke.records.update(hosts=smoke.timed("H", smoke.phase_h),
                                 seconds=time.perf_counter() - t0)
            _write_records(smoke.records)
            log(f"chip_smoke: Phase H alone on {args.device} passed in "
                f"{time.perf_counter() - t0:.1f} s")
            return 0
        timed = smoke.timed
        timed("A", smoke.phase_a_fold)
        timed("A", smoke.phase_a_mask_fold)
        timed("A", smoke.phase_a_look_back)
        timed("A", smoke.phase_a_mask_fold_rows)
        timed("A", smoke.phase_a_wire)
        timings = timed("A", smoke.phase_a_main_shapes)
        timings["unit_draws"] = timed("A", smoke.phase_a_unit_draws)
        timings["mask_fold_rows"] = timed("A", smoke.phase_a_rows_main)
        timed("A", smoke.phase_a_wire_main)
        pipeline = timed("P", smoke.phase_pipeline)
        result = timed("B", smoke.phase_b)
        first_flush = smoke.phase_b_out["wires"][: max(1, args.batch // 4)]
        wire = timed("W", smoke.phase_w, result["walls"], timings)
        shards = timed("X", smoke.phase_x, result["walls"])
        timings["wire_unfold"] = shards["wire_unfold"]
        hosts = timed("H", smoke.phase_h)
        sim = timed("S", smoke.phase_s, first_flush)
        del first_flush
        sim_mesh = timed("S-mesh", smoke.phase_s_mesh, sim)
        coordinator = timed("R", smoke.phase_r)
        coordinator_wire = timed("R-wire", smoke.phase_r, wire=True)
        durable = timed("D", smoke.phase_d)
        durable["tools"] = timed("D tools", smoke.phase_d_tools)
        loadgen = timed("L", smoke.phase_l)
        loadgen_shed = timed("L-shed", smoke.phase_l_shed)
        fanin = timed("E-fanin", smoke.phase_e_fanin)
        training = timed("T", smoke.phase_t)
        edge = timed("E", smoke.phase_e, training["rounds"]["length"])
        multi = timed("M", smoke.phase_m, training["rounds"]["length"])
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
                         shards=shards, hosts=hosts, sim_mesh=sim_mesh,
                         sim=sim, coordinator_round=coordinator,
                         coordinator_round_wire=coordinator_wire, durable_round=durable,
                         loadgen_round=loadgen,
                         loadgen_shed_round=loadgen_shed, edge_fanin_round=fanin,
                         edge_round=edge, training=training, multi_tenant=multi,
                         seconds=time.perf_counter() - t0)
    if not smoke.cuda:
        _write_records(smoke.records)
        log(f"chip_smoke: rehearsal on {args.device} passed in {time.perf_counter() - t0:.1f} s")
        return 0
    # launches per path: K1, K2 and K5 on Phase B's round, K3 and K4 on Phase
    # W's, K6 on W's fused leg, K2's per-row entry on Phase S's
    launches = {**result["launches"],
                **{k: wire["launches"][k] for k in ("wire_unpack", "packed_check")},
                "wire_fold": wire["fused"]["launches"]["wire_fold"],
                "wire_unfold": shards["launches"]["wire_unfold"],
                "mask_fold_rows": sim["launches"]["mask_fold_rows"]}
    loadgen_launches = {k: v + loadgen["driver_launches"].get(k, 0)
                        for k, v in loadgen["launches"].items()}
    table = smoke.kernel_table(timings, launches, {
        "launches_coordinator_round": coordinator["launches"],
        "launches_coordinator_round_wire": coordinator_wire["launches"],
        # the participants in this process, the coordinator's two processes
        "launches_durable": {k: v + sum(proc.get(k, 0) for proc in durable["process_launches"])
                             for k, v in durable["launches"].items()},
        "launches_sim": sim["launches"],
        # this slice's paths: X (4 shards), H (2 processes), S-mesh (2 shards)
        "launches_shards": shards["launches"],
        "launches_hosts": hosts["launches"],
        "launches_sim_mesh": sim_mesh["launches"],
        "launches_loadgen": loadgen_launches,
        "launches_loadgen_shed": {k: v + loadgen_shed["driver_launches"].get(k, 0)
                                  for k, v in loadgen_shed["launches"].items()},
        "launches_edge": edge["launches"],
        "launches_edge_fanin": {k: v + fanin["driver_launches"].get(k, 0)
                                for k, v in fanin["launches"].items()},
        "launches_training_rounds": training["rounds"]["launches"],
        "launches_multi_tenant": {k: v + multi["launches_mlp"].get(k, 0)
                                  for k, v in multi["launches"].items()},
    })  # fmt: skip
    smoke.records["kernels"] = table
    smoke.idle_shares(timings, {"phase R": coordinator["launches"],
                                "phase R-wire": coordinator_wire["launches"],
                                "phase L": loadgen["launches"],
                                "phase M": multi["launches"],
                                **{f"phase T round {i}": r["launches"] for i, r in
                                   enumerate(training["rounds"]["rounds"], start=1)}})  # fmt: skip
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


# each launch counter's kernel, by a part of its symbol's name
KERNEL_SYMBOLS = {"fold_packed": "fold_packed_kernel", "fold_planar": "fold_planar_kernel",
                  "mask_fold": "mf_mask_fold_kernel", "mask_fold_rows": "mf_mask_fold_rows_kernel",
                  "wire_unpack": "wire_unpack_kernel", "packed_check": "packed_check_kernel",
                  "unit_draws": "mf_unit_draws_kernel", "wire_fold": "wire_fold_kernel",
                  "wire_unfold": "wire_unfold_kernel"}


def trace_complete(trace: dict, launches: dict) -> bool:
    """Whether a trace holds as many calls of each kernel as this process's
    launch counters say it launched in the window."""
    want: dict = {}
    for counter, n in launches.items():
        symbol = KERNEL_SYMBOLS[counter]
        want[symbol] = want.get(symbol, 0) + n
    got = {symbol: sum(r["calls"] for name, r in trace["by_name"].items() if symbol in name)
           for symbol in want}  # fmt: skip
    return got == want


def trace_summary(prof, window_s: float) -> dict:
    """Device time by name (kernels, copies, fills) in a profiler window,
    the card's busy time (the union of those intervals) and its idle share
    of the window's host-clock wall."""
    by_name: dict = {}
    spans, named = [], []
    kinds = set()
    events = prof.events()
    for ev in events:
        kinds.add(str(ev.device_type))
        if "CUDA" not in str(ev.device_type):
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        named.append((start, ev.name))
        row = by_name.setdefault(ev.name, {"device_ms": 0.0, "calls": 0})
        row["device_ms"] += (end - start) / 1e3
        row["calls"] += 1
    busy_us, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    busy_s = busy_us / 1e6
    return {"window_s": window_s, "device_busy_s": busy_s,
            "idle_share": 1 - busy_s / window_s if window_s > 0 else None,
            "events": len(events), "device_events": len(spans), "device_types": sorted(kinds),
            # device events' first start and last end, microseconds from the trace's start
            "first_device_us": min((a for a, _ in spans), default=None),
            "order": [name[:48] for _, name in sorted(named)] if len(named) <= 64 else None,
            "last_device_us": max((b for _, b in spans), default=None),
            "by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1]["device_ms"]))}


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
