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
- **Phase R-wire** is the same round with device wire ingest, the packed
  upload format (the SDK sends wire v2), the ``file`` coordinator store
  and the round journal: it also checks that the coordinator's K4 checked
  each update (K3 not launched) and that journal entries and the store's
  state file were written. Then ``python -m
  xaynet_tpu_torch.server.runner -c <cfg>`` at length 1000 must answer
  ``GET /params`` and exit 0 on SIGTERM with "coordinator stopped" logged.

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

# Phase R's participants split a message into parts of at most this many
# bytes: a 150 MB update goes as 3 parts, through the multipart reader
PHASE_R_PART_BYTES = 64 << 20
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


# -- Phase R: the port's coordinator, and a minimal participant over HTTP ----


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def write_coordinator_config(path: Path, port: int, length: int, model_dir: Path,
                             n_updates: int = 3, device_fold: bool = True,
                             wire: bool = False) -> Path:
    """A coordinator config: the shipped mask config, probabilities and
    aggregation knobs (``configs/config.toml``; batch 64, packed staging),
    the device fold on, count windows with min = max (1 sum, ``n_updates``
    updates, 1 sum2), the filesystem model store (and the flight recorder's
    dumps) in ``model_dir``. With ``wire``: device wire ingest, the packed
    upload format (wire v2, so participants send byte planes), the ``file``
    coordinator store and the round journal in ``model_dir``."""
    window = 'time = {{ min = 0.0, max = 900.0 }}\ncount = {{ min = {n}, max = {n} }}'
    wire_keys = (
        "wire_ingest = true\n"
        '[ingest]\nwire_format = "packed"\n'
        "[resilience]\ncheckpoint_enabled = true\n"
    ) if wire else ""
    store = 'coordinator = "file"\n' if wire else ""
    path.write_text(
        f'[api]\nbind_address = "127.0.0.1:{port}"\n'
        f'[pet.sum]\nprob = 0.01\n{window.format(n=1)}\n'
        f'[pet.update]\nprob = 0.1\n{window.format(n=n_updates)}\n'
        f'[pet.sum2]\n{window.format(n=1)}\n'
        '[mask]\ngroup_type = "prime"\ndata_type = "f32"\nbound_type = "b0"\n'
        'model_type = "m3"\n'
        f"[model]\nlength = {length}\n"
        f"[aggregation]\ndevice = {str(device_fold).lower()}\nbatch_size = 64\n"
        "packed_staging = true\n"
        f"{wire_keys}"
        f'[storage]\nbackend = "filesystem"\n{store}model_dir = "{model_dir}"\n'
        f'[metrics]\nflight_dir = "{model_dir / "flight"}"\n'
    )
    return path


def http_call(base: str, method: str, path: str, body: bytes = b"",
              timeout: float = 900.0) -> tuple[int, bytes]:
    import http.client
    from urllib.parse import urlparse

    url = urlparse(base)
    conn = http.client.HTTPConnection(url.hostname, url.port, timeout=timeout)
    try:
        conn.request(method, path, body=body or None, headers={"Connection": "close"})
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
              timeout: float = 900.0) -> dict:
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
    timed alone. Returns the decoded global model, the masked updates and
    the Sum2 mask the participants sent (read at their ``_send``), and the
    walls."""
    import asyncio

    return asyncio.run(_sdk_round(base, weights, device, max_message_size, timeout))


async def _sdk_round(base, weights, device, max_message_size, timeout) -> dict:
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
    sent: dict = {"update": [], "sum2": []}
    seeds_seen: list[int] = []
    probe = HttpClient(base, timeout=timeout)
    params = await probe.get_round_params()
    seed, n_up = params.seed.as_bytes(), len(weights)
    if params.model_length != len(weights[0]):
        raise Failure(f"round model length {params.model_length} != {len(weights[0])}")

    def participant(keys, model, scalar):
        client = GatedClient(HttpClient(base, timeout=timeout))
        sm = StateMachine(PetSettings(keys=keys, scalar=scalar, max_message_size=max_message_size,
                                      device=device),
                          client, ArrayModelStore(model))  # fmt: skip
        real_send, real_aggregate = sm._send, sm._aggregate_masks

        async def send(payload, next_phase):
            for kind, attr in (("update", "masked_model"), ("sum2", "model_mask")):
                if hasattr(payload, attr):
                    sent[kind].append(payload)
            return await real_send(payload, next_phase)

        def aggregate(mask_seeds, length, config):
            seeds_seen.append(len(mask_seeds))
            return real_aggregate(mask_seeds, length, config)

        sm._send, sm._aggregate_masks = send, aggregate
        return sm, client

    summer, summer_client = participant(
        keys_for_task(seed, params.sum, params.update, "sum", start=0), None, Fraction(1))
    summer_client.gate.set()
    updaters = [participant(keys_for_task(seed, params.sum, params.update, "update",
                                          start=(20 + i) * 1000),
                            w, Fraction(1, n_up))
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

        cpu0 = time.process_time()
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

    # -- phase R: a round through the port's coordinator ----------------------

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
        import logging
        import os
        import resource
        import shutil
        import tempfile

        from xaynet_tpu_torch.core.crypto import encrypt
        from xaynet_tpu_torch.ops import kernels
        from xaynet_tpu_torch.server import settings as settings_mod
        from xaynet_tpu_torch.server.aggregation import StagedAggregator
        from xaynet_tpu_torch.server.phases import update as update_phase
        from xaynet_tpu_torch.telemetry.registry import get_registry

        args = self.args
        tag, c = ("phase R-wire", "rw") if wire else ("phase R", "r")
        length, n_up = args.length, 3
        rng = np.random.default_rng(args.seed + (4 if wire else 3))
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

        class PhaseMarks(logging.Handler):
            """The coordinator's phase transitions, on this process's clock."""

            def __init__(self):
                super().__init__()
                self.marks = []

            def emit(self, record):
                msg = record.getMessage()
                if "entering" in msg or "full close" in msg:
                    self.marks.append((time.perf_counter(), msg))

        def counters() -> dict:
            registry = get_registry()
            family = registry.get("xaynet_message_pipeline_seconds")
            out = {stage: family.labels(stage=stage).sum for stage in ("decrypt_parse", "total")}
            journal = registry.get("xaynet_resilience_checkpoints_total")
            out["journal_writes"] = sum(child.value for _, child in journal.children())
            return out

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
            before = counters()
            kernels.reset_launches()
            out = sdk_round(base, weights, device, PHASE_R_PART_BYTES, timeout=300)
            launches = dict(kernels.LAUNCHES)
            after = counters()
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
            hits = [t for t, msg in marks.marks if msg.startswith(prefix) and text in msg]
            return hits[0] - walls["t0"] if hits else None

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
            "ring_buffer_rows": None if ring is None else [len(b) for b in ring._bufs],
            "ring_pin_s": None if ring is None else ring.pin_seconds,
            "ring_reused": None if ring is None else ring.reused,
            "stage_s": window.get("stage_seconds"),
            "fold_s": window.get("fold_seconds"),
        }

        # the same inputs through the plain versions on the CPU: the fold of
        # the three masked updates and the unmask with the Sum2 mask
        t = time.perf_counter()
        ref = StagedAggregator(out["mask"].config, length, batch_size=n_up, device="cpu")
        for obj in out["updates"]:
            ref.validate_aggregation(obj)
            ref.aggregate(obj)
        ref_model = ref.finalize_inplace().unmask_array(out["mask"])
        plain_s = time.perf_counter() - t
        self.check(model.shape == (length,) and bool(np.all(np.isfinite(model))),
                   f"({c}1) global model finite, of the model length")
        self.check(model.tobytes() == ref_model.tobytes(),
                   f"({c}2) global model byte-identical to the plain CPU fold + unmask of the "
                   "updates and the mask the SDK participants sent")  # fmt: skip
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
            self.check(launches["fold_planar"] == n_up and launches["mask_fold"] == 2 * n_up,
                       f"({c}6) the SDK participants: K1 planar {launches['fold_planar']} == "
                       f"{n_up}, K2 {launches['mask_fold']} == {2 * n_up} (masking and Sum2)")
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

    def phase_r_cli(self) -> dict:
        """``python -m xaynet_tpu_torch.server.runner -c <cfg>`` at a small
        length: ``GET /params`` answers, SIGTERM stops it with exit code 0
        and "coordinator stopped" in its log."""
        import signal
        import shutil
        import tempfile

        length = 1000
        work = Path(tempfile.mkdtemp(prefix="xn_runner_"))
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        # the CPU rehearsal's runner folds on the host (it has no card)
        cfg = write_coordinator_config(work / "config.toml", port, length, work / "models",
                                       device_fold=self.cuda)
        log_path = work / "runner.log"
        t = time.perf_counter()
        with open(log_path, "wb") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "xaynet_tpu_torch.server.runner", "-c", str(cfg)],
                cwd=HERE, stdout=out, stderr=subprocess.STDOUT,
            )  # fmt: skip
        try:
            def params():
                if proc.poll() is not None:
                    raise Failure(f"the runner exited early with {proc.returncode}")
                try:
                    status, body = http_call(base, "GET", "/params", timeout=30)
                except OSError:
                    return None
                return json.loads(body) if status == 200 else None

            answered = wait_for(params, 120, "the runner's GET /params", poll=0.1)
            up_s = time.perf_counter() - t
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            text = log_path.read_text(errors="replace")
            shutil.rmtree(work, ignore_errors=True)
        self.records["runner_log_tail"] = text[-4000:]
        self.check(answered["model_length"] == length, "(r9) the runner's GET /params answers")
        self.check(rc == 0 and "coordinator stopped" in text,
                   f"(r10) SIGTERM stops the runner: exit code {rc}, 'coordinator stopped' logged")
        log(f"[phase R] runner CLI: GET /params answered {up_s:.1f} s after the start; "
            f"SIGTERM -> exit code {rc}, 'coordinator stopped' logged")
        return {"params_after_s": up_s, "exit_code": rc}

    def kernel_table(self, timings: dict, launches: dict, round_launches: dict,
                     wire_round_launches: dict) -> list[dict]:
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
                # Phases R and R-wire: the rounds through the coordinator
                "launches_coordinator_round": round_launches[name],
                "launches_coordinator_round_wire": wire_round_launches[name],
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
        coordinator = smoke.phase_r()
        coordinator_wire = smoke.phase_r(wire=True)
        if smoke.cuda:  # the runner CLI resolves CUDA; without a card it exits
            coordinator["runner_cli"] = smoke.phase_r_cli()
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
                         coordinator_round=coordinator, coordinator_round_wire=coordinator_wire,
                         seconds=time.perf_counter() - t0)
    if not smoke.cuda:
        _write_records(smoke.records)
        log(f"chip_smoke: rehearsal on {args.device} passed in {time.perf_counter() - t0:.1f} s")
        return 0
    # launches per path: K1 and K2 on Phase B's round, K3 and K4 on Phase W's
    launches = {**result["launches"],
                **{k: wire["launches"][k] for k in ("wire_unpack", "packed_check")}}
    table = smoke.kernel_table(timings, launches, coordinator["launches"],
                               coordinator_wire["launches"])
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
