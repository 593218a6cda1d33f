"""The port's CUDA kernels: build, load, launch, and their plain versions.

Two hand-written Hopper kernels replace the two Pallas TPU kernels of the
JAX package (``xaynet_tpu/ops/fold_pallas.py``):

- **K1** ``csrc/fold.cu`` — the lazy-carry batch fold
  (``fold_planar_batch_pallas``), planar ``uint32[K, L, n]`` input
  (:func:`fold_planar`) and packed byte-planar ``uint8[K, bpn, n]`` input
  (:func:`fold_packed`);
- **K2** ``csrc/mask_fold.cu`` — the fused Sum2 keystream -> reject -> fold
  (``mask_fold_planar_pallas``), :func:`mask_fold`.

Two more replace the XLA program of the JAX package's device wire ingest
(``xaynet_tpu/parallel/aggregator.py`` ``_build_wire_unpack`` /
``_build_planar_ok``):

- **K3** ``csrc/wire.cu`` — unpack of v1 interleaved wire element blocks
  ``uint8[K, n*bpn]`` into planar ``uint32[K, L, n]`` with a per-update
  validity verdict, :func:`wire_unpack`;
- **K4** ``csrc/wire.cu`` — the verdict alone over v2 byte-planar blocks
  ``uint8[K, bpn, n]``, :func:`packed_check`.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ctypes, at first use (never at
import: this module imports on machines without ``nvcc``). Libraries go to
``build/xaynet_tpu_torch/`` beside the package (``XAYNET_TORCH_BUILD_DIR``
overrides it), named by a digest of their source and compiler flags.

Each wrapper decides by the device of its tensors: a CPU tensor runs the
plain torch version beside it (``*_plain``), a CUDA tensor launches the
kernel or raises. There is no fallback from the kernel to the plain
version. ``LAUNCHES`` counts the kernel launches of each wrapper, under a
lock (the streaming pipeline's fold worker launches K1 from its own
thread): K1 one per batch fold, K2 one per seed and trip (a trip is one
pass over a provisioned run of keystream candidates; a seed takes one
trip except with probability < 2^-60, or when a caller shrinks
``chunk_candidates``), K3 and K4 one per group of wire updates.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import chacha
from . import limbs as host_limbs
from .fold import (
    MAX_LAZY_BATCH,
    _int_to_limbs_list,
    check_fold_args,
    narrow,
    p_cond_sub_const,
    p_lt_const,
    p_mod_add,
    store_,
    to_device_u32,
    widen,
)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"fold": "fold.cu", "mask_fold": "mask_fold.cu", "wire": "wire.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)  # fmt: skip

LAUNCHES = {"fold_planar": 0, "fold_packed": 0, "mask_fold": 0, "wire_unpack": 0, "packed_check": 0}
_LAUNCHES_LOCK = threading.Lock()

_LIBS: dict[str, ctypes.CDLL] = {}
_LIB_LOCK = threading.Lock()
_ORDER_BUFFERS: dict[tuple, tuple] = {}


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _launched(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


# --- build and load --------------------------------------------------------


def build_dir() -> Path:
    env = os.environ.get("XAYNET_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "xaynet_tpu_torch"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_stem(name: str) -> str:
    """File stem of kernel ``name``'s library: ``libxn_<name>-<digest>``, the
    digest taken over the source and the compiler flags, so a changed
    kernel or a changed flag always builds anew."""
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    digest.update("\0".join(NVCC_FLAGS).encode())
    return f"libxn_{name}-{digest.hexdigest()[:16]}"


def build(out_dir: Path | None = None) -> dict[str, Path]:
    """Compile every kernel source whose library (keyed on the source's and
    the flags' content, :func:`library_stem`) is missing, one ``nvcc`` per
    source, all started together. Returns the library paths; each compiler's output
    (``-Xptxas -v`` register and spill report) is kept beside its library
    as ``<stem>.log``."""
    out = Path(out_dir) if out_dir is not None else build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {name: out / f"{library_stem(name)}.so" for name in SOURCES}
    procs = {}
    for name, src in SOURCES.items():
        lib = libs[name]
        if lib.exists():
            continue
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", f"{lib}.tmp", str(CSRC / src)]
        procs[name] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
    failed = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        libs[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]}:\n{log}")
        else:
            os.replace(f"{libs[name]}.tmp", libs[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def _bind(name: str, lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.xn_error_string.argtypes = [i]
    lib.xn_error_string.restype = ctypes.c_char_p
    if name == "fold":
        lib.xn_fold_planar.argtypes = [p, p, p, i, i, ll, i, i, p]
        lib.xn_fold_planar.restype = i
        lib.xn_fold_packed.argtypes = [p, p, p, i, i, i, ll, i, i, p]
        lib.xn_fold_packed.restype = i
    elif name == "mask_fold":
        lib.xn_mask_fold_trip.argtypes = [p, ll, ll, i, i, i, i, p, p, p, ll, ll, p, p, p, p]
        lib.xn_mask_fold_trip.restype = i
    else:
        lib.xn_wire_unpack.argtypes = [p, p, p, p, i, i, i, ll, i, p]
        lib.xn_wire_unpack.restype = i
        lib.xn_packed_check.argtypes = [p, p, p, i, i, i, ll, p]
        lib.xn_packed_check.restype = i


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of :data:`SOURCES`), built on
    first use."""
    with _LIB_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build()[name]))
            _bind(name, lib)
            _LIBS[name] = lib
        return lib


def _check(rc: int, what: str, lib: ctypes.CDLL) -> None:
    if rc != 0:
        msg = lib.xn_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def _order_buffers(order: int, n_limb: int, device: torch.device):
    """Device constants of an order (cached per order and device):
    ``order`` as L+1 limbs (K1's ``order << b``), the draw-width
    little-endian bytes and the L-limb reduction constant (K2)."""
    key = (order, n_limb, str(device))
    bufs = _ORDER_BUFFERS.get(key)
    if bufs is None:
        ob = np.frombuffer(order.to_bytes(host_limbs.draw_width_for(order), "little"), np.uint8)
        bufs = (
            to_device_u32(np.array(_int_to_limbs_list(order, n_limb + 1), np.uint32), device),
            torch.from_numpy(ob.copy()).to(device),
            to_device_u32(host_limbs.order_limbs_for(order), device),
        )
        _ORDER_BUFFERS[key] = bufs
    return bufs


def _kbits(k: int) -> int:
    return max(1, (k - 1).bit_length())


# --- K1: the batch fold ----------------------------------------------------


def _fold_limbs_plain(acc: torch.Tensor, limbs_of, k: int, order: int) -> torch.Tensor:
    """The lazy-carry fold over int64 update limbs; ``limbs_of(j)`` gives
    limb plane j of every update, ``[K, n]``."""
    n_limb = acc.shape[0]
    carry = torch.zeros(acc.shape[1], dtype=torch.int64, device=acc.device)
    value = []
    for j in range(n_limb):
        x = limbs_of(j)
        lo = (x & 0xFFFF).sum(0)
        hi = (x >> 16).sum(0)
        t_lo = lo + carry
        t_hi = hi + (t_lo >> 16)
        value.append(((t_lo & 0xFFFF) | (t_hi << 16)) & 0xFFFFFFFF)
        carry = t_hi >> 16
    value.append(carry)
    value = torch.stack(value)
    for b in range(_kbits(k) - 1, -1, -1):
        value = p_cond_sub_const(value, _int_to_limbs_list(order << b, n_limb + 1))
    return store_(acc, p_mod_add(widen(acc), value[:n_limb], order))


def fold_planar_plain(acc: torch.Tensor, stack: torch.Tensor, order: int) -> torch.Tensor:
    """Plain torch K1 (planar input), any device: ``acc`` updated in place."""
    check_fold_args(acc, stack, host_limbs.n_limbs_for_order(order))
    return _fold_limbs_plain(acc, lambda j: widen(stack[:, j]), stack.shape[0], order)


def fold_packed_plain(acc: torch.Tensor, packed: torch.Tensor, order: int) -> torch.Tensor:
    """Plain torch K1 (packed byte-planar input), any device, in place."""
    n_limb = host_limbs.n_limbs_for_order(order)
    check_fold_args(acc, packed, n_limb)
    bpn = packed.shape[1]

    def limb(j: int) -> torch.Tensor:
        x = torch.zeros(packed.shape[0], packed.shape[2], dtype=torch.int64, device=acc.device)
        for i in range(min(4, bpn - 4 * j)):
            x |= packed[:, 4 * j + i].to(torch.int64) << (8 * i)
        return x

    return _fold_limbs_plain(acc, limb, packed.shape[0], order)


def fold_planar(acc: torch.Tensor, stack: torch.Tensor, order: int) -> torch.Tensor:
    """K1 on planar ``uint32[K, L, n]`` updates: ``acc = (acc + sum) mod order``
    over ``uint32[L, n]``, in place; returns ``acc``."""
    n_limb = host_limbs.n_limbs_for_order(order)
    check_fold_args(acc, stack, n_limb)
    if stack.dtype != torch.uint32 or stack.shape[1] != n_limb:
        raise ValueError(f"stack must be uint32[K, {n_limb}, n]")
    if acc.device.type == "cpu":
        return fold_planar_plain(acc, stack, order)
    _require_cuda(acc, stack)
    k, _, n = stack.shape
    if k == 0 or n == 0:
        return acc
    order_wide, _, _ = _order_buffers(order, n_limb, acc.device)
    pow2 = int(order == 1 << (32 * n_limb))
    lib = load("fold")
    with torch.cuda.device(acc.device):
        rc = lib.xn_fold_planar(
            stack.data_ptr(), acc.data_ptr(), order_wide.data_ptr(),
            k, n_limb, n, _kbits(k), pow2, _stream(acc.device),
        )  # fmt: skip
    _check(rc, "K1 fold (planar)", lib)
    _launched("fold_planar")
    return acc


def fold_packed(acc: torch.Tensor, packed: torch.Tensor, order: int) -> torch.Tensor:
    """K1 on packed byte-planar ``uint8[K, bpn, n]`` updates, in place."""
    n_limb = host_limbs.n_limbs_for_order(order)
    check_fold_args(acc, packed, n_limb)
    if packed.dtype != torch.uint8 or packed.shape[1] > 4 * n_limb:
        raise ValueError(f"packed must be uint8[K, bpn <= {4 * n_limb}, n]")
    if acc.device.type == "cpu":
        return fold_packed_plain(acc, packed, order)
    _require_cuda(acc, packed)
    k, bpn, n = packed.shape
    if k == 0 or n == 0:
        return acc
    order_wide, _, _ = _order_buffers(order, n_limb, acc.device)
    pow2 = int(order == 1 << (32 * n_limb))
    lib = load("fold")
    with torch.cuda.device(acc.device):
        rc = lib.xn_fold_packed(
            packed.data_ptr(), acc.data_ptr(), order_wide.data_ptr(),
            k, bpn, n_limb, n, _kbits(k), pow2, _stream(acc.device),
        )  # fmt: skip
    _check(rc, "K1 fold (packed)", lib)
    _launched("fold_packed")
    return acc


# --- K2: the fused mask fold -----------------------------------------------

# threads of one K2 tile and the widest draw (``kThreads``, ``kMaxDraw`` in
# csrc/mask_fold.cu); a tile's keystream is at most one 64-byte ChaCha
# block per thread, and a thread tests at most 32 candidates (one flag bit
# each)
K2_THREADS = 256
K2_MAX_DRAW = 4 * 68 + 4
_K2_MAX_TILE = 32 * K2_THREADS


@dataclass(frozen=True)
class TripPlan:
    """How K2 covers one seed's keystream: trips of ``trip`` candidates,
    each trip one launch over ``n_tiles`` tiles of ``tile`` candidates, with
    ``scratch_words`` int64 words of look-back state (tile counter, done
    flag, one status word per tile)."""

    bpn: int
    trip: int
    tile: int
    n_tiles: int
    scratch_words: int

    def offset(self, start: int, t: int) -> int:
        """Keystream byte at which trip ``t`` of a seed whose vector draw
        starts at byte ``start`` begins."""
        return start + t * self.trip * self.bpn


def plan_trips(count: int, order: int, chunk_candidates: int | None = None) -> TripPlan:
    """K2's launch arithmetic for ``count`` elements of ``order``: one trip
    covers ``chunk_candidates`` candidates (default: the 2^-60
    provisioning, :func:`chacha.provision_candidates`); a tile holds as
    many candidates as keep its keystream, from any start byte within a
    block, within one ChaCha block per thread."""
    bpn = host_limbs.draw_width_for(order)
    trip = int(chunk_candidates) if chunk_candidates else chacha.provision_candidates(count, order)
    if trip < 1:
        raise ValueError("chunk_candidates must be positive")
    tile = max(1, min(_K2_MAX_TILE, (64 * K2_THREADS - 63) // bpn))
    n_tiles = -(-trip // tile)
    return TripPlan(bpn=bpn, trip=trip, tile=tile, n_tiles=n_tiles, scratch_words=2 + n_tiles)


def _check_mask_fold_args(acc, key_words, offsets, count, order) -> list[int]:
    n_limb = host_limbs.n_limbs_for_order(order)
    if acc.dtype != torch.uint32 or tuple(acc.shape) != (n_limb, count):
        raise ValueError(f"acc must be uint32[{n_limb}, {count}]")
    if key_words.dtype != torch.uint32 or key_words.ndim != 2 or key_words.shape[1] != 8:
        raise ValueError("key_words must be uint32[B, 8]")
    if key_words.device != acc.device:
        raise ValueError("key words and accumulator live on different devices")
    offs = [int(o) for o in (offsets.tolist() if torch.is_tensor(offsets) else offsets)]
    if len(offs) != key_words.shape[0] or any(o < 0 for o in offs):
        raise ValueError("need one non-negative byte cursor per seed")
    return offs


def mask_fold_plain(
    acc: torch.Tensor,
    key_words: torch.Tensor,
    offsets,
    count: int,
    order: int,
    chunk_candidates: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch K2, any device: for every seed, derive its ``count``
    mask elements from its byte cursor and modular-add them into ``acc``
    (in place). Returns ``(acc, end cursors int64[B])``."""
    offs = _check_mask_fold_args(acc, key_words, offsets, count, order)
    acc64 = widen(acc)
    ends = []
    for b, kw in enumerate(widen(key_words).tolist()):
        mask, end = chacha.derive_uniform_limbs(
            kw, count, order, offs[b], chunk_candidates, device=acc.device
        )
        acc64 = p_mod_add(acc64, mask, order)
        ends.append(end)
    store_(acc, acc64)
    return acc, torch.tensor(ends, dtype=torch.int64, device=acc.device)


def mask_fold(
    acc: torch.Tensor,
    key_words: torch.Tensor,
    offsets,
    count: int,
    order: int,
    chunk_candidates: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: derive and modular-add a seed group's masks into the planar
    ``uint32[L, count]`` accumulator, in place.

    ``key_words`` is ``uint32[B, 8]`` (each seed as little-endian words),
    ``offsets`` the keystream byte cursor each seed's vector draw starts at
    (after its unit draw). Returns ``(acc, end cursors int64[B])``; each
    seed's contribution is bit-identical to ``MaskSeed.derive_mask(...).vect``
    folded with a modular add, and the mask never exists in device memory.
    ``chunk_candidates`` is the candidates one trip covers (default: the
    2^-60 provisioning, one trip); a small value forces the multi-trip path.
    A trip is one launch per seed (:func:`plan_trips`); after each trip the
    host reads the group's acceptance counts once, to learn which seeds
    need another.
    Cursors are int64 (the JAX kernel's int32 cursors stop at 2 GiB of
    keystream, which a 25M-element mask of the default config nearly fills).
    """
    offs = _check_mask_fold_args(acc, key_words, offsets, count, order)
    if acc.device.type == "cpu":
        return mask_fold_plain(acc, key_words, offs, count, order, chunk_candidates)
    _require_cuda(acc, key_words)
    dev = acc.device
    ends = torch.tensor(offs, dtype=torch.int64).to(dev)
    if count == 0 or not offs:
        return acc, ends
    n_limb = acc.shape[0]
    plan = plan_trips(count, order, chunk_candidates)
    if plan.bpn > K2_MAX_DRAW:
        raise ValueError(f"draw width {plan.bpn} is out of the kernel's range")
    lib = load("mask_fold")
    scratch = torch.empty(plan.scratch_words, dtype=torch.int64, device=dev)
    base = torch.zeros(len(offs), dtype=torch.int64, device=dev)
    _, order_bytes, order_limbs = _order_buffers(order, n_limb, dev)
    pow2 = int(order == 1 << (32 * n_limb))
    stream = _stream(dev)
    pending, done, t = list(range(len(offs))), [0] * len(offs), 0
    with torch.cuda.device(dev):
        while pending:
            for b in pending:
                rc = lib.xn_mask_fold_trip(
                    key_words.data_ptr() + 32 * b, plan.offset(offs[b], t), plan.trip,
                    plan.bpn, plan.tile, n_limb, pow2, order_bytes.data_ptr(),
                    order_limbs.data_ptr(), acc.data_ptr(), count, done[b],
                    base.data_ptr() + 8 * b, ends.data_ptr() + 8 * b, scratch.data_ptr(), stream,
                )  # fmt: skip
                _check(rc, "K2 mask fold", lib)
                _launched("mask_fold")
            done = base.cpu().tolist()  # the one sync of a trip
            pending = [b for b in pending if done[b] < count]
            t += 1
    return acc, ends


# --- K3 and K4: device wire ingest -----------------------------------------


def _wire_widths(order: int) -> tuple[int, int]:
    """(limbs, wire bytes per element) of ``order``; the unpack fills every
    limb from the wire bytes, so the two must agree (L == ceil(bpn / 4))."""
    n_limb, bpn = host_limbs.n_limbs_for_order(order), host_limbs.wire_width_for(order)
    if host_limbs.n_limbs_for_bytes(bpn) != n_limb:
        raise ValueError(f"wire width {bpn} does not fill {n_limb} limbs")
    return n_limb, bpn


def _check_batch(t: torch.Tensor, ok: bool, want: str) -> None:
    """Wire blocks must be ``uint8`` of the ``want`` shape (``ok``), at most
    ``MAX_LAZY_BATCH`` updates (the grid's update axis)."""
    if t.dtype != torch.uint8 or not ok:
        raise ValueError(f"expected {want}, got {t.dtype}{list(t.shape)}")
    if t.shape[0] > MAX_LAZY_BATCH:
        raise ValueError(f"batch of {t.shape[0]} exceeds {MAX_LAZY_BATCH} updates")


def _bad_rows(limbs_of, n_limb: int, k: int, order: int, device) -> torch.Tensor:
    """Per-update verdict ``uint32[K]``: 1 where any element (limb j of every
    update from ``limbs_of(j)``, int64 ``[K, n]``) is >= ``order``, else 0.
    Every bit pattern is valid at the boundary order ``2^(32L)``."""
    if order == 1 << (32 * n_limb):
        return torch.zeros(k, dtype=torch.int32, device=device).view(torch.uint32)
    planar = torch.stack([limbs_of(j) for j in range(n_limb)])  # [L, K, n]
    lt = p_lt_const(planar, _int_to_limbs_list(order, n_limb))
    return (~lt).any(dim=1).to(torch.int32).view(torch.uint32)


def wire_unpack_plain(raw: torch.Tensor, order: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch K3, any device: interleaved wire element blocks
    ``uint8[K, n*bpn]`` -> ``(planar uint32[K, L, n], bad uint32[K])``."""
    n_limb, bpn = _wire_widths(order)
    k, n = raw.shape[0], raw.shape[1] // bpn
    b = raw.reshape(k, n, bpn)

    def limb(j: int) -> torch.Tensor:
        x = torch.zeros((k, n), dtype=torch.int64, device=raw.device)
        for i in range(min(4, bpn - 4 * j)):
            x |= b[:, :, 4 * j + i].to(torch.int64) << (8 * i)
        return x

    limbs = [limb(j) for j in range(n_limb)]
    bad = _bad_rows(lambda j: limbs[j], n_limb, k, order, raw.device)
    return narrow(torch.stack(limbs, dim=1)), bad


def packed_check_plain(packed: torch.Tensor, order: int) -> torch.Tensor:
    """Plain torch K4, any device: byte-planar blocks ``uint8[K, bpn, n]`` ->
    ``bad uint32[K]``."""
    n_limb, bpn = _wire_widths(order)
    k, n = packed.shape[0], packed.shape[2]

    def limb(j: int) -> torch.Tensor:
        x = torch.zeros((k, n), dtype=torch.int64, device=packed.device)
        for i in range(min(4, bpn - 4 * j)):
            x |= packed[:, 4 * j + i].to(torch.int64) << (8 * i)
        return x

    return _bad_rows(limb, n_limb, k, order, packed.device)


def wire_unpack(raw: torch.Tensor, order: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: unpack K v1 wire element blocks ``uint8[K, n*bpn]`` (``bpn``
    little-endian bytes per element) into planar ``uint32[K, L, n]`` and
    check every element against ``order``. Returns ``(planar, bad)``, ``bad``
    a ``uint32[K]`` nonzero for each update with an element >= ``order``
    (the planar rows of such updates are unpacked all the same, and are the
    caller's to drop)."""
    n_limb, bpn = _wire_widths(order)
    _check_batch(raw, raw.ndim == 2 and raw.shape[1] % bpn == 0, f"uint8[K, n * {bpn}]")
    if raw.device.type == "cpu":
        return wire_unpack_plain(raw, order)
    _require_cuda(raw)
    dev = raw.device
    k, n = raw.shape[0], raw.shape[1] // bpn
    planar = torch.empty((k, n_limb, n), dtype=torch.int32, device=dev).view(torch.uint32)
    bad = torch.zeros(k, dtype=torch.int32, device=dev).view(torch.uint32)
    if k == 0 or n == 0:
        return planar, bad
    _, _, order_limbs = _order_buffers(order, n_limb, dev)
    check = int(order != 1 << (32 * n_limb))
    lib = load("wire")
    with torch.cuda.device(dev):
        rc = lib.xn_wire_unpack(
            raw.data_ptr(), planar.data_ptr(), bad.data_ptr(), order_limbs.data_ptr(),
            k, bpn, n_limb, n, check, _stream(dev),
        )  # fmt: skip
    _check(rc, "K3 wire unpack", lib)
    _launched("wire_unpack")
    return planar, bad


def packed_check(packed: torch.Tensor, order: int) -> torch.Tensor:
    """K4: check K v2 byte-planar element blocks ``uint8[K, bpn, n]`` against
    ``order``; returns ``bad uint32[K]``, nonzero for each update with an
    element >= ``order``. An order of ``2^(8 bpn)`` (the boundary
    ``2^(32L)`` among them) lies above every ``bpn``-byte pattern, so
    nothing is launched for it."""
    n_limb, bpn = _wire_widths(order)
    _check_batch(packed, packed.ndim == 3 and packed.shape[1] == bpn, f"uint8[K, {bpn}, n]")
    if packed.device.type == "cpu":
        return packed_check_plain(packed, order)
    _require_cuda(packed)
    dev = packed.device
    k, _, n = packed.shape
    bad = torch.zeros(k, dtype=torch.int32, device=dev).view(torch.uint32)
    if k == 0 or n == 0 or order >= 1 << (8 * bpn):
        return bad
    _, _, order_limbs = _order_buffers(order, n_limb, dev)
    lib = load("wire")
    with torch.cuda.device(dev):
        rc = lib.xn_packed_check(
            packed.data_ptr(), bad.data_ptr(), order_limbs.data_ptr(),
            k, bpn, n_limb, n, _stream(dev),
        )  # fmt: skip
    _check(rc, "K4 packed check", lib)
    _launched("packed_check")
    return bad
