"""A whole PET round as one device pass over participant blocks.

Port of ``xaynet_tpu/sim/round.py``. A round is a pure function of (mask
config, participant seeds, local models, scalar), so ``SimRound`` computes
it without a server, sockets or phases in between:

    update:  per block of ``block_size`` participants, the seeds' unit
             draws by K5 (``kernels.unit_draws``), then each seed's mask
             derived into its own row by K2 (``kernels.mask_fold_rows``),
             one launch for the block
    fold:    the block's masked models folded into the masked-sum
             accumulator by K1 (``kernels.fold_planar``)
    sum2:    the sum mask, the modular sum of every participant's mask:
             with ``fuse_mask_sum`` the block's masks folded by K1 as they
             are derived, else re-derived from the seeds by K2
             (``masking.sum_masks_planar``), as a real Sum2 leg does
    unmask:  the modular subtract (``fold.mod_sub_planar``)

The group arithmetic runs on planar ``uint32[L, n]`` accumulators on the
device; the unit channel (one element per participant) stays on the host
in limbs. The float boundary, the fixed-point encode before the blocks and
the decode after the unmask, runs through the same host functions
(``core/mask/encode.py``) a participant and the Unmask phase use, which is
what makes the simulated global model byte-identical to a coordinator
round (``sim.oracle``).

**Participant-axis mesh.** With ``mesh`` (``parallel.mesh.make_mesh``;
a mesh may repeat a device) the population is padded to a multiple of
``block_size x len(mesh)`` and shard ``s`` takes the ``s``-th contiguous
run of blocks: its own thread runs them on its device, through K5, K2's
per-row entry and K1 planar, into partial accumulators of its own. The
partials are then folded on the mesh's first device with K1 planar (the
function of the JAX program's ``batch_mod_sum`` combine, X5): modular sums
are associative, so the result is byte-identical to one device's.

Departures from the JAX program: the models are encoded one block at a
time (the map is elementwise, so the bytes are the same, and the host
holds one block's float64 temporaries, not the population's); the padding
lanes are not derived (the JAX program derives zero seeds and masks them
out: no padding lane is derived or folded here, with the same result).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Optional

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.mask.config import MaskConfigPair
from ..core.mask.encode import (
    clamp_scalar,
    decode_scalar_sum,
    decode_vect_any,
    decode_vect_fast,
    encode_unit,
    encode_vect_limbs,
    has_fast_path,
)
from ..device import resolve_device
from ..ops import kernels
from ..ops import limbs as host_limbs
from ..ops.fold import (
    MAX_LAZY_BATCH,
    mod_sub_planar,
    planar_to_wire,
    to_device_u32,
    to_numpy_u32,
    zeros_u32,
)
from ..ops.masking import seed_words, sum_masks_planar
from ..parallel.mesh import make_mesh
from ..telemetry import profiling

# elements encoded per host call: a 25M-parameter model is one row per call
# (the float64 temporaries of a call stay near a participant's own)
ENCODE_CHUNK_ELEMENTS = 1 << 24


def seeds_for(n: int, root: int = 0) -> list[bytes]:
    """``n`` deterministic 32-byte mask seeds (research-workload helper)."""
    rng = np.random.default_rng(root)
    return [rng.bytes(32) for _ in range(n)]


@dataclass(frozen=True)
class SimSpec:
    """Static shape of a simulated round."""

    config: MaskConfigPair
    model_length: int
    block_size: int = 128  # participants whose masks are derived per block
    fuse_mask_sum: bool = True  # derive once, feed update fold AND sum-mask fold
    return_internals: bool = False  # also return the pre-unmask aggregates

    def __post_init__(self):
        if self.model_length < 1:
            raise ValueError("model_length must be >= 1")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")


@dataclass
class SimResult:
    """Outcome of one simulated round."""

    global_model: np.ndarray  # float64[model_length], the unmasked aggregate
    nb_models: int
    scalar_sum: Fraction
    model_vect_limbs: np.ndarray  # uint32[model_length, L] — unmasked group elements
    model_unit_int: int
    internals: Optional[dict] = field(default=None, repr=False)


def encode_block(weights: np.ndarray, s_clamped: Fraction, config) -> np.ndarray:
    """A block of models ``[B, n]``, fixed-point encoded under the vect
    ``config``, as planar host limbs ``uint32[B, L, n]`` (encoded in calls of
    whole rows, at most ``ENCODE_CHUNK_ELEMENTS`` elements where a row is
    shorter)."""
    b, n = weights.shape
    out = np.empty((b, host_limbs.n_limbs_for_order(config.order), n), dtype=np.uint32)
    rows = max(1, ENCODE_CHUNK_ELEMENTS // n)
    for r0 in range(0, b, rows):
        chunk = weights[r0 : r0 + rows]
        enc = encode_vect_limbs(chunk.reshape(-1), s_clamped, config)
        out[r0 : r0 + len(chunk)] = enc.reshape(len(chunk), n, -1).transpose(0, 2, 1)
    return out


def mask_rows(rows, kw: np.ndarray, s_clamped: Fraction, config) -> tuple[np.ndarray, np.ndarray]:
    """Mask a block of participants in place, each as ``Masker.mask`` would:
    the seeds' unit masks and cursors are drawn by K5
    (``kernels.unit_draws``), seed ``b``'s vect mask is derived by K2 into
    ``rows[b]`` from its cursor on the device (``kernels.mask_fold_rows``),
    and the unit masks are downloaded and added to the encoded scalar.
    ``rows`` are the block's encoded models ``uint32[B, L, n]`` on the
    device (or zeros: the masks alone), ``kw`` the block's seed words
    ``uint32[B, 8]`` on the host. Returns (unit masks, masked units),
    ``uint32[B, L1]`` each."""
    kw_dev = to_device_u32(kw, rows.device)
    units, starts = kernels.unit_draws(kw_dev, config.unit.order)
    kernels.mask_fold_rows(rows, kw_dev, starts, rows.shape[-1], config.vect.order)
    units = to_numpy_u32(units)
    unit_enc = host_limbs.int_to_limbs(
        encode_unit(s_clamped, config.unit), host_limbs.n_limbs_for_order(config.unit.order)
    )
    ol_u = host_limbs.order_limbs_for(config.unit.order)
    return units, host_limbs.mod_add(np.broadcast_to(unit_enc, units.shape), units, ol_u)


def _fold(acc, rows, order: int) -> None:
    """K1 over a block's rows, in folds of at most ``MAX_LAZY_BATCH``."""
    for r0 in range(0, rows.shape[0], MAX_LAZY_BATCH):
        kernels.fold_planar(acc, rows[r0 : r0 + MAX_LAZY_BATCH], order)


class SimRound:
    """A whole-round simulation for a fixed spec on one device, or sharded
    over the participant axis of a ``mesh``.

    ``run(seeds, weights, scalar)`` simulates the round for any population
    size; ``program_calls`` counts runs (one per ``run``, never one per
    participant or block). ``device`` is CUDA unless given; with ``mesh``
    the mesh's first device is where the shards' partials are combined.
    """

    def __init__(self, spec: SimSpec, mesh=None, device=None):
        self.spec = spec
        self.mesh = make_mesh(mesh) if mesh is not None else None
        if self.mesh is not None:
            if device is not None and torch.device(device) != self.mesh[0]:
                raise ValueError(f"device {device} is not the mesh's first device {self.mesh[0]}")
            self.device = self.mesh[0]
        else:
            self.device = resolve_device(device)
        cfg = spec.config
        self._n_limb_v = host_limbs.n_limbs_for_order(cfg.vect.order)
        self._ol_u = host_limbs.order_limbs_for(cfg.unit.order)
        self.program_calls = 0

    def _grid(self, n_participants: int) -> tuple[int, int]:
        """(blocks, padded population) for this spec and mesh: the
        population padded to a multiple of ``block_size x len(mesh)``."""
        block = self.spec.block_size
        stride = block * (1 if self.mesh is None else len(self.mesh))
        padded = -(-n_participants // stride) * stride
        return padded // block, padded

    def _partials(self, seeds: list[bytes], kw: np.ndarray, weights: np.ndarray, s_clamped,
                  start: int, stop: int, dev):
        """Participants ``[start, stop)`` block by block on ``dev``: (masked
        vect sum, masked unit sum, mask vect sum, mask unit sum), the vect
        sums planar tensors, the unit sums host limbs."""
        spec = self.spec
        cfg, n = spec.config, spec.model_length
        order = cfg.vect.order
        ol_u = self._ol_u
        acc_mv = zeros_u32((self._n_limb_v, n), dev)
        acc_kv = zeros_u32((self._n_limb_v, n), dev) if spec.fuse_mask_sum else None
        mu = np.zeros(host_limbs.n_limbs_for_order(cfg.unit.order), dtype=np.uint32)
        ku = np.zeros_like(mu)
        for b0 in range(start, stop, spec.block_size):
            b1 = min(b0 + spec.block_size, stop)
            enc = to_device_u32(encode_block(weights[b0:b1], s_clamped, cfg.vect), dev)
            if spec.fuse_mask_sum:
                masks = zeros_u32(enc.shape, dev)
                units, masked = mask_rows(masks, kw[b0:b1], s_clamped, cfg)
                _fold(acc_kv, masks, order)
                _fold(acc_mv, enc, order)
                _fold(acc_mv, masks, order)
                del masks
                ku = host_limbs.mod_add(ku[None], host_limbs.batch_mod_sum(units, ol_u)[None],
                                        ol_u)[0]  # fmt: skip
            else:
                _, masked = mask_rows(enc, kw[b0:b1], s_clamped, cfg)
                _fold(acc_mv, enc, order)
            del enc
            mu = host_limbs.mod_add(mu[None], host_limbs.batch_mod_sum(masked, ol_u)[None], ol_u)[0]
        if not spec.fuse_mask_sum:
            if stop > start:
                ku, acc_kv = sum_masks_planar(seeds[start:stop], n, cfg,
                                              seed_batch=spec.block_size, device=dev)  # fmt: skip
            else:
                acc_kv = zeros_u32((self._n_limb_v, n), dev)
        return acc_mv, mu, acc_kv, ku

    def _shard(self, d: int, per: int, p: int, *args):
        """Shard ``d``'s contiguous run of blocks, on its device and a stream
        of its own, finished before it returns."""
        dev = self.mesh[d]
        start, stop = min(d * per, p), min((d + 1) * per, p)
        if dev.type != "cuda":
            return self._partials(*args, start, stop, dev)
        with torch.cuda.device(dev), torch.cuda.stream(torch.cuda.Stream(dev)):
            out = self._partials(*args, start, stop, dev)
            torch.cuda.current_stream(dev).synchronize()
        return out

    def _combine(self, parts: list) -> tuple:
        """The shards' partials folded on the mesh's first device: the vect
        sums by one K1 planar launch over the stacked partials, the unit
        sums on the host."""
        dev, order, ol_u = self.device, self.spec.config.vect.order, self._ol_u

        def fold_all(accs):
            out = zeros_u32(accs[0].shape, dev)
            stacked = torch.stack([a.view(torch.int32).to(dev) for a in accs]).view(torch.uint32)
            kernels.fold_planar(out, stacked, order)
            return out

        def unit_sum(units):
            return host_limbs.batch_mod_sum(np.stack(units)[:, None, :], ol_u)[0]

        mv, mu, kv, ku = zip(*parts)
        return fold_all(mv), unit_sum(mu), fold_all(kv), unit_sum(ku)

    def _round(self, seeds: list[bytes], kw: np.ndarray, weights: np.ndarray, s_clamped):
        """Every block folded, then the unmask: (model planar tensor, unit
        limbs, internals or None)."""
        spec = self.spec
        order, ol_u = spec.config.vect.order, self._ol_u
        args = (seeds, kw, weights, s_clamped)
        if self.mesh is None:
            acc_mv, mu, acc_kv, ku = self._partials(*args, 0, len(seeds), self.device)
        else:
            _, padded = self._grid(len(seeds))
            per = padded // len(self.mesh)
            with ThreadPoolExecutor(max_workers=len(self.mesh),
                                    thread_name_prefix="xn-sim-shard") as pool:  # fmt: skip
                parts = list(pool.map(lambda d: self._shard(d, per, len(seeds), *args),
                                      range(len(self.mesh))))  # fmt: skip
            acc_mv, mu, acc_kv, ku = self._combine(parts)
        model_v = mod_sub_planar(acc_mv, acc_kv, order)
        model_u = host_limbs.mod_sub(mu[None, :], ku[None, :], ol_u)[0]
        internals = (acc_mv, mu, acc_kv, ku) if spec.return_internals else None
        return model_v, model_u, internals

    def run(
        self,
        seeds: list[bytes] | np.ndarray,
        weights: np.ndarray,
        scalar: Fraction = Fraction(1),
    ) -> SimResult:
        """Simulate one round: ``seeds`` are the participants' mask seeds
        (list of 32-byte strings or ``uint32[P, 8]`` key words), ``weights``
        the ``[P, model_length]`` local models, ``scalar`` the shared
        update scalar (the homogeneous-population shape; the production
        analogue is every participant sending ``scalar=1/P``)."""
        spec = self.spec
        if isinstance(seeds, np.ndarray):
            kw = np.asarray(seeds, dtype=np.uint32)
        else:
            kw = seed_words(list(seeds))
        if kw.ndim != 2 or kw.shape[1] != 8:
            raise ValueError("seeds must be 32-byte strings or uint32[P, 8] key words")
        p = kw.shape[0]
        if p < 1:
            raise ValueError("need at least one participant")
        cfg = spec.config
        if p > min(cfg.vect.max_nb_models, cfg.unit.max_nb_models):
            raise ValueError("TooManyModels: population exceeds the config's max_nb_models")
        weights = np.asarray(weights)
        if weights.shape != (p, spec.model_length):
            raise ValueError(f"weights must be [{p}, {spec.model_length}], got {weights.shape}")
        seed_bytes = [row.astype("<u4").tobytes() for row in kw]
        s_clamped = clamp_scalar(scalar, cfg.unit)

        model_v, model_u, internals = profiling.timed_kernel(
            "sim_round",
            p * spec.model_length,
            lambda: self._round(seed_bytes, kw, weights, s_clamped),
            device=self.device,
        )
        self.program_calls += 1

        # group -> float boundary: the production unmask decode
        n_vect = planar_to_wire(to_numpy_u32(model_v))
        unit_int = host_limbs.limbs_to_int(model_u)
        scalar_sum = decode_scalar_sum(unit_int, cfg.unit, p)
        # unit-channel integrity: the unmasked unit must decode to exactly
        # P quantized clamped scalars
        expect = decode_scalar_sum(p * encode_unit(s_clamped, cfg.unit), cfg.unit, p)
        if scalar_sum != expect:
            raise AssertionError(
                f"unit channel corrupted: decoded scalar sum {scalar_sum} != {expect}"
            )
        if has_fast_path(cfg.vect):
            global_model = decode_vect_fast(n_vect, cfg.vect, p, scalar_sum)
        else:
            global_model = decode_vect_any(n_vect, cfg.vect, p, scalar_sum)

        out_internals = None
        if internals is not None:
            mv, mu, kv, ku = internals
            out_internals = {
                "masked_vect_sum": planar_to_wire(to_numpy_u32(mv)),
                "masked_unit_sum": mu,
                "mask_vect_sum": planar_to_wire(to_numpy_u32(kv)),
                "mask_unit_sum": ku,
            }
        return SimResult(
            global_model=np.asarray(global_model, dtype=np.float64),
            nb_models=p,
            scalar_sum=scalar_sum,
            model_vect_limbs=n_vect,
            model_unit_int=unit_int,
            internals=out_internals,
        )
