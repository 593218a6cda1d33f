"""Device-side masking operations: mask derivation, mask sum, unmask.

Port of ``xaynet_tpu/ops/masking_jax.py`` (reference hot loops:
rust/xaynet-core/src/mask/seed.rs:61-78 derive_mask,
rust/xaynet-sdk/src/state_machine/phases/sum2.rs:170-193 mask aggregation,
rust/xaynet-server/src/state_machine/phases/unmask.rs unmask subtract):

- ``derive_mask_limbs``: seed -> (unit element, planar vector limbs on the
  device): the unit draw by kernel K5 (``kernels.unit_draws``), the vector
  draws by kernel K2 into a zero accumulator from the byte cursor K5 left
  in device memory;
- ``mask_update``: a participant's masked model (encoded weights plus the
  seed's mask), with the mask derived by K2 and the add done by K1;
- ``sum_masks``: aggregate many seed-derived masks (the Sum2 hot loop) on
  the fused route only: one K5 launch for every seed's unit draw, then one
  K2 launch sequence per seed group, so no mask is ever materialized;
- ``unmask_vect_limbs``: the Unmask subtract ``(masked - mask) mod order``;
- ``derive_mask_limbs_batch``: many seeds' masks, each in its own row of a
  planar block on the device (K5's unit draws, then K2 per row through
  ``kernels.mask_fold_rows`` from K5's cursors, which stay on the device):
  the whole-round simulation's and the load generator's derivation;
- ``encode_models_batch``: the fixed-point encode of a population of models
  sharing one scalar, on the host.

K5's cursors never come to the host: K2 reads each seed's start cursor
from device memory, so it is queued right behind K5 and the host first
waits at the end of K2's trip (the acceptance counts it reads there).
The accumulator's zero fill is queued behind K5, so the card has work
while the host sets K2 up. K5's units come down once the fold has
returned, when the stream holds nothing more, to be summed or added on
the host.

The JAX module's ``derive_chunk_budgets`` is not ported: it sizes the
keystream its vmapped derivation materializes per lane, and K2 never
materializes a keystream (its trips are sized by ``kernels.plan_trips``).

Entry points run on ``cuda`` unless given a device (``device.resolve_device``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.mask.config import MaskConfigPair
from ..core.mask.encode import clamp_scalar, encode_unit, encode_vect_limbs
from ..core.mask.model import Scalar
from ..core.mask.object import MaskObject, MaskUnit, MaskVect
from ..device import resolve_device
from . import kernels
from . import limbs as host_limbs
from .fold import (
    fold_planar_batch,
    mod_sub_planar,
    planar_to_wire,
    to_device_u32,
    to_numpy_u32,
    wire_to_planar,
    zeros_u32,
)


def seed_words(seeds: list[bytes]) -> np.ndarray:
    """32-byte seeds -> ``uint32[B, 8]`` little-endian ChaCha key words."""
    if not seeds:
        return np.zeros((0, 8), dtype=np.uint32)
    return np.stack([np.frombuffer(s, dtype="<u4") for s in seeds])


def derive_mask_limbs(
    seed: bytes, length: int, config: MaskConfigPair, device=None
) -> tuple[np.ndarray, torch.Tensor]:
    """Expand a 32-byte seed into (unit limbs ``[L1]``, vector limbs as a
    planar ``uint32[L, length]`` tensor on the device). The JAX function
    returns the vector in wire layout ``[length, L]``. K2 starts from K5's
    cursor in device memory; the unit comes down after the fold."""
    dev = resolve_device(device)
    kw = to_device_u32(seed_words([seed]), dev)
    units, cursors = kernels.unit_draws(kw, config.unit.order)
    n_limb = host_limbs.n_limbs_for_order(config.vect.order)
    acc = zeros_u32((n_limb, length), dev)
    kernels.mask_fold(acc, kw, cursors, length, config.vect.order)
    return to_numpy_u32(units)[0], acc


def derive_mask_limbs_batch(
    seeds: list[bytes], length: int, config: MaskConfigPair, device=None
) -> tuple[np.ndarray, torch.Tensor]:
    """``derive_mask_limbs`` for many seeds: (units ``uint32[B, L1]`` on the
    host, vector limbs as a planar ``uint32[B, L, length]`` tensor on the
    device). Row ``b`` is bit-identical to ``MaskSeed.derive_mask`` with
    seed ``b``. The unit draws and their cursor handoffs are K5
    (``kernels.unit_draws``), the vector draws K2 into zero rows from K5's
    cursors on the device (``kernels.mask_fold_rows``): one launch and one
    host sync per trip for the whole batch, then the units' download. The
    JAX function returns the vectors in wire layout ``[B, length, L]``."""
    if not seeds:
        raise ValueError("no seeds")
    dev = resolve_device(device)
    kw = to_device_u32(seed_words(seeds), dev)
    units, starts = kernels.unit_draws(kw, config.unit.order)
    n_limb = host_limbs.n_limbs_for_order(config.vect.order)
    rows = zeros_u32((len(seeds), n_limb, length), dev)
    kernels.mask_fold_rows(rows, kw, starts, length, config.vect.order)
    return to_numpy_u32(units), rows


def encode_models_batch(
    weights: np.ndarray, scalar, config: MaskConfigPair
) -> tuple[np.ndarray, np.ndarray]:
    """Fixed-point encode a population of models sharing ``scalar``.

    ``weights`` is ``[B, length]``; returns ``(unit, vect)``: ``unit`` the
    limbs ``uint32[L1]`` of the encoded clamped scalar every participant
    shares, ``vect`` the limbs ``uint32[B, length, L]``. Byte-identical to ``B`` independent
    ``Masker.mask`` encodes: the map is elementwise, so the flattened array
    goes through the same ``encode_vect_limbs`` a single participant runs.
    """
    weights = np.asarray(weights)
    if weights.ndim != 2:
        raise ValueError("weights must be [participants, length]")
    s_clamped = clamp_scalar(scalar, config.unit)
    flat = encode_vect_limbs(weights.reshape(-1), s_clamped, config.vect)
    vect = flat.reshape(weights.shape[0], weights.shape[1], -1)
    unit_int = encode_unit(s_clamped, config.unit)
    unit = host_limbs.int_to_limbs(unit_int, host_limbs.n_limbs_for_order(config.unit.order))
    return unit, vect


def mask_update(
    seed: bytes, scalar: Scalar, weights: np.ndarray, config: MaskConfigPair, device=None
) -> MaskObject:
    """A participant's masked update, computed on the device: the mask is
    derived by K2 into a zero accumulator and the fixed-point-encoded
    weights are folded onto it by K1 (a batch of one). Byte-identical to
    ``Masker(config, MaskSeed(seed)).mask(scalar, weights)``."""
    dev = resolve_device(device)
    unit_rand, mask = derive_mask_limbs(seed, len(weights), config, dev)
    s_clamped = clamp_scalar(scalar.value, config.unit)
    encoded = encode_vect_limbs(weights, s_clamped, config.vect)
    stack = to_device_u32(wire_to_planar(encoded)[None], dev)
    fold_planar_batch(mask, stack, config.vect.order)
    del stack
    n_limb_u = host_limbs.n_limbs_for_order(config.unit.order)
    unit = host_limbs.mod_add(
        host_limbs.int_to_limbs(encode_unit(s_clamped, config.unit), n_limb_u)[None, :],
        unit_rand[None, :],
        host_limbs.order_limbs_for(config.unit.order),
    )[0]
    return MaskObject(
        MaskVect(config.vect, planar_to_wire(to_numpy_u32(mask))),
        MaskUnit(config.unit, unit),
    )


def sum_masks_planar(
    seeds: list[bytes],
    length: int,
    config: MaskConfigPair,
    seed_batch: int = 8,
    chunk_candidates: int | None = None,
    device=None,
) -> tuple[np.ndarray, torch.Tensor]:
    """The fused Sum2 route, keeping the mask sum on the device: returns
    (unit limbs, planar ``uint32[L, length]`` tensor). Every seed's unit
    draw and cursor handoff is one K5 launch; then, per group of
    ``seed_batch`` seeds, one K2 call derives and folds every seed's mask
    into the accumulator, starting from the group's cursors where K5 left
    them in device memory. The units come down once, after the last
    group, and are summed on the host."""
    if not seeds:
        raise ValueError("no seeds to aggregate")
    dev = resolve_device(device)
    n_limb = host_limbs.n_limbs_for_order(config.vect.order)
    kw = to_device_u32(seed_words(seeds), dev)
    units, cursors = kernels.unit_draws(kw, config.unit.order)
    acc = zeros_u32((n_limb, length), dev)
    step = max(1, seed_batch)
    for g0 in range(0, len(seeds), step):
        kernels.mask_fold(acc, kw[g0 : g0 + step], cursors[g0 : g0 + step], length,
                          config.vect.order, chunk_candidates)  # fmt: skip
    unit_acc = host_limbs.batch_mod_sum(to_numpy_u32(units),
                                        host_limbs.order_limbs_for(config.unit.order))  # fmt: skip
    return unit_acc, acc


def sum_masks(
    seeds: list[bytes],
    length: int,
    config: MaskConfigPair,
    seed_batch: int = 8,
    chunk_candidates: int | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Derive and modularly sum the masks of many seeds (Sum2 hot loop).

    Returns (unit limbs, wire-layout vector limbs ``[length, L]``), as the
    JAX function's fused route does; bit-identical to folding
    ``MaskSeed.derive_mask`` per seed.
    """
    unit, acc = sum_masks_planar(seeds, length, config, seed_batch, chunk_candidates, device)
    return unit, planar_to_wire(to_numpy_u32(acc))


def unmask_vect_limbs(masked: torch.Tensor, mask: torch.Tensor, order: int) -> torch.Tensor:
    """``(masked - mask) mod order`` over planar ``uint32[L, n]`` tensors
    (the JAX function takes wire-layout limbs)."""
    return mod_sub_planar(masked, mask, order)
