"""Device-side masking operations: mask derivation, mask sum, unmask.

Port of ``xaynet_tpu/ops/masking_jax.py`` (reference hot loops:
rust/xaynet-core/src/mask/seed.rs:61-78 derive_mask,
rust/xaynet-sdk/src/state_machine/phases/sum2.rs:170-193 mask aggregation,
rust/xaynet-server/src/state_machine/phases/unmask.rs unmask subtract):

- ``derive_mask_limbs``: seed -> (unit element, planar vector limbs on the
  device): the unit draw on the host ``StreamSampler``, the vector draws by
  kernel K2 into a zero accumulator from the handed-off byte cursor;
- ``mask_update``: a participant's masked model (encoded weights plus the
  seed's mask), with the mask derived by K2 and the add done by K1;
- ``sum_masks``: aggregate many seed-derived masks (the Sum2 hot loop) on
  the fused route only: host unit draws plus one K2 launch sequence per
  seed group, so no mask is ever materialized;
- ``unmask_vect_limbs``: the Unmask subtract ``(masked - mask) mod order``.

Entry points run on ``cuda`` unless given a device (``device.resolve_device``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.crypto.prng import StreamSampler
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


def _unit_draw(seed: bytes, config: MaskConfigPair) -> tuple[np.ndarray, int]:
    """The seed's unit element and the byte cursor its vector draw starts at
    (``MaskSeed.derive_mask`` draws the unit first, from the same stream)."""
    sampler = StreamSampler(seed)
    unit = sampler.draw_limbs(1, config.unit.order)[0]
    return unit, sampler.consumed_bytes


def derive_mask_limbs(
    seed: bytes, length: int, config: MaskConfigPair, device=None
) -> tuple[np.ndarray, torch.Tensor]:
    """Expand a 32-byte seed into (unit limbs ``[L1]``, vector limbs as a
    planar ``uint32[L, length]`` tensor on the device). The JAX function
    returns the vector in wire layout ``[length, L]``."""
    dev = resolve_device(device)
    unit, offset = _unit_draw(seed, config)
    n_limb = host_limbs.n_limbs_for_order(config.vect.order)
    acc = zeros_u32((n_limb, length), dev)
    kw = to_device_u32(seed_words([seed]), dev)
    kernels.mask_fold(acc, kw, [offset], length, config.vect.order)
    return unit, acc


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
    (unit limbs, planar ``uint32[L, length]`` tensor). Per group of
    ``seed_batch`` seeds: host unit draws and cursor handoffs, then one K2
    call that derives and folds every seed's mask into the accumulator."""
    if not seeds:
        raise ValueError("no seeds to aggregate")
    dev = resolve_device(device)
    n_limb = host_limbs.n_limbs_for_order(config.vect.order)
    ol_u = host_limbs.order_limbs_for(config.unit.order)
    acc = zeros_u32((n_limb, length), dev)
    unit_acc: np.ndarray | None = None
    step = max(1, seed_batch)
    for g0 in range(0, len(seeds), step):
        group = seeds[g0 : g0 + step]
        draws = [_unit_draw(s, config) for s in group]
        kw = to_device_u32(seed_words(group), dev)
        kernels.mask_fold(
            acc, kw, [off for _, off in draws], length, config.vect.order, chunk_candidates
        )
        for unit, _ in draws:
            unit_acc = (
                unit
                if unit_acc is None
                else host_limbs.mod_add(unit_acc[None, :], unit[None, :], ol_u)[0]
            )
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
