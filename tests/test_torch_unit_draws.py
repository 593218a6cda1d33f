"""The port's unit draws (kernel K5's plain version) against the JAX package.

``xaynet_tpu_torch.ops.kernels.unit_draws`` runs K5's plain version on CPU
tensors; it is held byte-identical in units, with equal cursors, to the
JAX package's batched in-graph unit draw ``masking_jax._unit_offsets_fn``
and to the port's host ``StreamSampler``: for the three group families at
draw widths 6, 7, 8, 12, 16, 37 and 268, at orders of 2^(32 L) (whose
candidates are one byte wider than their limbs, accepted one time in 256),
for B = 1, 3 and 257 seeds, and with the plain version's batched window cut
so short that most seeds continue alone. Then no path of the port is left
drawing units on the host: with the port's ``StreamSampler`` made to raise,
``derive_mask_limbs_batch``, ``mask_update``, ``sum_masks``, ``SimRound``
and ``PopulationEngine`` still run on the CPU and still give the JAX
package's bytes.
"""

from __future__ import annotations

import itertools
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xaynet_tpu.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
from xaynet_tpu.ops import limbs as ref_limbs, masking_jax
from xaynet_tpu.sim import SimRound as JaxSimRound
from xaynet_tpu.sim import SimSpec as JaxSimSpec
from xaynet_tpu_torch import convert
from xaynet_tpu_torch.core.crypto import prng
from xaynet_tpu_torch.core.mask.model import Scalar as PortScalar
from xaynet_tpu_torch.loadgen import PopulationEngine
from xaynet_tpu_torch.ops import fold, kernels, masking
from xaynet_tpu_torch.sim import SimRound, SimSpec

CPU = torch.device("cpu")
torch.set_num_threads(1)

WIDTHS = [6, 7, 8, 12, 16, 37, 268]
GROUPS = [GroupType.PRIME, GroupType.INTEGER, GroupType.POWER2]
# the orders 2^(32 L): 2^96 (draw 13), 2^128 (draw 17), 2^2112 (draw 265)
BOUNDARY = {
    "2^96": MaskConfig(GroupType.POWER2, DataType.I32, BoundType.BMAX, ModelType.M9),
    "2^128": MaskConfig(GroupType.POWER2, DataType.F64, BoundType.B6, ModelType.M12),
    "2^2112": MaskConfig(GroupType.POWER2, DataType.F64, BoundType.BMAX, ModelType.M3),
}


def _config(group: GroupType, width: int) -> MaskConfig:
    """The first catalogue config of ``group`` whose order draws ``width``
    bytes."""
    for data, bound, model in itertools.product(DataType, BoundType, ModelType):
        try:
            cfg = MaskConfig(group, data, bound, model)
            order = cfg.order
        except Exception:  # not every combination is a catalogue entry
            continue
        if ref_limbs.draw_width_for(order) == width:
            return cfg
    raise LookupError(f"no {group.name} config draws {width} bytes")


def _key_words(b: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (b, 8), dtype=np.uint64).astype(np.uint32)


def _check_against_jax_and_sampler(cfg: MaskConfig, kws: np.ndarray) -> None:
    pair = cfg.pair()
    want_units, want_cursors = masking_jax._unit_offsets_fn(pair)(jnp.asarray(kws))
    units, cursors = kernels.unit_draws(fold.to_device_u32(kws, CPU), cfg.order)
    assert units.dtype == torch.uint32 and cursors.dtype == torch.int64
    got = fold.to_numpy_u32(units)
    assert got.tobytes() == np.asarray(want_units).tobytes()
    assert cursors.tolist() == np.asarray(want_cursors).tolist()
    for b in range(min(len(kws), 8)):
        sampler = prng.StreamSampler(kws[b].astype("<u4").tobytes())
        assert np.array_equal(sampler.draw_limbs(1, cfg.order)[0], got[b])
        assert sampler.consumed_bytes == int(cursors[b])


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("group", GROUPS, ids=[g.name for g in GROUPS])
def test_unit_draws_plain_matches_jax_and_sampler(group, width):
    cfg = _config(group, width)
    assert ref_limbs.draw_width_for(cfg.order) == width
    _check_against_jax_and_sampler(cfg, _key_words(3, width))


@pytest.mark.parametrize("b", [1, 257])
@pytest.mark.parametrize(
    "group, width", [(GroupType.PRIME, 6), (GroupType.INTEGER, 7), (GroupType.POWER2, 12),
                     (GroupType.INTEGER, 268)],
    ids=["PRIME-6", "INTEGER-7", "POWER2-12", "INTEGER-268"],
)  # fmt: skip
def test_unit_draws_plain_batch_sizes(group, width, b):
    _check_against_jax_and_sampler(_config(group, width), _key_words(b, b + width))


@pytest.mark.parametrize(
    "name, b", [("2^96", 1), ("2^96", 3), ("2^96", 257), ("2^128", 1), ("2^128", 3),
                ("2^128", 257), ("2^2112", 1), ("2^2112", 3)],
)  # fmt: skip
def test_unit_draws_plain_at_power_of_two_orders(name, b):
    """At an order of 2^(32 L) the draw is 4L + 1 bytes wide, so a
    candidate is accepted only when its top byte is 0."""
    cfg = BOUNDARY[name]
    n_limb = ref_limbs.n_limbs_for_order(cfg.order)
    assert cfg.order == 1 << (32 * n_limb)
    assert ref_limbs.draw_width_for(cfg.order) == 4 * n_limb + 1
    _check_against_jax_and_sampler(cfg, _key_words(b, b + 1))


@pytest.mark.parametrize("name", ["2^128", "PRIME-6"])
def test_unit_draws_plain_continues_seeds_past_its_window(name, monkeypatch):
    """With the batched window cut to one candidate per seed, the seeds
    without an acceptance there continue alone from its end: same units and
    cursors."""
    cfg = BOUNDARY.get(name) or _config(GroupType.PRIME, 6)
    monkeypatch.setattr(kernels, "_UNIT_WINDOW_BYTES", 1)
    kws = _key_words(40, 99)
    _, cursors = kernels.unit_draws(fold.to_device_u32(kws, CPU), cfg.order)
    assert max(cursors.tolist()) > ref_limbs.draw_width_for(cfg.order)  # some continued
    _check_against_jax_and_sampler(cfg, kws)


def test_unit_draws_arguments():
    order = _config(GroupType.PRIME, 6).order
    units, cursors = kernels.unit_draws(fold.zeros_u32((0, 8), CPU), order)
    assert tuple(units.shape) == (0, 2) and tuple(cursors.shape) == (0,)
    with pytest.raises(ValueError, match="uint32"):
        kernels.unit_draws(torch.zeros((2, 8), dtype=torch.int64), order)
    with pytest.raises(ValueError, match="uint32"):
        kernels.unit_draws(fold.zeros_u32((2, 7), CPU), order)
    kernels.reset_launches()
    kernels.unit_draws(fold.zeros_u32((2, 8), CPU), order)
    assert kernels.LAUNCHES["unit_draws"] == 0  # the plain version on a CPU tensor


def test_no_path_draws_units_on_the_host(monkeypatch):
    """The port's host ``StreamSampler`` made to raise: the batched
    derivation, a participant's masking, the Sum2 mask sum, the sim (both
    sum-mask phases) and the engine still run, and give the JAX package's
    bytes; ``ops/masking`` no longer imports the sampler."""

    def refuse(self, *args, **kwargs):
        raise AssertionError("a host StreamSampler was built on a device path")

    monkeypatch.setattr(prng.StreamSampler, "__init__", refuse)
    assert not hasattr(masking, "StreamSampler") and not hasattr(masking, "unit_draw")
    jax_pair = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M6).pair()
    pair = convert.config_pair(jax_pair)
    rng = np.random.default_rng(17)
    p, n = 7, 19
    seeds = [rng.bytes(32) for _ in range(p)]
    weights = rng.uniform(-1, 1, (p, n)).astype(np.float32)
    scalar = Fraction(1, p)

    units, rows = masking.derive_mask_limbs_batch(seeds, n, pair, device=CPU)
    want_units, want_vects = masking_jax.derive_mask_limbs_batch(seeds, n, jax_pair)
    assert units.tobytes() == np.asarray(want_units).tobytes()
    wire = fold.to_numpy_u32(rows).transpose(0, 2, 1)
    assert wire.tobytes() == np.asarray(want_vects).tobytes()

    unit_sum, vect_sum = masking.sum_masks(seeds, n, pair, seed_batch=3, device=CPU)
    ol_u = ref_limbs.order_limbs_for(jax_pair.unit.order)
    ol_v = ref_limbs.order_limbs_for(jax_pair.vect.order)
    want_unit_sum = ref_limbs.batch_mod_sum(np.asarray(want_units)[:, None], ol_u)[0]
    assert np.array_equal(unit_sum, want_unit_sum)
    assert np.array_equal(vect_sum, ref_limbs.batch_mod_sum(np.asarray(want_vects), ol_v))

    masked = masking.mask_update(seeds[0], PortScalar(scalar), weights[0], pair, device=CPU)
    assert masked.vect.data.shape == (n, 2) and masked.unit.data.shape == (2,)

    want = JaxSimRound(JaxSimSpec(jax_pair, n, block_size=4)).run(seeds, weights, scalar)
    for fuse in (True, False):
        spec = SimSpec(pair, n, block_size=4, fuse_mask_sum=fuse)
        got = SimRound(spec, device=CPU).run(seeds, weights, scalar)
        assert got.global_model.tobytes() == np.asarray(want.global_model).tobytes()

    vects, masked_units = PopulationEngine(pair, n, block_size=4, device=CPU).emit(
        seeds, weights, scalar
    )
    assert vects.shape == (p, n, 2) and masked_units.shape == (p, 2)
    assert vects[0].tobytes() == masked.vect.data.tobytes()
    assert masked_units[0].tobytes() == masked.unit.data.tobytes()
