"""The port's whole-round simulation and oracle (``xaynet_tpu_torch.sim``)
against the JAX package's (``xaynet_tpu.sim``).

The same inputs, made from numpy seeds, go through the JAX functions and
the port's on the CPU (the port's K2 and K1 run their plain versions on CPU
tensors). Tolerance: none. Masks, encodes, accumulators, unmasked limbs and
the float64 global models are compared byte for byte; only the 1024 x 64
scale case is also checked against the float mean, within 1e-6, as the JAX
package's test does.

The oracle's three seeded cases (``tests/test_sim_oracle.py``) run the
port's production leg (its coordinator in-process, its SDK participants
with pinned mask seeds, all on the CPU device) against the JAX production
leg and the port's sim: the three global models agree to the float64 byte.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import pytest
import torch

from xaynet_tpu.core.mask.config import BoundType as JaxBound
from xaynet_tpu.core.mask.config import DataType as JaxData
from xaynet_tpu.core.mask.config import GroupType as JaxGroup
from xaynet_tpu.core.mask.config import MaskConfig as JaxMaskConfig
from xaynet_tpu.core.mask.config import ModelType as JaxModel
from xaynet_tpu.ops import masking_jax
from xaynet_tpu.sim import SimRound as JaxSimRound
from xaynet_tpu.sim import SimSpec as JaxSimSpec
from xaynet_tpu.sim import oracle as jax_oracle

from xaynet_tpu_torch import convert
from xaynet_tpu_torch.core.mask.config import GroupType
from xaynet_tpu_torch.device import DeviceUnavailable
from xaynet_tpu_torch.ops import kernels, masking
from xaynet_tpu_torch.ops.fold import planar_to_wire, to_device_u32, to_numpy_u32
from xaynet_tpu_torch.sim import (
    OracleCase,
    OracleMismatch,
    SimRound,
    SimSpec,
    run_oracle_case,
    run_production_round,
    seeds_for,
)
from xaynet_tpu_torch.sim.oracle import run_sim_round

torch.set_num_threads(1)
GROUPS = ["INTEGER", "PRIME", "POWER2"]


def _jax_pair(group: str, model=JaxModel.M3):
    return JaxMaskConfig(getattr(JaxGroup, group), JaxData.F32, JaxBound.B0, model).pair()


def _pairs(group: str, model=JaxModel.M3):
    jax_pair = _jax_pair(group, model)
    return jax_pair, convert.config_pair(jax_pair)


def _population(p: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(32) for _ in range(p)]
    return seeds, rng.uniform(-1, 1, (p, n)).astype(np.float32)


# --- ops: the batched derivation and the population encode ------------------


@pytest.mark.parametrize("group", GROUPS)
def test_derive_mask_limbs_batch_matches_jax(group):
    """Units and vector rows equal the JAX function's (its vectors are wire
    ``[B, n, L]``, the port's planar ``[B, L, n]`` on the device)."""
    jax_pair, pair = _pairs(group)
    seeds, _ = _population(5, 1, seed=5)
    n = 41
    want_units, want_vects = masking_jax.derive_mask_limbs_batch(seeds, n, jax_pair)
    units, rows = masking.derive_mask_limbs_batch(seeds, n, pair, device="cpu")
    assert units.dtype == np.uint32 and np.array_equal(units, np.asarray(want_units))
    assert rows.device.type == "cpu" and rows.dtype == torch.uint32
    got = to_numpy_u32(rows).transpose(0, 2, 1)
    assert got.shape == np.asarray(want_vects).shape
    assert np.array_equal(got, np.asarray(want_vects))
    with pytest.raises(ValueError, match="no seeds"):
        masking.derive_mask_limbs_batch([], n, pair, device="cpu")


@pytest.mark.parametrize("group", GROUPS)
def test_encode_models_batch_matches_jax(group):
    jax_pair, pair = _pairs(group)
    _, weights = _population(4, 23, seed=6)
    scalar = Fraction(1, 4)
    want_unit, want_vect = masking_jax.encode_models_batch(weights, scalar, jax_pair)
    unit, vect = masking.encode_models_batch(weights, scalar, pair)
    assert unit.dtype == want_unit.dtype and np.array_equal(unit, want_unit)
    assert vect.dtype == want_vect.dtype and vect.shape == want_vect.shape
    assert np.array_equal(vect, want_vect)
    with pytest.raises(ValueError, match="participants"):
        masking.encode_models_batch(weights[0], scalar, pair)


@pytest.mark.parametrize("chunk", [None, 9])
@pytest.mark.parametrize("group", GROUPS)
def test_mask_fold_rows_plain_matches_per_row_mask_fold(group, chunk):
    """Seed b into row b == the one-accumulator K2 (plain) of seed b alone
    into that row, end cursors too; ``chunk`` forces several trips."""
    _, pair = _pairs(group)
    order = pair.vect.order
    rng = np.random.default_rng(7)
    seeds = [rng.bytes(32) for _ in range(4)]
    n = 37
    base = masking.derive_mask_limbs_batch(seeds, n, pair, device="cpu")[1]  # valid elements
    kw = to_device_u32(masking.seed_words(seeds), "cpu")
    offs = [3 + 11 * i for i in range(4)]
    rows = base.clone()
    got, ends = kernels.mask_fold_rows(rows, kw, offs, n, order, chunk)
    assert got is rows
    for b in range(4):
        want, want_end = kernels.mask_fold_plain(base[b].clone(), kw[b : b + 1], offs[b : b + 1],
                                                 n, order, chunk)  # fmt: skip
        assert np.array_equal(to_numpy_u32(rows[b]), to_numpy_u32(want))
        assert int(ends[b]) == int(want_end[0])
    with pytest.raises(ValueError, match="one seed per row"):
        kernels.mask_fold_rows(rows, kw[:3], offs[:3], n, order)
    with pytest.raises(ValueError, match="rows must be"):
        kernels.mask_fold_rows(rows[0], kw, offs, n, order)


def test_mask_fold_rows_on_cpu_launches_nothing():
    _, pair = _pairs("PRIME")
    kernels.reset_launches()
    masking.derive_mask_limbs_batch(seeds_for(3), 16, pair, device="cpu")
    assert kernels.LAUNCHES["mask_fold_rows"] == 0 and sum(kernels.LAUNCHES.values()) == 0


# --- SimRound against the JAX program ---------------------------------------


def _both(jax_pair, pair, n, p, seed, **spec):
    seeds, weights = _population(p, n, seed)
    scalar = Fraction(1, p)
    want = JaxSimRound(JaxSimSpec(jax_pair, n, **spec)).run(seeds, weights, scalar=scalar)
    sim = SimRound(SimSpec(pair, n, **spec), device="cpu")
    got = sim.run(seeds, weights, scalar=scalar)
    assert sim.program_calls == 1
    return want, got


def _assert_same(want, got) -> None:
    assert got.global_model.dtype == np.float64
    assert got.global_model.tobytes() == want.global_model.tobytes()
    assert got.model_vect_limbs.dtype == np.uint32
    assert np.array_equal(got.model_vect_limbs, np.asarray(want.model_vect_limbs))
    assert got.model_unit_int == want.model_unit_int
    assert got.nb_models == want.nb_models and got.scalar_sum == want.scalar_sum


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "rederived"])
@pytest.mark.parametrize("group", GROUPS)
def test_sim_round_matches_jax(group, fuse):
    """p = 5 in blocks of 4: the JAX program pads its last block, the port
    folds a short one; both sum-mask phases; the internals too."""
    jax_pair, pair = _pairs(group)
    want, got = _both(jax_pair, pair, 33, 5, 20, block_size=4, fuse_mask_sum=fuse,
                      return_internals=True)  # fmt: skip
    _assert_same(want, got)
    assert set(got.internals) == set(want.internals)
    for key, value in want.internals.items():
        value = np.asarray(value)
        assert got.internals[key].dtype == value.dtype and np.array_equal(got.internals[key], value)


@pytest.mark.parametrize("block", [7, 3, 1])
def test_sim_round_block_sizes_match_jax(block):
    jax_pair, pair = _pairs("INTEGER")
    want, got = _both(jax_pair, pair, 19, 7, 21, block_size=block)
    _assert_same(want, got)
    assert got.internals is None


def test_sim_round_thousand_participants_matches_jax_and_mean():
    """The JAX package's scale case: 1024 participants x 64, m6, blocks of
    128; byte-identical to the JAX program and within 1e-6 of the mean."""
    jax_pair, pair = _pairs("INTEGER", JaxModel.M6)
    p, n = 1024, 64
    seeds = seeds_for(p, root=3)
    weights = np.random.default_rng(4).uniform(-1, 1, (p, n)).astype(np.float32)
    scalar = Fraction(1, p)
    want = JaxSimRound(JaxSimSpec(jax_pair, n, block_size=128)).run(seeds, weights, scalar=scalar)
    sim = SimRound(SimSpec(pair, n, block_size=128), device="cpu")
    got = sim.run(seeds, weights, scalar=scalar)
    _assert_same(want, got)
    assert sim.program_calls == 1 and got.nb_models == p
    np.testing.assert_allclose(got.global_model, weights.astype(np.float64).mean(axis=0),
                               atol=1e-6)  # fmt: skip


def test_sim_round_key_words_input_matches_seed_bytes():
    _, pair = _pairs("PRIME")
    seeds, weights = _population(6, 10, 22)
    sim = SimRound(SimSpec(pair, 10, block_size=4), device="cpu")
    a = sim.run(seeds, weights, Fraction(1, 6))
    b = sim.run(masking.seed_words(seeds), weights, Fraction(1, 6))
    assert a.global_model.tobytes() == b.global_model.tobytes()
    assert sim.program_calls == 2


def test_sim_round_input_validation():
    """The JAX package's refusals, and a mesh without a device."""
    _, pair = _pairs("INTEGER")
    sim = SimRound(SimSpec(pair, 8, block_size=4), device="cpu")
    seeds = seeds_for(3)
    weights = np.zeros((3, 8), np.float32)
    with pytest.raises(ValueError, match="weights"):
        sim.run(seeds, np.zeros((3, 9), np.float32))
    with pytest.raises(ValueError, match="participant"):
        sim.run([], np.zeros((0, 8), np.float32))
    with pytest.raises(ValueError, match="seeds"):
        sim.run(np.zeros((3, 4), np.uint32), weights)
    with pytest.raises(ValueError, match="TooManyModels"):
        SimRound(SimSpec(pair, 8, block_size=512), device="cpu").run(
            seeds_for(1001), np.zeros((1001, 8), np.float32)
        )
    with pytest.raises(ValueError):
        SimSpec(pair, 0)
    with pytest.raises(ValueError):
        SimSpec(pair, 8, block_size=0)
    with pytest.raises(ValueError, match="at least one device"):
        SimRound(SimSpec(pair, 8), mesh=[], device="cpu")


def test_sim_round_without_device_raises_where_there_is_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pair = _pairs("PRIME")
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        SimRound(SimSpec(pair, 8))
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        masking.derive_mask_limbs_batch(seeds_for(2), 8, pair)


# --- the oracle -----------------------------------------------------------

# tests/test_sim_oracle.py's three seeded cases, one per group family
CASES = [
    dict(group="INTEGER", model_length=13, n_update=3, seed=101, block_size=2),
    dict(group="PRIME", model_length=37, n_update=4, seed=202, block_size=4),
    dict(group="POWER2", model_length=64, n_update=5, seed=303, block_size=3),
]


def _cases(case: dict):
    fields = {k: v for k, v in case.items() if k != "group"}
    jax_case = jax_oracle.OracleCase(group_type=getattr(JaxGroup, case["group"]), **fields)
    return jax_case, OracleCase(group_type=getattr(GroupType, case["group"]), **fields)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["group"])
def test_oracle_production_rounds_and_sim_agree(case):
    """The port's production round == the JAX production round == the port's
    sim, float64 byte for byte."""
    jax_case, port_case = _cases(case)
    assert port_case.describe() == jax_case.describe()
    seeds, weights = port_case.population()
    jax_seeds, jax_weights = jax_case.population()
    assert seeds == jax_seeds and np.array_equal(weights, jax_weights)
    want = jax_oracle.run_production_round(jax_case)
    got = run_production_round(port_case, device="cpu")
    assert got.dtype == np.float64 and got.tobytes() == want.tobytes()
    report = run_oracle_case(port_case, production_model=got, device="cpu")
    assert report.identical and report.max_abs_diff == 0.0
    assert report.production_sha == report.sim_sha
    assert report.legs == {"mesh": None, "nb_models": port_case.n_update}


def test_oracle_detects_divergence():
    """A one-ULP flip of the production model trips ``OracleMismatch``."""
    _, port_case = _cases(CASES[0])
    sim_model = run_sim_round(port_case, device="cpu").global_model
    corrupted = sim_model.copy()
    corrupted[0] = np.nextafter(corrupted[0], np.inf)
    with pytest.raises(OracleMismatch, match="diverged"):
        run_oracle_case(port_case, production_model=corrupted, device="cpu")


@pytest.mark.parametrize("route", ["batch", "fused-pallas-interpret", "host-threaded"])
def test_oracle_refuses_mask_kernel_routes_by_name(route):
    with pytest.raises(ValueError, match=f"'{route}'.*ROADMAP Queue 2"):
        OracleCase(mask_kernel=route)
    assert OracleCase().mask_kernel == "auto"


def test_oracle_refuses_a_mesh():
    """A mesh the sim cannot run on is refused: an empty one, and one whose
    first device is not the oracle's (``tests/test_torch_sim_mesh.py`` runs
    the mesh leg)."""
    _, port_case = _cases(CASES[0])
    with pytest.raises(ValueError, match="at least one device"):
        run_sim_round(port_case, mesh=[], device="cpu")
    with pytest.raises(ValueError, match="first device"):
        run_sim_round(port_case, mesh=["cpu"], device="meta")


def test_oracle_sim_block_sizes_agree_with_one_production_round():
    """One production round holds every sim block size: a block per
    participant, a ragged last block, and the whole population in one."""
    _, port_case = _cases(CASES[1])
    production = run_production_round(port_case, device="cpu")
    for block_size in (1, 3, port_case.n_update):
        case = OracleCase(**{**port_case.__dict__, "block_size": block_size})
        report = run_oracle_case(case, production_model=production, device="cpu")
        assert report.identical and report.production_sha == report.sim_sha


def test_sim_matches_port_masking_per_participant():
    """The sim's masked aggregate is the fold of the port's own per-participant
    ``mask_update`` (K2 + K1) of the same seeds and models."""
    _, pair = _pairs("PRIME")
    seeds, weights = _population(3, 21, 24)
    from xaynet_tpu_torch.core.mask.model import Scalar
    from xaynet_tpu_torch.ops import limbs

    res = SimRound(SimSpec(pair, 21, block_size=2, return_internals=True), device="cpu").run(
        seeds, weights, Fraction(1, 3)
    )
    ol = limbs.order_limbs_for(pair.vect.order)
    acc = np.zeros((21, limbs.n_limbs_for_order(pair.vect.order)), np.uint32)
    for s, w in zip(seeds, weights):
        obj = masking.mask_update(s, Scalar(Fraction(1, 3)), w, pair, device="cpu")
        acc = limbs.mod_add(acc, obj.vect.data, ol)
    assert np.array_equal(acc, res.internals["masked_vect_sum"])
    units, rows = masking.derive_mask_limbs_batch(seeds, 21, pair, device="cpu")
    mask_sum = np.zeros_like(acc)
    for r in to_numpy_u32(rows):
        mask_sum = limbs.mod_add(mask_sum, planar_to_wire(r), ol)
    assert np.array_equal(mask_sum, res.internals["mask_vect_sum"])
