"""The port's sim sharded over the participant axis, against the JAX package's.

``SimRound(spec, mesh=[cpu] * m)`` pads the population to a multiple of
``block_size x m``, runs each shard's contiguous blocks on its own thread
and combines the partials with K1 planar; the JAX ``SimRound`` on
``conftest.py``'s 8 virtual CPU devices shard-maps the same grid. The
seeds and models are made from a seed with numpy. Tolerance: none. The
aggregates and the unmasked limbs are exact modular arithmetic and the
decode is the same double-double arithmetic in both packages, so the
float64 global models must be byte-identical, as must the internals.
Then the oracle's mesh leg against one production round through the
port's coordinator, and ``sim_check --mesh 2`` and ``sim_quickstart
--mesh 2`` on the CPU.
"""

from __future__ import annotations

import json
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from xaynet_tpu.core.mask.config import BoundType as JaxBound
from xaynet_tpu.core.mask.config import DataType as JaxData
from xaynet_tpu.core.mask.config import GroupType as JaxGroup
from xaynet_tpu.core.mask.config import MaskConfig as JaxMaskConfig
from xaynet_tpu.core.mask.config import ModelType as JaxModel
from xaynet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from xaynet_tpu.sim import SimRound as JaxSimRound
from xaynet_tpu.sim import SimSpec as JaxSimSpec
from xaynet_tpu_torch.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
from xaynet_tpu_torch.sim import (
    OracleCase,
    SimRound,
    SimSpec,
    run_oracle_case,
    run_production_round,
    seeds_for,
)

CPU = torch.device("cpu")
torch.set_num_threads(1)


def _pairs(group: str):
    args = (DataType.F32, BoundType.B0, ModelType.M6)
    jax_args = (JaxData.F32, JaxBound.B0, JaxModel.M6)
    return (JaxMaskConfig(getattr(JaxGroup, group), *jax_args).pair(),
            MaskConfig(getattr(GroupType, group), *args).pair())  # fmt: skip


@pytest.mark.parametrize("group,fuse", [("INTEGER", True), ("PRIME", True), ("POWER2", True),
                                        ("INTEGER", False)],
                         ids=["INTEGER-fused", "PRIME-fused", "POWER2-fused",
                              "INTEGER-rederived"])  # fmt: skip
def test_sharded_sim_matches_jax_mesh(group, fuse):
    """23 participants in blocks of 2: 8 shards pad them to 32 (shards 6
    and 7 hold padding only), 2 shards to 24. ``rederived`` re-derives the
    sum mask from each shard's seeds (``fuse_mask_sum=False``)."""
    jax_pair, pair = _pairs(group)
    p, n, block = 23, 29, 2
    seeds = seeds_for(p, root=5)
    weights = np.random.default_rng(7).uniform(-1, 1, (p, n)).astype(np.float32)
    scalar = Fraction(1, p)
    theirs = JaxSimRound(
        JaxSimSpec(jax_pair, n, block_size=block, fuse_mask_sum=fuse, return_internals=True),
        mesh=jax_make_mesh(jax.devices()[:8]),
    ).run(seeds, weights, scalar)
    spec = SimSpec(pair, n, block_size=block, fuse_mask_sum=fuse, return_internals=True)
    for m in (2, 8):
        sim = SimRound(spec, mesh=[CPU] * m)
        assert sim._grid(p) == (16 if m == 8 else 12, 32 if m == 8 else 24)
        got = sim.run(seeds, weights, scalar)
        assert got.global_model.tobytes() == theirs.global_model.tobytes()
        assert np.array_equal(got.model_vect_limbs, theirs.model_vect_limbs)
        assert got.model_unit_int == theirs.model_unit_int and got.nb_models == p
        for key, value in theirs.internals.items():
            assert np.array_equal(got.internals[key], value), key
        assert sim.program_calls == 1


def test_sharded_sim_one_participant_and_a_one_shard_mesh():
    """One participant on 8 shards (seven shards empty), and a mesh of one
    shard: both equal the sim on one device."""
    _, pair = _pairs("PRIME")
    spec = SimSpec(pair, 17, block_size=4)
    for p in (1, 9):
        seeds = seeds_for(p, root=p)
        weights = np.random.default_rng(p).uniform(-1, 1, (p, 17)).astype(np.float32)
        want = SimRound(spec, device="cpu").run(seeds, weights)
        for m in (1, 8):
            got = SimRound(spec, mesh=[CPU] * m).run(seeds, weights)
            assert got.global_model.tobytes() == want.global_model.tobytes()


@pytest.fixture(scope="module")
def oracle_case():
    case = OracleCase(group_type=GroupType.PRIME, model_length=37, n_update=4, seed=202,
                      block_size=1)  # fmt: skip
    return case, run_production_round(case, device="cpu")


@pytest.mark.parametrize("mesh_size", [2, 8])
def test_oracle_mesh_leg_agrees_with_production(oracle_case, mesh_size):
    case, production = oracle_case
    report = run_oracle_case(case, mesh=[CPU] * mesh_size, production_model=production,
                             device="cpu")  # fmt: skip
    assert report.identical and report.production_sha == report.sim_sha
    assert report.legs == {"mesh": mesh_size, "nb_models": case.n_update}


def test_sim_check_mesh_leg_on_cpu(capsys):
    from xaynet_tpu_torch.tools import sim_check

    assert sim_check.main(["--combos", "1", "--seed", "3", "--json", "--device", "cpu",
                           "--mesh", "2"]) == 0  # fmt: skip
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["result"] == "ok" and line["mesh"] == "byte-identical (x2)"


def test_sim_quickstart_mesh_on_cpu(capsys):
    """``--mesh 2``: the participants of each round split over two CPU
    shards, the models those of the unsharded run."""
    from xaynet_tpu_torch.examples import sim_quickstart

    assert sim_quickstart.main(["-p", "16", "-l", "40", "-b", "4", "--rounds", "1",
                                "--device", "cpu", "--mesh", "2"]) == 0  # fmt: skip
    out = capsys.readouterr().out
    assert "mesh: 2 devices" in out
    sha = out.split("model sha256 ")[1].split()[0]
    assert sim_quickstart.main(["-p", "16", "-l", "40", "-b", "4", "--rounds", "1",
                                "--device", "cpu"]) == 0  # fmt: skip
    assert f"model sha256 {sha}" in capsys.readouterr().out
