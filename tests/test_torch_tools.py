"""The port's command-line tools (``xaynet_tpu_torch.tools``) on the CPU.

- ``sim_check`` draws the JAX tool's seeded menu, the same combinations in
  the same order; on ``--device cpu`` each production round and sim agree
  byte for byte, and the sim's model equals the JAX package's sim for the
  same case; the mesh leg on the CPU wants its size (``--mesh N``: a
  repeated-device mesh is never implicit).
- ``loadgen_soak`` runs its headline, ``--identity`` and
  ``--legacy-control`` legs against the port's coordinator CLI at a small
  size: every update lands, the loadgen round is byte-identical to the
  flood control round, and the packed path stages strictly fewer bytes
  per accepted update than the legacy one.
- Neither tool touches JAX's environment variables, and without a card
  and without ``--device cpu`` each exits nonzero with
  ``DeviceUnavailable``.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from xaynet_tpu.core.mask.config import GroupType as JaxGroup
from xaynet_tpu.sim import oracle as jax_oracle

from xaynet_tpu_torch.tools import loadgen_soak, sim_check

REPO = Path(__file__).resolve().parents[1]


def _jax_menu(combos: int, seed: int) -> list:
    """The draws of ``tools/sim_check.py`` (its loop, without the rounds)."""
    rng = np.random.default_rng(seed)
    groups = [JaxGroup.INTEGER, JaxGroup.PRIME, JaxGroup.POWER2]
    lengths, populations = [13, 64, 257, 600], [3, 4, 5, 7]
    routes = [None, None, "batch", "fused-pallas-interpret", "host-threaded"]
    out = []
    for _ in range(combos):
        route = routes[int(rng.integers(len(routes)))]
        case = jax_oracle.OracleCase(
            group_type=groups[int(rng.integers(len(groups)))],
            model_length=int(lengths[int(rng.integers(len(lengths)))]),
            n_update=int(populations[int(rng.integers(len(populations)))]),
            seed=int(rng.integers(1 << 30)),
            block_size=int(rng.choice([2, 3, 4, 8])),
            device_sum2=route is not None,
            mask_kernel=route or "auto",
        )
        out.append((case, route))
    return out


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sim_check_draws_the_jax_menu(seed):
    ours = sim_check.menu(6, seed)
    theirs = _jax_menu(6, seed)
    assert [(c.describe(), c.block_size, r) for c, r in ours] == [
        (c.describe(), c.block_size, r) for c, r in theirs
    ]


def test_sim_check_on_cpu_matches_the_jax_sim(capsys):
    """One combination through the CLI: the production round and the sim
    agree (exit 0), and the sim's sha256 is the JAX package's sim's for
    the same case."""
    env = dict(os.environ)
    assert sim_check.main(["--combos", "1", "--seed", "3", "--json", "--device", "cpu"]) == 0
    assert dict(os.environ) == env  # JAX_PLATFORMS / XLA_FLAGS untouched
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (case, _), = _jax_menu(1, 3)
    assert line["case"] == case.describe() and line["result"] == "ok"
    sim = jax_oracle.run_sim_round(case)
    want = hashlib.sha256(np.asarray(sim.global_model, dtype=np.float64).tobytes()).hexdigest()
    assert line["sha256"] == want[:16]


def test_sim_check_refuses_the_mesh_by_name(capsys):
    """``--mesh`` without a size is refused by name: on one card or the CPU
    the mesh repeats the device, which the tool never does unasked
    (``tests/test_torch_sim_mesh.py`` runs ``--mesh 2``)."""
    with pytest.raises(SystemExit) as exit_:
        sim_check.main(["--mesh", "--device", "cpu"])
    assert exit_.value.code == 2
    assert "--mesh" in capsys.readouterr().err


def test_loadgen_soak_identity_and_legacy_control_on_cpu(capsys, monkeypatch):
    # the coordinators and drivers it spawns: two compute threads each (the
    # suite runs beside other workers)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    env = dict(os.environ)
    assert loadgen_soak.main([
        "--participants", "6", "--drivers", "1", "--model-len", "24", "--block-size", "8",
        "--identity", "--identity-n", "4", "--legacy-control", "4", "--device", "cpu",
    ]) == 0  # fmt: skip
    assert dict(os.environ) == env
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["identity"]["byte_identical"] is True
    assert result["headline"]["accepted"] == 6 and result["headline"]["errors"] == 0
    assert result["headline"]["statusz_ingress"] is True
    # packed v2 blocks of 24 elements x 6 bytes against unpacked 24 x 2 limbs
    assert result["packed_vs_legacy_bytes"] == {"packed": 144.0, "legacy": 192.0,
                                                "strictly_fewer": True}  # fmt: skip


@pytest.mark.parametrize("tool", ["sim_check", "loadgen_soak"])
def test_tool_without_a_card_refuses(tool):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", f"xaynet_tpu_torch.tools.{tool}"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)  # fmt: skip
    assert r.returncode != 0
    assert "DeviceUnavailable" in r.stderr
