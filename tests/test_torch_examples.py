"""The port's examples run end to end on the CPU, shrunken.

Each of ``xaynet_tpu_torch.examples.{house_prices, cifar_lenet,
shakespeare_lstm, lora_federated}`` runs as a subprocess — the command a
user runs, ``python -m ...`` — with ``--device cpu`` (the coordinator, the
masking and the training on the CPU, the kernels' plain versions), at the
shapes of ``tests/test_examples_smoke.py`` and with ``--check-loss``, which
makes the example exit nonzero unless the federated global model improves
on the initial loss. Without a card and without ``--device cpu`` an example
refuses to run.

The JAX package's other examples, ported as ``restore``, ``test_drive``,
``sim_quickstart`` and ``download_global_model``: each of the first three
runs as a subprocess on the CPU and refuses without a card;
``download_global_model`` reads the model a ``test_drive`` round published
on the port's coordinator; ``sim_quickstart``'s models equal the JAX
package's sim for the same population, byte for byte, and its ``--mesh``
(every visible card) refuses to run without one.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

EXAMPLES = {
    "house_prices": [],
    "cifar_lenet": ["--rounds", "2", "--participants", "6", "--image-size", "8",
                    "--epochs", "3", "--lr", "0.01"],
    "shakespeare_lstm": ["--rounds", "1", "--participants", "5", "--hidden", "16",
                         "--seq-len", "20", "--epochs", "3", "--lr", "0.01"],
    "lora_federated": ["--rounds", "2"],
}  # fmt: skip


def _run(name: str, args: list[str], env: dict | None = None) -> subprocess.CompletedProcess:
    # two compute threads per example: the suite runs beside other workers
    env = {"OMP_NUM_THREADS": "2", **(os.environ if env is None else env)}
    return subprocess.run(
        [sys.executable, "-m", f"xaynet_tpu_torch.examples.{name}", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )  # fmt: skip


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_passes_its_loss_gate_on_cpu(name):
    r = _run(name, [*EXAMPLES[name], "--check-loss", "--device", "cpu"])
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-2000:]}"
    assert "eval loss" in r.stdout


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_without_a_card_refuses(name):
    """Without ``--device cpu`` an example runs on CUDA; where there is no
    card it exits nonzero with ``DeviceUnavailable`` before it serves."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(name, EXAMPLES[name], env)
    assert r.returncode != 0
    assert "DeviceUnavailable" in r.stderr
    assert "round 1" not in r.stdout


# --------------------------------------------------------------------------
# the JAX package's other examples: download_global_model, restore,
# test_drive, sim_quickstart
# --------------------------------------------------------------------------

NEW_EXAMPLES = {
    "restore": [],
    "test_drive": ["-n", "4", "-l", "40", "-r", "1"],
    "sim_quickstart": ["-p", "16", "-l", "40", "-b", "4", "--rounds", "1"],
}


@pytest.mark.parametrize("name", sorted(NEW_EXAMPLES))
def test_example_runs_on_cpu_and_refuses_without_a_card(name):
    """``python -m xaynet_tpu_torch.examples.<name> --device cpu`` exits 0;
    without ``--device cpu`` and without a card it exits nonzero with
    ``DeviceUnavailable`` before it does anything."""
    r = _run(name, [*NEW_EXAMPLES[name], "--device", "cpu"])
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-2000:]}"
    want = {"restore": "save/restore round-trip OK", "test_drive": "round 1: completed",
            "sim_quickstart": "round 0: 16 participants x 40 params"}[name]  # fmt: skip
    assert want in r.stdout
    r = _run(name, NEW_EXAMPLES[name], dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and "DeviceUnavailable" in r.stderr
    assert want not in r.stdout


def test_download_global_model_reads_what_test_drive_published(tmp_path, capsys):
    """Against the port's coordinator (in this process, on the CPU): no
    model before the first round (204, ``main`` returns None); after
    ``test_drive --url`` drove one round of dummy (zero) updates,
    ``download_global_model.main`` returns the model ``GET /model`` serves,
    and ``--out`` writes its float64 bytes."""
    import asyncio

    import numpy as np

    from xaynet_tpu_torch.examples import download_global_model, test_drive
    from xaynet_tpu_torch.examples.coordinator import round_settings, start_coordinator
    from xaynet_tpu_torch.sdk.client import HttpClient

    url = start_coordinator(round_settings(0.3, 0.6, 1, 3, 60, 40), "cpu")
    assert download_global_model.main([url]) is None
    assert "no global model available yet" in capsys.readouterr().out
    assert test_drive.main(["--url", url, "-n", "4", "-l", "40", "-r", "1",
                            "--device", "cpu"]) == 0  # fmt: skip
    out = tmp_path / "model.f64"
    model = download_global_model.main([url, "--out", str(out)])
    served = np.asarray(asyncio.run(HttpClient(url).get_model()), dtype=np.float64)
    assert model.dtype == np.float64 and model.shape == (40,)
    assert model.tobytes() == served.tobytes() == out.read_bytes()
    assert np.array_equal(model, np.zeros(40))  # the dummy trainers' zeros
    assert "global model: 40 parameters" in capsys.readouterr().out


@pytest.mark.parametrize("rounds", [1, 2])
def test_sim_quickstart_model_equals_the_jax_sim(rounds):
    """``sim_quickstart``'s rounds (their seeds and weights drawn as the JAX
    example draws them) give the float64 models the JAX package's
    ``SimRound`` gives for the same population, byte for byte."""
    from fractions import Fraction

    import numpy as np

    from xaynet_tpu.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
    from xaynet_tpu.sim import SimRound, SimSpec, seeds_for

    from xaynet_tpu_torch.examples import sim_quickstart

    p, length, block = 12, 24, 4
    ours = sim_quickstart.simulate(p, length, block, rounds, "cpu")
    config = MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6).pair()
    sim = SimRound(SimSpec(config, length, block_size=block))
    rng = np.random.default_rng(0)
    for rnd, (result, weights, _) in enumerate(ours):
        want_w = rng.uniform(-1, 1, (p, length)).astype(np.float32)
        assert np.array_equal(weights, want_w)
        theirs = sim.run(seeds_for(p, root=rnd), want_w, scalar=Fraction(1, p))
        got = np.asarray(result.global_model, dtype=np.float64)
        assert got.tobytes() == np.asarray(theirs.global_model, dtype=np.float64).tobytes()


def test_sim_quickstart_refuses_the_mesh_by_name(capsys):
    """``--mesh`` meshes every visible card: without one it refuses, naming
    CUDA (``tests/test_torch_sim_mesh.py`` runs ``--mesh 2 --device cpu``)."""
    from xaynet_tpu_torch.device import DeviceUnavailable
    from xaynet_tpu_torch.examples import sim_quickstart

    with pytest.raises(DeviceUnavailable, match="CUDA"):
        sim_quickstart.main(["--mesh", "-p", "4", "-l", "8"])
