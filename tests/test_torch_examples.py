"""The port's training examples run end to end on the CPU, shrunken.

Each of ``xaynet_tpu_torch.examples.{house_prices, cifar_lenet,
shakespeare_lstm, lora_federated}`` runs as a subprocess — the command a
user runs, ``python -m ...`` — with ``--device cpu`` (the coordinator, the
masking and the training on the CPU, the kernels' plain versions), at the
shapes of ``tests/test_examples_smoke.py`` and with ``--check-loss``, which
makes the example exit nonzero unless the federated global model improves
on the initial loss. Without a card and without ``--device cpu`` an example
refuses to run.
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
