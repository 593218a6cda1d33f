"""The port stands alone: no JAX, no JAX package, no silent CPU path.

- every module of ``xaynet_tpu_torch`` imports in a fresh interpreter (the
  root conftest imports jax into this one) without pulling ``jax`` or any
  ``xaynet_tpu`` module into ``sys.modules``;
- the kernel loader imports where there is no ``nvcc``, and building then
  raises instead of falling back; a built library is reused only for the
  same source and flags;
- entry points given no device run on CUDA, so without one they raise,
  the streaming pipeline's included, and on a CPU device the pipeline
  runs without touching CUDA (nothing is pinned);
- a wrapper handed a tensor that is neither on the CPU nor on a CUDA
  device raises (only CPU tensors take the plain versions).
"""

from __future__ import annotations

import json
import os
import pkgutil
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

import xaynet_tpu_torch
from xaynet_tpu_torch.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
from xaynet_tpu_torch.core.mask.model import Scalar
from xaynet_tpu_torch.ops import kernels, masking
from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator
from xaynet_tpu_torch.parallel.streaming import StreamingAggregator
from xaynet_tpu_torch.server.aggregation import StagedAggregator

REPO = Path(__file__).resolve().parents[1]
PAIR = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3).pair()


def _port_modules() -> list[str]:
    names = [xaynet_tpu_torch.__name__]
    for info in pkgutil.walk_packages(xaynet_tpu_torch.__path__, prefix="xaynet_tpu_torch."):
        names.append(info.name)
    return names


def _run(code: str, env: dict | None = None) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )


def test_every_port_module_imports_without_jax():
    modules = _port_modules()
    assert "xaynet_tpu_torch.ops.kernels" in modules and len(modules) >= 20
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'xaynet_tpu' or k.startswith('xaynet_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_kernel_loader_imports_without_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path), CUDA_PATH=str(tmp_path))
    env["XAYNET_TORCH_BUILD_DIR"] = str(tmp_path / "build")
    code = (
        "from xaynet_tpu_torch.ops import kernels\n"
        "try:\n"
        "    kernels.build()\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
    )
    proc = _run(code, env)
    assert proc.returncode == 0, proc.stderr
    assert "raised: nvcc not found" in proc.stdout


def test_kernel_build_is_keyed_on_source_and_flags(tmp_path, monkeypatch):
    """A library is reused only while its source and compiler flags are
    unchanged: each is in the library's name, whatever the files' times."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in kernels.SOURCES.values():
        (csrc / src).write_bytes((kernels.CSRC / src).read_bytes())
    monkeypatch.setattr(kernels, "CSRC", csrc)
    stem = kernels.library_stem("mask_fold")
    assert stem.startswith("libxn_mask_fold-")
    out = tmp_path / "build"
    out.mkdir()
    for name in kernels.SOURCES:
        (out / f"{kernels.library_stem(name)}.so").write_bytes(b"")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert kernels.build(out)["mask_fold"] == out / f"{stem}.so"  # built: no nvcc needed
    with monkeypatch.context() as flags:
        flags.setattr(kernels, "NVCC_FLAGS", (*kernels.NVCC_FLAGS, "-DXN_CHANGED_FLAG"))
        assert kernels.library_stem("mask_fold") != stem
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kernels.build(out)
    (csrc / "mask_fold.cu").write_text((csrc / "mask_fold.cu").read_text() + "\n// edited\n")
    assert kernels.library_stem("mask_fold") != stem
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build(out)


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without CUDA, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    seed = bytes(32)
    calls = [
        lambda: DeviceAggregator(PAIR.vect, 8),
        lambda: StagedAggregator(PAIR, 8),
        lambda: StagedAggregator(PAIR, 8, batch_size=2, packed_staging=False),
        lambda: masking.derive_mask_limbs(seed, 8, PAIR),
        lambda: masking.sum_masks([seed], 8, PAIR),
        lambda: masking.mask_update(seed, Scalar(Fraction(1)), np.zeros(8, np.float32), PAIR),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cpu_device_runs_when_asked(no_cuda):
    agg = StagedAggregator(PAIR, 8, device="cpu")
    assert agg.kernel_used == "plain"


def test_pipeline_on_cpu_device_needs_no_cuda(no_cuda, monkeypatch):
    """The pipeline on a CPU device stages into plain host buffers: it never
    reaches the CUDA runtime (no pinning), and folds with the plain K1."""

    def no_cudart():
        raise AssertionError("the CPU path reached the CUDA runtime")

    monkeypatch.setattr(torch.cuda, "cudart", no_cudart)
    agg = DeviceAggregator(PAIR.vect, 8, device="cpu")
    stream = StreamingAggregator(agg, max_batch=2)
    stream.submit_batch(np.zeros((2, 8, agg.n_limbs), np.uint32))
    stream.drain()
    stream.close()
    assert agg.nb_models == 2 and agg.stream is None


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Only a CPU tensor takes the plain version; anything else must be a
    CUDA tensor for the kernel, or the wrapper raises."""
    acc = torch.empty((2, 16), dtype=torch.uint32, device="meta")
    stack = torch.empty((1, 2, 16), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        kernels.fold_planar(acc, stack, PAIR.vect.order)
    packed = torch.empty((1, 6, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        kernels.fold_packed(acc, packed, PAIR.vect.order)
    kw = torch.empty((1, 8), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        kernels.mask_fold(acc, kw, [0], 16, PAIR.vect.order)


@pytest.mark.parametrize(
    "module",
    [
        "xaynet_tpu_torch.core.mask.serialization",
        "xaynet_tpu_torch.core.mask.object",
        "xaynet_tpu_torch.parallel.aggregator",
        "xaynet_tpu_torch.server.aggregation",
    ],
)
def test_wire_ingest_modules_import_alone_without_jax(module):
    """Each module on the wire-ingest path, imported alone in a fresh
    interpreter, pulls in neither ``jax`` nor the JAX package."""
    assert module in _port_modules()
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'xaynet_tpu' or k.startswith('xaynet_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("name", sorted(kernels.SOURCES))
def test_each_kernel_source_keys_only_its_library(name, tmp_path, monkeypatch):
    """Every kernel source (``wire.cu`` among them) is in its library's
    digest: editing it renames that library and no other, so an edited
    kernel always rebuilds."""
    assert kernels.SOURCES["wire"] == "wire.cu"
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in kernels.SOURCES.values():
        (csrc / src).write_bytes((kernels.CSRC / src).read_bytes())
    monkeypatch.setattr(kernels, "CSRC", csrc)
    before = {n: kernels.library_stem(n) for n in kernels.SOURCES}
    src = csrc / kernels.SOURCES[name]
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: kernels.library_stem(n) for n in kernels.SOURCES}
    assert [n for n in kernels.SOURCES if after[n] != before[n]] == [name]


def test_wire_wrappers_refuse_non_cpu_non_cuda_tensors():
    order = PAIR.vect.order
    raw = torch.empty((1, 96), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        kernels.wire_unpack(raw, order)
    packed = torch.empty((1, 6, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        kernels.packed_check(packed, order)
