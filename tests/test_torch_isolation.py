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
  device raises (only CPU tensors take the plain versions);
- the whole-round sim and the load generator (``sim``, ``loadgen``)
  import alone without JAX, and without a device given they run on CUDA;
- the model families, their trainer and the training examples (``models``,
  ``examples``) import alone without ``jax``, ``flax`` or ``optax``, and
  without a device given they build and train on CUDA;
- the coordinator (``server.runner.serve``, ``StateMachineInitializer``, the
  ``python -m xaynet_tpu_torch.server.runner`` CLI) with ``[aggregation]
  device`` true or false and no device given refuses to run without CUDA,
  the multi-tenant one (``[tenancy] enabled``) too;
- the tenancy package (``tenancy``: the page pool, the scheduler, the
  registry, the lifecycle) imports alone without JAX, and a CPU pipeline
  leases its staging pages from the pool without page-locking any;
- the ingest pipeline (``ingest``) and the operator console
  (``server.console``) import alone without JAX, and a coordinator with
  ``[ingest] enabled`` and no device given refuses to run without CUDA,
  alone and with tenancy.
"""

from __future__ import annotations

import asyncio
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
from xaynet_tpu_torch.device import DeviceUnavailable
from xaynet_tpu_torch.loadgen import PopulationEngine
from xaynet_tpu_torch.models import lenet, lora, lstm, mlp, resnet
from xaynet_tpu_torch.models.federated import FederatedTrainer
from xaynet_tpu_torch.parallel.streaming import StreamingAggregator
from xaynet_tpu_torch.server import runner
from xaynet_tpu_torch.server.aggregation import StagedAggregator
from xaynet_tpu_torch.server.settings import Settings
from xaynet_tpu_torch.server.state_machine import StateMachineInitializer
from xaynet_tpu_torch.sim import SimRound, SimSpec
from xaynet_tpu_torch.tenancy import LOCAL_TENANT, PagePool

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
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'optax', 'xaynet_tpu'))\n"
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
        lambda: masking.derive_mask_limbs_batch([seed], 8, PAIR),
        lambda: SimRound(SimSpec(PAIR, 8)),
        lambda: PopulationEngine(PAIR, 8),
        lambda: mlp.init_params(torch.Generator(), 4),
        lambda: lenet.init_params(torch.Generator(), image_shape=(8, 8, 3)),
        lambda: lstm.init_params(torch.Generator(), hidden=4),
        lambda: resnet.init_params(torch.Generator(), stage_sizes=(1, 1, 1, 1)),
        lambda: lora.init_adapters(torch.Generator(), lora.LoraSpec({"q": (4, 4)})),
        lambda: FederatedTrainer(lambda: mlp.MLP(4), mlp.make_train_step,
                                 (np.zeros((4, 4), np.float32), np.zeros(4, np.float32))),
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
    pool = PagePool(page_bytes=4096, slab_pages=4)
    agg = DeviceAggregator(PAIR.vect, 8, device="cpu")
    stream = StreamingAggregator(agg, max_batch=2, pool=pool)
    stream.submit_batch(np.zeros((2, 8, agg.n_limbs), np.uint32))
    stream.drain()
    assert pool.stats()["host_pages_in_use"] == 1 and pool.pinned_bytes() == 0
    stream.close()
    assert agg.nb_models == 2 and agg.stream is None and pool.balanced(LOCAL_TENANT)


def test_mesh_entry_points_default_to_cuda_and_raise_without_it(no_cuda, monkeypatch):
    """A mesh given no devices spans the visible cards, the coordinator's
    and the multi-process aggregator's too: without CUDA they raise. A mesh
    of the CPU device repeated runs the shard-parallel pipeline without
    reaching the CUDA runtime."""
    from xaynet_tpu_torch.parallel.mesh import make_mesh, serve_mesh
    from xaynet_tpu_torch.parallel.multihost import MultiHostAggregator

    for call in (make_mesh, lambda: serve_mesh("cuda"), lambda: make_mesh(["cuda:0"]),
                 lambda: MultiHostAggregator(PAIR.vect, 8),
                 lambda: SimRound(SimSpec(PAIR, 8), mesh=["cuda"]),
                 lambda: StagedAggregator(PAIR, 8, mesh=["cuda"] * 2)):  # fmt: skip
        with pytest.raises(DeviceUnavailable, match="no CUDA device"):
            call()

    def no_cudart():
        raise AssertionError("the CPU path reached the CUDA runtime")

    monkeypatch.setattr(torch.cuda, "cudart", no_cudart)
    pool = PagePool(page_bytes=4096, slab_pages=4)
    agg = DeviceAggregator(PAIR.vect, 8, mesh=["cpu"] * 2, tenant="t", pool=pool)
    stream = StreamingAggregator(agg, max_batch=2, pool=pool)
    stream.submit_batch(np.zeros((2, 8, agg.n_limbs), np.uint32))
    stream.drain()
    assert stream._sharded and pool.pinned_bytes() == 0
    assert pool.device_pages_by_device() == {"cpu": 2}  # one page per shard's slice
    stream.close()
    agg.release_plan_pages()
    assert agg.nb_models == 2 and pool.balanced(LOCAL_TENANT) and pool.balanced("t")


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


# the wire-ingest path, the coordinator's and the participant's: every
# module of the port's host, server and SDK packages, each imported on its own
_ALONE = sorted(
    {
        "xaynet_tpu_torch.core.mask.serialization",
        "xaynet_tpu_torch.core.mask.object",
        "xaynet_tpu_torch.parallel.aggregator",
        "xaynet_tpu_torch.parallel.mesh",
        "xaynet_tpu_torch.parallel.multihost",
        "xaynet_tpu_torch.parallel.shards",
        "xaynet_tpu_torch.parallel.streaming",
        "xaynet_tpu_torch.server.aggregation",
        "xaynet_tpu_torch.ops.speculation",
    }
    | {
        m
        for m in _port_modules()
        if m.split(".")[1:2] in (["server"], ["core"], ["storage"], ["telemetry"],
                                 ["resilience"], ["utils"], ["sdk"], ["sim"], ["loadgen"],
                                 ["models"], ["examples"], ["tenancy"], ["ingest"], ["edge"])
    }
)  # fmt: skip

_IMPORT_EACH_ALONE = """
import importlib, json, os, sys
import numpy, torch
out = {}
for m in MODULES:
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            importlib.import_module(m)
            bad = sorted(k for k in sys.modules
                         if k.split(".")[0] in ("jax", "flax", "optax", "xaynet_tpu"))
        except BaseException as err:
            bad = ["import failed: %r" % (err,)]
        os.write(w, json.dumps(bad).encode())
        os._exit(0)
    os.close(w)
    with os.fdopen(r) as f:
        out[m] = json.loads(f.read())
    os.waitpid(pid, 0)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def imported_alone() -> dict:
    """Module -> what importing it alone pulled in of ``jax`` and the JAX
    package (or its import error). One fresh interpreter imports torch and
    numpy, then forks a child per module, so each child starts from an
    interpreter that holds nothing of the port."""
    proc = _run(f"MODULES = {_ALONE!r}\n" + _IMPORT_EACH_ALONE)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", _ALONE)
def test_wire_ingest_modules_import_alone_without_jax(module, imported_alone):
    """Each module on the wire-ingest path and the coordinator's, the
    several-device modules (``parallel.mesh``, ``shards``, ``multihost``,
    ``streaming``), every module of the port's ``server``, ``core``, ``storage``, ``telemetry``,
    ``resilience``, ``utils``, ``sdk``, ``sim``, ``loadgen``, ``models``,
    ``examples``, ``tenancy``, ``ingest`` and ``edge`` among them
    (``server.console`` and ``ops.speculation`` too), imported alone, pulls in neither ``jax``,
    ``flax``, ``optax`` nor the JAX package."""
    assert module in _port_modules()
    assert imported_alone[module] == []


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


def _device_round_settings() -> Settings:
    settings = Settings.default()
    settings.model.length = 8
    settings.aggregation.device = True
    return settings


def test_coordinator_device_round_without_cuda_raises(no_cuda):
    settings = _device_round_settings()
    store = runner.init_store(settings)
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        StateMachineInitializer(settings, store)
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        asyncio.run(runner.serve(settings))
    # [aggregation] device = false (the JAX package's host fold) runs on
    # CUDA as well in the port: no device given still means the card
    settings.aggregation.device = False
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        StateMachineInitializer(settings, store)
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        asyncio.run(runner.serve(settings))
    # a CPU device runs when asked
    for flag in (False, True):
        settings.aggregation.device = flag
        assert StateMachineInitializer(settings, store, device="cpu").device.type == "cpu"


def test_multi_tenant_coordinator_without_cuda_raises(no_cuda):
    """``serve`` with ``[tenancy] enabled`` and no device given resolves
    CUDA for every tenant, so without one it refuses before any tenant is
    built; a CPU device is taken when asked (the tests' way)."""
    settings = _device_round_settings()
    settings.tenancy.enabled = True
    settings.tenancy.tenants = ["t0", "t1"]
    settings.validate()
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        asyncio.run(runner.serve(settings))
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        asyncio.run(runner.serve_tenants(settings))


@pytest.mark.parametrize("tenancy", [False, True], ids=["alone", "tenancy"])
def test_ingest_coordinator_without_cuda_raises(no_cuda, tenancy):
    """The ingest pipeline runs no device code and adds no path around the
    device check: ``serve`` with ``[ingest] enabled`` and no device given
    refuses before any pipeline starts."""
    settings = _device_round_settings()
    settings.ingest.enabled = True
    if tenancy:
        settings.tenancy.enabled = True
        settings.tenancy.tenants = ["t0"]
    settings.validate()
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        asyncio.run(runner.serve(settings))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _assert_cli_refuses_without_cuda(cfg: Path) -> None:
    """``python -m xaynet_tpu_torch.server.runner -c cfg`` with no card
    exits with an error and never listens."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, whatever the machine
    proc = subprocess.run(
        [sys.executable, "-m", "xaynet_tpu_torch.server.runner", "-c", str(cfg)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )  # fmt: skip
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "REST API listening" not in proc.stderr


def test_runner_cli_refuses_device_round_without_cuda(tmp_path):
    """``python -m xaynet_tpu_torch.server.runner`` with ``device = true``
    exits with an error where there is no CUDA, instead of serving."""
    cfg = tmp_path / "config.toml"
    cfg.write_text(
        f'[api]\nbind_address = "127.0.0.1:{_free_port()}"\n'
        "[model]\nlength = 8\n[aggregation]\ndevice = true\n"
    )
    _assert_cli_refuses_without_cuda(cfg)


def test_runner_cli_refuses_shipped_config_without_cuda(tmp_path):
    """The shipped config (``[aggregation] device = false``, the JAX
    package's host fold) starts the port's coordinator on CUDA too: with no
    card the CLI exits with an error instead of folding on the CPU."""
    shipped = (REPO / "configs" / "config.toml").read_text()
    assert 'bind_address = "127.0.0.1:8081"' in shipped
    assert Settings.load(str(REPO / "configs" / "config.toml"), env={}).aggregation.device is False
    cfg = tmp_path / "config.toml"
    cfg.write_text(
        shipped.replace('"127.0.0.1:8081"', f'"127.0.0.1:{_free_port()}"')
        .replace('"./global_models"', f'"{tmp_path / "models"}"')
    )
    _assert_cli_refuses_without_cuda(cfg)
