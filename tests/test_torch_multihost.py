"""The port's multi-process ingest (``parallel.multihost``) on gloo, on the CPU.

After ``tests/test_multihost.py``: two processes form a ``torch.distributed``
group (gloo, over a TCP store on 127.0.0.1), each a "host" with a local
mesh of 4 CPU shards (``[cpu] * 4``: 8 shards in all, as the JAX worker's
8-device global mesh), at the JAX worker's shapes: model length 1000,
K = 6. Each stages
only its slice; the unmasked slice and the wire leg's slice must equal the
JAX package's single-process ``MultiHostAggregator`` (its global mesh over
``conftest.py``'s 8 virtual CPU devices) on the same inputs, byte for byte.
The wire leg's invalid element is the model's last, in the last process's
slice only: the all-reduced verdict must read ``[True] * 6 + [False]`` on
every process.

The worker is this file run as a script (it imports the port alone, no
JAX); each spawn has its own timeout, so a group that does not form fails
the test instead of hanging the suite.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
MODEL_LEN, K, SHARDS_PER_PROCESS = 1000, 6, 4
TIMEOUT_S = 120


def _inputs(order: int, n_limb: int):
    """The JAX worker's data: valid group elements, the same on every process."""
    rng = np.random.default_rng(123)
    top = int(order >> 32)
    wire = rng.integers(0, 1 << 32, size=(K, MODEL_LEN, n_limb), dtype=np.uint32)
    wire[:, :, n_limb - 1] = rng.integers(0, top, size=(K, MODEL_LEN), dtype=np.uint32)
    mask = rng.integers(0, 1 << 32, size=(MODEL_LEN, n_limb), dtype=np.uint32)
    mask[:, n_limb - 1] = rng.integers(0, top, size=MODEL_LEN, dtype=np.uint32)
    return wire, mask


def _raw_with_bad(wire: np.ndarray, bpn: int, limbs_to_bytes_le) -> np.ndarray:
    """The K updates' v1 blocks plus one whose LAST element is >= the order."""
    bad = wire[0].copy()
    bad[MODEL_LEN - 1] = np.iinfo(np.uint32).max
    stack = np.concatenate([wire, bad[None]], axis=0)
    return np.stack([np.frombuffer(limbs_to_bytes_le(stack[i], bpn), dtype=np.uint8)
                     for i in range(K + 1)])  # fmt: skip


def worker(port: int, rank: int, n_procs: int, out: str, device: str = "cpu") -> None:
    """One process of the group: ``SHARDS_PER_PROCESS`` CPU shards, or one
    shard on ``device`` when that is a card (the processes share it)."""
    import torch

    sys.path.insert(0, str(REPO))
    from xaynet_tpu_torch.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
    from xaynet_tpu_torch.ops import limbs as host_limbs
    from xaynet_tpu_torch.parallel.multihost import MultiHostAggregator, initialize, process_count

    torch.set_num_threads(1)
    initialize(f"127.0.0.1:{port}", num_processes=n_procs, process_id=rank, timeout_s=TIMEOUT_S)
    assert process_count() == n_procs
    config = MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6)
    wire, mask = _inputs(config.order, host_limbs.n_limbs_for_order(config.order))
    cpu = [torch.device("cpu")] * SHARDS_PER_PROCESS if device == "cpu" else [device]
    if device != "cpu":
        torch.cuda.set_device(torch.device(device))

    agg = MultiHostAggregator(config, MODEL_LEN, mesh=cpu)
    lo, hi = agg.local_slice
    agg.add_local_batch(wire[:, lo:hi, :])
    assert agg.nb_models == K
    unmasked = agg.unmask_local(mask[lo:hi])

    bpn = config.bytes_per_number
    raw = _raw_with_bad(wire, bpn, host_limbs.limbs_to_bytes_le)
    agg2 = MultiHostAggregator(config, MODEL_LEN, mesh=cpu)
    ok = agg2.add_local_wire_batch(raw[:, lo * bpn : hi * bpn])
    np.savez(out, lo=lo, hi=hi, unmasked=unmasked, wire_slice=agg2.snapshot_local(), ok=ok,
             nb=agg2.nb_models)  # fmt: skip
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_reference():
    """The JAX single-process aggregator on the same inputs."""
    from xaynet_tpu.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
    from xaynet_tpu.ops import limbs as jax_limbs
    from xaynet_tpu.parallel.multihost import MultiHostAggregator

    config = MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6)
    wire, mask = _inputs(config.order, jax_limbs.n_limbs_for_order(config.order))
    agg = MultiHostAggregator(config, MODEL_LEN)
    assert agg.local_slice == (0, MODEL_LEN)
    agg.add_local_batch(wire)
    unmasked = agg.unmask_local(mask)
    agg2 = MultiHostAggregator(config, MODEL_LEN)
    ok = agg2.add_local_wire_batch(_raw_with_bad(wire, config.bytes_per_number,
                                                 jax_limbs.limbs_to_bytes_le))  # fmt: skip
    return unmasked, agg2.snapshot_local(), ok, agg2.nb_models


def test_two_process_gloo_ingest_matches_jax_multihost(tmp_path):
    n_procs = 2
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(port), str(rank), str(n_procs),
             str(tmp_path / f"rank{rank}.npz")],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )  # fmt: skip
        for rank in range(n_procs)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    unmasked, wire_acc, ok, nb = _jax_reference()
    assert ok.tolist() == [True] * K + [False] and nb == K
    covered = []
    for rank in range(n_procs):
        got = np.load(tmp_path / f"rank{rank}.npz")
        lo, hi = int(got["lo"]), int(got["hi"])
        covered.append((lo, hi))
        assert np.array_equal(got["unmasked"], unmasked[lo:hi])
        assert np.array_equal(got["wire_slice"], wire_acc[lo:hi])
        assert got["ok"].tolist() == ok.tolist()  # the same verdict on every process
        assert int(got["nb"]) == K
    assert covered == [(0, 500), (500, MODEL_LEN)]


def test_single_process_multihost_aggregator_matches_jax():
    """One process: ``initialize`` is a no-op and the aggregator owns the
    whole model on its local mesh."""
    import torch

    from xaynet_tpu_torch.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
    from xaynet_tpu_torch.ops import limbs as host_limbs
    from xaynet_tpu_torch.parallel.multihost import MultiHostAggregator, initialize

    initialize(None, num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()
    config = MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6)
    wire, mask = _inputs(config.order, host_limbs.n_limbs_for_order(config.order))
    unmasked, wire_acc, ok, nb = _jax_reference()
    for shards in (1, 8):
        agg = MultiHostAggregator(config, MODEL_LEN, mesh=[torch.device("cpu")] * shards)
        assert agg.local_slice == (0, MODEL_LEN)
        agg.add_local_batch(wire)
        assert np.array_equal(agg.unmask_local(mask), unmasked)
        agg2 = MultiHostAggregator(config, MODEL_LEN, mesh=[torch.device("cpu")] * shards)
        raw = _raw_with_bad(wire, config.bytes_per_number, host_limbs.limbs_to_bytes_le)
        assert agg2.add_local_wire_batch(raw).tolist() == ok.tolist()
        assert np.array_equal(agg2.snapshot_local(), wire_acc) and agg2.nb_models == nb


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], *sys.argv[5:6])
    print(json.dumps({"worker": int(sys.argv[2]), "ok": True}), flush=True)
