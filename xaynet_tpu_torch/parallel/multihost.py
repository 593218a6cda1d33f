"""Multi-process sharded aggregation: each process ingests only its model slice.

Port of ``xaynet_tpu/parallel/multihost.py`` on ``torch.distributed``. The
aggregation is elementwise over the model axis, so several processes are a
placement problem, not a communication problem: every process owns a
contiguous slice ``[lo, hi)`` of the padded model axis, parses and stages
only that slice of each update, and folds it on its own devices (its local
mesh, one shard per entry). No bulk data crosses processes. The one
collective is the per-update verdict of a raw wire batch (the JAX
package's psum over the model axis): each process checks and folds its
byte slice with K6, the ``bool[K]`` drop vectors are all-reduced (MAX), and
every process subtracts back, with K6's subtract-back pass, the members
another process rejected, so the acceptance vector is the same on every
process.

The process group uses the **gloo** backend on CPU tensors, over a TCP
store: it needs no NCCL, and several processes may share one card (each
with its own CUDA context), which NCCL refuses.

Usage (one process per host or per card, every process runs the same
program)::

    from xaynet_tpu_torch.parallel.multihost import initialize, MultiHostAggregator
    initialize("host0:29500", num_processes=N, process_id=i)
    agg = MultiHostAggregator(config, model_length)   # local mesh: visible cards
    lo, hi = agg.local_slice                          # this process's [lo, hi)
    agg.add_local_batch(wire[:, lo:hi, :])
    out_local = agg.unmask_local(mask_wire[lo:hi, :])
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.mask.config import MaskConfig
from .aggregator import DeviceAggregator
from .mesh import make_mesh, pad_to_multiple, shard_slices


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = 300.0,
) -> None:
    """Join the process group (a no-op for one process): gloo over the TCP
    store at ``coordinator_address`` (``host:port`` or ``tcp://host:port``;
    rank 0 listens there). A group that cannot form within ``timeout_s``
    raises."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("several processes need the coordinator address and a process id")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=url, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s))  # fmt: skip


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _all_reduce_drop(drop: torch.Tensor) -> torch.Tensor:
    """The per-update drop vector ORed over every process (gloo, CPU)."""
    flags = drop.to(torch.int32)
    dist.all_reduce(flags, op=dist.ReduceOp.MAX)
    return flags.bool()


class MultiHostAggregator:
    """Sharded aggregation where each process feeds only its model slice.

    ``mesh`` is this process's devices (default: its visible cards), one
    shard each; every process must have as many (checked with one
    all-gather). The padded model length divides evenly over all the
    processes' shards, so each process owns a contiguous
    ``padded / num_processes`` slice of the model axis, which its local
    mesh splits again.
    """

    def __init__(self, config: MaskConfig, model_length: int, mesh=None):
        self.mesh = make_mesh(mesh)
        n_proc, rank = process_count(), process_index()
        n_local = len(self.mesh)
        if n_proc > 1:
            counts = [torch.zeros(1, dtype=torch.int64) for _ in range(n_proc)]
            dist.all_gather(counts, torch.tensor([n_local], dtype=torch.int64))
            if any(int(c) != n_local for c in counts):
                raise ValueError("every process must contribute the same number of devices")
        self.model_length = model_length
        self.padded_length = pad_to_multiple(model_length, n_proc * n_local)
        self._lo_padded, self._hi_padded = shard_slices(self.padded_length, n_proc)[rank]
        width = self._hi_padded - self._lo_padded
        # this process's padded slice is its aggregator's whole model (the
        # last process's slice holds the padding columns)
        self.agg = DeviceAggregator(config, width, mesh=self.mesh)
        self.n_limbs = self.agg.n_limbs
        self._reduce = _all_reduce_drop if n_proc > 1 else None

    @property
    def local_slice(self) -> tuple[int, int]:
        """This process's [lo, hi) of the REAL (unpadded) model axis."""
        return min(self._lo_padded, self.model_length), min(self._hi_padded, self.model_length)

    @property
    def nb_models(self) -> int:
        return self.agg.nb_models

    def _pad_rows(self, arr: np.ndarray, axis: int, per_element: int = 1) -> np.ndarray:
        """Zero-pad this process's slice out to its padded slice width
        (``per_element`` entries of ``axis`` to an element)."""
        want = self.agg.model_length * per_element - arr.shape[axis]
        if want == 0:
            return arr
        pad = [(0, 0)] * arr.ndim
        pad[axis] = (0, want)
        return np.pad(arr, pad)

    def add_local_batch(self, local_wire: np.ndarray) -> None:
        """Fold a batch given only this process's slice, ``uint32[K, hi-lo,
        L]`` (K1 on each local shard). Every process calls it with the same
        K."""
        arr = np.asarray(local_wire, dtype=np.uint32)
        lo, hi = self.local_slice
        if arr.ndim != 3 or arr.shape[1:] != (hi - lo, self.n_limbs):
            raise ValueError(f"expected uint32[K, {hi - lo}, {self.n_limbs}] (this process's slice)")
        self.agg.add_batch(self._pad_rows(arr, 1))

    def add_local_wire_batch(self, local_raw: np.ndarray) -> np.ndarray:
        """Fold RAW wire bytes given only this process's element slice,
        ``uint8[K, (hi-lo) * bpn]`` (element-aligned: a process's slice is
        whole elements): K6 on each local shard's byte slice, the verdicts
        all-reduced over the processes, and every member another process
        (or shard) rejected subtracted back. Every process calls it with
        the same K. Returns the ``bool[K]`` acceptance vector, the same on
        every process."""
        bpn = self.agg.packed_width
        raw = np.asarray(local_raw)
        lo, hi = self.local_slice
        if raw.dtype != np.uint8 or raw.ndim != 2 or raw.shape[1] != (hi - lo) * bpn:
            raise ValueError(f"expected uint8[K, {(hi - lo) * bpn}] (this process's wire slice)")
        return self.agg.add_wire_batch(self._pad_rows(raw, 1, bpn), reduce=self._reduce)

    def unmask_local(self, local_mask_wire: np.ndarray) -> np.ndarray:
        """Subtract the aggregated mask (this process's slice only) on the
        local shards and return the unmasked wire slice ``uint32[hi-lo, L]``
        (the per-slice subtract of the JAX ``p_mod_sub``)."""
        lo, hi = self.local_slice
        mask = np.asarray(local_mask_wire, dtype=np.uint32)
        if mask.shape != (hi - lo, self.n_limbs):
            raise ValueError(f"expected uint32[{hi - lo}, {self.n_limbs}] (this process's slice)")
        return self.agg.unmask_limbs(self._pad_rows(mask, 0))[: hi - lo]

    def snapshot_local(self) -> np.ndarray:
        """This process's wire-layout slice of the aggregate."""
        lo, hi = self.local_slice
        return self.agg.snapshot()[: hi - lo]
