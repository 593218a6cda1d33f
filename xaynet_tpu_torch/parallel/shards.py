"""Per-shard decomposition of the aggregation accumulator.

Port of ``xaynet_tpu/parallel/shards.py`` for device plans. A
:class:`ShardPlan` splits a :class:`~.aggregator.DeviceAggregator`'s planar
accumulator ``uint32[L, padded]`` into one accumulator per mesh entry, each
over that entry's contiguous model-axis column slice
(``mesh.shard_slices``), on its device, with a CUDA stream of its own. The
streaming pipeline runs one fold worker per shard over them, and each
shard's copies and folds overlap the other shards' (on one card as on
several: each shard's stream is its own).

Exactness: the fold is an exact modular sum and the model axis is
embarrassingly parallel, so any decomposition of the columns folds to the
byte-identical aggregate; a shard two batches ahead of another changes
nothing once every shard has folded every batch, which the pipeline's
per-batch commit guarantees.

K1 and K6 fold IN PLACE on each shard's accumulator. Every mutation of
shard ``d``'s accumulator holds ``locks[d]``: the shard's worker folds
while the thread that commits a wire batch subtracts back its rejected
members, and on the CPU those run synchronously on one tensor. On CUDA the
lock orders only the launches, which the shard's stream then runs in turn.

Ownership: while a plan is adopted (``DeviceAggregator.adopt_plan``) its
per-shard accumulators ARE the aggregate; ``reassemble()`` reads them into
one tensor on the mesh's first device, and an explicit write of the
aggregator's accumulator (restore, reset) supersedes the plan.

Each shard's accumulator is leased from the page pool's device ledger under
the aggregator's tenant, on its own card (``PagePool.lease_device``), so a
mesh over several cards charges each card its slice. The JAX package's
native-u64 host backend and its thread budget are not ported.
"""

from __future__ import annotations

import threading
import weakref
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from ..ops import kernels
from ..ops.fold import to_device_u32, zeros_u32
from .mesh import shard_slices


def on_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` contiguous on ``device`` (a copy only where it is not already)."""
    if not t.is_contiguous():
        t = t.contiguous()
    return t if t.device == device else t.to(device)


class ShardPlan:
    """Per-shard accumulators of one aggregator, and their folds.

    The accumulators start from the aggregator's global accumulator (one
    slice copied to each shard), from zeros (``zero_accs``), or from host
    journal ``planes`` (``uint32[L, width]`` each, in shard order: the
    shard-exact restore).
    """

    def __init__(self, agg, zero_accs: bool = False, planes: list | None = None):
        # weak: the aggregator holds its adopted plan, and a cycle would
        # leave both (and the shards' device memory) to the cyclic collector
        self._agg = weakref.ref(agg)
        self.devices = list(agg.mesh)
        self.n_shards = len(self.devices)
        self.slices = shard_slices(agg.padded_length, self.n_shards)
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in self.devices]
        self.locks = [threading.Lock() for _ in self.devices]
        src = None
        if planes is None and not zero_accs:
            agg._after_folds()
            src = agg._acc
        self.accs: list[torch.Tensor] = []
        for d, (lo, hi) in enumerate(self.slices):
            dev = self.devices[d]
            with self.on_stream(d, *([src] if src is not None else [])):
                if planes is not None:
                    acc = to_device_u32(np.ascontiguousarray(planes[d], dtype=np.uint32), dev)
                elif src is None:
                    acc = zeros_u32((agg.n_limbs, hi - lo), dev)
                else:
                    acc = src[:, lo:hi].to(dev, copy=True).contiguous()
            self.accs.append(acc)
        self._pool = agg._pool
        self._leases: list = []
        if self._pool is not None:
            for (lo, hi), dev in zip(self.slices, self.devices):
                self._leases.append(
                    self._pool.lease_device(agg.tenant, agg.n_limbs * (hi - lo) * 4, str(dev))
                )
            weakref.finalize(self, self._pool.release_soon, self._leases)

    @property
    def agg(self):
        return self._agg()

    def release_pages(self) -> None:
        """Give every shard's ledger pages back (idempotent)."""
        if self._pool is not None:
            for lease in self._leases:
                self._pool.release(lease)

    # -- streams -----------------------------------------------------------

    @contextmanager
    def on_stream(self, d: int, *inputs: torch.Tensor):
        """Run the enclosed work on shard ``d``'s stream, its device current
        (nothing to switch on the CPU). The stream first waits for the work
        the caller queued on the streams that made ``inputs``, and inputs on
        the shard's device are kept from reuse until its stream is past
        them."""
        stream = self.streams[d]
        if stream is None:
            yield
            return
        dev = self.devices[d]
        with torch.cuda.device(dev):
            for t in inputs:
                stream.wait_stream(torch.cuda.current_stream(t.device))
                if t.device == dev:
                    t.record_stream(stream)
            with torch.cuda.stream(stream):
                yield

    def after(self, d: int, device: torch.device) -> None:
        """Order ``device``'s current stream after every fold queued on shard
        ``d`` so far (before it reads the shard's accumulator)."""
        if self.streams[d] is not None:
            torch.cuda.current_stream(device).wait_stream(self.streams[d])

    def synchronize(self) -> None:
        """Wait for every shard's queued work (the drain barrier); a fold
        that failed on the device raises here."""
        for stream in self.streams:
            if stream is not None:
                stream.synchronize()

    # -- folds ---------------------------------------------------------------

    def fold(self, d: int, batch: torch.Tensor, packed: bool = False) -> None:
        """Fold shard ``d``'s slice of a batch, planar ``uint32[K, L, width]``
        or packed ``uint8[K, bpn, width]`` on any device, into its
        accumulator through the aggregator's fold seams (K1), in place."""
        agg = self.agg
        fold = agg._packed_fold_fn if packed else agg._fold_fn
        with self.locks[d], self.on_stream(d, batch):
            fold(self.accs[d], on_device(batch, self.devices[d]))

    def wire_fold(self, d: int, raw: torch.Tensor) -> torch.Tensor:
        """K6 over shard ``d``'s byte slice ``uint8[K, width * bpn]`` of a v1
        wire batch, on the shard's device: its members' in-range elements
        folded, each member with an element >= the order on this slice left
        out. Returns the shard's device ``bool[K]`` verdicts, unfetched;
        ``raw`` stays the caller's until :meth:`settle_wire` has read it."""
        with self.locks[d], self.on_stream(d, raw):
            return self.agg._wire_fold_fn(self.accs[d], raw)

    def settle_wire(self, raws: list, oks: list, reduce=None) -> torch.Tensor:
        """The cross-shard verdict of a wire batch each shard folded with
        :meth:`wire_fold`: a member rejected on ANY shard is rejected on
        every shard. Each shard's verdicts are fetched after its K6 (the
        streaming pipeline's workers have waited for their folds by then),
        the drop vector is their OR (``reduce``, when given, combines that
        host ``bool[K]`` across processes too), and each shard that folded
        a member another one rejected subtracts it back with K6's
        subtract-back pass (``kernels.wire_unfold``; no launch on a shard
        with nothing to take back). ``raws`` are the shards' byte slices as
        :meth:`wire_fold` read them. Returns the batch's acceptance, a host
        ``bool[K]``. The verdicts cross devices through the host, so a mesh
        over several cards needs no peer copy."""
        oks_host = []
        for d, ok in enumerate(oks):
            with self.on_stream(d):
                oks_host.append(ok.cpu())
        drop = ~torch.stack(oks_host).all(dim=0)
        if reduce is not None:
            drop = reduce(drop)
        for d, (raw, ok) in enumerate(zip(raws, oks_host)):
            extra = drop & ok
            if extra.any():
                with self.locks[d], self.on_stream(d):
                    kernels.wire_unfold(self.accs[d], raw, extra.to(self.devices[d]),
                                        self.agg.order)  # fmt: skip
        return ~drop

    # -- reassembly ------------------------------------------------------------

    def reassemble(self) -> torch.Tensor:
        """The global planar accumulator ``uint32[L, padded]`` read from the
        shards into one tensor on the mesh's first device (a READ: the plan
        stays authoritative and keeps folding into its shards)."""
        dev0 = self.devices[0]
        with torch.cuda.device(dev0) if dev0.type == "cuda" else nullcontext():
            for d in range(self.n_shards):
                self.after(d, dev0)
            # uint32 rides as int32 through the copy (the same bits)
            parts = [acc.view(torch.int32).to(dev0) for acc in self.accs]
            return torch.cat(parts, dim=1).view(torch.uint32)
