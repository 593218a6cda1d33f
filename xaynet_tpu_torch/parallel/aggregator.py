"""Device-resident aggregation of masked updates on one device.

Port of ``xaynet_tpu/parallel/aggregator.py:ShardedAggregator`` for a single
device (the mesh, the shard plans and the host native fold are not part of
this package). The running aggregate is a device-resident planar
``uint32[L, model_len]`` tensor; masked updates are folded into it in
batches by kernel K1 (``ops.fold``), planar or packed byte-planar, and the
Unmask subtract runs against it in place of a host gather.

On CUDA the accumulator belongs to one stream of its own (``stream``):
every fold runs there, whichever thread calls it, so the streaming
pipeline's fold worker and the caller's thread never mutate ``acc``
unordered. Work the caller made on its own stream is ordered before a fold
that reads it (:meth:`on_stream`), and readers of ``acc`` wait for the
folds queued before them.

Device wire ingest: ``validate_wire_updates`` / ``validate_planar_updates``
take raw wire element blocks (v1 interleaved, v2 byte-planar), upload a
group in one copy and unpack + validity-check it on the card (kernels K3
and K4), so a coordinator never parses elements on the host; accepted rows
stay on the device until a flush folds them. The fused wire ingest
(``add_wire_batch``, ``dispatch_staged_bytes``) folds raw v1 element
blocks straight into the accumulator with kernel K6, leaving out the
members with an element >= the order: no planar batch exists on the
device, and the acceptance vector stays there until the caller fetches it.

With a ``tenant``, the accumulator's bytes go on the page pool's device
ledger (``tenancy.pool``) under that tenant when the accumulator is
allocated, and ``release_plan_pages`` gives them back (the round's Unmask
tail); one device has no shard plan, so the single accumulator is the
one lease. A GC finalizer backstops an aggregator dropped without the
release.

The reference analogue is rust/xaynet-server/src/state_machine/phases/
update.rs:119-152, one sequential big-int pass per accepted update.
"""

from __future__ import annotations

import weakref
from contextlib import contextmanager

import numpy as np
import torch

from ..core.mask.config import MaskConfig
from ..device import resolve_device
from ..ops import kernels
from ..ops import limbs as host_limbs
from ..ops.fold import (
    MAX_LAZY_BATCH,
    fold_packed_batch,
    fold_planar_batch,
    mod_sub_planar,
    planar_to_wire,
    to_device_u32,
    to_numpy_u32,
    wire_to_planar,
    zeros_u32,
)
from ..telemetry.registry import get_registry
from ..tenancy.pool import PagePool, get_pool

# what crosses to the device for the round's fold, by layout (the JAX
# package's family): the streaming pipeline's ring bytes (packed /
# unpacked) and, here, the raw wire blocks that device wire ingest uploads
BYTES_STAGED = get_registry().counter(
    "xaynet_bytes_staged_total",
    "Bytes copied into host staging rings (and later across host->device), "
    "by layout: packed = byte-planar wire-width planes, unpacked = full "
    "uint32 limb planes, wire = raw serialized element blocks, "
    "wire-planar = v2 byte-planar element blocks staged packed.",
    ("layout",),
)


def _release_leases(pool: PagePool, leases: list) -> None:
    """Module-level so an aggregator's GC finalizer holds no reference to it."""
    for lease in leases:
        pool.release(lease)


class DeviceAggregator:
    """Accumulates masked updates on one device (``cuda`` by default).

    ``kernel_used`` reports what folds the batches: ``"cuda"`` (kernel K1)
    on a CUDA device, ``"plain"`` (its plain torch version) on the CPU.
    ``_fold_fn`` / ``_packed_fold_fn`` are the fold seams (planar and
    packed batches): every fold goes through them, and a test may replace
    one on an instance, as with the JAX package's. Both fold in place.
    ``_wire_fold_fn`` is the fused wire ingest's seam (K6): it folds in
    place and returns the device acceptance vector.
    """

    def __init__(self, config: MaskConfig, model_length: int, device=None,
                 tenant: str | None = None, pool: PagePool | None = None):
        self.device = resolve_device(device)
        self.config = config
        self.model_length = model_length
        # one device: no mesh padding (the JAX package pads to the mesh size)
        self.padded_length = model_length
        self.order = config.order
        self.n_limbs = host_limbs.n_limbs_for_order(config.order)
        # the single-source-of-truth pack width (ops/limbs.wire_width_for)
        self.packed_width = host_limbs.wire_width_for(self.order)
        self.kernel_used = "cuda" if self.device.type == "cuda" else "plain"
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.reset()
        # the accumulator's device memory on the pool's ledger (a round's
        # aggregator; the sim and the SDK's helpers lease nothing)
        self.tenant = tenant
        self._pool = None
        self._leases: list = []
        if tenant is not None:
            self._pool = pool if pool is not None else get_pool()
            self._leases.append(
                self._pool.lease_device(tenant, self.n_limbs * self.padded_length * 4)
            )
            weakref.finalize(self, _release_leases, self._pool, self._leases)

    def release_plan_pages(self) -> None:
        """Give the accumulator's ledger pages back (the round's Unmask
        tail, once nothing reads ``acc`` any more). Idempotent."""
        if self._pool is not None:
            _release_leases(self._pool, self._leases)

    def _fold_fn(self, acc: torch.Tensor, staged: torch.Tensor) -> None:
        fold_planar_batch(acc, staged, self.order)

    def _packed_fold_fn(self, acc: torch.Tensor, staged: torch.Tensor) -> None:
        fold_packed_batch(acc, staged, self.n_limbs, self.order)

    def _wire_fold_fn(self, acc: torch.Tensor, staged: torch.Tensor) -> torch.Tensor:
        return kernels.wire_fold(acc, staged, self.order)[1]

    @contextmanager
    def on_stream(self, *inputs: torch.Tensor):
        """Run the enclosed work on the stream that owns ``acc`` (nothing to
        switch on the CPU). ``inputs`` are device tensors made on the
        caller's stream: the fold stream waits for the caller's work so far,
        and their memory is kept from reuse until the fold stream is past
        them."""
        if self.stream is None:
            yield
            return
        if inputs:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            for t in inputs:
                t.record_stream(self.stream)
        with torch.cuda.stream(self.stream):
            yield

    def _after_folds(self) -> None:
        """Order the caller's stream after every fold queued so far (before
        the caller reads ``acc``)."""
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def packed_staging_usable(self) -> bool:
        """Whether packed byte-planar staging shrinks anything: at the
        ``order == 2^(32L)`` boundary bpn == 4L and packing is a no-op."""
        return self.packed_width < 4 * self.n_limbs

    def add_batch(self, stack) -> None:
        """Fold wire-layout ``uint32[K, model_len, L]`` host updates."""
        stack = np.asarray(stack, dtype=np.uint32)
        if stack.ndim != 3 or stack.shape[2] != self.n_limbs:
            raise ValueError("expected uint32[K, model_len, L]")
        if stack.shape[1] != self.model_length:
            raise ValueError("model length mismatch")
        if stack.shape[0] > MAX_LAZY_BATCH:
            raise ValueError("batch too large for lazy-carry fold")
        self.add_planar_batch(to_device_u32(wire_to_planar(stack), self.device))

    def add_planar_batch(self, stack_planar: torch.Tensor) -> None:
        """Fold a device-resident planar ``uint32[K, L, model_len]`` batch."""
        with self.on_stream(stack_planar):
            self._fold_fn(self.acc, stack_planar)
        self.nb_models += stack_planar.shape[0]

    def add_packed_batch(self, packed: torch.Tensor) -> None:
        """Fold a device-resident packed byte-planar ``uint8[K, bpn, model_len]``
        batch (K1's packed variant: limbs assemble inside the fold)."""
        with self.on_stream(packed):
            self._packed_fold_fn(self.acc, packed)
        self.nb_models += packed.shape[0]

    def _check_raw(self, raw) -> np.ndarray:
        """Raw v1 wire element blocks ``uint8[K, model_len * bpn]`` (the
        checks of the JAX ``_stage_raw_bytes``; one device has no padding)."""
        raw = np.asarray(raw)
        if raw.dtype != np.uint8 or raw.ndim != 2 or raw.shape[1] != (
            self.model_length * self.packed_width
        ):
            raise ValueError("expected uint8[K, model_len * bytes_per_number]")
        if raw.shape[0] > MAX_LAZY_BATCH:
            raise ValueError("batch too large for lazy-carry fold")
        return raw

    def add_wire_batch(self, raw) -> np.ndarray:
        """Fold RAW wire element blocks ``uint8[K, model_len * bpn]``: the
        serialized little-endian element blocks go up as they are and are
        checked and folded on the device in one K6 launch, so the
        coordinator never parses an element on the host.

        Validity is per update: an update with any element >= the group
        order is left out of the fold and not counted in ``nb_models``
        (the reference rejects such a message before its seed-dict
        insert). Returns the ``bool[K]`` acceptance vector."""
        raw = self._check_raw(raw)
        BYTES_STAGED.labels(layout="wire").inc(raw.nbytes)
        staged = torch.from_numpy(raw).to(self.device)
        ok = self.dispatch_staged_bytes(staged)
        with self.on_stream():
            ok_host = ok.cpu().numpy()  # the acceptance fetch, its one sync
        self.nb_models += int(ok_host.sum())
        return ok_host

    def dispatch_staged_bytes(self, staged: torch.Tensor) -> torch.Tensor:
        """Check and fold a device-resident raw-byte batch WITHOUT fetching
        the acceptance vector: returns the device ``bool[K]`` ``ok``. The
        caller owns the deferred accounting: it must fetch the vector and
        credit ``nb_models`` (what ``add_wire_batch`` does at once,
        and the streaming pipeline once per drain)."""
        with self.on_stream(staged):
            return self._wire_fold_fn(self.acc, staged)

    @staticmethod
    def _verdicts(bad: torch.Tensor) -> list[bool]:
        """The group's acceptance, fetched to the host (its one sync)."""
        return [v == 0 for v in bad.view(torch.int32).tolist()]

    def validate_wire_updates(self, raws) -> list:
        """Unpack and validity-check a GROUP of raw v1 wire updates in one
        device round trip: one upload, one K3 launch, one fetch of the
        verdicts. Returns a list parallel to ``raws``: the device planar
        ``uint32[L, model_len]`` row of each accepted update, ``None`` for
        each with an element >= the group order (reference ordering: the
        caller validates BEFORE the seed-dict insert, update.rs:119-152).
        Kernels here compile once, not per shape, so unlike the JAX package
        the group is not padded to a power of two."""
        if not raws:
            return []
        block = self._check_raw(np.stack([np.asarray(r) for r in raws]))
        BYTES_STAGED.labels(layout="wire").inc(block.nbytes)
        planar, bad = kernels.wire_unpack(torch.from_numpy(block).to(self.device), self.order)
        return [planar[i] if ok else None for i, ok in enumerate(self._verdicts(bad))]

    def validate_planar_updates(self, raws) -> list:
        """Wire-v2 twin of :meth:`validate_wire_updates`: one upload, one K4
        launch and one fetch of the verdicts for a group of byte-planar
        element blocks. The upload IS the packed layout, and the returned
        rows are slices of it (``uint8[bpn, model_len]``), ``None`` for the
        members with an element >= the group order. Not padded to a power
        of two either."""
        if not raws:
            return []
        block = np.stack([np.asarray(r) for r in raws])
        if block.dtype != np.uint8 or block.ndim != 3 or block.shape[1:] != (
            self.packed_width,
            self.model_length,
        ):
            raise ValueError("expected uint8[K, bytes_per_number, model_len]")
        if block.shape[0] > MAX_LAZY_BATCH:
            raise ValueError("batch too large for lazy-carry fold")
        BYTES_STAGED.labels(layout="wire-planar").inc(block.nbytes)
        staged = torch.from_numpy(block).to(self.device)
        bad = kernels.packed_check(staged, self.order)
        return [staged[i] if ok else None for i, ok in enumerate(self._verdicts(bad))]

    def mask_planar(self, mask_vect) -> torch.Tensor:
        """An aggregated host mask (wire ``[n, L]`` or planar ``[L, n]``) as a
        planar tensor on this device."""
        mask = np.asarray(mask_vect, dtype=np.uint32)
        if mask.shape == (self.model_length, self.n_limbs):
            mask = wire_to_planar(mask)
        if mask.shape != (self.n_limbs, self.model_length):
            raise ValueError("mask shape matches neither the wire nor the planar layout")
        return to_device_u32(mask, self.device)

    def unmask_limbs(self, mask_vect) -> np.ndarray:
        """Subtract the aggregated mask on the device; returns the unmasked
        host wire ``uint32[model_len, L]`` (the only accumulator download)."""
        self._after_folds()
        out = mod_sub_planar(self.acc, self.mask_planar(mask_vect), self.order)
        return planar_to_wire(to_numpy_u32(out))

    def snapshot(self) -> np.ndarray:
        """Host wire-layout copy of the aggregate (checkpoints / tests)."""
        self._after_folds()
        return planar_to_wire(to_numpy_u32(self.acc))

    def restore(self, wire: np.ndarray, nb_models: int) -> None:
        """Restore from a host wire-layout snapshot."""
        wire = np.asarray(wire, dtype=np.uint32)
        if wire.shape != (self.model_length, self.n_limbs):
            raise ValueError("snapshot shape does not match the aggregator")
        # made on the fold stream, so its memory is only ever reused in
        # that stream's order
        with self.on_stream():
            self.acc = to_device_u32(wire_to_planar(wire), self.device)
        self.nb_models = nb_models

    def reset(self) -> None:
        with self.on_stream():
            self.acc = zeros_u32((self.n_limbs, self.model_length), self.device)
        self.nb_models = 0
