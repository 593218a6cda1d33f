"""Device-resident aggregation of masked updates, over a mesh of devices.

Port of ``xaynet_tpu/parallel/aggregator.py:ShardedAggregator`` (the host
native fold is not part of this package). The running aggregate is a
device-resident planar ``uint32[L, padded_len]`` tensor; masked updates are
folded into it in batches by kernel K1 (``ops.fold``), planar or packed
byte-planar, and the Unmask subtract runs against it in place of a host
gather.

**Meshes.** ``mesh`` (``parallel.mesh.make_mesh``) is a tuple of devices,
one shard each; without one the aggregator runs on one ``device``, as
before. The model axis is padded to a multiple of the mesh size
(``padded_length``). On a mesh of several shards the accumulator is a
:class:`~.shards.ShardPlan`: one accumulator per shard, over its column
slice, on its device and stream. Every fold entry point slices its batch
per shard and folds each slice there; ``acc`` reassembles the shards on
the mesh's first device on demand (a read), and only ``restore``/``reset``
write the global accumulator, which the next fold splits into a new plan.
The Unmask subtract runs per shard (:meth:`unmask_limbs`,
:meth:`unmask_shard`): every shard's subtract is queued before the first
result is fetched, and only the unmasked slices cross to the host. The
journal reads and writes the shards' planes (:meth:`snapshot_shards`,
:meth:`restore_shards`).

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
tail): on one device the single accumulator is the one lease, on a mesh
each shard's accumulator is one, on its card. A GC finalizer backstops an
aggregator dropped without the release.

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
from .mesh import make_mesh, pad_to_multiple, shard_slices
from .shards import ShardPlan, on_device

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


class DeviceAggregator:
    """Accumulates masked updates on one device (``cuda`` by default) or over
    a ``mesh`` of devices, one shard each.

    ``kernel_used`` reports what folds the batches: ``"cuda"`` (kernel K1)
    on a CUDA device, ``"plain"`` (its plain torch version) on the CPU.
    ``_fold_fn`` / ``_packed_fold_fn`` are the fold seams (planar and
    packed batches): every fold goes through them, each shard's too, and a
    test may replace one on an instance, as with the JAX package's. Both
    fold in place. ``_wire_fold_fn`` is the fused wire ingest's seam (K6):
    it folds in place and returns the device acceptance vector.
    """

    def __init__(self, config: MaskConfig, model_length: int, device=None,
                 tenant: str | None = None, pool: PagePool | None = None, mesh=None):
        if mesh is None:
            self.mesh = (resolve_device(device),)
        else:
            self.mesh = make_mesh(mesh)
            if device is not None and torch.device(device) != self.mesh[0]:
                raise ValueError(f"device {device} is not the mesh's first device {self.mesh[0]}")
        self.device = self.mesh[0]
        self.n_shards = len(self.mesh)
        self.config = config
        self.model_length = model_length
        self.padded_length = pad_to_multiple(model_length, self.n_shards)
        self.order = config.order
        self.n_limbs = host_limbs.n_limbs_for_order(config.order)
        # the single-source-of-truth pack width (ops/limbs.wire_width_for)
        self.packed_width = host_limbs.wire_width_for(self.order)
        self.kernel_used = "cuda" if self.device.type == "cuda" else "plain"
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # the accumulator's device memory on the pool's ledger (a round's
        # aggregator; the sim and the SDK's helpers lease nothing)
        self.tenant = tenant
        self._pool = None
        self._leases: list = []
        if tenant is not None:
            self._pool = pool if pool is not None else get_pool()
        # exactly one of the two holds the aggregate: the global
        # accumulator, or (on a mesh of several shards) the adopted plan
        self._acc: torch.Tensor | None = None
        self._live_plan: ShardPlan | None = None
        self.reset()
        if tenant is not None and self.n_shards == 1:
            self._leases.append(self._pool.lease_device(
                tenant, self.n_limbs * self.padded_length * 4, str(self.device)
            ))
            weakref.finalize(self, self._pool.release_soon, self._leases)

    # -- the accumulator and its shard plan ------------------------------

    @property
    def acc(self) -> torch.Tensor:
        """The global planar accumulator ``uint32[L, padded_len]``. With an
        adopted shard plan this READ reassembles the shards on the mesh's
        first device."""
        plan = self._live_plan
        return plan.reassemble() if plan is not None else self._acc

    @acc.setter
    def acc(self, value: torch.Tensor) -> None:
        # an explicit accumulator write supersedes an adopted plan
        self._drop_plan()
        self._acc = value

    def _drop_plan(self) -> None:
        plan, self._live_plan = self._live_plan, None
        if plan is not None:
            plan.release_pages()

    def adopt_plan(self, plan: ShardPlan) -> None:
        """Adopt ``plan`` as the authoritative accumulator (the global one
        is dropped: its slices live in the plan now)."""
        self._live_plan = plan
        self._acc = None

    def ensure_plan(self) -> ShardPlan | None:
        """The adopted shard plan, split from the global accumulator if a
        restore wrote one since; None on a one-shard mesh."""
        if self.n_shards == 1:
            return None
        if self._live_plan is None:
            self.adopt_plan(ShardPlan(self))
        return self._live_plan

    def release_plan_pages(self) -> None:
        """Give the accumulator's ledger pages back (the round's Unmask
        tail, once nothing reads ``acc`` any more): the one accumulator's,
        or every shard's. Idempotent."""
        if self._live_plan is not None:
            self._live_plan.release_pages()
        if self._pool is not None:
            for lease in self._leases:
                self._pool.release(lease)

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
        plan = self._live_plan
        if plan is not None:
            for d in range(plan.n_shards):
                plan.after(d, self.device)

    def sync_folds(self) -> None:
        """Block until every fold queued so far has completed on the
        device(s); a fold that failed there raises here."""
        if self.stream is not None:
            self.stream.synchronize()
        if self._live_plan is not None:
            self._live_plan.synchronize()

    def packed_staging_usable(self) -> bool:
        """Whether packed byte-planar staging shrinks anything: at the
        ``order == 2^(32L)`` boundary bpn == 4L and packing is a no-op."""
        return self.packed_width < 4 * self.n_limbs

    # -- folds -------------------------------------------------------------

    def fold_staged(self, staged: torch.Tensor, packed: bool = False) -> None:
        """Fold a device batch, planar ``uint32[K, L, padded]`` or packed
        ``uint8[K, bpn, padded]``, through the fold seams (K1), in place:
        into the one accumulator, or each shard's column slice into its
        shard (the shards' streams joined into the caller's after)."""
        plan = self.ensure_plan()
        if plan is None:
            (self._packed_fold_fn if packed else self._fold_fn)(self.acc, staged)
            return
        for d, (lo, hi) in enumerate(plan.slices):
            plan.fold(d, staged[:, :, lo:hi], packed)
        for d in range(plan.n_shards):
            plan.after(d, staged.device)

    def wire_fold_staged(self, staged: torch.Tensor) -> torch.Tensor:
        """K6 over a device batch of v1 wire blocks ``uint8[K, padded *
        bpn]``, in place; returns the device ``bool[K]`` acceptance,
        unfetched. On a mesh each shard folds its element-aligned byte
        slice and the shards settle one verdict (``ShardPlan.settle_wire``)."""
        plan = self.ensure_plan()
        if plan is None:
            return self._wire_fold_fn(self.acc, staged)
        bpn = self.packed_width
        raws, oks = [], []
        for d, (lo, hi) in enumerate(plan.slices):
            with plan.on_stream(d, staged):
                raws.append(on_device(staged[:, lo * bpn : hi * bpn], plan.devices[d]))
            oks.append(plan.wire_fold(d, raws[-1]))
        ok = plan.settle_wire(raws, oks)
        for d in range(plan.n_shards):
            plan.after(d, staged.device)
        return ok

    def _to_planar_padded(self, stack: np.ndarray) -> np.ndarray:
        """Wire ``[K, n, L]`` -> planar padded ``[K, L, padded_len]`` (host)."""
        planar = wire_to_planar(stack)
        if self.padded_length != planar.shape[2]:
            planar = np.pad(planar, ((0, 0), (0, 0), (0, self.padded_length - planar.shape[2])))
        return planar

    def add_batch(self, stack) -> None:
        """Fold wire-layout ``uint32[K, model_len, L]`` host updates."""
        stack = np.asarray(stack, dtype=np.uint32)
        if stack.ndim != 3 or stack.shape[2] != self.n_limbs:
            raise ValueError("expected uint32[K, model_len, L]")
        if stack.shape[1] != self.model_length:
            raise ValueError("model length mismatch")
        if stack.shape[0] > MAX_LAZY_BATCH:
            raise ValueError("batch too large for lazy-carry fold")
        planar = self._to_planar_padded(stack)
        plan = self.ensure_plan()
        if plan is None:
            self.add_planar_batch(to_device_u32(planar, self.device))
            return
        # each shard's columns cross to its own device, nothing else
        for d, (lo, hi) in enumerate(plan.slices):
            piece = np.ascontiguousarray(planar[:, :, lo:hi])
            with plan.on_stream(d):
                plan.fold(d, to_device_u32(piece, plan.devices[d]))
        self.nb_models += stack.shape[0]

    def add_planar_batch(self, stack_planar: torch.Tensor) -> None:
        """Fold a device-resident planar ``uint32[K, L, padded_len]`` batch."""
        with self.on_stream(stack_planar):
            self.fold_staged(stack_planar)
        self.nb_models += stack_planar.shape[0]

    def add_packed_batch(self, packed: torch.Tensor) -> None:
        """Fold a device-resident packed byte-planar ``uint8[K, bpn,
        padded_len]`` batch (K1's packed variant: limbs assemble inside the
        fold)."""
        with self.on_stream(packed):
            self.fold_staged(packed, packed=True)
        self.nb_models += packed.shape[0]

    def _check_raw(self, raw) -> np.ndarray:
        """Raw v1 wire element blocks ``uint8[K, model_len * bpn]`` (the
        checks of the JAX ``_stage_raw_bytes``)."""
        raw = np.asarray(raw)
        if raw.dtype != np.uint8 or raw.ndim != 2 or raw.shape[1] != (
            self.model_length * self.packed_width
        ):
            raise ValueError("expected uint8[K, model_len * bytes_per_number]")
        if raw.shape[0] > MAX_LAZY_BATCH:
            raise ValueError("batch too large for lazy-carry fold")
        return raw

    def _pad_raw(self, raw: np.ndarray) -> np.ndarray:
        """Zero-pad raw wire blocks to the padded length (zero bytes decode
        to zero elements: valid, and fold-neutral)."""
        pad = (self.padded_length - self.model_length) * self.packed_width
        return np.pad(raw, ((0, 0), (0, pad))) if pad else raw

    def add_wire_batch(self, raw, reduce=None) -> np.ndarray:
        """Fold RAW wire element blocks ``uint8[K, model_len * bpn]``: the
        serialized little-endian element blocks go up as they are and are
        checked and folded on the device by K6, so the coordinator never
        parses an element on the host. On a mesh each shard's byte slice
        goes up to its own device and folds there, and a member with an
        element >= the order on any shard is subtracted back from every
        shard that folded it (``ShardPlan.settle_wire``; ``reduce``, when
        given, combines the ``bool[K]`` drop vector across processes before
        that, ``multihost``'s all-reduce).

        Validity is per update: an update with any element >= the group
        order is left out of the fold and not counted in ``nb_models``
        (the reference rejects such a message before its seed-dict
        insert). Returns the ``bool[K]`` acceptance vector."""
        raw = self._pad_raw(self._check_raw(raw))
        BYTES_STAGED.labels(layout="wire").inc(raw.nbytes)
        plan = self.ensure_plan()
        if plan is None:
            staged = torch.from_numpy(raw).to(self.device)
            ok = self.dispatch_staged_bytes(staged)
            if reduce is not None:  # another process may reject what this one folded
                with self.on_stream():
                    ok = ok.cpu()
                drop = reduce(~ok)
                if (drop & ok).any():
                    with self.on_stream():
                        kernels.wire_unfold(self.acc, staged, (drop & ok).to(self.device),
                                            self.order)  # fmt: skip
                ok = ~drop
        else:
            bpn = self.packed_width
            raws, oks = [], []
            for d, (lo, hi) in enumerate(plan.slices):
                piece = torch.from_numpy(np.ascontiguousarray(raw[:, lo * bpn : hi * bpn]))
                with plan.on_stream(d):
                    raws.append(piece.to(plan.devices[d]))
                oks.append(plan.wire_fold(d, raws[-1]))
            ok = plan.settle_wire(raws, oks, reduce)
        with self.on_stream():  # in the fold stream's order
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
            return self.wire_fold_staged(staged)

    @staticmethod
    def _verdicts(bad: torch.Tensor) -> list[bool]:
        """The group's acceptance, fetched to the host (its one sync)."""
        return [v == 0 for v in bad.view(torch.int32).tolist()]

    def validate_wire_updates(self, raws) -> list:
        """Unpack and validity-check a GROUP of raw v1 wire updates in one
        device round trip: one upload, one K3 launch, one fetch of the
        verdicts. Returns a list parallel to ``raws``: the device planar
        ``uint32[L, padded_len]`` row of each accepted update (on the mesh's
        first device), ``None`` for each with an element >= the group order
        (reference ordering: the caller validates BEFORE the seed-dict
        insert, update.rs:119-152). Kernels here compile once, not per
        shape, so unlike the JAX package the group is not padded to a power
        of two."""
        if not raws:
            return []
        block = self._pad_raw(self._check_raw(np.stack([np.asarray(r) for r in raws])))
        BYTES_STAGED.labels(layout="wire").inc(block.nbytes)
        planar, bad = kernels.wire_unpack(torch.from_numpy(block).to(self.device), self.order)
        return [planar[i] if ok else None for i, ok in enumerate(self._verdicts(bad))]

    def validate_planar_updates(self, raws) -> list:
        """Wire-v2 twin of :meth:`validate_wire_updates`: one upload, one K4
        launch and one fetch of the verdicts for a group of byte-planar
        element blocks. The upload IS the packed layout, and the returned
        rows are slices of it (``uint8[bpn, padded_len]``), ``None`` for the
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
        if self.padded_length != self.model_length:
            block = np.pad(block, ((0, 0), (0, 0), (0, self.padded_length - self.model_length)))
        BYTES_STAGED.labels(layout="wire-planar").inc(block.nbytes)
        staged = torch.from_numpy(block).to(self.device)
        bad = kernels.packed_check(staged, self.order)
        return [staged[i] if ok else None for i, ok in enumerate(self._verdicts(bad))]

    # -- unmask --------------------------------------------------------------

    def mask_planar(self, mask_vect) -> np.ndarray:
        """An aggregated host mask (wire ``[n, L]`` or planar ``[L, n]``) in
        the padded planar layout ``uint32[L, padded_len]`` every unmask path
        subtracts (shared with the eager per-shard unmask, which needs it
        before the drain)."""
        mask = np.asarray(mask_vect, dtype=np.uint32)
        if mask.shape == (self.model_length, self.n_limbs):
            mask = wire_to_planar(mask)
        if mask.shape != (self.n_limbs, self.model_length):
            raise ValueError("mask shape matches neither the wire nor the planar layout")
        if self.padded_length != self.model_length:
            mask = np.pad(mask, ((0, 0), (0, self.padded_length - self.model_length)))
        return mask

    def unmask_limbs(self, mask_vect) -> np.ndarray:
        """Subtract the aggregated mask on the device; returns the unmasked
        host wire ``uint32[model_len, L]`` (the only accumulator download).
        On a mesh each shard subtracts its slice of the mask from its own
        accumulator (:meth:`_unmask_plan`)."""
        planar = self.mask_planar(mask_vect)
        if self._live_plan is not None:
            return self._unmask_plan(self._live_plan, planar)
        self._after_folds()
        out = mod_sub_planar(self._acc, to_device_u32(planar, self.device), self.order)
        return planar_to_wire(to_numpy_u32(out)[:, : self.model_length])

    def _unmask_slice(self, plan: ShardPlan, d: int, mask_planar: np.ndarray) -> torch.Tensor:
        """Queue shard ``d``'s subtract of its mask slice (the plain torch
        route of the JAX ``p_mod_sub``) on its stream; returns the unmasked
        planar slice on its device, unfetched (:meth:`_fetch_slice`)."""
        lo, hi = plan.slices[d]
        dev = plan.devices[d]
        with plan.on_stream(d):
            mask = to_device_u32(np.ascontiguousarray(mask_planar[:, lo:hi]), dev)
            return mod_sub_planar(plan.accs[d], mask, self.order)

    def _fetch_slice(self, plan: ShardPlan, d: int, res: torch.Tensor, out: np.ndarray) -> None:
        """Shard ``d``'s unmasked slice into its wire rows of ``out``, the
        padding rows dropped (fetched in its stream's order)."""
        lo, hi = plan.slices[d]
        real_hi = min(hi, self.model_length)
        if lo < real_hi:
            with plan.on_stream(d):
                out[lo:real_hi] = planar_to_wire(to_numpy_u32(res)[:, : real_hi - lo])

    def unmask_shard(self, plan: ShardPlan, d: int, mask_planar: np.ndarray,
                     out: np.ndarray) -> None:
        """One shard's leg of the per-shard unmask: subtract shard ``d``'s
        slice of the padded planar mask from its accumulator and write the
        unmasked wire rows into ``out[lo:hi]`` (``uint32[model_len, L]``;
        padding rows are dropped). Shared by :meth:`_unmask_plan` and the
        pipeline's eager per-shard unmask, whose shard workers run it at
        once on distinct rows of ``out``."""
        self._fetch_slice(plan, d, self._unmask_slice(plan, d, mask_planar), out)

    def _unmask_plan(self, plan: ShardPlan, mask_planar: np.ndarray) -> np.ndarray:
        """The per-shard unmask against a live plan: every shard's subtract
        is queued before the first result is fetched, so the shards'
        kernels overlap and only the unmasked slices cross to the host."""
        out = np.empty((self.model_length, self.n_limbs), dtype=np.uint32)
        pending = [self._unmask_slice(plan, d, mask_planar) for d in range(plan.n_shards)]
        for d, res in enumerate(pending):
            self._fetch_slice(plan, d, res, out)
        return out

    # -- snapshots -------------------------------------------------------------

    def snapshot(self) -> np.ndarray:
        """Host wire-layout copy of the aggregate (checkpoints / tests)."""
        self._after_folds()
        return planar_to_wire(to_numpy_u32(self.acc)[:, : self.model_length])

    def restore(self, wire: np.ndarray, nb_models: int) -> None:
        """Restore from a host wire-layout snapshot."""
        wire = np.asarray(wire, dtype=np.uint32)
        if wire.shape != (self.model_length, self.n_limbs):
            raise ValueError("snapshot shape does not match the aggregator")
        planar = self._to_planar_padded(wire[None])[0]
        # made on the fold stream, so its memory is only ever reused in
        # that stream's order
        with self.on_stream():
            self.acc = to_device_u32(planar, self.device)
        self.nb_models = nb_models

    def snapshot_shards(self) -> list | None:
        """The adopted plan's per-shard planes ``[(lo, hi, uint32[L, hi-lo])]``
        of the PADDED model axis, each fetched from its shard alone: the
        journal form that checkpoints a mesh without reassembling the
        accumulator. None without a plan (one shard, or a global
        accumulator a restore wrote): the caller journals the wire
        snapshot."""
        plan = self._live_plan
        if plan is None:
            return None
        planes = []
        for d, (lo, hi) in enumerate(plan.slices):
            with plan.on_stream(d):
                planes.append((lo, hi, to_numpy_u32(plan.accs[d])))
        return planes

    def restore_shards(self, planes: list, nb_models: int) -> None:
        """Restore from journal planes ``[(lo, hi, uint32[L, hi-lo])]``:
        shard-exact (each plane uploaded to its shard's device, nothing
        joined on the host) when the planes are this mesh's slices;
        otherwise joined on the host and cut at ``model_length``, so a
        journal written on a mesh of another size restores here however it
        was padded. A non-zero column past ``model_length`` raises: padding
        holds zeros, so such a journal is not an aggregate of this model."""
        planes = sorted(((int(lo), int(hi), np.asarray(p, dtype=np.uint32))
                         for lo, hi, p in planes), key=lambda t: t[0])  # fmt: skip
        for lo, hi, plane in planes:
            if plane.shape != (self.n_limbs, hi - lo):
                raise ValueError(f"journal plane [{lo},{hi}) has shape {plane.shape}")
            if hi > self.model_length and plane[:, max(0, self.model_length - lo):].any():
                raise ValueError(
                    f"journal plane [{lo},{hi}) holds non-zero columns past the model "
                    f"length {self.model_length}"
                )
        mine = shard_slices(self.padded_length, self.n_shards)
        if self.n_shards > 1 and [(lo, hi) for lo, hi, _ in planes] == mine:
            self._drop_plan()
            self.adopt_plan(ShardPlan(self, planes=[p for _, _, p in planes]))
        else:
            planar = np.zeros((self.n_limbs, self.padded_length), dtype=np.uint32)
            for lo, hi, plane in planes:
                cut = min(hi, self.model_length)
                if lo < cut:
                    planar[:, lo:cut] = plane[:, : cut - lo]
            with self.on_stream():
                self.acc = to_device_u32(planar, self.device)
        self.nb_models = nb_models

    def reset(self) -> None:
        if self.n_shards == 1:
            with self.on_stream():
                self.acc = zeros_u32((self.n_limbs, self.padded_length), self.device)
        else:
            self._drop_plan()
            self.adopt_plan(ShardPlan(self, zero_accs=True))
        self.nb_models = 0
