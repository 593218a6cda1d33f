"""Update-phase aggregation on the device, and the Unmask view over it.

Port of the device branch of ``xaynet_tpu/server/aggregation.py``. The
reference aggregates each accepted update inline with a sequential big-int
loop (rust/xaynet-server/src/state_machine/phases/update.rs:119-152). Here
validated updates are staged and folded in batches into the device
accumulator (``parallel.aggregator.DeviceAggregator``); the tiny unit part
stays on the host.

Device folds flow through the streaming pipeline (``parallel.streaming``),
as in the JAX package: ``flush()`` *submits* the staged micro-batch into a
bounded producer/consumer (ring-buffer staging overlaps the in-flight
folds) and returns; ``drain()``, at phase end and in
``finalize``/``finalize_inplace``, blocks for the result. The fold is an
exact modular sum, so the aggregate is byte-identical to a synchronous
fold. Updates are staged in their wire layout and packed straight into the
pipeline's ring at flush. With packed staging (the default, as
``[aggregation] packed_staging``) a batch crosses to the device as
``bpn``-byte planes ``uint8[K, bpn, n]`` and folds through K1's packed
variant.

Device wire ingest: an update parsed lazily from the wire
(``LazyWireMaskVect``, ``core.mask.serialization.parse_mask_object(...,
lazy_vect=True)``) is unpacked and validity-checked on the device at
``validate_aggregation`` (or, a micro-batch at a time, at
``prevalidate_wire_batch``); its elements are never parsed on the host.
The accepted row stays on the device (planar for wire v1, packed for v2),
is staged as it is, and ``flush`` folds such rows on the caller's thread
(``fold_planar_rows_now`` / ``fold_packed_rows_now``) while host rows go
through the pipeline's ring. The kind of object passed in decides the
route; there is no switch.

Journal snapshots (``snapshot_journal``/``restore_journal``) come with the
phase machine.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.mask.config import MaskConfigPair
from ..core.mask.encode import (
    decode_scalar_sum,
    decode_vect_any,
    decode_vect_exact,
    decode_vect_fast,
    has_fast_path,
)
from ..core.mask.masking import Aggregation, AggregationError, UnmaskingError
from ..core.mask.model import Model
from ..core.mask.object import LazyWireMaskVect, MaskObject, MaskUnit, MaskVect
from ..ops import limbs as limb_ops
from ..parallel.aggregator import DeviceAggregator
from ..parallel.streaming import StreamingAggregator


class DeviceAggregation(Aggregation):
    """Aggregation view over the device accumulator.

    ``unmask_array``/``unmask`` subtract the elected mask on the device
    (``DeviceAggregator.unmask_limbs``) and only the unmasked result crosses
    to the host for the fixed-point decode. ``object`` gathers the masked
    aggregate to the host for checkpoint and test paths.

    With ``stream`` (``StagedAggregator.finalize_inplace(defer_drain=True)``)
    the pipeline rides into Unmask still open, and folds may still be in
    flight: ``nb_models`` reads the count atomically with the fold worker,
    and the unmask drains first. One device has no eager per-shard unmask,
    so the unmask drains, closes the pipeline, then subtracts.
    """

    def __init__(self, config: MaskConfigPair, object_size: int, device: DeviceAggregator,
                 unit_acc, stream: StreamingAggregator | None = None):
        # deliberately NOT calling super().__init__: it would allocate an
        # empty host MaskObject of the full model size just to carry configs
        self._nb_models = device.nb_models
        self.object_size = object_size
        self._config = config
        self._device = device
        self._unit_acc = np.asarray(unit_acc)
        self._stream = stream

    @property
    def nb_models(self) -> int:
        if self._stream is not None:
            return self._stream.counted_models()
        return self._nb_models

    @property
    def config(self) -> MaskConfigPair:
        return self._config

    @property
    def object(self) -> MaskObject:
        """Gathered host aggregate (checkpoints/tests only)."""
        if self._stream is not None:
            self._stream.drain()
        return MaskObject(
            MaskVect(self._config.vect, self._device.snapshot()),
            MaskUnit(self._config.unit, self._unit_acc),
        )

    def validate_unmasking(self, mask: MaskObject) -> None:
        if self.nb_models == 0:
            raise UnmaskingError("NoModel")
        if self.nb_models > self._config.vect.max_nb_models:
            raise UnmaskingError("TooManyModels")
        if self.nb_models > self._config.unit.max_nb_models:
            raise UnmaskingError("TooManyScalars")
        if self._config.vect != mask.vect.config or self.object_size != len(mask.vect):
            raise UnmaskingError("MaskManyMismatch")
        if self._config.unit != mask.unit.config:
            raise UnmaskingError("MaskOneMismatch")
        if not mask.is_valid():
            raise UnmaskingError("InvalidMask")

    def _settle_stream(self) -> None:
        """Close a deferred-drain pipeline and pin the final model count."""
        stream, self._stream = self._stream, None
        if stream is not None:
            stream.close()
            self._nb_models = self._device.nb_models

    def _unmasked_limbs(self, mask_obj: MaskObject) -> tuple[np.ndarray, int]:
        if self._stream is not None:
            try:
                # fold errors surface here, as they would have at the drain
                self._stream.drain()
            finally:
                self._settle_stream()
        n_vect = self._device.unmask_limbs(mask_obj.vect.data)
        ol_u = limb_ops.order_limbs_for(self._config.unit.order)
        n_unit = limb_ops.mod_sub(
            self._unit_acc[None, :], np.asarray(mask_obj.unit.data)[None, :], ol_u
        )[0]
        return n_vect, limb_ops.limbs_to_int(n_unit)

    def unmask_array(self, mask_obj: MaskObject) -> np.ndarray:
        """Fast unmasking -> float64 numpy array (double-double decode)."""
        n_vect, n_unit = self._unmasked_limbs(mask_obj)
        scalar_sum = decode_scalar_sum(n_unit, self._config.unit, self.nb_models)
        if has_fast_path(self._config.vect):
            return decode_vect_fast(n_vect, self._config.vect, self.nb_models, scalar_sum)
        return decode_vect_any(n_vect, self._config.vect, self.nb_models, scalar_sum)

    def unmask(self, mask_obj: MaskObject) -> Model:
        """Exact unmasking -> ``Model`` of rational weights."""
        n_vect, n_unit = self._unmasked_limbs(mask_obj)
        scalar_sum = decode_scalar_sum(n_unit, self._config.unit, self.nb_models)
        values = limb_ops.limbs_to_ints(n_vect)
        return Model(decode_vect_exact(values, self._config.vect, self.nb_models, scalar_sum))


class StagedAggregator:
    """Stages validated masked updates and folds them in batches on the
    device (``cuda`` unless ``device`` says otherwise), through the
    streaming pipeline."""

    def __init__(
        self,
        config: MaskConfigPair,
        object_size: int,
        batch_size: int = 64,
        packed_staging: bool = True,
        device=None,
    ):
        self.config = config
        self.object_size = object_size
        self.batch_size = max(1, batch_size)
        # host wire rows uint32[model_len, L], or device rows validated by
        # wire ingest (planar uint32[L, model_len], packed uint8[bpn, model_len])
        self._staged_vect: list = []
        self._staged_unit: list[np.ndarray] = []
        self._device = DeviceAggregator(config.vect, object_size, device=device)
        # flush() submits micro-batches here; drain()/finalize() sync
        self._stream = StreamingAggregator(
            self._device, max_batch=self.batch_size, packed=packed_staging
        )
        # the tiny unit part stays on the host
        self._unit_acc = np.zeros(limb_ops.n_limbs_for_order(config.unit.order), dtype=np.uint32)

    @property
    def kernel_used(self) -> str:
        """What folds the batches: ``cuda`` (K1) or ``plain`` (CPU)."""
        return self._device.kernel_used

    @property
    def nb_models(self) -> int:
        # staged + (in-flight + folded, read atomically with the fold
        # worker's handoff): an accepted update counts from the moment it
        # is staged
        return len(self._staged_vect) + self._stream.counted_models()

    @property
    def pending(self) -> int:
        """Updates staged but not yet submitted."""
        return len(self._staged_vect)

    def validate_aggregation(self, obj: MaskObject) -> None:
        """Per-update protocol validation (same checks as the reference,
        masking.rs:253-279) without materializing a probe accumulator."""
        if self.config.vect != obj.vect.config:
            raise AggregationError("ModelMismatch")
        if self.config.unit != obj.unit.config:
            raise AggregationError("ScalarMismatch")
        if self.object_size != len(obj.vect):
            raise AggregationError("ModelMismatch")
        if self.nb_models >= self.config.vect.max_nb_models:
            raise AggregationError("TooManyModels")
        if self.nb_models >= self.config.unit.max_nb_models:
            raise AggregationError("TooManyScalars")
        vect = obj.vect
        if isinstance(vect, LazyWireMaskVect) and not vect.materialized:
            # device wire ingest: unpack + element validity on the device,
            # the accepted row cached on the object so stage() never uploads
            # again; before the caller's seed-dict insert (update.rs:119-152).
            # A prevalidate_wire_batch may already have cached the verdict.
            row = vect._staged_planar
            if row is None and not vect._wire_invalid:
                if vect.planar:
                    row = self._device.validate_planar_updates([vect.planar_block])[0]
                else:
                    row = self._device.validate_wire_updates([vect.wire_block])[0]
            if row is None or not obj.unit.is_valid():
                raise AggregationError("InvalidObject")
            vect._staged_planar = row
        elif not obj.is_valid():
            raise AggregationError("InvalidObject")

    def prevalidate_wire_batch(self, objs) -> None:
        """Device validation of a micro-batch about to be processed member by
        member: one upload, one kernel launch and one fetch of the verdicts
        per layout and ``batch_size`` chunk
        (``DeviceAggregator.validate_wire_updates`` /
        ``validate_planar_updates``), where the per-member path pays a
        device round trip each. The verdicts are cached on the vect objects
        and ``validate_aggregation`` consumes them in order, so the
        validate-before-seed-dict-insert sequence is unchanged. Members that
        are not lazy wire vects, are already validated, or carry the wrong
        config or element count are left to the per-member path (which
        rejects a mismatched one alone)."""
        want_bytes = self.object_size * self.config.vect.bytes_per_number
        lazies = [
            obj.vect
            for obj in objs
            if isinstance(obj.vect, LazyWireMaskVect)
            and not obj.vect.materialized
            and obj.vect._staged_planar is None
            and not obj.vect._wire_invalid
            and obj.vect.config == self.config.vect
            and np.asarray(obj.vect.wire_block).size == want_bytes
        ]
        # v1 (interleaved) and v2 (byte-planar) members take different
        # kernels, so they validate in separate groups
        for planar_wire in (False, True):
            group = [v for v in lazies if v.planar is planar_wire]
            for start in range(0, len(group), self.batch_size):
                chunk = group[start : start + self.batch_size]
                if planar_wire:
                    rows = self._device.validate_planar_updates([v.planar_block for v in chunk])
                else:
                    rows = self._device.validate_wire_updates(
                        [np.asarray(v.wire_block) for v in chunk]
                    )
                for vect, row in zip(chunk, rows):
                    if row is None:
                        vect._wire_invalid = True
                    else:
                        vect._staged_planar = row

    def validate_partial(self, obj: MaskObject, members: int) -> None:
        """Protocol validation for an edge PARTIAL aggregate of ``members``
        updates: the checks of one update, but the model-count headroom must
        fit every member (the envelope folds entirely or not at all)."""
        if members < 1:
            raise AggregationError("EmptyPartial")
        if self.config.vect != obj.vect.config:
            raise AggregationError("ModelMismatch")
        if self.config.unit != obj.unit.config:
            raise AggregationError("ScalarMismatch")
        if self.object_size != len(obj.vect):
            raise AggregationError("ModelMismatch")
        if self.nb_models + members > self.config.vect.max_nb_models:
            raise AggregationError("TooManyModels")
        if self.nb_models + members > self.config.unit.max_nb_models:
            raise AggregationError("TooManyScalars")
        if not obj.is_valid():
            raise AggregationError("InvalidObject")

    def fold_partial(self, obj: MaskObject, members: int) -> None:
        """Fold a pre-aggregated partial of ``members`` updates as one row
        and advance ``nb_models`` by ``members``. Staged updates flush and
        everything drains first, so the count adjustment cannot race the
        fold worker."""
        if members < 1:
            raise AggregationError("EmptyPartial")
        self.drain()
        self._stream.submit_batch([obj.vect.data])
        self._stream.drain()
        # the partial counts as `members` models, not the one row folded
        self._device.nb_models += members - 1
        order_limbs = limb_ops.order_limbs_for(self.config.unit.order)
        self._unit_acc = limb_ops.mod_add(
            self._unit_acc[None, :], np.asarray(obj.unit.data)[None, :], order_limbs
        )[0]

    def stage(self, obj: MaskObject) -> None:
        """Stage an update without folding (caller controls flush timing):
        the device row that wire ingest validated, else the host wire row."""
        row = obj.vect._staged_planar if isinstance(obj.vect, LazyWireMaskVect) else None
        if row is None:
            row = np.asarray(obj.vect.data, dtype=np.uint32)
        self._staged_vect.append(row)
        self._staged_unit.append(np.asarray(obj.unit.data, dtype=np.uint32))

    def aggregate(self, obj: MaskObject) -> None:
        self.stage(obj)
        if len(self._staged_vect) >= self.batch_size:
            self.flush()

    def flush(self) -> None:
        """Fold the staged micro-batch: device rows from wire ingest on this
        thread (packed v2 rows through K1's packed variant, planar v1 rows
        through its planar one), host rows submitted into the streaming
        pipeline without waiting for their fold (the pipeline's ring and
        dispatch-ahead bounds are the backpressure); :meth:`drain`
        synchronizes."""
        if not self._staged_vect:
            return
        rows, self._staged_vect = self._staged_vect, []
        units, self._staged_unit = np.stack(self._staged_unit), []
        packed = [r for r in rows if torch.is_tensor(r) and r.dtype == torch.uint8]
        planar = [r for r in rows if torch.is_tensor(r) and r.dtype != torch.uint8]
        host = [r for r in rows if not torch.is_tensor(r)]
        rows.clear()  # consumed as they fold: each list frees its rows
        self._stream.fold_packed_rows_now(packed)
        packed.clear()
        self._stream.fold_planar_rows_now(planar)
        planar.clear()
        # host wire rows are packed straight into the pipeline's staging
        # ring and folded by its worker while this thread goes back to staging
        step = self._stream.max_batch
        for start in range(0, len(host), step):
            self._stream.submit_batch(host[start : start + step])
        host.clear()
        order_limbs = limb_ops.order_limbs_for(self.config.unit.order)
        batch_unit = limb_ops.batch_mod_sum(units[:, None, :], order_limbs)[0]
        self._unit_acc = limb_ops.mod_add(
            self._unit_acc[None, :], batch_unit[None, :], order_limbs
        )[0]

    def drain(self) -> None:
        """Flush, then block until every in-flight fold has completed (the
        phase-transition synchronization point)."""
        self.flush()
        self._stream.drain()

    def snapshot_state(self) -> tuple[np.ndarray, np.ndarray, int]:
        """Exact host copy of the aggregate: ``(vect wire uint32[model_len,
        L], unit uint32[L_unit], nb_models)``, as the JAX package's
        ``StagedAggregator.snapshot_state`` (``convert`` reads either).
        Drains first."""
        self.drain()
        return self._device.snapshot(), np.array(self._unit_acc), self._device.nb_models

    def restore_state(self, vect: np.ndarray, unit: np.ndarray, nb_models: int) -> None:
        """Restore a snapshot into an EMPTY aggregator (resume)."""
        if self.nb_models:
            raise RuntimeError("restore_state requires an empty aggregator")
        self._device.restore(np.ascontiguousarray(vect, dtype=np.uint32), nb_models)
        self._unit_acc = np.ascontiguousarray(unit, dtype=np.uint32)

    def finalize(self) -> Aggregation:
        """The protocol-level host ``Aggregation``: drains, closes the
        pipeline and GATHERS the accumulator to the host (for snapshot and
        test callers; :meth:`finalize_inplace` is the Unmask handoff that
        keeps it on the device)."""
        self.drain()
        self._stream.close()
        agg = Aggregation(self.config, self.object_size)
        agg.object = MaskObject(
            MaskVect(self.config.vect, self._device.snapshot()),
            MaskUnit(self.config.unit, self._unit_acc),
        )
        agg.nb_models = self._device.nb_models
        return agg

    def finalize_inplace(self, defer_drain: bool = False) -> DeviceAggregation:
        """The Unmask handoff WITHOUT gathering the accumulator: a
        :class:`DeviceAggregation` view that subtracts the mask on the
        device. With ``defer_drain`` the pipeline rides into Unmask still
        open: the staged remainder is submitted and the drain barrier moves
        into the unmask."""
        if defer_drain:
            self.flush()
            return DeviceAggregation(self.config, self.object_size, self._device,
                                     self._unit_acc, stream=self._stream)
        self.drain()
        self._stream.close()
        return DeviceAggregation(self.config, self.object_size, self._device, self._unit_acc)
