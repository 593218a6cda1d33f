"""Update-phase aggregation on the device, and the Unmask view over it.

Port of the device branch of ``xaynet_tpu/server/aggregation.py``. The
reference aggregates each accepted update inline with a sequential big-int
loop (rust/xaynet-server/src/state_machine/phases/update.rs:119-152). Here
validated updates are staged and folded in batches into the device
accumulator (``parallel.aggregator.DeviceAggregator``); the tiny unit part
stays on the host.

Flushes are synchronous: ``flush()`` folds the staged micro-batch before it
returns. The JAX package streams them through a pipeline instead; the fold
is an exact modular sum, so the aggregate is byte-identical either way.
With packed staging (the default, as ``[aggregation] packed_staging``) a
batch crosses to the device as ``bpn``-byte planes ``uint8[K, bpn, n]`` and
folds through K1's packed variant.
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
from ..core.mask.object import MaskObject, MaskUnit, MaskVect
from ..ops import limbs as limb_ops
from ..ops.fold import to_device_u32, wire_to_planar
from ..parallel.aggregator import DeviceAggregator


class DeviceAggregation(Aggregation):
    """Aggregation view over the device accumulator.

    ``unmask_array``/``unmask`` subtract the elected mask on the device
    (``DeviceAggregator.unmask_limbs``) and only the unmasked result crosses
    to the host for the fixed-point decode. ``object`` gathers the masked
    aggregate to the host for checkpoint and test paths.
    """

    def __init__(self, config: MaskConfigPair, object_size: int, device: DeviceAggregator,
                 unit_acc):
        # deliberately NOT calling super().__init__: it would allocate an
        # empty host MaskObject of the full model size just to carry configs
        self.nb_models = device.nb_models
        self.object_size = object_size
        self._config = config
        self._device = device
        self._unit_acc = np.asarray(unit_acc)

    @property
    def config(self) -> MaskConfigPair:
        return self._config

    @property
    def object(self) -> MaskObject:
        """Gathered host aggregate (checkpoints/tests only)."""
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

    def _unmasked_limbs(self, mask_obj: MaskObject) -> tuple[np.ndarray, int]:
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
    device (``cuda`` unless ``device`` says otherwise)."""

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
        self._device = DeviceAggregator(config.vect, object_size, device=device)
        self._packed = packed_staging and self._device.packed_staging_usable()
        self._staged_vect: list[np.ndarray] = []
        self._staged_unit: list[np.ndarray] = []
        self._unit_acc = np.zeros(limb_ops.n_limbs_for_order(config.unit.order), dtype=np.uint32)

    @property
    def kernel_used(self) -> str:
        """What folds the batches: ``cuda`` (K1) or ``plain`` (CPU)."""
        return self._device.kernel_used

    @property
    def nb_models(self) -> int:
        return len(self._staged_vect) + self._device.nb_models

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
        if not obj.is_valid():
            raise AggregationError("InvalidObject")

    def stage(self, obj: MaskObject) -> None:
        """Stage an update without folding (caller controls flush timing)."""
        self._staged_vect.append(np.asarray(obj.vect.data, dtype=np.uint32))
        self._staged_unit.append(np.asarray(obj.unit.data, dtype=np.uint32))

    def aggregate(self, obj: MaskObject) -> None:
        self.stage(obj)
        if len(self._staged_vect) >= self.batch_size:
            self.flush()

    def flush(self) -> None:
        """Fold the staged micro-batch into the device accumulator (before
        returning)."""
        if not self._staged_vect:
            return
        rows, self._staged_vect = self._staged_vect, []
        units, self._staged_unit = np.stack(self._staged_unit), []
        dev = self._device
        if self._packed:
            packed = np.empty((len(rows), dev.packed_width, self.object_size), dtype=np.uint8)
            for i, row in enumerate(rows):
                limb_ops.pack_wire(row, dev.packed_width, out=packed[i])
            rows.clear()
            dev.add_packed_batch(torch.from_numpy(packed).to(dev.device))
        else:
            planar = np.stack([wire_to_planar(r) for r in rows])
            rows.clear()
            dev.add_planar_batch(to_device_u32(planar, dev.device))
        order_limbs = limb_ops.order_limbs_for(self.config.unit.order)
        batch_unit = limb_ops.batch_mod_sum(units[:, None, :], order_limbs)[0]
        self._unit_acc = limb_ops.mod_add(
            self._unit_acc[None, :], batch_unit[None, :], order_limbs
        )[0]

    def snapshot_state(self) -> tuple[np.ndarray, np.ndarray, int]:
        """Exact host copy of the aggregate: ``(vect wire uint32[model_len,
        L], unit uint32[L_unit], nb_models)``, as the JAX package's
        ``StagedAggregator.snapshot_state`` (``convert`` reads either)."""
        self.flush()
        return self._device.snapshot(), np.array(self._unit_acc), self._device.nb_models

    def restore_state(self, vect: np.ndarray, unit: np.ndarray, nb_models: int) -> None:
        """Restore a snapshot into an EMPTY aggregator (resume)."""
        if self.nb_models:
            raise RuntimeError("restore_state requires an empty aggregator")
        self._device.restore(np.ascontiguousarray(vect, dtype=np.uint32), nb_models)
        self._unit_acc = np.ascontiguousarray(unit, dtype=np.uint32)

    def finalize(self) -> DeviceAggregation:
        """The Unmask handoff: fold what is staged and return the
        :class:`DeviceAggregation` view, which unmasks on the device (the
        JAX package's ``finalize_inplace``; its ``finalize`` gathers the
        accumulator to the host first)."""
        self.flush()
        return DeviceAggregation(self.config, self.object_size, self._device, self._unit_acc)
