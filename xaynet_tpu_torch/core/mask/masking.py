"""Masking, aggregation and unmasking of models.

Functional port of the reference engine (reference:
rust/xaynet-core/src/mask/masking.rs:74-418) over the limb representation.
In this package it is the host oracle the device path is held against:

- ``Masker.mask``: clamp/scale/shift weights into the finite group (see
  ``encode``), then add ChaCha20-derived random group elements — the random
  draws are bit-identical to the reference so sum participants and the
  coordinator derive identical masks from the same seed;
- ``Aggregation.aggregate``: elementwise modular addition over ``uint32[n,L]``
  limb tensors (the coordinator hot loop; device version in ``ops.fold``);
- ``Aggregation.unmask``: modular subtract of the aggregated mask, then
  fixed-point decode and scalar-sum correction.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from ...ops import limbs as limb_ops
from ..crypto.prng import StreamSampler
from .config import MaskConfig, MaskConfigPair
from .encode import (
    clamp_scalar,
    decode_scalar_sum,
    decode_vect_any,
    decode_vect_exact,
    decode_vect_fast,
    encode_unit,
    encode_vect_limbs,
    has_fast_path,
)
from .model import Model, Scalar
from .object import MaskObject, MaskUnit, MaskVect
from .seed import MaskSeed


class AggregationError(ValueError):
    """Aggregation validation failure; ``kind`` mirrors the reference enum."""

    def __init__(self, kind: str):
        super().__init__(f"aggregation error: {kind}")
        self.kind = kind


class UnmaskingError(ValueError):
    """Unmasking validation failure; ``kind`` mirrors the reference enum."""

    def __init__(self, kind: str):
        super().__init__(f"unmasking error: {kind}")
        self.kind = kind


def _order_limbs(config: MaskConfig) -> np.ndarray:
    return limb_ops.order_limbs_for(config.order)


class Masker:
    """Masks a model with a (possibly given) random 32-byte seed."""

    def __init__(self, config: MaskConfigPair, seed: MaskSeed | None = None):
        self.config = config
        self.seed = seed if seed is not None else MaskSeed.generate()

    def mask(self, scalar: Scalar, model: Union[Model, np.ndarray]) -> tuple[MaskSeed, MaskObject]:
        """Mask ``model``; returns (seed, masked object).

        ``model`` may be an exact ``Model`` or a numpy float array (fast path
        for bounded-f32 configs).
        """
        config_n, config_1 = self.config.vect, self.config.unit
        sampler = StreamSampler(self.seed.as_bytes())
        # draw order matters: one unit draw first, then the vector draws
        rand_1 = sampler.draw_limbs(1, config_1.order)[0]
        length = len(model)

        s_clamped = clamp_scalar(scalar.value, config_1)

        weights = model if isinstance(model, np.ndarray) else model.weights
        rand_n = sampler.draw_limbs(length, config_n.order)
        encoded = encode_vect_limbs(weights, s_clamped, config_n)
        masked_vect = limb_ops.mod_add(encoded, rand_n, _order_limbs(config_n))

        shifted_1 = encode_unit(s_clamped, config_1)
        n_limb_1 = limb_ops.n_limbs_for_order(config_1.order)
        masked_unit = limb_ops.mod_add(
            limb_ops.int_to_limbs(shifted_1, n_limb_1)[None, :],
            rand_1[None, :],
            _order_limbs(config_1),
        )[0]

        obj = MaskObject(MaskVect(config_n, masked_vect), MaskUnit(config_1, masked_unit))
        return self.seed, obj


class Aggregation:
    """An aggregator for masks and masked models (modular accumulation)."""

    def __init__(self, config: MaskConfigPair, object_size: int):
        self.nb_models = 0
        self.object = MaskObject.empty(config, object_size)
        self.object_size = object_size

    def __len__(self) -> int:
        return self.object_size

    @property
    def config(self) -> MaskConfigPair:
        return self.object.config

    # --- validation (reference: masking.rs:142-169, 253-279) -------------

    def validate_unmasking(self, mask: MaskObject) -> None:
        if self.nb_models == 0:
            raise UnmaskingError("NoModel")
        if self.nb_models > self.object.vect.config.max_nb_models:
            raise UnmaskingError("TooManyModels")
        if self.nb_models > self.object.unit.config.max_nb_models:
            raise UnmaskingError("TooManyScalars")
        if self.object.vect.config != mask.vect.config or self.object_size != len(mask.vect):
            raise UnmaskingError("MaskManyMismatch")
        if self.object.unit.config != mask.unit.config:
            raise UnmaskingError("MaskOneMismatch")
        if not mask.is_valid():
            raise UnmaskingError("InvalidMask")

    def validate_aggregation(self, obj: MaskObject) -> None:
        if self.object.vect.config != obj.vect.config:
            raise AggregationError("ModelMismatch")
        if self.object.unit.config != obj.unit.config:
            raise AggregationError("ScalarMismatch")
        if self.object_size != len(obj.vect):
            raise AggregationError("ModelMismatch")
        if self.nb_models >= self.object.vect.config.max_nb_models:
            raise AggregationError("TooManyModels")
        if self.nb_models >= self.object.unit.config.max_nb_models:
            raise AggregationError("TooManyScalars")
        if not obj.is_valid():
            raise AggregationError("InvalidObject")

    # --- aggregation (reference: masking.rs:292-316) ----------------------

    def aggregate(self, obj: MaskObject) -> None:
        if self.nb_models == 0:
            # fresh containers so later accumulation never mutates the
            # caller's object (the reference takes ownership by move)
            self.object = MaskObject(
                MaskVect(obj.vect.config, obj.vect.data),
                MaskUnit(obj.unit.config, obj.unit.data),
            )
            self.nb_models = 1
            return
        config_n, config_1 = self.object.vect.config, self.object.unit.config
        self.object.vect.data = limb_ops.mod_add(
            self.object.vect.data, obj.vect.data, _order_limbs(config_n)
        )
        self.object.unit.data = limb_ops.mod_add(
            self.object.unit.data[None, :], obj.unit.data[None, :], _order_limbs(config_1)
        )[0]
        self.nb_models += 1

    def aggregate_batch(self, stack: np.ndarray, unit_stack: np.ndarray) -> None:
        """Aggregate ``K`` updates at once: ``uint32[K, n, L]`` + ``uint32[K, L]``.

        Tree-reduces the batch (log2 K flat kernels) then folds into the
        accumulator — the staging-friendly shape for the device path.
        """
        k = stack.shape[0]
        if k == 0:
            return
        config_n, config_1 = self.object.vect.config, self.object.unit.config
        ol_n = _order_limbs(config_n)
        batch_u = limb_ops.batch_mod_sum(unit_stack[:, None, :], _order_limbs(config_1))[0]
        batch_v = limb_ops.batch_mod_sum(stack, ol_n)
        if self.nb_models == 0:
            self.object.vect.data = batch_v
        else:
            self.object.vect.data = limb_ops.mod_add(self.object.vect.data, batch_v, ol_n)
        if self.nb_models == 0:
            self.object.unit.data = batch_u
        else:
            self.object.unit.data = limb_ops.mod_add(
                self.object.unit.data[None, :], batch_u[None, :], _order_limbs(config_1)
            )[0]
        self.nb_models += k

    def aggregate_partial(self, obj: MaskObject, nb_models: int) -> None:
        """Fold a pre-aggregated PARTIAL (the modular sum of ``nb_models``
        already-masked updates, an edge envelope's) as one addition: masked
        aggregation is modular addition, so this is byte-identical to
        folding the members one by one; only the model count advances by
        the member count instead of one."""
        if nb_models < 1:
            raise AggregationError("EmptyPartial")
        remaining = min(
            self.object.vect.config.max_nb_models, self.object.unit.config.max_nb_models
        ) - self.nb_models
        if nb_models > remaining:
            raise AggregationError("TooManyModels")
        self.aggregate(obj)
        self.nb_models += nb_models - 1

    # --- unmasking (reference: masking.rs:190-231) ------------------------

    def _unmasked_limbs(self, mask_obj: MaskObject) -> tuple[np.ndarray, int]:
        config_n, config_1 = self.object.vect.config, self.object.unit.config
        n_vect = limb_ops.mod_sub(self.object.vect.data, mask_obj.vect.data, _order_limbs(config_n))
        n_unit = limb_ops.mod_sub(
            self.object.unit.data[None, :], mask_obj.unit.data[None, :], _order_limbs(config_1)
        )[0]
        return n_vect, limb_ops.limbs_to_int(n_unit)

    def unmask(self, mask_obj: MaskObject) -> Model:
        """Exact unmasking -> ``Model`` of rational weights (reference parity)."""
        config_n, config_1 = self.object.vect.config, self.object.unit.config
        n_vect, n_unit = self._unmasked_limbs(mask_obj)
        scalar_sum = decode_scalar_sum(n_unit, config_1, self.nb_models)
        values = limb_ops.limbs_to_ints(n_vect)
        return Model(decode_vect_exact(values, config_n, self.nb_models, scalar_sum))

    def unmask_array(self, mask_obj: MaskObject) -> np.ndarray:
        """Fast unmasking -> float64 numpy array (double-double decode)."""
        config_n, config_1 = self.object.vect.config, self.object.unit.config
        n_vect, n_unit = self._unmasked_limbs(mask_obj)
        scalar_sum = decode_scalar_sum(n_unit, config_1, self.nb_models)
        if has_fast_path(config_n):
            return decode_vect_fast(n_vect, config_n, self.nb_models, scalar_sum)
        return decode_vect_any(n_vect, config_n, self.nb_models, scalar_sum)
