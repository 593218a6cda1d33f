"""Masking / aggregation math of the PET protocol (host numpy copy).

Reference surface: rust/xaynet-core/src/mask/ (config, model, scalar, object,
seed, masking). Group elements are fixed-width ``uint32`` limb arrays; the
device hot loops live in ``xaynet_tpu_torch.ops``.
"""

from .config import (
    MASK_CONFIG_LENGTH,
    BoundType,
    DataType,
    GroupType,
    InvalidMaskConfigError,
    MaskConfig,
    MaskConfigPair,
    ModelType,
)
from .masking import Aggregation, AggregationError, Masker, UnmaskingError
from .model import Model, ModelCastError, PrimitiveCastError, Scalar
from .object import InvalidMaskObjectError, MaskObject, MaskUnit, MaskVect
from .seed import MASK_SEED_LENGTH, MaskSeed

__all__ = [
    "MASK_CONFIG_LENGTH",
    "BoundType",
    "DataType",
    "GroupType",
    "InvalidMaskConfigError",
    "MaskConfig",
    "MaskConfigPair",
    "ModelType",
    "Aggregation",
    "AggregationError",
    "Masker",
    "UnmaskingError",
    "Model",
    "ModelCastError",
    "PrimitiveCastError",
    "Scalar",
    "InvalidMaskObjectError",
    "MaskObject",
    "MaskUnit",
    "MaskVect",
    "MASK_SEED_LENGTH",
    "MaskSeed",
]
