"""Model representation and primitive conversions.

The reference represents a model as ``Vec<Ratio<BigInt>>`` — exact rational
weights (reference: rust/xaynet-core/src/mask/model.rs:25,94-160). This port
keeps the exact representation (`fractions.Fraction`) for the protocol
surface and conformance tests, and adds zero-copy numpy bridges
(``from_array`` / ``to_array``) that the TPU fast path uses so 25M-parameter
models never materialize as python objects.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Iterable, Iterator

import numpy as np

from .config import DataType

_F32_MAX = float(np.finfo(np.float32).max)
_F64_MAX = float(np.finfo(np.float64).max)
_INT_BOUNDS = {DataType.I32: 2**31, DataType.I64: 2**63}


class ModelCastError(ValueError):
    """A weight is not representable in the requested primitive type."""


class PrimitiveCastError(ValueError):
    """A primitive value (non-finite float) cannot become an exact weight."""


class Model:
    """A numerical model: a sequence of exact rational weights."""

    __slots__ = ("weights",)

    def __init__(self, weights: Iterable[Fraction]):
        self.weights: list[Fraction] = list(weights)

    def __len__(self) -> int:
        return len(self.weights)

    def __iter__(self) -> Iterator[Fraction]:
        return iter(self.weights)

    def __getitem__(self, i):
        return self.weights[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, Model) and self.weights == other.weights

    def __repr__(self) -> str:
        return f"Model(len={len(self.weights)})"

    # --- primitive conversions (reference-parity surface) ---------------

    @classmethod
    def from_primitives(cls, values: Iterable, data_type: DataType) -> "Model":
        """Exact conversion; raises ``PrimitiveCastError`` on non-finite floats."""
        if data_type in (DataType.I32, DataType.I64):
            return cls(Fraction(int(v)) for v in values)
        out = []
        for v in values:
            f = float(np.float32(v)) if data_type is DataType.F32 else float(v)
            if not math.isfinite(f):
                raise PrimitiveCastError(f"non-finite value {v!r}")
            out.append(Fraction(f))
        return cls(out)

    @classmethod
    def from_primitives_bounded(cls, values: Iterable, data_type: DataType) -> "Model":
        """Clamping conversion: infinities to +/-max, NaN to zero."""
        if data_type in (DataType.I32, DataType.I64):
            return cls(Fraction(int(v)) for v in values)
        fmax = _F32_MAX if data_type is DataType.F32 else _F64_MAX
        out = []
        for v in values:
            f = float(np.float32(v)) if data_type is DataType.F32 else float(v)
            if math.isnan(f):
                out.append(Fraction(0))
            else:
                out.append(Fraction(min(max(f, -fmax), fmax)))
        return cls(out)

    def into_primitives(self, data_type: DataType) -> list:
        """Convert to primitives; raises ``ModelCastError`` when out of range."""
        if data_type in (DataType.I32, DataType.I64):
            bound = _INT_BOUNDS[data_type]
            out = []
            for w in self.weights:
                i = int(w)  # truncates toward zero, like Ratio::to_integer
                if not (-bound <= i < bound):
                    raise ModelCastError(f"weight {w} out of range for {data_type.name}")
                out.append(i)
            return out
        fmax = _F32_MAX if data_type is DataType.F32 else _F64_MAX
        out = []
        for w in self.weights:
            if w < -Fraction(fmax) or w > Fraction(fmax):
                raise ModelCastError(f"weight {w} out of range for {data_type.name}")
            f = float(w)  # correctly rounded
            out.append(float(np.float32(f)) if data_type is DataType.F32 else f)
        return out

    # --- numpy bridges (fast path) ---------------------------------------

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "Model":
        dt = DataType.F32 if arr.dtype == np.float32 else DataType.F64
        if arr.dtype in (np.int32, np.int64):
            return cls(Fraction(int(v)) for v in arr.tolist())
        return cls.from_primitives(arr.tolist(), dt)

    def to_array(self, data_type: DataType = DataType.F32) -> np.ndarray:
        dtype = {
            DataType.F32: np.float32,
            DataType.F64: np.float64,
            DataType.I32: np.int32,
            DataType.I64: np.int64,
        }[data_type]
        return np.asarray(self.into_primitives(data_type), dtype=dtype)


class Scalar:
    """A non-negative rational scaling factor (e.g. 1/N for FedAvg)."""

    __slots__ = ("value",)

    def __init__(self, numer: int, denom: int = 1):
        if numer < 0 or denom <= 0:
            raise ValueError("scalar must be a non-negative ratio")
        self.value = Fraction(numer, denom)

    @classmethod
    def unit(cls) -> "Scalar":
        return cls(1, 1)

    @classmethod
    def from_fraction(cls, f: Fraction) -> "Scalar":
        if f < 0:
            raise ValueError("scalar must be non-negative")
        s = cls(0, 1)
        s.value = f
        return s

    @classmethod
    def from_float(cls, f: float) -> "Scalar":
        """Exact conversion; raises on non-finite or negative values."""
        if not math.isfinite(f) or f < 0:
            raise ValueError(f"invalid scalar {f!r}")
        return cls.from_fraction(Fraction(f))

    @classmethod
    def from_float_bounded(cls, f: float) -> "Scalar":
        """Clamping conversion: +inf to f64::MAX, negatives and NaN to zero."""
        if math.isnan(f) or f < 0:
            return cls(0, 1)
        return cls.from_fraction(Fraction(min(f, _F64_MAX)))

    def to_float(self) -> float:
        """Correctly-rounded primitive conversion (IntoPrimitive analogue)."""
        return float(self.value)

    def __eq__(self, other) -> bool:
        return isinstance(other, Scalar) and self.value == other.value

    def __repr__(self) -> str:
        return f"Scalar({self.value})"
