"""State carried across from the JAX package into the port.

The JAX package's aggregator state reaches the port as numpy arrays (this
package never imports the JAX one), so a round started there can be
finished here:

- ``StagedAggregator.snapshot_state()``: the triple ``(vect wire
  uint32[model_len, L], unit uint32[L_unit], nb_models)``;
- ``ShardedAggregator.snapshot()``: the wire ``uint32[model_len, L]``
  aggregate, with its ``nb_models``.

Masking configurations and mask objects cross by their wire forms
(``to_bytes()`` of a configuration; the limb arrays of an object), so any
object with the JAX package's attribute names converts.
"""

from __future__ import annotations

import numpy as np

from .core.mask.config import MaskConfig, MaskConfigPair
from .core.mask.object import MaskObject, MaskUnit, MaskVect
from .ops import limbs as host_limbs
from .parallel.aggregator import DeviceAggregator
from .server.aggregation import StagedAggregator


def config_pair(pair) -> MaskConfigPair:
    """A masking configuration pair (this package's, or any object with the
    JAX package's ``to_bytes()``) as this package's ``MaskConfigPair``."""
    if isinstance(pair, MaskConfigPair):
        return pair
    return MaskConfigPair.from_bytes(pair.to_bytes())


def mask_object(obj) -> MaskObject:
    """A mask object with the JAX package's layout (``vect.data`` wire
    ``uint32[n, L]``, ``unit.data`` ``uint32[L_unit]``, configs with
    ``to_bytes()``) as this package's ``MaskObject``."""
    return MaskObject(
        MaskVect(
            MaskConfig.from_bytes(obj.vect.config.to_bytes()),
            np.ascontiguousarray(obj.vect.data, dtype=np.uint32),
        ),
        MaskUnit(
            MaskConfig.from_bytes(obj.unit.config.to_bytes()),
            np.ascontiguousarray(obj.unit.data, dtype=np.uint32),
        ),
    )


def _checked_wire(vect, order: int, model_length: int) -> np.ndarray:
    wire = np.ascontiguousarray(vect, dtype=np.uint32)
    n_limb = host_limbs.n_limbs_for_order(order)
    if wire.shape != (model_length, n_limb):
        raise ValueError(f"aggregate must be uint32[{model_length}, {n_limb}], got {wire.shape}")
    if not host_limbs.all_lt_order(wire, order):
        raise ValueError("aggregate holds elements outside the group")
    return wire


def staged_aggregator_from_state(
    state: tuple, config, object_size: int, device=None, **kwargs
) -> StagedAggregator:
    """A port ``StagedAggregator`` resumed from a JAX
    ``StagedAggregator.snapshot_state()`` triple (``kwargs`` go to the
    constructor: ``batch_size``, ``packed_staging``)."""
    vect, unit, nb_models = state
    pair = config_pair(config)
    agg = StagedAggregator(pair, object_size, device=device, **kwargs)
    unit = np.ascontiguousarray(unit, dtype=np.uint32)
    if unit.shape != (host_limbs.n_limbs_for_order(pair.unit.order),):
        raise ValueError("unit aggregate has the wrong limb count")
    agg.restore_state(_checked_wire(vect, pair.vect.order, object_size), unit, int(nb_models))
    return agg


def device_aggregator_from_snapshot(
    wire: np.ndarray, nb_models: int, config, model_length: int, device=None
) -> DeviceAggregator:
    """A port ``DeviceAggregator`` holding a JAX ``ShardedAggregator.snapshot()``
    (``config`` is the vector ``MaskConfig``, either package's)."""
    cfg = config if isinstance(config, MaskConfig) else MaskConfig.from_bytes(config.to_bytes())
    agg = DeviceAggregator(cfg, model_length, device=device)
    agg.restore(_checked_wire(wire, cfg.order, model_length), int(nb_models))
    return agg
