"""A whole small PET round through the port against the same round through
the JAX package.

Five masked updates (n = 3000, the shipped prime/f32/b0/m3 configuration)
fold in batches of two through ``xaynet_tpu.server.aggregation.StagedAggregator
(device=True, kernel="pallas-interpret")`` and through the port's
``StagedAggregator`` on the CPU; the Sum2 mask sum runs through
``masking_jax.sum_masks(kernel="fused-pallas-interpret")`` and the port's
``sum_masks``; then both unmask. Tolerance 0 throughout: the aggregates
and the mask sum are exact modular arithmetic, and the decode is the same
double-double arithmetic on both sides.

Unmask runs on the device view (``finalize_inplace``) in both packages;
``finalize`` gathers a host ``Aggregation`` in both. The pipeline half
hands the round to Unmask with the drain deferred
(``finalize_inplace(defer_drain=True)``) and folds a pre-aggregated
partial (``fold_partial``) in both packages, and compares.

The state-carry half restores a JAX ``snapshot_state()`` (and a
``ShardedAggregator.snapshot()``) into the port through
``xaynet_tpu_torch.convert``, folds the rest of the round there, and
compares.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import pytest
import torch

from xaynet_tpu.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
from xaynet_tpu.core.mask.masking import Aggregation, Masker
from xaynet_tpu.core.mask.model import Scalar
from xaynet_tpu.core.mask.object import MaskObject, MaskUnit, MaskVect
from xaynet_tpu.core.mask.seed import MaskSeed
from xaynet_tpu.ops import masking_jax
from xaynet_tpu.parallel.aggregator import ShardedAggregator
from xaynet_tpu.server.aggregation import StagedAggregator
from xaynet_tpu_torch import convert
from xaynet_tpu_torch.core.mask.masking import AggregationError
from xaynet_tpu_torch.ops import masking as port_masking
from xaynet_tpu_torch.server.aggregation import StagedAggregator as PortStagedAggregator

CPU = torch.device("cpu")
# the suite runs in several worker processes at once: keep torch's CPU ops
# on one thread each so they do not crowd the other workers
torch.set_num_threads(1)
CFG = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)
N = 3000
K = 5


@pytest.fixture(scope="module")
def round_inputs():
    pair = CFG.pair()
    rng = np.random.default_rng(2024)
    weights = rng.uniform(-0.9, 0.9, (K, N)).astype(np.float32)
    seeds = [rng.bytes(32) for _ in range(K)]
    updates = [
        Masker(pair, MaskSeed(s)).mask(Scalar(Fraction(1, K)), w)[1]
        for s, w in zip(seeds, weights)
    ]
    return pair, weights, seeds, updates


def _jax_round(pair, updates, seeds):
    agg = StagedAggregator(pair, N, device=True, batch_size=2, kernel="pallas-interpret")
    for obj in updates:
        agg.validate_aggregation(obj)
        agg.aggregate(obj)
    state = agg.snapshot_state()
    view = agg.finalize_inplace()
    unit, vect = masking_jax.sum_masks(seeds, N, pair, seed_batch=2, kernel="fused-pallas-interpret")
    mask = MaskObject(MaskVect(pair.vect, np.asarray(vect)), MaskUnit(pair.unit, np.asarray(unit)))
    view.validate_unmasking(mask)
    return state, mask, view.unmask_array(mask)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "planar"])
def test_round_matches_jax_package(round_inputs, packed):
    pair, weights, seeds, updates = round_inputs
    state, mask, model = _jax_round(pair, updates, seeds)

    port_pair = convert.config_pair(pair)
    agg = PortStagedAggregator(port_pair, N, batch_size=2, packed_staging=packed, device=CPU)
    assert agg.kernel_used == "plain"
    for obj in updates:
        port_obj = convert.mask_object(obj)
        agg.validate_aggregation(port_obj)
        agg.aggregate(port_obj)
    vect, unit, nb = agg.snapshot_state()
    assert np.array_equal(vect, state[0]) and np.array_equal(unit, state[1]) and nb == state[2] == K

    port_unit, port_vect = port_masking.sum_masks(seeds, N, port_pair, seed_batch=2, device=CPU)
    assert np.array_equal(port_vect, mask.vect.data)
    assert np.array_equal(port_unit, mask.unit.data)

    view = agg.finalize_inplace()
    port_mask = convert.mask_object(mask)
    view.validate_unmasking(port_mask)
    got = view.unmask_array(port_mask)
    assert np.array_equal(got, model)
    assert float(np.max(np.abs(got - weights.mean(axis=0)))) <= K / CFG.exp_shift + 1e-6


def test_finalize_gathers_host_aggregation_as_jax_package(round_inputs):
    """``finalize()`` drains and gathers the aggregate into a host
    ``Aggregation`` in both packages: same object, same count, same model."""
    pair, _weights, seeds, updates = round_inputs
    _state, mask, model = _jax_round(pair, updates, seeds)
    jax_agg = StagedAggregator(pair, N, device=True, batch_size=2, kernel="pallas-interpret")
    port = PortStagedAggregator(convert.config_pair(pair), N, batch_size=2, device=CPU)
    for obj in updates:
        jax_agg.aggregate(obj)
        port.aggregate(convert.mask_object(obj))
    want, got = jax_agg.finalize(), port.finalize()
    assert got.nb_models == want.nb_models == K
    assert np.array_equal(got.object.vect.data, want.object.vect.data)
    assert np.array_equal(got.object.unit.data, want.object.unit.data)
    assert np.array_equal(got.unmask_array(convert.mask_object(mask)), model)


def test_round_with_deferred_drain_matches_jax_package(round_inputs):
    """The pipeline rides into Unmask still open in both packages: the
    views count every update before the drain, and unmask to the same
    model."""
    pair, _weights, seeds, updates = round_inputs
    _state, mask, model = _jax_round(pair, updates, seeds)
    jax_agg = StagedAggregator(pair, N, device=True, batch_size=2, kernel="pallas-interpret")
    port = PortStagedAggregator(convert.config_pair(pair), N, batch_size=2, device=CPU)
    for obj in updates:
        jax_agg.aggregate(obj)
        port.aggregate(convert.mask_object(obj))
    jax_view = jax_agg.finalize_inplace(defer_drain=True)
    view = port.finalize_inplace(defer_drain=True)
    assert view.nb_models == jax_view.nb_models == K
    port_mask = convert.mask_object(mask)
    view.validate_unmasking(port_mask)
    got = view.unmask_array(port_mask)
    assert np.array_equal(got, jax_view.unmask_array(mask))
    assert np.array_equal(got, model)
    assert view.nb_models == K


def test_fold_partial_matches_jax_package(round_inputs):
    """Two updates fold one by one, the other three arrive as one partial
    aggregate of three members; both packages count five models and hold
    the same aggregate."""
    pair, _weights, _seeds, updates = round_inputs
    partial = Aggregation(pair, N)
    for obj in updates[2:]:
        partial.aggregate(obj)
    jax_agg = StagedAggregator(pair, N, device=True, batch_size=2, kernel="pallas-interpret")
    port = PortStagedAggregator(convert.config_pair(pair), N, batch_size=2, device=CPU)
    port_partial = convert.mask_object(partial.object)
    for obj in updates[:2]:
        jax_agg.aggregate(obj)
        port.aggregate(convert.mask_object(obj))
    jax_agg.validate_partial(partial.object, 3)
    port.validate_partial(port_partial, 3)
    jax_agg.fold_partial(partial.object, 3)
    port.fold_partial(port_partial, 3)
    want, got = jax_agg.snapshot_state(), port.snapshot_state()
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[2] == want[2] == K
    with pytest.raises(AggregationError, match="EmptyPartial"):
        port.fold_partial(port_partial, 0)


def test_round_resumes_from_jax_snapshot(round_inputs):
    """A round begun in the JAX package (first three updates) finishes in
    the port from its ``snapshot_state()``; the result equals the JAX
    package finishing it."""
    pair, _weights, seeds, updates = round_inputs
    jax_agg = StagedAggregator(pair, N, device=True, batch_size=2, kernel="pallas-interpret")
    for obj in updates[:3]:
        jax_agg.aggregate(obj)
    mid = jax_agg.snapshot_state()
    for obj in updates[3:]:
        jax_agg.aggregate(obj)
    want = jax_agg.snapshot_state()

    port = convert.staged_aggregator_from_state(mid, pair, N, device=CPU, batch_size=2)
    assert port.nb_models == 3
    for obj in updates[3:]:
        port.aggregate(convert.mask_object(obj))
    got = port.snapshot_state()
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[2] == want[2] == K

    unit, vect = masking_jax.sum_masks(seeds, N, pair, kernel="host-threaded")
    mask = MaskObject(MaskVect(pair.vect, np.asarray(vect)), MaskUnit(pair.unit, np.asarray(unit)))
    want_model = jax_agg.finalize_inplace().unmask(mask)
    got_model = port.finalize_inplace().unmask(convert.mask_object(mask))
    assert list(got_model) == list(want_model)


def test_device_aggregator_from_sharded_snapshot(round_inputs):
    pair, _weights, _seeds, updates = round_inputs
    stack = np.stack([u.vect.data for u in updates])
    sharded = ShardedAggregator(pair.vect, N, kernel="xla")
    sharded.add_batch(stack[:2])
    port = convert.device_aggregator_from_snapshot(
        sharded.snapshot(), sharded.nb_models, pair.vect, N, device=CPU
    )
    sharded.add_batch(stack[2:])
    port.add_batch(stack[2:])
    assert port.nb_models == sharded.nb_models == K
    assert np.array_equal(port.snapshot(), sharded.snapshot())


def test_convert_rejects_bad_state(round_inputs):
    pair, _weights, _seeds, _updates = round_inputs
    n_limb = 2
    with pytest.raises(ValueError, match="uint32"):
        convert.staged_aggregator_from_state(
            (np.zeros((N - 1, n_limb), np.uint32), np.zeros(2, np.uint32), 1), pair, N, device=CPU
        )
    outside = np.full((N, n_limb), 0xFFFFFFFF, np.uint32)
    with pytest.raises(ValueError, match="outside the group"):
        convert.staged_aggregator_from_state(
            (outside, np.zeros(2, np.uint32), 1), pair, N, device=CPU
        )
