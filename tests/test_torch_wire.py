"""The port's device wire ingest against the JAX package's, on the CPU.

Inputs are made from a seed with numpy (and the JAX package's ``Masker``).
Tolerance: none. Wire bytes, limbs, verdicts and aggregates are exact, so
everything must be byte-identical:

- serialization (v1 interleaved, v2 byte-planar, the lazy parse) against
  ``xaynet_tpu.core.mask.serialization``;
- the plain versions of K3 (``wire_unpack_plain``) and K4
  (``packed_check_plain``), and their wrappers on CPU tensors, against
  ``limbs_jax.wire_bytes_to_planar`` / ``packed_planar_to_limbs`` +
  ``planar_all_lt_const``, on the shipped config and the three configs of
  ``tests/test_jax_kernels.py``'s wire test (the 2^96 boundary among them);
- ``DeviceAggregator.validate_wire_updates`` / ``validate_planar_updates``
  against a one-device ``ShardedAggregator(kernel="xla")``, ``None`` in the
  same places;
- the caller-thread folds of device rows against the JAX pipeline's;
- a port ``StagedAggregator`` fed lazy v1/v2 objects, with an invalid and a
  count-mismatched member in the prevalidated group, against the JAX
  ``StagedAggregator(device=True, kernel="xla")``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xaynet_tpu.core.mask import BoundType, DataType, GroupType, Masker, MaskConfig, ModelType, Scalar
from xaynet_tpu.core.mask import serialization as jax_ser
from xaynet_tpu.core.mask.masking import AggregationError as JaxAggregationError
from xaynet_tpu.core.mask.object import MaskVect as JaxMaskVect
from xaynet_tpu.ops import limbs as jax_limbs
from xaynet_tpu.ops import limbs_jax
from xaynet_tpu.parallel.aggregator import ShardedAggregator
from xaynet_tpu.parallel.mesh import make_mesh
from xaynet_tpu.parallel.streaming import StreamingAggregator as JaxStreamingAggregator
from xaynet_tpu.server.aggregation import StagedAggregator as JaxStagedAggregator
from xaynet_tpu_torch import convert
from xaynet_tpu_torch.core.mask import serialization as ser
from xaynet_tpu_torch.core.mask.config import MaskConfig as PortMaskConfig
from xaynet_tpu_torch.core.mask.masking import AggregationError
from xaynet_tpu_torch.core.mask.object import LazyWireMaskVect
from xaynet_tpu_torch.ops import kernels
from xaynet_tpu_torch.ops.fold import to_numpy_u32
from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator
from xaynet_tpu_torch.parallel.streaming import StreamingAggregator, StreamingError
from xaynet_tpu_torch.server.aggregation import StagedAggregator

CPU = torch.device("cpu")
MAIN = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)
CONFIGS = {
    "prime-f32-m3": MAIN,
    "int-f32-m6": MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M6),
    "pow2-2^96": MaskConfig(GroupType.POWER2, DataType.I32, BoundType.BMAX, ModelType.M9),
    "prime-f64-multilimb": MaskConfig(GroupType.PRIME, DataType.F64, BoundType.B6, ModelType.M3),
}
CFG_IDS = list(CONFIGS)


def _port_cfg(cfg) -> PortMaskConfig:
    return PortMaskConfig.from_bytes(cfg.to_bytes())


def _elements(cfg, k: int, n: int, seed: int, plant: bool) -> np.ndarray:
    """``k`` updates of ``n`` elements as wire limbs ``uint32[k, n, L]``:
    random valid elements, every 13th ``order - 1``; with ``plant``, update
    0 holds an all-0xFF element first, update ``k // 2`` the order itself
    in the middle and update ``k - 1`` all-0xFF bytes last (each invalid
    unless the order is ``2^(32L)``)."""
    order, bpn = cfg.order, cfg.bytes_per_number
    n_limb = jax_limbs.n_limbs_for_order(order)
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 1 << 32, size=(k, n, n_limb), dtype=np.uint64).astype(np.uint32)
    pow2 = order == 1 << (32 * n_limb)
    if not pow2:
        top = int(jax_limbs.int_to_limbs(order, n_limb)[-1])
        out[..., n_limb - 1] = rng.integers(0, top, size=(k, n), dtype=np.uint64)
        out[:, ::13] = jax_limbs.int_to_limbs(order - 1, n_limb)
    if plant:
        ones = jax_limbs.int_to_limbs((1 << (8 * bpn)) - 1, n_limb)
        out[0, 0] = ones
        out[k - 1, n - 1] = ones
        if not pow2:
            out[k // 2, n // 2] = jax_limbs.int_to_limbs(order, n_limb)
    return out


def _v1(cfg, rows: np.ndarray) -> np.ndarray:
    """Interleaved wire element blocks ``uint8[K, n * bpn]`` (JAX codec)."""
    bpn = cfg.bytes_per_number
    return np.stack([np.frombuffer(jax_limbs.limbs_to_bytes_le(r, bpn), np.uint8) for r in rows])


def _v2(cfg, rows: np.ndarray) -> np.ndarray:
    """Byte-planar wire element blocks ``uint8[K, bpn, n]``."""
    k, n = rows.shape[:2]
    return np.ascontiguousarray(_v1(cfg, rows).reshape(k, n, -1).transpose(0, 2, 1))


def _jax_verdicts(planar, order: int) -> list[bool]:
    return np.asarray(limbs_jax.planar_all_lt_const(planar, order)).tolist()


# --- serialization ----------------------------------------------------------


@pytest.mark.parametrize("planar", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("name", CFG_IDS)
def test_serialization_matches_jax(name, planar):
    cfg = CONFIGS[name]
    rng = np.random.default_rng(1)
    w = rng.uniform(-1, 1, 41).astype(np.float32)
    _, masked = Masker(cfg.pair()).mask(Scalar(1, 3), w)
    port_obj = convert.mask_object(masked)
    wire = jax_ser.serialize_mask_object(masked, planar_vect=planar)
    assert ser.serialize_mask_object(port_obj, planar_vect=planar) == wire
    assert ser.serialize_mask_vect(port_obj.vect, planar=planar) == jax_ser.serialize_mask_vect(
        masked.vect, planar=planar
    )
    assert ser.serialized_object_length(port_obj.config, 41) == len(wire)
    assert ser.serialized_object_length(port_obj.config, 41) == jax_ser.serialized_object_length(
        masked.config, 41
    )

    eager, used = ser.parse_mask_object(wire)
    want, want_used = jax_ser.parse_mask_object(wire)
    assert used == want_used == len(wire)
    assert np.array_equal(eager.vect.data, want.vect.data)
    assert np.array_equal(eager.unit.data, want.unit.data)

    lazy, used = ser.parse_mask_object(wire, lazy_vect=True)
    jax_lazy, _ = jax_ser.parse_mask_object(wire, lazy_vect=True)
    assert used == len(wire)
    assert isinstance(lazy.vect, LazyWireMaskVect) and lazy.vect.planar is planar
    assert not lazy.vect.materialized and len(lazy.vect) == 41
    # zero-copy: the element block is a view of the message
    assert np.shares_memory(lazy.vect.wire_block, np.frombuffer(wire, np.uint8))
    assert np.array_equal(lazy.vect.wire_block, jax_lazy.vect.wire_block)
    if planar:
        assert np.array_equal(lazy.vect.planar_block, jax_lazy.vect.planar_block)
        # an untouched v2 lazy vect re-emits its block as it is
        assert ser.serialize_mask_vect(lazy.vect, planar=True) == jax_ser.serialize_mask_vect(
            masked.vect, planar=True
        )
    else:
        with pytest.raises(ValueError, match="interleaved"):
            lazy.vect.planar_block
    assert np.array_equal(lazy.vect.data, want.vect.data)
    assert lazy.vect.materialized and lazy.vect.is_valid()


def test_vect_element_block_and_parse_errors_match_jax():
    cfg = _port_cfg(MAIN)
    vect = JaxMaskVect(MAIN, jax_limbs.ints_to_limbs([1, 2, 3], 2))
    wire = jax_ser.serialize_mask_vect(vect)
    assert np.array_equal(ser.vect_element_block(wire), jax_ser.vect_element_block(wire))
    assert ser.vect_element_block(wire).shape == (3 * cfg.bytes_per_number,)
    bad_inputs = {
        "too short": wire[:5],
        "framed element count": wire[:-1],
        "invalid mask config": b"\xff\xff\xff\xff" + wire[4:],
    }
    for match, data in bad_inputs.items():
        with pytest.raises(ser.DecodeError, match=match):
            ser.vect_element_block(data)
        with pytest.raises(jax_ser.DecodeError, match=match):
            jax_ser.vect_element_block(data)
    with pytest.raises(ser.DecodeError, match="framed element count"):
        ser.vect_element_block(wire + b"\x00\x00")
    with pytest.raises(ser.DecodeError, match="planar"):
        ser.vect_element_block(jax_ser.serialize_mask_vect(vect, planar=True))
    with pytest.raises(ser.DecodeError, match="truncated"):
        ser.parse_mask_vect(wire[:-1])
    # an element >= order: the eager parse rejects it, the lazy one defers
    raw = bytearray(wire)
    raw[ser.VECT_HEADER_LENGTH : ser.VECT_HEADER_LENGTH + 6] = b"\xff" * 6
    with pytest.raises(ser.DecodeError, match="group order"):
        ser.parse_mask_vect(bytes(raw))
    with pytest.raises(jax_ser.DecodeError, match="group order"):
        jax_ser.parse_mask_vect(bytes(raw))
    lazy, _ = ser.parse_mask_vect(bytes(raw), lazy=True)
    assert not lazy.is_valid()  # materializes, then the host rule rejects
    assert ser.WIRE_PLANAR_FLAG == jax_ser.WIRE_PLANAR_FLAG


# --- K3 and K4: plain versions and CPU wrappers ------------------------------


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("name", CFG_IDS)
def test_wire_unpack_plain_matches_jax(name, k):
    cfg = CONFIGS[name]
    n = 37
    rows = _elements(cfg, k, n, seed=k, plant=k > 1)
    raw = _v1(cfg, rows)
    want = limbs_jax.wire_bytes_to_planar(jnp.asarray(raw), n, cfg.bytes_per_number)
    ok = _jax_verdicts(want, cfg.order)
    for fn in (kernels.wire_unpack_plain, kernels.wire_unpack):
        planar, bad = fn(torch.from_numpy(raw), cfg.order)
        assert planar.dtype == torch.uint32 and bad.dtype == torch.uint32
        assert np.array_equal(to_numpy_u32(planar), np.asarray(want))
        assert [int(b) == 0 for b in to_numpy_u32(bad)] == ok
    pow2 = cfg.order == 1 << (32 * jax_limbs.n_limbs_for_order(cfg.order))
    if k > 1:  # the planted updates, and only they, are rejected
        assert ok == [pow2 or i not in (0, k // 2, k - 1) for i in range(k)]


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("name", CFG_IDS)
def test_packed_check_plain_matches_jax(name, k):
    cfg = CONFIGS[name]
    n = 37
    n_limb = jax_limbs.n_limbs_for_order(cfg.order)
    packed = _v2(cfg, _elements(cfg, k, n, seed=10 + k, plant=k > 1))
    want = limbs_jax.packed_planar_to_limbs(jnp.asarray(packed), n_limb)
    ok = _jax_verdicts(want, cfg.order)
    for fn in (kernels.packed_check_plain, kernels.packed_check):
        bad = fn(torch.from_numpy(packed), cfg.order)
        assert [int(b) == 0 for b in to_numpy_u32(bad)] == ok


def test_wire_order_edges_match_jax():
    """The order itself is invalid and ``order - 1`` valid, at the first and
    the last element, in both layouts."""
    cfg = MAIN
    n_limb = jax_limbs.n_limbs_for_order(cfg.order)
    rows = _elements(cfg, 4, 19, seed=5, plant=False)
    rows[0, 0] = rows[1, -1] = jax_limbs.int_to_limbs(cfg.order, n_limb)
    rows[2, 0] = rows[3, -1] = jax_limbs.int_to_limbs(cfg.order - 1, n_limb)
    _, bad = kernels.wire_unpack(torch.from_numpy(_v1(cfg, rows)), cfg.order)
    assert to_numpy_u32(bad).tolist() == [1, 1, 0, 0]
    bad = kernels.packed_check(torch.from_numpy(_v2(cfg, rows)), cfg.order)
    assert to_numpy_u32(bad).tolist() == [1, 1, 0, 0]
    want = limbs_jax.wire_bytes_to_planar(jnp.asarray(_v1(cfg, rows)), 19, cfg.bytes_per_number)
    assert _jax_verdicts(want, cfg.order) == [False, False, True, True]


def test_wire_wrappers_check_their_arguments():
    order = MAIN.order
    with pytest.raises(ValueError, match="uint8"):
        kernels.wire_unpack(torch.zeros((1, 12), dtype=torch.int32), order)
    with pytest.raises(ValueError, match="n \\* 6"):
        kernels.wire_unpack(torch.zeros((1, 13), dtype=torch.uint8), order)
    with pytest.raises(ValueError, match="uint8\\[K, 6, n\\]"):
        kernels.packed_check(torch.zeros((1, 5, 4), dtype=torch.uint8), order)
    planar, bad = kernels.wire_unpack(torch.zeros((0, 12), dtype=torch.uint8), order)
    assert planar.shape == (0, 2, 2) and bad.shape == (0,)


def test_wire_launch_counters_untouched_on_cpu():
    kernels.reset_launches()
    raw = torch.from_numpy(_v1(MAIN, _elements(MAIN, 2, 9, seed=0, plant=False)))
    kernels.wire_unpack(raw, MAIN.order)
    kernels.packed_check(raw.view(2, 6, 9), MAIN.order)
    assert kernels.LAUNCHES["wire_unpack"] == kernels.LAUNCHES["packed_check"] == 0


# --- DeviceAggregator.validate_*_updates ------------------------------------


def _jax_aggregator(cfg, n: int) -> ShardedAggregator:
    return ShardedAggregator(cfg, n, mesh=make_mesh(jax.devices()[:1]), kernel="xla")


@pytest.mark.parametrize("name", CFG_IDS)
def test_validate_updates_match_jax(name):
    cfg = CONFIGS[name]
    n, k = 29, 5
    rows = _elements(cfg, k, n, seed=3, plant=True)
    jax_agg = _jax_aggregator(cfg, n)
    agg = DeviceAggregator(_port_cfg(cfg), n, device=CPU)

    raws = list(_v1(cfg, rows))
    want = jax_agg.validate_wire_updates(raws)
    got = agg.validate_wire_updates(raws)
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        if w is not None:
            assert g.shape == (agg.n_limbs, n) and g.dtype == torch.uint32
            assert np.array_equal(to_numpy_u32(g), np.asarray(w))

    planes = list(_v2(cfg, rows))
    want = jax_agg.validate_planar_updates(planes)
    got = agg.validate_planar_updates(planes)
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == torch.uint8 and np.array_equal(g.numpy(), np.asarray(w))

    # a group of one: the JAX package's single-update entry points
    (one,) = agg.validate_wire_updates([raws[1]])
    assert np.array_equal(to_numpy_u32(one), np.asarray(jax_agg.validate_wire_update(raws[1])))
    assert (agg.validate_planar_updates([planes[0]])[0] is None) == (
        jax_agg.validate_planar_update(planes[0]) is None
    )
    assert agg.validate_wire_updates([]) == agg.validate_planar_updates([]) == []


def test_validate_updates_shape_guards():
    n = 11
    agg = DeviceAggregator(_port_cfg(MAIN), n, device=CPU)
    with pytest.raises(ValueError, match="model_len \\* bytes_per_number"):
        agg.validate_wire_updates([np.zeros(n * 6 + 1, np.uint8)])
    with pytest.raises(ValueError, match="model_len \\* bytes_per_number"):
        agg.validate_wire_updates([np.zeros(n * 6, np.uint32)])
    with pytest.raises(ValueError, match="bytes_per_number, model_len"):
        agg.validate_planar_updates([np.zeros((5, n), np.uint8)])
    # a member of the other layout's rank
    with pytest.raises(ValueError, match="model_len \\* bytes_per_number"):
        agg.validate_wire_updates([np.zeros((6, n), np.uint8)])
    with pytest.raises(ValueError, match="bytes_per_number, model_len"):
        agg.validate_planar_updates([np.zeros(6 * n, np.uint8)])


# --- caller-thread folds of device rows -------------------------------------


@pytest.mark.parametrize("planar", [False, True], ids=["v1", "v2"])
def test_fold_rows_now_matches_jax(planar):
    """Eleven device rows (a chunk of 8 and one of 3) fold on the caller's
    thread to the JAX pipeline's aggregate and count."""
    cfg = MAIN
    n, k = 31, 11
    rows = _elements(cfg, k, n, seed=21, plant=False)
    jax_agg = _jax_aggregator(cfg, n)
    jax_stream = JaxStreamingAggregator(jax_agg, max_batch=4)
    agg = DeviceAggregator(_port_cfg(cfg), n, device=CPU)
    stream = StreamingAggregator(agg, max_batch=4)
    chunks = []
    real = agg._packed_fold_fn if planar else agg._fold_fn

    def seam(acc, staged):
        chunks.append((int(staged.shape[0]), staged.dtype))
        return real(acc, staged)

    if planar:
        agg._packed_fold_fn = seam
        jax_stream.fold_packed_rows_now(jax_agg.validate_planar_updates(list(_v2(cfg, rows))))
        stream.fold_packed_rows_now(agg.validate_planar_updates(list(_v2(cfg, rows))))
    else:
        agg._fold_fn = seam
        jax_stream.fold_planar_rows_now(jax_agg.validate_wire_updates(list(_v1(cfg, rows))))
        stream.fold_planar_rows_now(agg.validate_wire_updates(list(_v1(cfg, rows))))
    dtype = torch.uint8 if planar else torch.uint32
    assert chunks == [(8, dtype), (3, dtype)]
    jax_stream.drain()
    stream.drain()
    assert np.array_equal(agg.snapshot(), jax_agg.snapshot())
    assert agg.nb_models == jax_agg.nb_models == k
    stream.fold_planar_rows_now([])  # nothing to fold: no error
    stream.close()
    jax_stream.close()
    with pytest.raises(StreamingError, match="closed"):
        stream.fold_planar_rows_now(agg.validate_wire_updates(list(_v1(cfg, rows[:1]))))


def test_fold_rows_now_poisons_on_a_fold_error():
    """K1 folds in place: a caller-thread fold that raises poisons the
    pipeline, and every later drain raises."""
    cfg = MAIN
    n = 17
    agg = DeviceAggregator(_port_cfg(cfg), n, device=CPU)
    stream = StreamingAggregator(agg, max_batch=2)
    rows = agg.validate_wire_updates(list(_v1(cfg, _elements(cfg, 2, n, seed=2, plant=False))))

    def boom(acc, staged):
        raise RuntimeError("fold died (stand-in)")

    agg._fold_fn = boom
    with pytest.raises(StreamingError, match="fold died"):
        stream.fold_planar_rows_now(rows)
    with pytest.raises(StreamingError):
        stream.drain()
    assert agg.nb_models == 0
    stream.close()


# --- StagedAggregator: the Update phase with wire ingest --------------------


def _masked(cfg, count: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [
        Masker(cfg.pair()).mask(Scalar(1, count), rng.uniform(-1, 1, n).astype(np.float32))[1]
        for _ in range(count)
    ]


def _wires(cfg, n: int, seed: int) -> list[tuple[str, bytes]]:
    """A micro-batch of eight serialized updates, v1 at even and v2 at odd
    indices: an invalid v1 member (its third element all 0xFF) at index 4,
    a v2 member of the wrong element count at index 5, an invalid v2 member
    (its last element all 0xFF) at index 7, the others valid."""
    masked = _masked(cfg, 8, n, seed)
    short = _masked(cfg, 1, n - 3, seed + 1)[0]
    bpn = cfg.bytes_per_number
    out = []
    for i, m in enumerate(masked):
        obj = short if i == 5 else m
        wire = bytearray(jax_ser.serialize_mask_object(obj, planar_vect=i % 2 == 1))
        head = jax_ser.VECT_HEADER_LENGTH
        if i == 4:  # v1: element 2 is bytes [2 bpn, 3 bpn) of the block
            wire[head + 2 * bpn : head + 3 * bpn] = b"\xff" * bpn
        if i == 7:  # v2: the last element's byte b is the last byte of plane b
            for b in range(bpn):
                wire[head + (b + 1) * n - 1] = 0xFF
        out.append(bytes(wire))
    return out


def _run_round(agg, parse, wires, host_objs, prevalidate: bool):
    objs = [parse(w, lazy_vect=True)[0] for w in wires]
    if prevalidate:
        agg.prevalidate_wire_batch(objs)
    rejected = {}
    for i, obj in enumerate(objs + host_objs):
        try:
            agg.validate_aggregation(obj)
        except (AggregationError, JaxAggregationError) as e:
            rejected[i] = e.kind
            continue
        agg.aggregate(obj)
    return objs, rejected


@pytest.mark.parametrize("prevalidate", [True, False], ids=["prevalidated", "per-member"])
@pytest.mark.parametrize("batch", [3, 8])
@pytest.mark.parametrize("name", ["prime-f32-m3", "int-f32-m6"])
def test_staged_wire_ingest_round_matches_jax(name, batch, prevalidate):
    cfg = CONFIGS[name]
    n = 57
    wires = _wires(cfg, n, seed=40)
    host = _masked(cfg, 2, n, seed=41)  # eager members: the pipeline's ring
    jax_agg = JaxStagedAggregator(cfg.pair(), n, device=True, batch_size=batch, kernel="xla")
    port = StagedAggregator(convert.config_pair(cfg.pair()), n, batch_size=batch, device=CPU)
    routes = []
    for method in ("fold_packed_rows_now", "fold_planar_rows_now", "submit_batch"):
        real = getattr(port._stream, method)

        def spy(rows, real=real, method=method):
            if len(rows):
                routes.append((method, len(rows)))
            return real(rows)

        setattr(port._stream, method, spy)

    jax_objs, jax_rejected = _run_round(jax_agg, jax_ser.parse_mask_object, wires, host,
                                        prevalidate)
    objs, rejected = _run_round(port, ser.parse_mask_object, wires,
                                [convert.mask_object(m) for m in host], prevalidate)
    assert rejected == jax_rejected == {4: "InvalidObject", 5: "ModelMismatch", 7: "InvalidObject"}
    assert not any(o.vect.materialized for o in objs)  # no host element parse
    assert port.nb_models == jax_agg.nb_models == 7
    vect, unit, nb = port.snapshot_state()
    want_vect, want_unit, want_nb = jax_agg.snapshot_state()
    assert np.array_equal(vect, want_vect) and np.array_equal(unit, want_unit)
    assert nb == want_nb == 7
    # device rows folded on the caller's thread by layout, host rows piped
    assert sum(k for m, k in routes if m == "fold_planar_rows_now") == 3  # v1: 0, 2, 6
    assert sum(k for m, k in routes if m == "fold_packed_rows_now") == 2  # v2: 1, 3
    assert sum(k for m, k in routes if m == "submit_batch") == 2
