"""The port's batch fold (kernel K1's plain version) against the JAX package.

Same inputs, made from a seed with numpy, go through
``xaynet_tpu.ops.fold_jax`` / ``fold_pallas`` (interpret mode) and through
``xaynet_tpu_torch`` on the CPU, where the wrappers run K1's plain torch
version. Tolerance 0: the limbs must be byte-identical (exact modular
arithmetic).

The 67-limb orders are held against the python big-int oracle and the
reference's host limb fold instead: XLA's CPU compile of the 67-limb
``fold_planar_batch`` takes ~24 s and of the Pallas fold several minutes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xaynet_tpu.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
from xaynet_tpu.ops import fold_jax, fold_pallas, limbs as ref_limbs
from xaynet_tpu_torch.ops import fold, kernels
from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator

CPU = torch.device("cpu")
# the suite runs in several worker processes at once: keep torch's CPU ops
# on one thread each so they do not crowd the other workers
torch.set_num_threads(1)

CFG_L2 = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)  # 2 limbs, bpn 6
CFG_L3 = MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B0, ModelType.M9)  # 3 limbs
CFG_WRAP = MaskConfig(GroupType.POWER2, DataType.I32, BoundType.BMAX, ModelType.M9)  # 2^96
CFG_L10 = MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.BMAX, ModelType.M3)  # 10 limbs
CFG_L67 = MaskConfig(GroupType.INTEGER, DataType.F64, BoundType.BMAX, ModelType.M12)  # 67 limbs
CFG_L66_WRAP = MaskConfig(GroupType.POWER2, DataType.F64, BoundType.BMAX, ModelType.M3)  # 2^2112


def _port_config(cfg):
    from xaynet_tpu_torch.core.mask.config import MaskConfig as PortMaskConfig

    return PortMaskConfig.from_bytes(cfg.to_bytes())


def _elements(rng: np.random.Generator, order: int, shape: tuple[int, ...]) -> np.ndarray:
    """Uniform group elements as wire limbs ``uint32[*shape, L]``."""
    n_limb = ref_limbs.n_limbs_for_order(order)
    flat = [int.from_bytes(rng.bytes(4 * n_limb + 8), "little") % order
            for _ in range(int(np.prod(shape)))]
    return ref_limbs.ints_to_limbs(flat, n_limb).reshape(*shape, n_limb)


def _case(order: int, k: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    acc0 = fold_jax.wire_to_planar(_elements(rng, order, (n,)))
    stack = fold_jax.wire_to_planar(_elements(rng, order, (k, n)))
    return acc0, stack


def _port_fold(acc0: np.ndarray, stack: np.ndarray, order: int) -> np.ndarray:
    acc = fold.to_device_u32(acc0, CPU)
    out = fold.fold_planar_batch(acc, fold.to_device_u32(stack, CPU), order)
    assert out is acc  # in place, as the JAX function donates its accumulator
    return fold.to_numpy_u32(acc)


def _big_int_fold(acc0: np.ndarray, stack: np.ndarray, order: int) -> np.ndarray:
    n_limb = acc0.shape[0]
    acc = ref_limbs.limbs_to_ints(fold_jax.planar_to_wire(acc0))
    for row in stack:
        vals = ref_limbs.limbs_to_ints(fold_jax.planar_to_wire(row))
        acc = [(a + v) % order for a, v in zip(acc, vals)]
    return fold_jax.wire_to_planar(ref_limbs.ints_to_limbs(acc, n_limb))


@pytest.mark.parametrize("k", [1, 2, 8, 64])
@pytest.mark.parametrize("cfg", [CFG_L2, CFG_L3, CFG_WRAP, CFG_L10], ids=["L2", "L3", "L3-wrap", "L10"])
def test_plain_fold_matches_fold_jax(cfg, k):
    order = cfg.order
    acc0, stack = _case(order, k, 96, seed=k)
    want = np.asarray(fold_jax.fold_planar_batch(jnp.asarray(acc0), jnp.asarray(stack), order))
    assert np.array_equal(_port_fold(acc0, stack, order), want)


@pytest.mark.parametrize(
    "cfg,k",
    [(CFG_L2, 1), (CFG_L2, 8), (CFG_L2, 64), (CFG_WRAP, 2), (CFG_L10, 8)],
    ids=["L2-k1", "L2-k8", "L2-k64", "L3-wrap-k2", "L10-k8"],
)
def test_plain_fold_matches_pallas_interpret(cfg, k):
    order = cfg.order
    acc0, stack = _case(order, k, 128, seed=100 + k)
    want = np.asarray(
        fold_pallas.fold_planar_batch_pallas(
            jnp.asarray(acc0), jnp.asarray(stack), order, interpret=True
        )
    )
    assert np.array_equal(_port_fold(acc0, stack, order), want)


def test_plain_fold_ragged_length_matches_pallas_tiles():
    """A model length that is not a multiple of the Pallas tile (which
    zero-pads internally): the port takes any n without padding."""
    order = CFG_L2.order
    n = 2 * fold_pallas.TILE + 37
    acc0, stack = _case(order, 8, n, seed=7)
    want = np.asarray(
        fold_pallas.fold_planar_batch_pallas(
            jnp.asarray(acc0), jnp.asarray(stack), order, interpret=True
        )
    )
    assert np.array_equal(_port_fold(acc0, stack, order), want)


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("cfg", [CFG_L67, CFG_L66_WRAP], ids=["L67", "L66-wrap"])
def test_plain_fold_wide_orders(cfg, k):
    """66/67-limb orders: big-int oracle and the reference's host limb fold."""
    order = cfg.order
    acc0, stack = _case(order, k, 24, seed=200 + k)
    got = _port_fold(acc0, stack, order)
    assert np.array_equal(got, _big_int_fold(acc0, stack, order))
    ol = ref_limbs.order_limbs_for(order)
    host = ref_limbs.mod_add(
        fold_jax.planar_to_wire(acc0),
        ref_limbs.batch_mod_sum(np.ascontiguousarray(stack.transpose(0, 2, 1)), ol),
        ol,
    )
    assert np.array_equal(fold_jax.planar_to_wire(got), host)


def test_plain_fold_headroom_edge():
    """K = 65535, the lazy-carry headroom, at a tiny n (all-max elements
    stress every carry); one more update is refused."""
    order = CFG_L2.order
    n_limb = 2
    top = ref_limbs.int_to_limbs(order - 1, n_limb)
    stack = np.broadcast_to(top[None, :, None], (fold_jax.MAX_LAZY_BATCH, n_limb, 4)).copy()
    acc0 = np.broadcast_to(top[:, None], (n_limb, 4)).copy()
    want = np.asarray(fold_jax.fold_planar_batch(jnp.asarray(acc0), jnp.asarray(stack), order))
    got = _port_fold(acc0, stack, order)
    assert np.array_equal(got, want)
    expect = ((fold_jax.MAX_LAZY_BATCH + 1) * (order - 1)) % order
    assert ref_limbs.limbs_to_ints(fold_jax.planar_to_wire(got)) == [expect] * 4
    too_big = torch.zeros((fold_jax.MAX_LAZY_BATCH + 1, n_limb, 4), dtype=torch.uint32)
    with pytest.raises(ValueError, match="headroom"):
        fold.fold_planar_batch(fold.zeros_u32((n_limb, 4), CPU), too_big, order)


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize(
    "cfg",
    [CFG_L2, MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.B2, ModelType.M12), CFG_WRAP],
    ids=["L2-bpn6", "L3-bpn11", "L3-wrap-bpn12"],
)
def test_plain_packed_fold_matches_fold_jax(cfg, k):
    """K1's packed variant (limbs assembled from byte planes) against
    ``fold_jax.fold_packed_batch``."""
    order = cfg.order
    n_limb = ref_limbs.n_limbs_for_order(order)
    acc0, stack = _case(order, k, 80, seed=300 + k)
    packed = ref_limbs.pack_planar(stack, ref_limbs.wire_width_for(order))
    want = np.asarray(
        fold_jax.fold_packed_batch(jnp.asarray(acc0), jnp.asarray(packed), n_limb, order)
    )
    acc = fold.to_device_u32(acc0, CPU)
    fold.fold_packed_batch(acc, torch.from_numpy(packed), n_limb, order)
    assert np.array_equal(fold.to_numpy_u32(acc), want)


def test_planar_mod_sub_matches_fold_jax():
    """The Unmask subtract (plain torch on every device) against
    ``fold_jax.p_mod_sub``."""
    for cfg in (CFG_L2, CFG_WRAP, CFG_L10):
        order = cfg.order
        acc0, stack = _case(order, 1, 64, seed=400)
        want = np.asarray(fold_jax.p_mod_sub(jnp.asarray(acc0), jnp.asarray(stack[0]), order))
        got = fold.mod_sub_planar(fold.to_device_u32(acc0, CPU), fold.to_device_u32(stack[0], CPU), order)
        assert np.array_equal(fold.to_numpy_u32(got), want)


def test_device_aggregator_matches_host_aggregation():
    """``DeviceAggregator`` (two planar batches, one packed) against the
    reference's host limb aggregate; unmask, snapshot and restore."""
    from xaynet_tpu.core.mask.masking import Aggregation

    order = CFG_L2.order
    rng = np.random.default_rng(11)
    stack = _elements(rng, order, (7, 50))
    mask = _elements(rng, order, (50,))
    agg = DeviceAggregator(_port_config(CFG_L2), 50, device=CPU)
    assert agg.kernel_used == "plain"
    agg.add_batch(stack[:3])
    agg.add_batch(stack[3:5])
    packed = ref_limbs.pack_wire(stack[5:], agg.packed_width)
    agg.add_packed_batch(torch.from_numpy(packed))
    host = Aggregation(CFG_L2.pair(), 50)
    host.aggregate_batch(stack, np.zeros((7, 2), np.uint32))
    assert agg.nb_models == 7
    assert np.array_equal(agg.snapshot(), host.object.vect.data)
    ol = ref_limbs.order_limbs_for(order)
    assert np.array_equal(agg.unmask_limbs(mask), ref_limbs.mod_sub(host.object.vect.data, mask, ol))
    again = DeviceAggregator(_port_config(CFG_L2), 50, device=CPU)
    again.restore(agg.snapshot(), agg.nb_models)
    assert np.array_equal(again.snapshot(), agg.snapshot()) and again.nb_models == 7
    again.reset()
    assert again.nb_models == 0 and not again.snapshot().any()


def test_kernel_launch_counter_untouched_on_cpu():
    """On CPU tensors the wrappers run the plain versions: no launch counts."""
    kernels.reset_launches()
    acc0, stack = _case(CFG_L2.order, 2, 16, seed=1)
    _port_fold(acc0, stack, CFG_L2.order)
    assert kernels.LAUNCHES == {
        "fold_planar": 0, "fold_packed": 0, "mask_fold": 0, "mask_fold_rows": 0, "wire_unpack": 0,
        "packed_check": 0, "unit_draws": 0, "wire_fold": 0, "wire_unfold": 0,
    }


# --- K6's staging geometry (csrc/fold.cu), on the host ----------------------

WIRE_WIDTHS = sorted({
    (ref_limbs.n_limbs_for_order(c.order), ref_limbs.wire_width_for(c.order))
    for c in (MaskConfig(g, d, b, m) for g in GroupType for d in DataType for b in BoundType
              for m in ModelType)
})  # fmt: skip


def _k6_constants() -> dict:
    """The constants and the columns-a-thread rule of ``csrc/fold.cu``'s K6."""
    import re

    src = (kernels.CSRC / "fold.cu").read_text()

    def const(name: str) -> int:
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    cpt = re.search(r"return lt == 2 \? (\d+) : \(lt == 3 \|\| lt == 4\) \? (\d+) : (\d+);", src)
    two, three_four, other = (int(g) for g in cpt.groups())
    return {"stages": const("kWireStages"), "tile_bytes": const("kWireTileBytes"),
            "threads": const("kThreads"),
            "cpt": lambda L: two if L == 2 else three_four if L in (3, 4) else other}  # fmt: skip


@pytest.mark.parametrize("n_limb,bpn", WIRE_WIDTHS)
def test_k6_staging_geometry_covers_every_width_and_base(n_limb, bpn):
    """K6's tile and stage arithmetic (``wire_cpt``, ``wire_threads``,
    ``wire_stage_bytes``, ``wire_run`` of ``csrc/fold.cu``) reckoned by
    brute force at every width of the repo's orders, for tensors starting
    0-15 bytes past a 16-byte boundary and lengths at and around the tile:
    the copied hulls stay inside the tensor, every byte of a run outside
    its hull lies in the tensor's first or last 16 bytes, every shared read
    stays inside its stage, four stages need no opt-in above 48 KB, and the
    card tests' ``_wire_tile`` names the same tile."""
    import importlib.util

    k6 = _k6_constants()
    cpt = k6["cpt"](n_limb) if n_limb <= 5 else 1
    threads = k6["threads"]
    while threads > 32 and threads * cpt * bpn > k6["tile_bytes"]:
        threads //= 2
    tile = cpt * threads
    stage = (tile * bpn + 32 + 15) & ~15
    assert k6["stages"] * stage <= 48 * 1024
    if n_limb <= 5:
        assert threads == k6["threads"]  # the kernel's compile-time width
    spec = importlib.util.spec_from_file_location("cuda_tests", kernels.CSRC.parents[1] / "tests"
                                                  / "test_torch_cuda.py")  # fmt: skip
    cuda_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cuda_tests)
    assert cuda_tests._wire_tile(n_limb, bpn) == tile

    def up(x):
        return (x + 15) & ~15

    def down(x):
        return x & ~15

    k = 3
    for n in (tile - 1, tile, tile + 1, 1001):
        for origin in range(16):
            total = k * n * bpn
            in_lo, in_hi = up(origin), down(origin + total)
            for m in range(k):
                for c0 in range(0, n, tile):
                    cols = min(tile, n - c0)
                    run = origin + (m * n + c0) * bpn
                    end = run + cols * bpn
                    base = down(run)
                    lo, hi = max(base, in_lo), min(up(end), in_hi)
                    if lo >= hi:  # nothing to copy: the run is in the first or last bytes
                        assert end <= in_lo or run >= in_hi
                        continue
                    assert origin <= lo and hi <= origin + total and hi - base <= stage
                    if run < lo:  # bytes before the hull: the tensor's first ones
                        assert lo == in_lo
                    if end > hi:  # bytes after it: the tensor's last ones
                        assert hi == in_hi
                    # the fast path's last shared word, for a run inside its hull
                    if lo <= run and end <= hi:
                        p = (run - base) + (cols - 1) * bpn
                        assert ((p >> 2) + n_limb) * 4 + 4 <= stage
