"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test needs an NVIDIA GPU and ``nvcc`` and skips
without them. This file imports neither JAX nor the JAX package, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``chip_smoke.py`` runs the same comparisons at the main path's sizes.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from xaynet_tpu_torch.core.crypto.prng import StreamSampler
from xaynet_tpu_torch.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
from xaynet_tpu_torch.ops import kernels, limbs
from xaynet_tpu_torch.ops.fold import to_device_u32, widen

pytestmark = pytest.mark.cuda

ORDERS = {
    "L2": MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3).order,
    "L3-2^96": MaskConfig(GroupType.POWER2, DataType.I32, BoundType.BMAX, ModelType.M9).order,
    "L4-draw17": MaskConfig(GroupType.POWER2, DataType.F64, BoundType.B6, ModelType.M12).order,
    "L10": MaskConfig(GroupType.INTEGER, DataType.F32, BoundType.BMAX, ModelType.M3).order,
    "L67": MaskConfig(GroupType.INTEGER, DataType.F64, BoundType.BMAX, ModelType.M12).order,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    try:
        kernels.nvcc_path()
    except RuntimeError as exc:
        pytest.skip(str(exc))
    return torch.device("cuda")


def _elements(order: int, shape: tuple[int, ...], seed: int) -> np.ndarray:
    """Planar limbs of valid group elements (top limb below the order's)."""
    rng = np.random.default_rng(seed)
    n_limb = limbs.n_limbs_for_order(order)
    *lead, n = shape
    out = rng.integers(0, 1 << 32, size=(*lead, n_limb, n), dtype=np.uint64).astype(np.uint32)
    if order != 1 << (32 * n_limb):
        top = int(limbs.int_to_limbs(order, n_limb)[-1])
        out[..., n_limb - 1, :] = rng.integers(0, top, size=(*lead, n), dtype=np.uint64)
    return out


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(widen(a), widen(b)))


@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("name", ["L2", "L3-2^96", "L10", "L67"])
def test_fold_kernels_match_plain(cuda, name, k):
    order = ORDERS[name]
    n = 4099
    acc = to_device_u32(_elements(order, (n,), k), cuda)
    stack = _elements(order, (k, n), k + 1)
    planar = to_device_u32(stack, cuda)
    got = kernels.fold_planar(acc.clone(), planar, order)
    assert _same(got, kernels.fold_planar_plain(acc.clone(), planar, order))
    packed = torch.from_numpy(limbs.pack_planar(stack, limbs.wire_width_for(order))).to(cuda)
    got = kernels.fold_packed(acc.clone(), packed, order)
    assert _same(got, kernels.fold_packed_plain(acc.clone(), packed, order))


@pytest.mark.parametrize("trips", [1, 5])
@pytest.mark.parametrize("name", ["L2", "L4-draw17", "L67"])
def test_mask_fold_kernel_matches_plain_and_host(cuda, name, trips):
    order = ORDERS[name]
    n_limb = limbs.n_limbs_for_order(order)
    bpn = limbs.draw_width_for(order)
    count = 500
    seeds = [bytes([i, 7]) * 16 for i in range(3)]
    kws = to_device_u32(np.stack([np.frombuffer(s, "<u4") for s in seeds]), cuda)
    offs = [13 * i + 6 for i in range(3)]
    chunk = None if trips == 1 else max(7, count * (1 << (8 * bpn)) // order // trips)
    acc0 = to_device_u32(_elements(order, (count,), 3), cuda)
    got, ends = kernels.mask_fold(acc0.clone(), kws, offs, count, order, chunk)
    want, want_ends = kernels.mask_fold_plain(acc0.clone(), kws, offs, count, order, chunk)
    assert _same(got, want) and ends.tolist() == want_ends.tolist()
    zero = torch.zeros((n_limb, count), dtype=torch.int32, device=cuda).view(torch.uint32)
    mask, end = kernels.mask_fold(zero, kws[:1], offs[:1], count, order, chunk)
    sampler = StreamSampler(seeds[0])
    sampler.skip_bytes(offs[0])
    host = sampler.draw_limbs(count, order)
    assert np.array_equal(mask.view(torch.int32).cpu().numpy().view(np.uint32).T, host)
    assert int(end[0]) == sampler.consumed_bytes


def test_launch_counters_count_kernel_launches(cuda):
    order = ORDERS["L2"]
    kernels.reset_launches()
    acc = to_device_u32(_elements(order, (64,), 0), cuda)
    kernels.fold_planar(acc, to_device_u32(_elements(order, (2, 64), 1), cuda), order)
    kws = to_device_u32(np.zeros((2, 8), np.uint32), cuda)
    kernels.mask_fold(acc, kws, [0, 5], 64, order)
    assert kernels.LAUNCHES == {"fold_planar": 1, "fold_packed": 0, "mask_fold": 2}
