"""The population engine: blocks of valid masked updates, derived on the device.

Port of ``xaynet_tpu/loadgen/population.py``. A production update
participant computes ``masked = encode(model) + derive_mask(seed)`` in the
group. The engine runs exactly that for a block of participants at a time:
the production fixed-point encode of the block on the host, one upload,
then K2 derives each participant's mask straight into its encoded row
(``sim.round.mask_rows``, the sim's own block step), and the masked rows come back to the host for
serialization. The output rows are ordinary ``uint32`` limb tensors; the
forge (``loadgen.build``) runs them through the production serialization,
so the wire bytes are what a real SDK would have sent for the same (seed,
model, scalar): byte-correct traffic, not fuzz.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..core.mask.config import MaskConfigPair
from ..core.mask.encode import clamp_scalar
from ..device import resolve_device
from ..ops import limbs as host_limbs
from ..ops.fold import to_device_u32, to_numpy_u32
from ..ops.masking import seed_words
from ..sim.round import encode_block, mask_rows
from ..telemetry import profiling


class PopulationEngine:
    """A masked-update generator for a fixed (config, length) on one device.

    ``emit(seeds, weights, scalar)`` returns the whole population's masked
    vect/unit limbs; the population is processed in blocks of
    ``block_size`` participants (device memory ~ two blocks of planar
    rows). ``device`` is CUDA unless given.
    """

    def __init__(
        self, config: MaskConfigPair, model_length: int, block_size: int = 512, device=None
    ):
        if model_length < 1:
            raise ValueError("model_length must be >= 1")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.config = config
        self.model_length = model_length
        self.block_size = block_size
        self.device = resolve_device(device)
        self.program_calls = 0  # one per BLOCK, never per participant

    def emit(
        self,
        seeds: list[bytes] | np.ndarray,
        weights: np.ndarray,
        scalar: Fraction = Fraction(1),
    ) -> tuple[np.ndarray, np.ndarray]:
        """Masked updates for the whole population.

        ``seeds`` are 32-byte mask seeds (or ``uint32[P, 8]`` key words),
        ``weights`` the ``[P, model_length]`` local models; every
        participant shares ``scalar`` (the homogeneous-population shape a
        soak uses: ``1/P``). Returns ``(masked_vects uint32[P, n, L],
        masked_units uint32[P, L1])``: the exact limbs ``Masker.mask``
        would produce per participant.
        """
        if isinstance(seeds, np.ndarray):
            kw = np.asarray(seeds, dtype=np.uint32)
        else:
            kw = seed_words(list(seeds))
        if kw.ndim != 2 or kw.shape[1] != 8:
            raise ValueError("seeds must be 32-byte strings or uint32[P, 8] key words")
        p = kw.shape[0]
        if p < 1:
            raise ValueError("need at least one participant")
        weights = np.asarray(weights)
        if weights.shape != (p, self.model_length):
            raise ValueError(
                f"weights must be [{p}, {self.model_length}], got {weights.shape}"
            )
        cfg, n, dev = self.config, self.model_length, self.device
        s_clamped = clamp_scalar(scalar, cfg.unit)
        out_v = np.empty((p, n, host_limbs.n_limbs_for_order(cfg.vect.order)), dtype=np.uint32)
        out_u = np.empty((p, host_limbs.n_limbs_for_order(cfg.unit.order)), dtype=np.uint32)
        for start in range(0, p, self.block_size):
            stop = min(start + self.block_size, p)
            rows = to_device_u32(encode_block(weights[start:stop], s_clamped, cfg.vect), dev)
            _, masked_units = profiling.timed_kernel(
                "loadgen_emit",
                (stop - start) * n,
                lambda rows=rows, kw_b=kw[start:stop]: mask_rows(rows, kw_b, s_clamped, cfg),
                device=dev,
            )
            out_u[start:stop] = masked_units
            self.program_calls += 1
            out_v[start:stop] = to_numpy_u32(rows).transpose(0, 2, 1)
            del rows
        return out_v, out_u
