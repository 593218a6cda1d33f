"""The forge: engine rows -> sealed, signed, byte-exact update uploads.

Port of ``xaynet_tpu/loadgen/build.py``. Everything below the limb tensors
is the production encode path of the port: the same ``Update`` payload,
wire v1/v2 element serialization, seed-dict sealed boxes and Ed25519
signatures the SDK state machine emits, so a forged upload is
indistinguishable (byte for byte, given the same inputs) from a real
participant's. The only departures from the state machine are
organizational: masks are derived in blocks on the device
(``loadgen.population``) instead of one ``mask_update`` per participant,
and signing keys come from the deterministic ``keys_for_task`` search so
every forged participant really holds the update task for the round.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Optional

import numpy as np

from ..core.common import RoundParameters
from ..core.crypto.encrypt import PublicEncryptKey
from ..core.crypto.sign import SigningKeyPair
from ..core.mask.object import MaskObject, MaskUnit, MaskVect
from ..core.mask.seed import MaskSeed
from ..core.message import Message, Update
from ..sdk.simulation import keys_for_task
from .population import PopulationEngine


class UpdateForge:
    """Seals engine rows into wire-ready update messages for one round."""

    def __init__(
        self,
        params: RoundParameters,
        sum_dict: dict,
        wire_planar: Optional[bool] = None,
    ):
        self.params = params
        self.coordinator_pk = PublicEncryptKey(params.pk)
        self._ephm = {pk: PublicEncryptKey(e) for pk, e in sum_dict.items()}
        # None follows the round's negotiated wire format, like the SDK
        self.wire_planar = params.wire_format >= 2 if wire_planar is None else wire_planar
        self._round_seed = params.seed.as_bytes()

    def seal(
        self,
        keys: SigningKeyPair,
        mask_seed: bytes,
        masked_vect: np.ndarray,
        masked_unit: np.ndarray,
    ) -> bytes:
        """One sealed upload: the participant's seed dict (its mask seed
        encrypted to every sum participant's ephemeral key), the masked
        model rows, both task signatures, the sealed envelope."""
        cfg = self.params.mask_config
        masked = MaskObject(
            MaskVect(cfg.vect, np.asarray(masked_vect, dtype=np.uint32)),
            MaskUnit(cfg.unit, np.asarray(masked_unit, dtype=np.uint32)),
        )
        seed = MaskSeed(bytes(mask_seed))
        payload = Update(
            sum_signature=keys.sign(self._round_seed + b"sum").as_bytes(),
            update_signature=keys.sign(self._round_seed + b"update").as_bytes(),
            masked_model=masked,
            local_seed_dict={pk: seed.encrypt(e) for pk, e in self._ephm.items()},
            wire_planar=self.wire_planar,
        )
        message = Message(
            participant_pk=keys.public, coordinator_pk=self.params.pk, payload=payload
        )
        return self.coordinator_pk.encrypt(message.to_bytes(keys.secret))


@dataclass
class ForgedPopulation:
    """One shard's worth of ready-to-replay uploads + the ground truth a
    byte-identity control needs to reproduce them."""

    messages: list  # sealed bytes, participant order
    weights: np.ndarray  # float32[P, n] — the local models
    scalar: Fraction
    mask_seeds: list  # 32-byte mask seeds, participant order
    key_starts: list  # keys_for_task search starts, participant order


def population_inputs(n: int, length: int, rng_seed: int) -> tuple[np.ndarray, list[bytes]]:
    """The local models ``float32[n, length]`` and mask seeds that
    ``forge_population`` draws from ``rng_seed``: what a control round
    rebuilds."""
    rng = np.random.default_rng(rng_seed)
    weights = rng.uniform(-1, 1, (n, length)).astype(np.float32)
    return weights, [rng.bytes(32) for _ in range(n)]


def forge_population(
    params: RoundParameters,
    sum_dict: dict,
    n: int,
    *,
    model_length: Optional[int] = None,
    block_size: int = 512,
    key_start: int = 0,
    key_spacing: int = 1000,
    rng_seed: int = 7,
    scalar: Optional[Fraction] = None,
    wire_planar: Optional[bool] = None,
    engine: Optional[PopulationEngine] = None,
    device=None,
) -> ForgedPopulation:
    """Forge ``n`` valid update uploads for the current round.

    Deterministic per (round seed, key_start, rng_seed): a control run
    can rebuild the identical population. ``key_start``/``key_spacing``
    partition the signing-key search space exactly like ``sdk.flood`` so
    shards never collide on participant keys. The masks are derived in
    blocks of ``block_size`` on ``device`` (CUDA unless given); the
    per-participant crypto (signatures, seed boxes, sealed envelope) is the
    host-side cost a real fleet pays too — process-shard the forge
    (``runner``) to scale it.
    """
    length = model_length if model_length is not None else params.model_length
    weights, mask_seeds = population_inputs(n, length, rng_seed)
    scalar = scalar if scalar is not None else Fraction(1, max(1, n))

    eng = engine or PopulationEngine(
        params.mask_config, length, block_size=block_size, device=device
    )
    masked_vects, masked_units = eng.emit(mask_seeds, weights, scalar)

    forge = UpdateForge(params, sum_dict, wire_planar=wire_planar)
    round_seed = params.seed.as_bytes()
    messages = []
    key_starts = []
    for i in range(n):
        start = key_start + i * key_spacing
        keys = keys_for_task(
            round_seed, params.sum, params.update, "update", start=start
        )
        key_starts.append(start)
        messages.append(forge.seal(keys, mask_seeds[i], masked_vects[i], masked_units[i]))
    return ForgedPopulation(
        messages=messages,
        weights=weights,
        scalar=scalar,
        mask_seeds=mask_seeds,
        key_starts=key_starts,
    )
