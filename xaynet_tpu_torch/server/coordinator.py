"""Coordinator round state.

Reference: rust/xaynet-server/src/state_machine/coordinator.rs:22-134 —
round credentials + public round parameters + phase window parameters, all
derived from settings and persisted every Idle phase for checkpoint/restore.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from ..core.common import RoundParameters, RoundSeed
from ..core.crypto.encrypt import EncryptKeyPair, PublicEncryptKey, SecretEncryptKey
from .settings import Settings


@dataclass
class CoordinatorState:
    keys: EncryptKeyPair
    round_id: int
    round_params: RoundParameters

    @classmethod
    def from_settings(cls, settings: Settings) -> "CoordinatorState":
        keys = EncryptKeyPair.generate()
        mask_config = settings.mask.to_config().pair()
        return cls(
            keys=keys,
            round_id=0,
            round_params=RoundParameters(
                pk=keys.public.as_bytes(),
                sum=settings.pet.sum.prob,
                update=settings.pet.update.prob,
                seed=RoundSeed.zeroed(),
                mask_config=mask_config,
                model_length=settings.model.length,
                wire_format=2 if settings.ingest.wire_format == "packed" else 1,
            ),
        )

    def to_bytes(self) -> bytes:
        # the durable round-state blob must carry the round's secret key —
        # a restarted coordinator cannot decrypt the round's messages
        # without it; the blob lives in the coordinator's own store (§9)
        return json.dumps(  # lint: taint-ok: durable round-state blob, restore needs the round key
            {
                "public_key": self.keys.public.as_bytes().hex(),
                "secret_key": self.keys.secret.as_bytes().hex(),
                "round_id": self.round_id,
                "round_params": self.round_params.to_dict(),
            }
        ).encode()

    @classmethod
    def from_bytes(cls, data: bytes) -> "CoordinatorState":
        d = json.loads(data.decode())
        return cls(
            keys=EncryptKeyPair(
                public=PublicEncryptKey(bytes.fromhex(d["public_key"])),
                secret=SecretEncryptKey(bytes.fromhex(d["secret_key"])),
            ),
            round_id=int(d["round_id"]),
            round_params=RoundParameters.from_dict(d["round_params"]),
        )
