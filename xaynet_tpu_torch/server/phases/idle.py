"""Idle phase: round bootstrap.

Reference behavior (rust/xaynet-server/src/state_machine/phases/idle.rs:41-151):
increment the round id, delete the previous round's dictionaries, generate a
fresh round encryption keypair, deterministically advance the round seed
(``seed = sha256(sign_ed25519(seed ‖ sum_prob_le ‖ update_prob_le))`` with a
signing key derived from the new encryption secret), persist the coordinator
state, then broadcast keys and parameters.
"""

from __future__ import annotations

import struct

from ...core.common import RoundSeed
from ...core.crypto.encrypt import EncryptKeyPair
from ...core.crypto.hash import sha256
from ...core.crypto.sign import SigningKeyPair
from ...telemetry import tracing as trace
from ..events import DictionaryUpdate, PhaseName
from .base import PhaseState, Shared


class Idle(PhaseState):
    NAME = PhaseName.IDLE

    def __init__(self, shared: Shared):
        super().__init__(shared)
        # events emitted early in the round must carry the new round id
        shared.set_round_id(shared.round_id + 1)
        if shared.metrics is not None:
            shared.metrics.round_total(shared.round_id)

    async def process(self) -> None:
        await self.shared.store.coordinator.delete_dicts()
        # the previous round's mid-round checkpoint (and its resume budget)
        # cannot outlive the dictionaries it is consistent with
        await self.shared.store.coordinator.delete_round_checkpoint()
        self.shared.resume_attempts = 0  # lint: tenant-ok: round reset within this tenant's own Shared
        # a stale graceful-flush hook would journal a dead phase's state
        self.shared.flush_hook = None
        # per-edge envelope watermarks are round-scoped: window sequences
        # restart at 0 with every round's fresh window state on the edges
        self.shared.edge_watermarks.clear()  # lint: tenant-ok: round reset within this tenant's own Shared
        self._gen_round_keypair()
        self._update_round_probabilities()
        self._update_round_seed()
        # the round's trace window opens HERE, the moment the new seed
        # exists: the trace id derives from it, so the SDK and the edge tier
        # compute the identical id from the broadcast parameters and the
        # whole distributed round stitches into one trace (DESIGN §16). The
        # previous round's trace flushes (Chrome export) as a side effect.
        trace.get_tracer().begin_round(
            self.shared.round_id,
            trace.round_trace_id(self.shared.state.round_params.seed.as_bytes()),
        )
        await self.shared.store.coordinator.set_coordinator_state(self.shared.state.to_bytes())

    def broadcast(self) -> None:
        self.shared.events.broadcast_keys(self.shared.state.keys)
        self.shared.events.broadcast_params(self.shared.state.round_params)
        # previous round's artefacts are no longer valid
        self.shared.events.broadcast_sum_dict(DictionaryUpdate.invalidate())
        self.shared.events.broadcast_seed_dict(DictionaryUpdate.invalidate())

    async def next(self):
        from .sum import SumPhase

        return SumPhase(self.shared)

    # --- internals --------------------------------------------------------

    def _gen_round_keypair(self) -> None:
        keys = EncryptKeyPair.generate()
        self.shared.state.keys = keys
        self.shared.state.round_params.pk = keys.public.as_bytes()

    def _update_round_probabilities(self) -> None:
        # constant probabilities; adaptive strategies plug in here
        pass

    def _update_round_seed(self) -> None:
        params = self.shared.state.round_params
        signing = SigningKeyPair.derive_from_seed(self.shared.state.keys.secret.as_bytes())
        signature = signing.sign(
            params.seed.as_bytes()
            + struct.pack("<d", params.sum)
            + struct.pack("<d", params.update)
        )
        params.seed = RoundSeed(sha256(signature.as_bytes()))
