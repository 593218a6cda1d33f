"""Idle phase: round bootstrap.

Reference behavior (rust/xaynet-server/src/state_machine/phases/idle.rs:41-151):
increment the round id, delete the previous round's dictionaries, generate a
fresh round encryption keypair, deterministically advance the round seed
(``seed = sha256(sign_ed25519(seed ‖ sum_prob_le ‖ update_prob_le))`` with a
signing key derived from the new encryption secret), persist the coordinator
state, then broadcast keys and parameters.
"""

from __future__ import annotations

import asyncio
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
        # off the event loop: closing the last round's pipeline waits for
        # its folds, and the reclaim's GC pass stalls every tenant's loop
        agg, self.shared.round_aggregator = self.shared.round_aggregator, None
        await asyncio.to_thread(self._reconcile_pool, agg)
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

    def _reconcile_pool(self, agg) -> None:
        """Round-boundary page accounting (docs/DESIGN.md §19): at Idle the
        tenant must hold ZERO pool leases — the previous round's unmask
        released them on the clean path. A crashed round (Failure -> Idle)
        leaves its aggregator open instead, and a flush of the failed phase
        may still be folding: close it first (``agg``, the last round's
        aggregator: it waits for the folds and gives the ring's pages
        back), then run the GC so dropped aggregators' and rings'
        finalizers return their pages safely (the buffers are unreachable,
        nothing can alias them), then force-reclaim any stragglers,
        counted on ``xaynet_pool_reclaimed_total`` so the invariant break
        is visible on /metrics rather than silent. Runs on a worker
        thread."""
        from ...tenancy.pool import get_pool

        if agg is not None:
            agg.close()
        pool = get_pool()
        if not pool.balanced(self.shared.tenant):
            import gc

            gc.collect()
            pool.reclaim(self.shared.tenant)
        # between-round defrag (docs/DESIGN.md §23): Idle is the only phase
        # where this tenant holds no transient fold views, so compaction's
        # memmove-under-lock cannot race this tenant's copies. Other
        # tenants' live runs are protected by the migrator protocol (only
        # quiescent, migrator-registered leases move: a ring buffer gets
        # its migrator back only once its fold has completed on the card).
        ten = getattr(self.shared.settings, "tenancy", None)
        if ten is not None and ten.defrag_enabled:
            if pool.fragmentation() > ten.defrag_threshold:
                pool.compact()

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
