"""Update phase: collect and aggregate masked model updates.

Reference behavior
(rust/xaynet-server/src/state_machine/phases/update.rs:50-184): for each
accepted ``UpdateRequest``: validate the masked object against the
aggregation state, atomically insert the participant's encrypted seed dict
(validated against the sum dictionary), then aggregate the masked model.
Afterwards the seed dictionary is fetched and broadcast for sum
participants.

Difference from the reference: accepted updates are *staged* and folded
in batches by the ``StagedAggregator`` (K1 on CUDA, the plain version on
a CPU device) instead of a per-update big-int loop;
validation and seed-dict ordering are per-update exactly as in the
reference.

Resilience: when ``[resilience] checkpoint_enabled`` is on, the phase
periodically persists the drained aggregate through the store
(``CheckpointManager``), and the phase can be constructed with
``resume_from`` — a validated :class:`RoundCheckpoint` — to re-enter the
round with the aggregate restored instead of restarting at Idle
(docs/DESIGN.md §9). A resumed phase's count window is reduced by the
restored updates, so an already-satisfied round drains straight through.
"""

from __future__ import annotations

import asyncio
import logging

from ...core.mask.masking import AggregationError
from ...resilience.chaos import maybe_kill
from ...resilience.checkpoint import CheckpointManager, RoundCheckpoint, entry, write_entry
from ...telemetry.registry import get_registry
from ..aggregation import StagedAggregator, build_staged_aggregator
from ..events import DictionaryUpdate, PhaseName
from ..requests import (
    EnvelopeReplay,
    PartialAggregate,
    RequestError,
    StateMachineRequest,
    UpdateRequest,
)
from .base import PhaseError, PhaseState, reduce_count_window

logger = logging.getLogger("xaynet.coordinator")

_registry = get_registry()
EDGE_ENVELOPES = _registry.counter(
    "xaynet_edge_envelopes_total",
    "Partial-aggregate envelopes handled by the update phase, by outcome "
    "(accepted | replay = already-folded envelope acked idempotently | "
    "stale = below the per-edge watermark | rejected).",
    ("outcome",),
)
EDGE_MEMBERS_FOLDED = _registry.counter(
    "xaynet_edge_members_folded_total",
    "Masked updates folded via accepted partial-aggregate envelopes.",
)


class UpdatePhase(PhaseState):
    NAME = PhaseName.UPDATE

    def __init__(self, shared, resume_from: RoundCheckpoint | None = None):
        super().__init__(shared)
        settings = shared.settings
        self.aggregator: StagedAggregator = build_staged_aggregator(shared)
        self._seed_dict = None
        self._resume_from = resume_from
        self._resumed_models = 0
        if resume_from is not None:
            if resume_from.nb_models:
                self.aggregator.restore_journal(resume_from)
            self._resumed_models = resume_from.nb_models
            # the restored updates count as arrivals for the liveness
            # controller: the post-resume window is offset by them, and
            # reporting only the remainder would poison the shrink clamp
            # with a tiny "observed load" (base.PhaseState.arrivals_offset)
            self.arrivals_offset = resume_from.nb_models
            logger.info(  # lint: taint-ok: restored-model COUNT only, no journal payload
                "round %d: update phase RESUMED from journal (%d models restored)",
                shared.round_id,
                resume_from.nb_models,
            )
        resilience = settings.resilience
        self._ckpt = (
            CheckpointManager(
                shared,
                self.aggregator,
                every_batches=resilience.checkpoint_every_batches,
                every_s=resilience.checkpoint_every_s,
            )
            if resilience.checkpoint_enabled
            else None
        )

    async def process(self) -> None:
        params = self.shared.settings.pet.update
        if self._resume_from is not None:
            # the restored updates already satisfied part of the window; a
            # fully-satisfied resume drains straight through to sum2 (the
            # participants who submitted them will not resend)
            params = reduce_count_window(params, self._resumed_models)
            # sum participants contacting a restarted coordinator need the
            # sum dictionary re-broadcast to build their seed dicts
            sum_dict = await self.shared.store.coordinator.sum_dict()
            if sum_dict:
                self.shared.events.broadcast_sum_dict(DictionaryUpdate.new(sum_dict))
        elif self._ckpt is not None:
            # seal the Sum -> Update transition: a crash before the first
            # accepted update must resume into Update with the frozen sum
            # dictionary, not restart the round from Idle
            sum_dict = await self.shared.store.coordinator.sum_dict() or {}
            await write_entry(self.shared, entry(self.shared, "update", sum_dict=sum_dict))
        if self._ckpt is not None:
            # graceful-signal flush: the journal cadence may lag the live
            # aggregate; a SIGTERM mid-phase forces one final save (runner)
            self.shared.flush_hook = self._ckpt.save_now
        await self.process_requests(params)
        if self.shared.settings.overlap.feature("sum2_drain"):
            # phase overlap (docs/DESIGN.md §22): SUBMIT the staged
            # remainder but leave the drain barrier to the sum2 phase,
            # which runs it in the background under its own collection
            # wall — the fold tail that used to extend the update wall is
            # hidden, and fold errors still fail the round before Unmask
            await asyncio.get_running_loop().run_in_executor(None, self.aggregator.flush)
        else:
            # phase transition: drain the streaming pipeline — every
            # submitted fold completes and the deferred acceptance sync
            # runs, off the event loop (the one blocking sync point)
            await asyncio.get_running_loop().run_in_executor(None, self.aggregator.drain)
        self._seed_dict = await self.shared.store.coordinator.seed_dict()
        if not self._seed_dict:
            raise PhaseError("NoSeedDict", "seed dictionary missing after update phase")
        # the journal entry is NOT deleted here: the sum2 phase rewrites it
        # as a sum2-tagged entry (aggregate + votes) before acknowledging
        # its first vote, and the unmask phase retires it only after the
        # global model is published — the round is resumable end to end
        self.shared.flush_hook = None

    def broadcast(self) -> None:
        self.shared.events.broadcast_seed_dict(DictionaryUpdate.new(self._seed_dict))

    async def next(self):
        from .sum2 import Sum2Phase

        return Sum2Phase(self.shared, self.aggregator)

    async def handle_request(self, req: StateMachineRequest) -> None:
        if not isinstance(req, UpdateRequest):
            raise RequestError(RequestError.Kind.MESSAGE_REJECTED, "not an update message")
        try:
            # off the event loop: host validation scans the full element
            # vector, and wire-ingest validation does a device transfer +
            # kernel + sync — neither may stall the loop serving the API
            # (ordering is preserved: the await completes before the
            # seed-dict insert below)
            await asyncio.get_running_loop().run_in_executor(
                None, self.aggregator.validate_aggregation, req.masked_model
            )
        except AggregationError as err:
            raise RequestError(RequestError.Kind.MESSAGE_REJECTED, err.kind) from err
        store_err = await self.shared.store.coordinator.add_local_seed_dict(
            req.participant_pk, req.local_seed_dict
        )
        if store_err is not None:
            raise RequestError(RequestError.Kind.MESSAGE_REJECTED, store_err.value)
        self.aggregator.stage(req.masked_model)
        if self.aggregator.pending >= self.aggregator.batch_size:
            # fold off the event loop so the API stays responsive during
            # large folds; handle_request awaits it, so folds serialize
            await asyncio.get_running_loop().run_in_executor(None, self.aggregator.flush)
            if self._ckpt is not None:
                await self._ckpt.maybe_save()
        # chaos hook (kill-matrix harness): dies BEFORE the ack leaves, so
        # with checkpoint_every_batches = 1 the journal already carries the
        # update the client will retry idempotently after restart
        maybe_kill("update")

    async def handle_partial(self, req: PartialAggregate, remaining: int) -> None:
        """Fold one edge envelope ATOMICALLY (docs/DESIGN.md §11).

        Order of checks: round identity -> per-edge watermark (idempotent
        replay ack / stale) -> count-window overshoot (atomic: the
        envelope is never split across ``count.max``) -> envelope
        self-consistency -> aggregation validation -> seed-dict
        pre-validation against a snapshot (this phase is the round's only
        seed-dict writer, so the snapshot cannot go stale under us) ->
        commit (all seed dicts, then ONE ``masked_add`` dispatch advancing
        ``nb_models`` by the member count). Every pre-commit failure
        rejects the envelope whole; a storage failure mid-commit is an
        infrastructure error that fails the round rather than leave seeds
        without models (the nb_models == seed-watermark invariant).
        """
        shared = self.shared
        if req.round_seed != shared.state.round_params.seed.as_bytes():
            EDGE_ENVELOPES.labels(outcome="rejected").inc()
            raise RequestError(
                RequestError.Kind.MESSAGE_REJECTED, "envelope from another round"
            )
        last_seq = shared.edge_watermarks.get(req.edge_id)
        if last_seq is not None and req.window_seq <= last_seq:
            if req.window_seq == last_seq:
                # the envelope AT the watermark: the edge retried after a
                # lost acknowledgement, its content is already folded —
                # ack idempotently so a successfully folded envelope is
                # not misreported as rejected data loss on the edge
                EDGE_ENVELOPES.labels(outcome="replay").inc()
                logger.info(
                    "round %d: idempotent ack for replayed edge envelope %s/%d",
                    shared.round_id,
                    req.edge_id,
                    req.window_seq,
                )
                raise EnvelopeReplay()
            EDGE_ENVELOPES.labels(outcome="stale").inc()
            raise RequestError(
                RequestError.Kind.MESSAGE_REJECTED,
                f"stale envelope: edge {req.edge_id} window {req.window_seq} "
                f"already folded (watermark {last_seq})",
            )
        if len(req) > remaining:
            raise RequestError(
                RequestError.Kind.MESSAGE_DISCARDED,
                f"envelope of {len(req)} would exceed count.max",
            )
        if len(req.members) == 0 or len(set(req.members)) != len(req.members) or sorted(
            req.seed_dicts
        ) != sorted(req.members):
            EDGE_ENVELOPES.labels(outcome="rejected").inc()
            raise RequestError(
                RequestError.Kind.MESSAGE_REJECTED, "inconsistent envelope accounting"
            )
        try:
            # off the event loop: validity scans the full element vector
            await asyncio.get_running_loop().run_in_executor(
                None, self.aggregator.validate_partial, req.masked, len(req)
            )
        except AggregationError as err:
            EDGE_ENVELOPES.labels(outcome="rejected").inc()
            raise RequestError(RequestError.Kind.MESSAGE_REJECTED, err.kind) from err
        sum_dict = await shared.store.coordinator.sum_dict() or {}
        seed_dict = await shared.store.coordinator.seed_dict() or {}
        seeded = {pk for inner in seed_dict.values() for pk in inner}
        for pk in req.members:
            local = req.seed_dicts[pk]
            if pk in seeded:
                EDGE_ENVELOPES.labels(outcome="rejected").inc()
                raise RequestError(
                    RequestError.Kind.MESSAGE_REJECTED,
                    "envelope member already seeded this round",
                )
            if len(local) != len(sum_dict) or any(spk not in sum_dict for spk in local):
                EDGE_ENVELOPES.labels(outcome="rejected").inc()
                raise RequestError(
                    RequestError.Kind.MESSAGE_REJECTED,
                    "envelope member seed dict does not match the sum dictionary",
                )
        # commit point: no rejection is possible past here
        for pk in req.members:
            store_err = await shared.store.coordinator.add_local_seed_dict(
                pk, req.seed_dicts[pk]
            )
            if store_err is not None:  # pre-validated: only infrastructure left
                raise PhaseError(
                    "EdgeEnvelope",
                    f"seed-dict commit failed mid-envelope: {store_err.value}",
                )
        await asyncio.get_running_loop().run_in_executor(
            None, self.aggregator.fold_partial, req.masked, len(req)
        )
        shared.edge_watermarks[req.edge_id] = req.window_seq
        EDGE_ENVELOPES.labels(outcome="accepted").inc()
        EDGE_MEMBERS_FOLDED.inc(len(req))
        logger.info(
            "round %d [tenant %s]: folded edge envelope %s/%d (%d members, one dispatch)",
            shared.round_id,
            shared.tenant,
            req.edge_id,
            req.window_seq,
            len(req),
        )
        if self._ckpt is not None:
            await self._ckpt.maybe_save()
        maybe_kill("update")

    async def coalesced_batch_start(self, members) -> None:
        """Batch prevalidation: when device wire ingest is on, the whole
        micro-batch's unpack + element-validity runs as ONE device dispatch
        + ONE acceptance fetch (``prevalidate_wire_batch``) instead of a
        blocking round-trip per member; ``handle_request`` then consumes
        the cached per-member verdicts in order, so validation still
        precedes each member's seed-dict insert exactly as before."""
        masked = [m.masked_model for m in members if isinstance(m, UpdateRequest)]
        if len(masked) > 1:
            await asyncio.get_running_loop().run_in_executor(
                None, self.aggregator.prevalidate_wire_batch, masked
            )

    async def coalesced_batch_done(self, n: int) -> None:
        """One stacked fold per coalesced micro-batch: the whole batch of
        staged updates is SUBMITTED to the streaming aggregation pipeline
        as a single ``masked_add`` dispatch — staging of the next batch
        overlaps the in-flight fold; the pipeline drains at phase end."""
        if self.aggregator.pending:
            await asyncio.get_running_loop().run_in_executor(None, self.aggregator.flush)
            if self._ckpt is not None:
                await self._ckpt.maybe_save()
