"""Sum2 phase: collect aggregated masks from sum participants.

Reference behavior (rust/xaynet-server/src/state_machine/phases/sum2.rs:33-98):
each accepted ``Sum2Request`` increments the score of the submitted mask
(sum membership and single submission enforced by the store); the model
aggregation is carried forward to Unmask.

Phase overlap (docs/DESIGN.md §22): with ``[overlap] sum2_drain`` the
update phase hands its streaming pipeline over still in flight and this
phase runs the drain barrier in a background executor thread while it
collects sum2 masks — the fold tail that used to serialize behind the
update wall is hidden under this phase's collection wall, recorded as an
``overlap.drain`` span (home phase ``update``) so the round timeline
measures the hidden seconds as negative slack. The drain future is
awaited before the phase exits, so fold errors still fail the round
before Unmask reads the accumulator.

Resilience (docs/DESIGN.md §9): with ``[resilience] checkpoint_enabled``
the phase writes a sum2-tagged journal entry (finished aggregate + sealed
dictionaries) BEFORE acknowledging its first vote, then rewrites it per
accepted vote; ``next`` advances the entry to ``unmask`` before the
finalize barrier so the publish window is covered too. Journal-before-ack
takes precedence over the drain overlap: when both are on, the drain is
awaited before the vote window opens (the base entry needs the exact
aggregate; the overlap win is forfeited for the round's durability).
"""

from __future__ import annotations

import asyncio
import logging
import time

from ...core.mask.serialization import serialize_mask_object
from ...resilience.chaos import maybe_kill
from ...resilience.checkpoint import (
    RoundCheckpoint,
    entry,
    invert_seed_dict,
    write_entry,
)
from ...telemetry import tracing as trace
from ...telemetry.timeline import record_overlap
from ..aggregation import StagedAggregator
from ..events import DictionaryUpdate, PhaseName
from ..requests import RequestError, StateMachineRequest, Sum2Request
from .base import PhaseState, reduce_count_window

logger = logging.getLogger("xaynet.coordinator")

SPAN_OVERLAP_DRAIN = trace.declare_span("overlap.drain")


class Sum2Phase(PhaseState):
    NAME = PhaseName.SUM2

    def __init__(
        self,
        shared,
        aggregator: StagedAggregator,
        resume_from: RoundCheckpoint | None = None,
    ):
        super().__init__(shared)
        self.aggregator = aggregator
        self._drain_task: asyncio.Future | None = None
        self._resume_from = resume_from
        self._journal = shared.settings.resilience.checkpoint_enabled
        # accepted votes in journal form [(sum_pk, serialized mask bytes)];
        # a resumed phase starts from the journaled votes
        self._votes: list = list(resume_from.mask_votes) if resume_from else []
        self._base: RoundCheckpoint | None = None

    def _drain_overlapped(self) -> None:
        """The update pipeline's drain barrier, run under the sum2 wall:
        the hidden seconds land as an ``overlap.drain`` span attributed
        to the update phase (its work), which the timeline fold merges
        into the update interval — the measured negative slack."""
        t0 = time.monotonic()
        try:
            self.aggregator.drain()
        finally:
            dt = time.monotonic() - t0
            trace.get_tracer().record_span(
                SPAN_OVERLAP_DRAIN,
                start=t0,
                duration=dt,
                phase="update",
                tenant=self.shared.tenant,
            )
            record_overlap("drain", dt, tenant=self.shared.tenant)

    async def process(self) -> None:
        params = self.shared.settings.pet.sum2
        if self.shared.settings.overlap.feature("sum2_drain"):
            self._drain_task = asyncio.get_running_loop().run_in_executor(
                None, self._drain_overlapped
            )
        if self._journal and self._drain_task is not None:
            # journal-ready-before-first-vote-ack: the base entry snapshots
            # the finished aggregate, so the drain must complete BEFORE the
            # window opens — durability outranks the overlap win here
            task, self._drain_task = self._drain_task, None
            await task
        if self._journal:
            if self._resume_from is not None:
                await self._rebroadcast_dicts()
                self.arrivals_offset = len(self._votes)
                params = reduce_count_window(params, len(self._votes))
                self._base = self._resume_from
                logger.info(
                    "round %d: sum2 phase RESUMED from journal (%d votes restored)",
                    self.shared.round_id,
                    len(self._votes),
                )
            else:
                await self._build_base()
        try:
            await self.process_requests(params)
        finally:
            if self._drain_task is not None:
                # the overlap window closes with the phase: fold errors
                # surface HERE (failing the round exactly where the
                # serial flow's drain would have), never past sum2
                task, self._drain_task = self._drain_task, None
                await task

    async def _rebroadcast_dicts(self) -> None:
        """Participants contacting a restarted coordinator need the round
        dictionaries re-broadcast: the seed dict drives the sum2 mask
        computation the re-opened window is waiting for."""
        coord = self.shared.store.coordinator
        sum_dict = await coord.sum_dict()
        if sum_dict:
            self.shared.events.broadcast_sum_dict(DictionaryUpdate.new(sum_dict))
        seed_dict = await coord.seed_dict()
        if seed_dict:
            self.shared.events.broadcast_seed_dict(DictionaryUpdate.new(seed_dict))

    async def _build_base(self) -> None:
        """Journal the Update -> Sum2 transition: the finished aggregate +
        the sealed dictionaries, written before the first vote is acked."""
        loop = asyncio.get_running_loop()
        # drain + snapshot off the event loop (blocks on in-flight folds)
        snap = await loop.run_in_executor(None, self.aggregator.snapshot_journal)
        coord = self.shared.store.coordinator
        sum_dict = await coord.sum_dict() or {}
        seed_dicts = invert_seed_dict(await coord.seed_dict())
        self._base = entry(
            self.shared,
            "sum2",
            snap,
            sum_dict=sum_dict,
            seed_dicts=seed_dicts,
            mask_votes=self._votes,
        )
        await write_entry(self.shared, self._base)

    def broadcast(self) -> None:
        # the round's dictionaries are spent once the masks are in
        # (reference: sum2.rs invalidates the dicts on exit)
        self.shared.events.broadcast_sum_dict(DictionaryUpdate.invalidate())
        self.shared.events.broadcast_seed_dict(DictionaryUpdate.invalidate())

    async def next(self):
        from .unmask import Unmask

        if self._base is not None:
            # advance the journal into the publish window BEFORE the
            # finalize barrier: a crash anywhere from here to the journal
            # retire in Unmask resumes into Unmask with the final votes
            self._base.phase = "unmask"
            self._base.mask_votes = list(self._votes)
            await write_entry(self.shared, self._base)
        # finalize WITHOUT gathering: Unmask gets a device view, so the
        # elected mask is subtracted where the accumulator lies; with
        # [overlap] eager_unmask the pipeline stays open into Unmask, whose
        # subtract drains it first (one device: no per-shard commit)
        eager = self.shared.settings.overlap.feature("eager_unmask")
        return Unmask(self.shared, self.aggregator.finalize_inplace(defer_drain=eager))

    async def handle_request(self, req: StateMachineRequest) -> None:
        if not isinstance(req, Sum2Request):
            raise RequestError(RequestError.Kind.MESSAGE_REJECTED, "not a sum2 message")
        err = await self.shared.store.coordinator.incr_mask_score(
            req.participant_pk, req.model_mask
        )
        if err is not None:
            raise RequestError(RequestError.Kind.MESSAGE_REJECTED, err.value)
        if self._base is not None:
            # journal-before-ack: the accepted vote is durable before the
            # acknowledgement leaves (rewrite; votes are mask-sized)
            self._votes.append(
                (req.participant_pk, serialize_mask_object(req.model_mask))
            )
            self._base.mask_votes = list(self._votes)
            await write_entry(self.shared, self._base)
        maybe_kill("sum2")
