"""Sum phase: collect ephemeral keys from sum participants.

Reference behavior (rust/xaynet-server/src/state_machine/phases/sum.rs:43-126):
accept ``SumRequest``s within the count/time window, adding each
(participant pk -> ephemeral pk) entry to the sum dictionary; duplicates are
rejected. On success the sum dictionary is fetched and broadcast for update
participants.

Resilience (docs/DESIGN.md §9): with ``[resilience] checkpoint_enabled``
every ACCEPTED sum participant is journaled before the acknowledgement
leaves — a crash mid-sum resumes into a reduced window covering only the
participants still missing; the store-held dictionary (replayed from the
journal on boot restore, or still live on a durable backend) offsets the
window.
"""

from __future__ import annotations

import logging

from ...resilience.chaos import maybe_kill
from ...resilience.checkpoint import RoundCheckpoint, entry, write_entry
from ..events import DictionaryUpdate, PhaseName
from ..requests import RequestError, StateMachineRequest, SumRequest
from .base import PhaseError, PhaseState, reduce_count_window

logger = logging.getLogger("xaynet.coordinator")


class SumPhase(PhaseState):
    NAME = PhaseName.SUM

    def __init__(self, shared, resume_from: RoundCheckpoint | None = None):
        super().__init__(shared)
        self._sum_dict = None
        self._resume_from = resume_from
        self._journal = shared.settings.resilience.checkpoint_enabled

    async def process(self) -> None:
        params = self.shared.settings.pet.sum
        if self._resume_from is not None:
            # the store dictionary (journal replay, or a durable backend's
            # surviving entries — possibly MORE than the journal recorded:
            # an accepted-but-unjournaled sum participant is still a valid
            # member) offsets the re-opened window
            restored = len(await self.shared.store.coordinator.sum_dict() or {})
            self.arrivals_offset = restored
            params = reduce_count_window(params, restored)
            logger.info(
                "round %d: sum phase RESUMED from journal (%d participants restored)",
                self.shared.round_id,
                restored,
            )
        await self.process_requests(params)
        self._sum_dict = await self.shared.store.coordinator.sum_dict()
        if not self._sum_dict:
            raise PhaseError("NoSumDict", "sum dictionary missing after sum phase")

    def broadcast(self) -> None:
        self.shared.events.broadcast_sum_dict(DictionaryUpdate.new(self._sum_dict))

    async def next(self):
        from .update import UpdatePhase

        return UpdatePhase(self.shared)

    async def handle_request(self, req: StateMachineRequest) -> None:
        if not isinstance(req, SumRequest):
            raise RequestError(RequestError.Kind.MESSAGE_REJECTED, "not a sum message")
        err = await self.shared.store.coordinator.add_sum_participant(
            req.participant_pk, req.ephm_pk
        )
        if err is not None:
            raise RequestError(RequestError.Kind.MESSAGE_REJECTED, err.value)
        if self._journal:
            # journal-before-ack: the accepted participant is durable before
            # the acknowledgement leaves (one rewrite per accept; the sum
            # dictionary is tiny relative to the update-phase aggregate)
            sum_dict = await self.shared.store.coordinator.sum_dict() or {}
            await write_entry(self.shared, entry(self.shared, "sum", sum_dict=sum_dict))
        maybe_kill("sum")
