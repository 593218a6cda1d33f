"""Update coalescing: many verified updates, one channel envelope.

The port's copy of ``xaynet_tpu/ingest/coalescer.py``.

During the update phase each accepted message costs a channel envelope, a
phase wakeup, and eventually a fold dispatch. The coalescer buffers
verified ``UpdateRequest``s for up to ``max_batch`` messages or
``linger_s`` seconds and submits them as ONE ``CoalescedUpdates`` envelope;
the update phase batch-prevalidates the members (with device wire ingest,
one K4 or K3 launch and one fetch of the verdicts per ``batch_size``
chunk), processes them in order (validation + seed-dict insert stay
per-member, so the seed-dict/masked-model pairing is never reordered) and
flushes the micro-batch once: its device rows fold through K1 in chunks of
8, host rows go into the streaming aggregation pipeline as one batch,
whose fold overlaps the decrypt/validate/stage of the next, and the
pipeline drains at the phase transition. During sum/sum2 the pipeline
bypasses the coalescer entirely — those requests are per-message by
construction.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from ..server.requests import CoalescedUpdates, RequestError, RequestSender, UpdateRequest
from ..telemetry import tracing as trace
from ..utils import tracing
from .admission import BATCH_SIZE_HIST, AdmissionController

logger = logging.getLogger("xaynet.ingest")

SPAN_COALESCE = trace.declare_span("ingest.coalesce")


class UpdateCoalescer:
    """Micro-batches ``UpdateRequest``s into ``CoalescedUpdates`` envelopes."""

    def __init__(self, request_tx: RequestSender, max_batch: int = 32, linger_s: float = 0.002):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.request_tx = request_tx
        self.max_batch = max_batch
        self.linger_s = linger_s
        self._buf: list[tuple[UpdateRequest, asyncio.Future, str]] = []  # guarded-by: event-loop
        self._opened: float = 0.0  # first add of the current buffer  # guarded-by: event-loop
        self._linger_task: Optional[asyncio.Task] = None  # guarded-by: event-loop
        self.batches_sent = 0  # guarded-by: event-loop
        self.members_sent = 0  # guarded-by: event-loop

    @property
    def pending(self) -> int:
        return len(self._buf)

    async def add(self, req: UpdateRequest) -> asyncio.Future:
        """Buffer one verified update; returns its member future.

        The caller need not await the future — member rejections are
        consumed and counted here so an abandoned future never warns.
        """
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        fut.add_done_callback(_consume_member_result)
        if not self._buf:
            self._opened = time.monotonic()
        self._buf.append((req, fut, tracing.current_request_id()))
        if len(self._buf) >= self.max_batch:
            await self.flush()
        elif self._linger_task is None:
            self._linger_task = asyncio.create_task(self._linger_flush())
        return fut

    async def _linger_flush(self) -> None:
        await asyncio.sleep(self.linger_s)
        self._linger_task = None
        await self.flush()

    async def flush(self) -> None:
        """Submit the buffered micro-batch as one envelope (no-op if empty).

        Blocks until the state machine has handled the whole batch — the
        ingest worker behind ``add`` therefore backpressures naturally.
        """
        if self._linger_task is not None:
            self._linger_task.cancel()
            self._linger_task = None
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        batch = CoalescedUpdates(
            members=[req for req, _, _ in buf],
            responses=[fut for _, fut, _ in buf],
            request_ids=[rid for _, _, rid in buf],
        )
        BATCH_SIZE_HIST.labels(stage="coalesce").observe(len(batch))
        self.batches_sent += 1
        self.members_sent += len(batch)
        # the coalesce window as a retroactive span (first add -> submit),
        # plus the member ids in the log so one grep joins a request's REST
        # log line to the envelope that carried it into the state machine
        trace.get_tracer().record_span(
            SPAN_COALESCE,
            start=self._opened,
            duration=time.monotonic() - self._opened,
            n=len(batch),
        )
        logger.debug(
            "coalesced %d updates into one envelope (rids: %s)",
            len(batch),
            " ".join(rid for _, _, rid in buf),
        )
        try:
            await self.request_tx.request(batch)
        except RequestError as err:
            # batch-level rejection (purge at phase end, shutdown): members
            # that the phase never reached inherit the batch verdict
            batch.reject_members(err)

    async def close(self) -> None:
        await self.flush()


def _consume_member_result(fut: asyncio.Future) -> None:
    if fut.cancelled():
        return
    err = fut.exception()
    if err is not None:
        AdmissionController.count_rejection("state-machine")
