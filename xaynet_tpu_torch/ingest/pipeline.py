"""The ingest pipeline: pre-filter -> admission -> shards -> workers.

The port's copy of ``xaynet_tpu/ingest/pipeline.py``.

Wiring order per message:

1. **pre-filter** (on the REST task, before any queue slot or crypto):
   structural length check (a ciphertext shorter than sealed-box overhead +
   message header cannot contain a PET message) and the wrong-phase gate —
   during idle/unmask/failure/shutdown NO ciphertext can be valid, so the
   message is dropped before sealed-box decryption. The tag-level phase
   filter (sum message during update, ...) still runs right after the
   sealed-box open and *before* signature verification / payload parse in
   ``services._decrypt_parse_one`` — the sealed box hides the tag, so
   pre-decrypt filtering cannot see it (docs/DESIGN.md §7).
2. **admission** — watermark verdict; shed means HTTP 429 + Retry-After.
3. **intake shard** — bounded queue, round-robin.
4. **decrypt worker** (one task per shard) — drains a batch, ONE
   thread-pool hop decrypts + verifies + task-validates all of it, then
   submits: updates through the coalescer, everything else per-message.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque

from ..core.crypto.encrypt import SEALBYTES
from ..core.message.message import HEADER_LENGTH
from ..resilience.faults import maybe_fail_async
from ..server.events import PhaseName
from ..server.requests import RequestError, RequestSender, UpdateRequest, request_from_message
from ..server.services import PetMessageHandler, ServiceError
from ..server.settings import IngestSettings
from ..telemetry import tracing as trace
from ..telemetry.registry import get_registry
from ..utils import tracing
from .admission import BATCH_SIZE_HIST, Admission, AdmissionController, Verdict
from .coalescer import UpdateCoalescer
from .intake import ShardedIntake, ShardFull

logger = logging.getLogger("xaynet.ingest")

SPAN_ADMISSION = trace.declare_span("ingest.admission")
SPAN_QUEUE_WAIT = trace.declare_span("ingest.queue_wait")
SPAN_DECRYPT_BATCH = trace.declare_span("ingest.decrypt_batch")

WORKER_RESTARTS = get_registry().counter(
    "xaynet_ingest_worker_restarts_total",
    "Ingest decrypt workers restarted by the supervisor after dying "
    "unexpectedly, by shard and tenant.",
    ("shard", "tenant"),
)

INGRESS_ACCEPTED = get_registry().counter(
    "xaynet_ingress_accepted_total",
    "Messages ACCEPTED at the ingress boundary — decrypted, verified and "
    "task-validated, then forwarded toward the state machine — by tenant. "
    "Admission ('admitted') only means a queue slot; this counts survivors "
    "of the whole intake pipeline, the coordinator-ingress headline.",
    ("tenant",),
)
INGRESS_WIRE = get_registry().counter(
    "xaynet_ingress_wire_total",
    "Accepted Update payloads by wire element layout: packed = v2 "
    "byte-planar (WIRE_PLANAR_FLAG), legacy = v1 interleaved. The mix "
    "shows how much of the fleet honors the round's negotiated format.",
    ("format",),
)

# backoff between restarts of a crash-looping worker: capped doubling, so a
# deterministic crash (bad build) cannot busy-spin the event loop
_RESTART_BACKOFF_BASE_S = 0.05
_RESTART_BACKOFF_MAX_S = 5.0


class RateWindow:
    """Per-second event buckets over a short sliding window: the
    accepted/shed *rates* for the /healthz + /statusz ingress section,
    without scraping a metrics backend. All calls run on the event loop
    (submit and the decrypt workers are both loop tasks), so no lock."""

    def __init__(self, window_s: int = 10):
        if window_s < 1:
            raise ValueError("window must be >= 1s")
        self.window_s = window_s
        self._buckets: deque[tuple[int, int]] = deque()

    def add(self, n: int = 1, now: float | None = None) -> None:
        t = int(time.monotonic() if now is None else now)
        if self._buckets and self._buckets[-1][0] == t:
            self._buckets[-1] = (t, self._buckets[-1][1] + n)
        else:
            self._buckets.append((t, n))
        self._trim(t)

    def rate(self, now: float | None = None) -> float:
        """Events/s averaged over the window (the current partial second
        included — a steady source reads steady, a stopped one decays to
        zero within ``window_s``)."""
        t = int(time.monotonic() if now is None else now)
        self._trim(t)
        return sum(c for _, c in self._buckets) / float(self.window_s)

    def _trim(self, t: int) -> None:
        cutoff = t - self.window_s
        while self._buckets and self._buckets[0][0] <= cutoff:
            self._buckets.popleft()

# phases whose tag can appear in a valid ciphertext; anything else is shed
# before we even pay for the sealed-box open
_INGESTIBLE = {PhaseName.SUM, PhaseName.UPDATE, PhaseName.SUM2}

_MIN_CIPHERTEXT = SEALBYTES + HEADER_LENGTH


class IngestPipeline:
    """Admission-controlled, batched path from REST to the state machine."""

    def __init__(
        self,
        handler: PetMessageHandler,
        request_tx: RequestSender,
        events,
        settings: IngestSettings,
        tenant: str = "default",
        budget=None,
    ):
        settings.validate()
        self.handler = handler
        self.request_tx = request_tx
        self.events = events
        self.settings = settings
        # multi-tenant seam (docs/DESIGN.md §19): the tenant id labels this
        # pipeline's logs/metrics; `budget` (tenancy.TenantAdmissionBudget)
        # layers the per-tenant share of the PROCESS-wide intake on top of
        # this pipeline's own AdmissionController — a flooding tenant sheds
        # before it can crowd other tenants' decrypt capacity
        self.tenant = tenant
        self.budget = budget
        self.intake = ShardedIntake(settings.shards, settings.queue_bound)
        self.admission = AdmissionController(
            capacity=self.intake.capacity,
            high_watermark=settings.high_watermark,
            low_watermark=settings.low_watermark,
            retry_after_seconds=settings.retry_after_seconds,
        )
        self.coalescer = (
            UpdateCoalescer(
                request_tx,
                max_batch=settings.coalesce_max_batch,
                linger_s=settings.coalesce_linger_ms / 1000.0,
            )
            if settings.coalesce
            else None
        )
        self._workers: list[asyncio.Task] = []  # guarded-by: event-loop
        # ingress accounting (guarded-by: event-loop — submit and the
        # decrypt workers are all loop tasks): totals + short-window rates
        # + the accepted wire-format mix, surfaced as the "ingress" section
        # of /healthz and /statusz
        self._accepted = 0
        self._shed = 0
        self._rejected = 0
        self._wire_mix = {"packed": 0, "legacy": 0}
        self._accepted_rate = RateWindow()
        self._shed_rate = RateWindow()
        self._ingress_accepted = INGRESS_ACCEPTED.labels(tenant=tenant)

    # --- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        if self._workers:
            return
        self._workers = [
            asyncio.create_task(
                self._supervise(shard), name=f"ingest-worker-{shard.index}"
            )
            for shard in self.intake.shards
        ]
        logger.info(
            "ingest pipeline up: %d shards x %d bound, decrypt batch <= %d, coalesce %s",
            self.settings.shards,
            self.settings.queue_bound,
            self.settings.max_batch,
            f"<= {self.settings.coalesce_max_batch}" if self.coalescer else "off",
        )

    async def stop(self) -> None:
        for task in self._workers:
            task.cancel()
        for task in self._workers:
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._workers = []
        if self.coalescer is not None:
            await self.coalescer.close()
        if self.budget is not None:
            # return this tenant's entire held share: messages still queued
            # in the intake die with this pipeline, and a stopped tenant
            # must not keep budget charged against the OTHER tenants'
            # process-wide capacity (docs/DESIGN.md §19)
            self.budget.discharge(self.tenant, self.budget.held(self.tenant))

    @property
    def running(self) -> bool:
        return bool(self._workers)

    # --- intake -----------------------------------------------------------

    def _phase(self) -> PhaseName:
        return self.events.phase.get_latest().event

    async def submit(self, encrypted: bytes) -> Admission:
        """Admit, shed, or drop one encrypted message (REST entry point).

        The REST request id is assigned HERE and rides with the ciphertext
        through the intake queue, so the decrypt worker and the coalescer
        log under the same id the request logs carry — the id no longer
        dies at the pipeline boundary.
        """
        if len(encrypted) < _MIN_CIPHERTEXT or self._phase() not in _INGESTIBLE:
            # cheap pre-decrypt rejection: structurally impossible, or no
            # phase is accepting messages at all
            return self.admission.dropped("pre-filter")
        request_id = tracing.new_request_id()
        with trace.get_tracer().span(
            SPAN_ADMISSION, rid=request_id, tenant=self.tenant
        ) as span:
            if self.budget is not None and not self.budget.charge(self.tenant):
                # per-tenant budget exceeded: shed BEFORE the shared
                # controller — this tenant is over its share even if the
                # process as a whole has headroom
                span.set(verdict="shed-budget")
                self._count_shed()
                return Admission(
                    Verdict.SHED,
                    retry_after=self.admission.retry_after(self.intake.occupancy),
                )
            verdict = self.admission.admit(self.intake.occupancy)
            if verdict.shed:
                if self.budget is not None:
                    self.budget.discharge(self.tenant)
                span.set(verdict="shed")
                self._count_shed()
                return verdict
            try:
                self.intake.put_nowait((request_id, time.monotonic(), encrypted))
            except ShardFull:
                if self.budget is not None:
                    self.budget.discharge(self.tenant)
                span.set(verdict="shed-shard-full")
                self._count_shed()
                return self.admission.shed_shard_full(self.intake.occupancy)
            self.admission.count_admitted()
            span.set(verdict="admitted")
        return verdict

    # --- drain ------------------------------------------------------------

    async def _supervise(self, shard) -> None:
        """Keep the shard's decrypt worker alive: a worker that dies on an
        unexpected error (not a single poisoned batch — those are absorbed
        inside ``_worker``) is restarted with capped-doubling backoff, so
        one crash never silently halves the coordinator's intake capacity
        for the rest of the process."""
        backoff = _RESTART_BACKOFF_BASE_S
        while True:
            try:
                await self._worker(shard)
                return  # _worker only returns on cancellation paths
            except asyncio.CancelledError:
                raise
            except Exception:
                WORKER_RESTARTS.labels(shard=str(shard.index), tenant=self.tenant).inc()
                logger.exception(
                    "ingest worker %d died; restarting in %.2fs", shard.index, backoff
                )
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, _RESTART_BACKOFF_MAX_S)

    async def _worker(self, shard) -> None:
        while True:
            # deterministic chaos: a fault plan can kill this worker here
            # (before any message is claimed, so nothing in flight is lost);
            # the supervisor restarts it
            await maybe_fail_async(f"ingest.worker.{shard.index}")
            batch = await shard.get_batch(
                self.settings.max_batch, self.settings.linger_ms / 1000.0
            )
            self.intake.drained()
            if self.budget is not None:
                # the drained messages leave this tenant's share of the
                # process-wide budget the moment they leave the queue
                self.budget.discharge(self.tenant, len(batch))
            self.admission.observe(self.intake.occupancy)
            BATCH_SIZE_HIST.labels(stage="decrypt").observe(len(batch))
            # the oldest member's wait IS the batch's queue-wait span: it
            # bounds every other member's and is the number backpressure
            # tuning needs
            oldest = min(ts for _, ts, _ in batch)
            trace.get_tracer().record_span(
                SPAN_QUEUE_WAIT,
                start=oldest,
                duration=time.monotonic() - oldest,
                shard=shard.index,
                n=len(batch),
            )
            try:
                await self._process(batch, shard.index)
            except asyncio.CancelledError:
                raise
            except Exception:
                # a poisoned batch must not kill the shard's worker
                logger.exception(
                    "ingest worker %d: batch failed (rids: %s)",
                    shard.index,
                    " ".join(rid for rid, _, _ in batch),
                )

    async def _process(self, batch: list[tuple], shard_index: int = -1) -> None:
        with trace.get_tracer().span(
            SPAN_DECRYPT_BATCH, shard=shard_index, n=len(batch)
        ) as span:
            results = await self.handler.process_batch([raw for _, _, raw in batch])
            rejected = 0
            submits = []
            coalescing = self.coalescer is not None and self._phase() is PhaseName.UPDATE
            for (request_id, _, _), res in zip(batch, results):
                if res is None:
                    continue  # multipart chunk absorbed
                if isinstance(res, ServiceError):
                    self.admission.count_rejection(res.stage)
                    self._rejected += 1
                    rejected += 1
                    logger.debug(
                        "[%s] ingest worker %d: message dropped at %s: %s",
                        request_id,
                        shard_index,
                        res.stage,
                        res,
                    )
                    continue
                self._count_accepted(res)
                req = request_from_message(res)
                if coalescing and isinstance(req, UpdateRequest):
                    with tracing.use_request_id(request_id):
                        await self.coalescer.add(req)  # captures the current id
                else:
                    submits.append(self._submit_one(req, request_id))
            span.set(rejected=rejected)
        if submits:
            await asyncio.gather(*submits)
        if self.coalescer is not None and self.coalescer.pending:
            # don't leave a partial micro-batch lingering when the shard
            # queue is empty anyway — latency buys nothing here
            if self.intake.occupancy == 0:
                await self.coalescer.flush()

    async def _submit_one(self, req, request_id: str) -> None:
        # the coroutine runs later under gather, so the message's tracing id
        # must be re-entered here — reading the ambient contextvar would
        # stamp every envelope of the batch with the LAST message's id
        try:
            with tracing.use_request_id(request_id):
                await self.request_tx.request(req)
        except RequestError:
            self.admission.count_rejection("state-machine")

    # --- ingress accounting ----------------------------------------------

    def _count_shed(self) -> None:
        self._shed += 1
        self._shed_rate.add()

    def _count_accepted(self, message) -> None:
        """One message survived the whole intake pipeline. Update payloads
        also book their wire element layout (the packed-vs-legacy mix)."""
        self._accepted += 1
        self._accepted_rate.add()
        self._ingress_accepted.inc()
        payload = getattr(message, "payload", None)
        wire_planar = getattr(payload, "wire_planar", None)
        if wire_planar is not None:
            fmt = "packed" if wire_planar else "legacy"
            self._wire_mix[fmt] += 1
            INGRESS_WIRE.labels(format=fmt).inc()

    def ingress_stats(self) -> dict:
        """The ``ingress`` section of /healthz and /statusz: end-to-end
        acceptance (not mere admission), shed pressure, per-shard intake
        occupancy, and the accepted wire-format mix."""
        return {
            "accepted_total": self._accepted,
            "accepted_per_s": round(self._accepted_rate.rate(), 2),
            "shed_total": self._shed,
            "shed_per_s": round(self._shed_rate.rate(), 2),
            "rejected_total": self._rejected,
            "shard_occupancy": [s.occupancy for s in self.intake.shards],
            "wire": dict(self._wire_mix),
        }

    # --- health -----------------------------------------------------------

    def health(self) -> dict:
        """Saturation snapshot for GET /healthz."""
        occupancy = self.intake.occupancy
        self.admission.observe(occupancy)
        out = {
            "saturated": self.admission.saturated,
            "occupancy": occupancy,
            "capacity": self.intake.capacity,
            "shards": len(self.intake.shards),
            "running": self.running,
            # updates buffered toward the next coalesced envelope (operators
            # watching an edge's backlog need the pre-seal depth too)
            "coalescer_pending": self.coalescer.pending if self.coalescer else 0,
            "ingress": self.ingress_stats(),
        }
        if self.budget is not None:
            out["tenant"] = self.tenant
            out["budget_held"] = self.budget.held(self.tenant)
            out["budget_limit"] = self.budget.per_tenant
        return out
