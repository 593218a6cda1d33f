"""EdgeService: the long-running core of an edge aggregator process.

An edge is a lightweight decrypt/verify/fold tier between participants and
the coordinator (docs/DESIGN.md §11). It reuses the coordinator's own
machinery end to end:

- the **ingest pipeline** (admission watermarks, bounded intake shards,
  batched decrypt workers, the update coalescer) admits participant
  uploads exactly as a coordinator would — the edge just sits on the other
  end of the request channel;
- the **EdgeAggregator** folds verified updates into one partial masked
  aggregate per window through the accounting path;
- the **resilient upstream client** ships each sealed window upstream as
  ONE ``PartialAggregate`` envelope, in strict window order (the
  coordinator's per-edge watermark treats any sequence at/below the last
  folded one as a replay).

An edge runs no device work (its fold is the host ``Aggregation``), so it
needs no card. Port of ``xaynet_tpu/edge/service.py``.

Round/phase state is learned by polling ``GET /edge/round`` upstream and
re-broadcast on a local event bus, so the reused components cannot tell
they are not inside a coordinator.
"""

from __future__ import annotations

import asyncio
import logging
import time

from ..core.common import RoundParameters, RoundSeed
from ..core.crypto.encrypt import EncryptKeyPair, PublicEncryptKey, SecretEncryptKey
from ..ingest import IngestPipeline
from ..sdk.client import ClientError, ClientPermanentError
from ..server.events import EventPublisher, PhaseName
from ..server.requests import (
    ChannelClosed,
    CoalescedUpdates,
    RequestError,
    RequestReceiver,
    UpdateRequest,
)
from ..server.services import PetMessageHandler
from ..server.settings import MaskSettings, Settings
from ..telemetry import tracing as trace
from ..telemetry.recorder import flight_dump
from ..telemetry.registry import get_registry
from .aggregator import EdgeAdmitError, EdgeAggregator
from .upstream import ResilientUpstream, UpstreamClient

logger = logging.getLogger("xaynet.edge")

SPAN_WINDOW = trace.declare_span("edge.window")
SPAN_SEAL = trace.declare_span("edge.seal")
SPAN_SHIP = trace.declare_span("edge.ship")

_registry = get_registry()
ENVELOPES_SHIPPED = _registry.counter(
    "xaynet_edge_envelopes_shipped_total",
    "Sealed envelopes this edge finished shipping, by outcome (accepted | "
    "rejected = coordinator protocol refusal | dropped = retries exhausted "
    "or round moved on).",
    ("outcome",),
)
ENVELOPE_BACKLOG = _registry.gauge(
    "xaynet_edge_envelope_backlog",
    "Sealed envelopes waiting to be shipped upstream (a stuck edge shows "
    "here and in /healthz).",
)
FORWARDED = _registry.counter(
    "xaynet_edge_forwarded_total",
    "Participant messages relayed upstream unchanged (non-update phases).",
)
WINDOW_MEMBERS_DROPPED = _registry.counter(
    "xaynet_edge_window_members_dropped_total",
    "Members of a never-sealed window dropped because the round moved on "
    "upstream (distinct from shipped-envelope outcomes: these envelopes "
    "never existed).",
)

# sealed-envelope ship queue bound: past this, sealing blocks — an edge
# that cannot reach its coordinator must stop absorbing uploads rather
# than buffer unbounded windows
_SHIP_QUEUE_BOUND = 64


class EdgeService:
    """Round sync + window fold + envelope shipping for one edge process."""

    def __init__(self, settings: Settings, upstream=None):
        self.settings = settings
        edge = settings.edge
        self.edge_id = edge.edge_id or f"edge-{id(self) & 0xFFFF:04x}"
        self.upstream = (
            upstream
            if upstream is not None
            else ResilientUpstream(UpstreamClient(edge.upstream_url, token=edge.token))
        )
        # local event bus: the reused coordinator components (pipeline,
        # message handler, REST fetcher) read round state from here; the
        # sync loop is the only writer
        self.events = EventPublisher(
            round_id=0,
            keys=EncryptKeyPair.generate(),  # placeholder until first sync
            params=RoundParameters(
                pk=b"\x00" * 32,
                sum=0.0,
                update=0.0,
                seed=RoundSeed.zeroed(),
                mask_config=MaskSettings().to_config().pair(),
                model_length=1,
            ),
            phase=PhaseName.IDLE,
        )
        self.events_sub = self.events.subscribe()
        self.request_rx = RequestReceiver()
        self.request_tx = self.request_rx.sender()
        self.handler = PetMessageHandler(self.events_sub, self.request_tx)
        self.pipeline = IngestPipeline(
            self.handler, self.request_tx, self.events_sub, settings.ingest
        )
        self.aggregator: EdgeAggregator | None = None
        self.round_id = 0
        self._round_seed: bytes | None = None
        self._phase = PhaseName.IDLE
        self._window_opened: float | None = None
        self._ship_q: asyncio.Queue = asyncio.Queue(_SHIP_QUEUE_BOUND)
        self._shipping = 0  # envelopes taken off the queue, not yet resolved
        self._tasks: list[asyncio.Task] = []
        self.shipped = 0
        self.rejected = 0
        self.dropped = 0

    # --- lifecycle --------------------------------------------------------

    @property
    def synced(self) -> bool:
        return self._round_seed is not None

    @property
    def accepting_updates(self) -> bool:
        """True while update uploads should fold LOCALLY (vs forward)."""
        return self.aggregator is not None and self._phase is PhaseName.UPDATE

    async def start(self) -> None:
        await self.pipeline.start()
        self._tasks = [
            asyncio.create_task(self._sync_loop(), name="edge-sync"),
            asyncio.create_task(self._consume_loop(), name="edge-consume"),
            asyncio.create_task(self._ship_loop(), name="edge-ship"),
            asyncio.create_task(self._linger_loop(), name="edge-linger"),
        ]
        logger.info(
            "edge %s up: upstream %s, window <= %d members / %.3fs linger",
            self.edge_id,
            self.settings.edge.upstream_url,
            self.settings.edge.max_members,
            self.settings.edge.linger_s,
        )

    async def stop(self) -> None:
        for task in self._tasks:
            task.cancel()
        for task in self._tasks:
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks = []
        # close the channel BEFORE stopping the pipeline: its coalescer's
        # final flush awaits verdicts the (cancelled) consume loop will
        # never deliver — a closed channel fails those fast instead of
        # deadlocking stop() (same order as server.runner.serve)
        self.request_tx.close()
        await self.pipeline.stop()
        self.upstream.close()

    # --- upstream round sync ----------------------------------------------

    async def _sync_loop(self) -> None:
        while True:
            try:
                await self._sync_once()
            except asyncio.CancelledError:
                raise
            except ClientError as err:
                logger.warning("edge %s: upstream sync failed: %s", self.edge_id, err)
            except Exception:
                logger.exception("edge %s: sync loop error", self.edge_id)
            await asyncio.sleep(self.settings.edge.poll_s)

    async def _sync_once(self) -> None:
        info = await self.upstream.get_edge_round()
        if info is None:
            return
        params = RoundParameters.from_dict(info["params"])
        phase = PhaseName(info["phase"])
        seed = params.seed.as_bytes()
        if seed != self._round_seed:
            if self.aggregator is not None and self.aggregator.pending:
                # the old round is gone; its unsealed window can never fold
                # (no envelope was sealed for it — keep the shipped-envelope
                # outcome counters consistent with envelopes_sealed_total)
                WINDOW_MEMBERS_DROPPED.inc(self.aggregator.pending)
                logger.warning(
                    "edge %s: dropping %d members of a stale round's window",
                    self.edge_id,
                    self.aggregator.pending,
                )
            keys = EncryptKeyPair(
                public=PublicEncryptKey(params.pk),
                secret=SecretEncryptKey(bytes.fromhex(info["secret_key"])),
            )
            self.aggregator = EdgeAggregator(
                params.mask_config,
                params.model_length,
                max_members=self.settings.edge.max_members,
                # wall-clock base: a restarted edge (same edge_id, same
                # round) must start PAST its crashed predecessor's shipped
                # sequences or the coordinator's watermark blackholes every
                # envelope it sends for the rest of the round. Window seals
                # are linger-paced (far slower than 1/ms), so a ms base from
                # a later process start always clears the old incarnation.
                start_seq=int(time.time() * 1000),
            )
            self._round_seed = seed
            self._window_opened = None
            self.round_id = int(info["round_id"])
            # the edge derives the SAME round trace id the coordinator and
            # the SDK derive from the public seed: its ingest/window/ship
            # spans stitch into the one distributed round trace, and its
            # upstream client stamps X-Xaynet-Trace accordingly
            trace.get_tracer().begin_round(self.round_id, trace.round_trace_id(seed))
            set_round_trace = getattr(self.upstream, "set_round_trace", None)
            if set_round_trace is not None:  # injected test doubles may lack it
                set_round_trace(seed)
            self.events.set_round_id(self.round_id)
            self.events.broadcast_keys(keys)
            self.events.broadcast_params(params)
            logger.info("edge %s: synced round %d", self.edge_id, self.round_id)
        if phase is not self._phase:
            if self._phase is PhaseName.UPDATE:
                # flush-on-phase-deadline: the update window upstream is
                # closing/closed — ship whatever is pending immediately
                # rather than sit out the linger
                await self._seal_pending()
            self._phase = phase
            self.events.broadcast_phase(phase)

    # --- the fold path ----------------------------------------------------

    async def _consume_loop(self) -> None:
        """Drain the request channel the reused ingest pipeline feeds."""
        while True:
            try:
                env = await self.request_rx.next_request()
            except ChannelClosed:
                return
            req = env.request
            if isinstance(req, CoalescedUpdates):
                for member in req.envelopes(env.request_id):
                    # a coalesced batch may straddle a window boundary: seal
                    # the full window mid-batch so the tail members open the
                    # next one instead of bouncing off "window-full" (a
                    # rejection the participant's state machine treats as final)
                    if self.aggregator is not None and self.aggregator.full:
                        await self._seal_pending()
                    self._admit_one(member)
                if not env.response.done():
                    env.response.set_result(None)
            else:
                if self.aggregator is not None and self.aggregator.full:
                    await self._seal_pending()
                self._admit_one(env)
            if self.aggregator is not None and self.aggregator.full:
                await self._seal_pending()

    def _admit_one(self, env) -> None:
        req = env.request
        if not isinstance(req, UpdateRequest) or not self.accepting_updates:
            self._resolve(
                env, RequestError(RequestError.Kind.MESSAGE_REJECTED, "edge folds updates only")
            )
            return
        try:
            if self.aggregator.pending == 0:
                self._window_opened = time.monotonic()
            self.aggregator.admit(req)
        except EdgeAdmitError as err:
            self._resolve(env, RequestError(RequestError.Kind.MESSAGE_REJECTED, str(err)))
            return
        self._resolve(env, None)

    @staticmethod
    def _resolve(env, error) -> None:
        if env.response.done():
            return
        if error is None:
            env.response.set_result(None)
        else:
            env.response.set_exception(error)

    async def _linger_loop(self) -> None:
        linger = self.settings.edge.linger_s
        tick = max(min(linger / 2 if linger > 0 else 0.05, 0.25), 0.01)
        while True:
            await asyncio.sleep(tick)
            if (
                self._window_opened is not None
                and time.monotonic() - self._window_opened >= linger
            ):
                await self._seal_pending()

    async def _seal_pending(self) -> None:
        if self.aggregator is None or not self.aggregator.pending:
            return
        opened = self._window_opened
        tracer = trace.get_tracer()
        with tracer.span(SPAN_SEAL, members=self.aggregator.pending) as seal_span:
            envelope = self.aggregator.seal(self.edge_id, self._round_seed)
            if seal_span.ctx is not None:
                # the envelope carries the seal span's context: the
                # coordinator's fold span adopts the trace and links back
                envelope.trace = trace.format_header(seal_span.ctx)
        if opened is not None:
            # the window's lifetime (first admit -> seal) as a retro span
            tracer.record_span(
                SPAN_WINDOW,
                start=opened,
                duration=time.monotonic() - opened,
                seq=envelope.window_seq,
                members=len(envelope),
            )
        self._window_opened = None
        await self._ship_q.put(envelope)  # blocks when the backlog is full
        ENVELOPE_BACKLOG.set(self._ship_q.qsize() + self._shipping)

    # --- shipping ---------------------------------------------------------

    async def _ship_loop(self) -> None:
        """Ship sealed envelopes upstream ONE at a time, in window order —
        the coordinator's watermark is strictly monotonic per edge, so an
        out-of-order ship would be rejected as a replay."""
        while True:
            envelope = await self._ship_q.get()
            self._shipping = 1
            ENVELOPE_BACKLOG.set(self._ship_q.qsize() + self._shipping)
            try:
                with trace.get_tracer().span(
                    SPAN_SHIP, seq=envelope.window_seq, members=len(envelope)
                ) as ship_span:
                    try:
                        await self.upstream.post_envelope(envelope.to_bytes())
                    except BaseException as err:
                        outcome = "dropped"
                        if isinstance(err, ClientPermanentError):
                            outcome = "rejected"
                        ship_span.set(outcome=outcome)
                        raise
                    ship_span.set(outcome="accepted")
                self.shipped += 1
                ENVELOPES_SHIPPED.labels(outcome="accepted").inc()
            except ClientPermanentError as err:
                # protocol rejection: the members fall out of this round
                # (they retry upstream directly on their next tick if the
                # window is still open — docs/DESIGN.md §11 failure modes)
                self.rejected += 1
                ENVELOPES_SHIPPED.labels(outcome="rejected").inc()
                logger.warning(
                    "edge %s: envelope %d rejected upstream: %s",
                    self.edge_id,
                    envelope.window_seq,
                    err,
                )
            except ClientError as err:
                self.dropped += 1
                ENVELOPES_SHIPPED.labels(outcome="dropped").inc()
                logger.warning(
                    "edge %s: envelope %d dropped (upstream unreachable): %s",
                    self.edge_id,
                    envelope.window_seq,
                    err,
                )
                # forensic bundle: the span ring holds the window, seal and
                # ship-retry spans that led up to losing this envelope
                flight_dump(
                    "edge-ship-drop",
                    f"edge {self.edge_id} window {envelope.window_seq} "
                    f"({len(envelope)} members): {err}",
                    edge_id=self.edge_id,
                    window_seq=envelope.window_seq,
                )
            except asyncio.CancelledError:
                raise
            finally:
                self._shipping = 0
                ENVELOPE_BACKLOG.set(self._ship_q.qsize())

    # --- relay + health ---------------------------------------------------

    async def forward_upstream(self, encrypted: bytes) -> None:
        """Relay one participant upload unchanged (non-update phases)."""
        FORWARDED.inc()
        await self.upstream.forward_message(encrypted)

    def health(self) -> dict:
        """The /healthz ``edge`` section: upstream link + backlog depth."""
        pending = self.aggregator.pending if self.aggregator is not None else 0
        backlog = self._ship_q.qsize() + self._shipping
        section = {
            "edge": {
                "edge_id": self.edge_id,
                "upstream": self.settings.edge.upstream_url,
                "synced": self.synced,
                "round_id": self.round_id,
                "phase": self._phase.value,
                "window_members": pending,
                "backlog_envelopes": backlog,
                "shipped": self.shipped,
                "rejected": self.rejected,
                "dropped": self.dropped,
            }
        }
        if not self.synced:
            section["status"] = "unsynced"
        elif backlog >= _SHIP_QUEUE_BOUND:
            section["status"] = "stuck"
        return section
