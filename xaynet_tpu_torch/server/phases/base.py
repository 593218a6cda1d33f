"""Phase machinery: shared context, run loop, count/time request windows.

Functional port of the reference's phase framework (reference:
rust/xaynet-server/src/state_machine/phases/phase.rs:49-231 and
handler.rs:96-202):

- ``run_phase``: broadcast the phase event -> ``process`` -> purge requests
  left over from the phase -> ``broadcast`` -> ``next``; any error routes to
  the Failure phase.
- request windows: accept up to ``count.max`` requests during
  ``[0, time.min]``; then keep accepting until ``count.min`` is reached,
  bounded by ``time.max`` — too few accepted requests is a
  ``PhaseTimeout``. Requests beyond ``count.max`` are *discarded*; requests
  that fail protocol checks are *rejected*.

Liveness extension (docs/DESIGN.md §10): a phase may carry a
``count.quorum`` (quorum <= min <= max). Once ``time.min`` has elapsed and
arrivals stall — no accepted message for ``liveness.stall_grace_s`` — a
phase with ``accepted >= quorum`` closes successfully in DEGRADED mode
instead of waiting out ``time.max`` for a ``count.min`` that churned-out
participants will never deliver; the same fallback applies when
``time.max`` expires at/above quorum. Every window completion is counted
on ``xaynet_phase_outcome_total{phase,outcome=full|degraded|timeout}``
and reported to the round controller when one is installed.
"""

from __future__ import annotations

import asyncio
import logging
import time as time_mod
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

from ...storage.traits import Store
from ...telemetry import tracing as trace
from ...telemetry.recorder import flight_dump
from ...telemetry.registry import get_registry
from ...utils import tracing
from ..events import EventPublisher, PhaseName
from ..requests import (
    ChannelClosed,
    CoalescedUpdates,
    EnvelopeReplay,
    PartialAggregate,
    RequestError,
    RequestReceiver,
    StateMachineRequest,
)
from ..settings import PhaseSettings, Settings, Sum2Settings

if TYPE_CHECKING:
    from ..coordinator import CoordinatorState

logger = logging.getLogger("xaynet.coordinator")

PHASE_OUTCOMES = get_registry().counter(
    "xaynet_phase_outcome_total",
    "Request-window phase completions, by phase and outcome "
    "(full | degraded | timeout).",
    ("phase", "outcome"),
)

# one span name per phase — spelled out (not built in a loop) so the
# analysis `span` pass can cross-check the literal set against the DESIGN
# §16 span table exactly like the metrics table
_PHASE_SPANS: dict[str, str] = {
    "idle": trace.declare_span("phase.idle"),
    "sum": trace.declare_span("phase.sum"),
    "update": trace.declare_span("phase.update"),
    "sum2": trace.declare_span("phase.sum2"),
    "unmask": trace.declare_span("phase.unmask"),
    "failure": trace.declare_span("phase.failure"),
    "shutdown": trace.declare_span("phase.shutdown"),
}
SPAN_PARTIAL = trace.declare_span("edge.upstream_fold")


class PhaseError(Exception):
    """A phase failed; drives the transition into Failure."""

    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"{kind}{': ' + detail if detail else ''}")
        self.kind = kind


class PhaseTimeout(PhaseError):
    """The window closed below quorum; carries the full window diagnostics
    (who arrived, what the thresholds were, how long the phase ran) so the
    Failure-phase log line and the phase_error metric event name the gap
    instead of a static string."""

    def __init__(
        self,
        accepted: Optional[int] = None,
        count_min: int = 0,
        quorum: int = 0,
        rejected: int = 0,
        discarded: int = 0,
        seconds: float = 0.0,
    ):
        detail = "not enough messages received within the time window"
        if accepted is not None:
            detail += (
                f" ({accepted} accepted / min {count_min} / quorum {quorum}; "
                f"{rejected} rejected, {discarded} discarded; "
                f"{seconds:.1f}s in phase)"
            )
        super().__init__("PhaseTimeout", detail)
        self.accepted = accepted
        self.count_min = count_min
        self.quorum = quorum
        self.rejected = rejected
        self.discarded = discarded
        self.seconds = seconds


@dataclass
class Shared:
    """Context threaded through all phases (single-writer)."""

    state: "CoordinatorState"
    request_rx: RequestReceiver
    events: EventPublisher
    store: Store
    settings: Settings
    metrics: Optional[object] = None
    # the tenant this round state belongs to (docs/DESIGN.md §19): keys the
    # aggregator's pool leases and scheduler slots, labels phase spans,
    # flight dumps and tenant metric families, scopes checkpoints/storage
    tenant: str = "default"
    # Failure-phase round-resume budget for the CURRENT round (reset by
    # Idle); bounds how often one round may re-enter Update from its
    # checkpoint before falling back to a restart
    resume_attempts: int = 0
    # adaptive count-window controller ([liveness] adaptive = true); phases
    # report window outcomes here, Unmask/Failure report round outcomes
    round_ctl: Optional[object] = None
    # the torch device the round's aggregator runs on (CUDA unless the
    # caller of serve() passed another); the runner resolves it
    device: Optional[object] = None
    # per-edge partial-aggregate watermarks for the CURRENT round (reset by
    # Idle): edge_id -> highest window_seq folded. A redelivered envelope
    # (edge retry after a lost acknowledgement) is rejected as stale
    # instead of folded twice (docs/DESIGN.md §11).
    edge_watermarks: dict = field(default_factory=dict)
    # graceful-shutdown flush (docs/DESIGN.md §9): the phase whose journal
    # cadence can lag live state (Update) installs its ``save_now`` here so
    # the runner's SIGTERM/SIGINT path can persist a final journal entry
    # before exiting; per-event-journaling phases leave it None
    flush_hook: Optional[object] = None
    # the round's StagedAggregator (``build_staged_aggregator`` sets it):
    # Idle closes it, waiting out a flush a failed or cancelled phase left
    # running, before it reclaims the tenant's pages
    round_aggregator: Optional[object] = None

    def set_round_id(self, round_id: int) -> None:
        self.state.round_id = round_id
        self.events.set_round_id(round_id)

    @property
    def round_id(self) -> int:
        return self.state.round_id


def reduce_count_window(params, offset: int):
    """Shrink a phase's count window by ``offset`` already-journaled
    arrivals (a resumed phase re-opens for the REMAINDER only; the restored
    participants will not resend). A fully-satisfied window drains straight
    through: min/max/quorum clamp at 0."""
    import dataclasses

    if not offset:
        return params
    count = dataclasses.replace(
        params.count,
        min=max(params.count.min - offset, 0),
        max=max(params.count.max - offset, 0),
        quorum=(
            None
            if params.count.quorum is None
            else max(params.count.quorum - offset, 0)
        ),
    )
    return dataclasses.replace(params, count=count)


class _Counter:
    """Accepted/rejected/discarded bookkeeping (handler.rs:28-89), plus the
    liveness quorum (quorum == min when no degraded completion is armed)."""

    def __init__(self, count_min: int, count_max: int, quorum: Optional[int] = None):
        self.min = count_min
        self.max = count_max
        self.quorum = count_min if quorum is None else min(quorum, count_min)
        self.accepted = 0
        self.rejected = 0
        self.discarded = 0

    @property
    def has_enough(self) -> bool:
        return self.accepted >= self.min

    @property
    def has_quorum(self) -> bool:
        return self.accepted >= self.quorum

    @property
    def has_overmuch(self) -> bool:
        return self.accepted >= self.max


class PhaseState:
    """Base class for phases; subclasses set NAME and implement hooks."""

    NAME: PhaseName
    # arrivals the round controller should count ON TOP of this window's
    # accepted requests (a checkpoint-resumed update phase runs a reduced
    # window: the restored models were real arrivals, and omitting them
    # would make a resumed 100-participant round look like a 5-participant
    # deployment to the adaptive shrink clamp)
    arrivals_offset: int = 0

    def __init__(self, shared: Shared):
        self.shared = shared

    # --- hooks ------------------------------------------------------------

    async def process(self) -> None:
        raise NotImplementedError

    def broadcast(self) -> None:
        pass

    async def next(self) -> Optional["PhaseState"]:
        raise NotImplementedError

    async def handle_request(self, req: StateMachineRequest) -> None:
        """Phase-specific request handling; raises ``RequestError`` to reject."""
        raise RequestError(RequestError.Kind.MESSAGE_REJECTED, "phase accepts no requests")

    async def handle_partial(self, req: PartialAggregate, remaining: int) -> None:
        """Phase-specific partial-aggregate handling (edge tier); raises
        ``RequestError`` to reject the WHOLE envelope — partials are atomic
        and only the update phase accepts them. ``remaining`` is the count
        window's free capacity: the overshoot check lives in the handler,
        AFTER the watermark replay check, so a redelivered already-folded
        envelope is still acked idempotently at a nearly-closed window."""
        raise RequestError(
            RequestError.Kind.MESSAGE_REJECTED, "phase accepts no partial aggregates"
        )

    async def coalesced_batch_start(self, members) -> None:
        """Hook: a coalesced micro-batch is about to be processed
        member-wise (the update phase batch-prevalidates device wire
        updates here — one device round-trip for the whole group)."""

    async def coalesced_batch_done(self, n: int) -> None:
        """Hook: a coalesced micro-batch of ``n`` members was just processed
        (the update phase flushes its staged fold here)."""

    # --- run loop ---------------------------------------------------------

    def _announce(self) -> None:
        """Broadcast + record the phase entry (every phase, every override)."""
        self.shared.events.broadcast_phase(self.NAME)
        if self.shared.metrics is not None:
            self.shared.metrics.phase(self.shared.round_id, self.NAME.value)
        logger.info("round %d: entering %s phase", self.shared.round_id, self.NAME.value)

    async def run_phase(self) -> Optional["PhaseState"]:
        self._announce()
        t0 = time_mod.monotonic()
        # the phase span brackets exactly what phase_duration measures
        # (process + purge), so tools/trace_report.py can cross-check the
        # trace against the round report's phase walls. Idle straddles the
        # round boundary (it COMPUTES the seed the new round's trace id
        # derives from), so its span is a fresh root — parenting it to the
        # previous round's root would leave an orphan in the new round's
        # export.
        idle_ctx = (
            trace.TraceContext(trace.new_id()) if self.NAME is PhaseName.IDLE else None
        )
        with trace.get_tracer().span(
            _PHASE_SPANS[self.NAME.value],
            ctx=idle_ctx,
            round_id=self.shared.round_id,
            tenant=self.shared.tenant,
        ) as phase_span:
            # the window outcome lands on the phase span too
            # (_record_window_outcome), so the timeline fold can tell a
            # degraded round from the span buffer alone
            self._phase_span = phase_span
            try:
                await self.process()
                await self.purge_outdated_requests()
            except (PhaseError, ChannelClosed) as err:
                self._record_duration(t0)
                return await self._into_failure(err)
            except Exception as err:  # storage or internal errors
                self._record_duration(t0)
                return await self._into_failure(PhaseError(type(err).__name__, str(err)))
        self._record_duration(t0)
        self.broadcast()
        return await self.next()

    def _record_duration(self, t0: float) -> None:
        if self.shared.metrics is not None and hasattr(self.shared.metrics, "phase_duration"):
            self.shared.metrics.phase_duration(
                self.shared.round_id, self.NAME.value, time_mod.monotonic() - t0
            )

    async def _into_failure(self, err: Exception) -> "PhaseState":
        from .failure import Failure

        logger.warning("round %d: %s phase failed: %s", self.shared.round_id, self.NAME.value, err)
        return Failure(self.shared, err, failed_phase=self.NAME)

    async def purge_outdated_requests(self) -> None:
        """Reject every request still queued from this phase (phase.rs:183-192).

        Purges are counted separately from in-window rejects (``purged``
        outcome): a degraded close rejects every straggler still queued, and
        that burst must not pollute reject-rate dashboards."""
        while True:
            env = self.shared.request_rx.try_recv()
            if env is None:
                return
            self._respond(env, RequestError(RequestError.Kind.MESSAGE_REJECTED, "phase ended"))
            metrics = self.shared.metrics
            if metrics is not None:
                if hasattr(metrics, "message_purged"):
                    metrics.message_purged(self.shared.round_id, self.NAME.value)
                else:  # pre-purge recorders (test spies): keep the old bucket
                    metrics.message_rejected(self.shared.round_id, self.NAME.value)

    # --- request windows --------------------------------------------------

    async def process_requests(self, params: PhaseSettings | Sum2Settings) -> str:
        """Run the count/time request window; returns the outcome
        (``"full"`` or ``"degraded"``) or raises :class:`PhaseTimeout`."""
        # effective_quorum re-clamps quorum <= min after any adaptive
        # controller adjustment to min (settings.CountSettings)
        counter = _Counter(
            params.count.min,
            params.count.max,
            getattr(params.count, "effective_quorum", None),
        )
        logger.debug(
            "processing requests for min %.1fs / max %.1fs (count %d..%d, quorum %d)",
            params.time.min,
            params.time.max,
            params.count.min,
            params.count.max,
            counter.quorum,
        )
        t0 = time_mod.monotonic()
        await self._process_during(params.time.min, counter)
        time_left = max(params.time.max - params.time.min, 0.0)
        try:
            await self._process_until_enough(counter, time_mod.monotonic() + time_left)
        except asyncio.TimeoutError:
            # only raised below quorum: at/above quorum the deadline closes
            # the window degraded by RETURNING between requests (never by
            # cancelling one mid-flight — see _process_until_enough)
            self._record_window_outcome(counter, "timeout", t0)
            raise PhaseTimeout(
                accepted=counter.accepted,
                count_min=counter.min,
                quorum=counter.quorum,
                rejected=counter.rejected,
                discarded=counter.discarded,
                seconds=time_mod.monotonic() - t0,
            ) from None
        outcome = "full" if counter.has_enough else "degraded"
        self._record_window_outcome(counter, outcome, t0)
        logger.log(
            logging.WARNING if outcome == "degraded" else logging.INFO,
            "round %d %s: %s close — %d accepted (min %d, quorum %d, max %d), "
            "%d rejected, %d discarded",
            self.shared.round_id,
            self.NAME.value,
            outcome,
            counter.accepted,
            counter.min,
            counter.quorum,
            counter.max,
            counter.rejected,
            counter.discarded,
        )
        return outcome

    def _record_window_outcome(self, counter: _Counter, outcome: str, t0: float) -> None:
        PHASE_OUTCOMES.labels(phase=self.NAME.value, outcome=outcome).inc()
        phase_span = getattr(self, "_phase_span", None)
        if phase_span is not None:
            phase_span.set(outcome=outcome)
        if outcome in ("degraded", "timeout"):
            # forensic bundle: the span ring holds what led up to the
            # degraded close / below-quorum timeout (recent request, ingest
            # and fold spans), the deltas show which counters moved
            flight_dump(
                "degraded-close" if outcome == "degraded" else "phase-timeout",
                f"round {self.shared.round_id} {self.NAME.value}: "
                f"{counter.accepted} accepted (min {counter.min}, quorum "
                f"{counter.quorum}), {counter.rejected} rejected, "
                f"{counter.discarded} discarded",
                phase=self.NAME.value,
                round_id=self.shared.round_id,
                tenant=self.shared.tenant,
            )
        if self.shared.round_ctl is not None:
            self.shared.round_ctl.observe_phase(
                self.NAME.value,
                counter.accepted + self.arrivals_offset,
                outcome,
                time_mod.monotonic() - t0,
            )

    async def _process_during(self, duration: float, counter: _Counter) -> None:
        deadline = time_mod.monotonic() + duration
        while True:
            remaining = deadline - time_mod.monotonic()
            if remaining <= 0:
                return
            try:
                env = await asyncio.wait_for(self.shared.request_rx.next_request(), remaining)
            except asyncio.TimeoutError:
                return
            await self._process_single(env, counter)

    async def _process_until_enough(self, counter: _Counter, deadline: float) -> None:
        """Accept until ``count.min`` — or until the ``time.max`` deadline
        or, with a quorum armed, until arrivals STALL at/above quorum: no
        accepted message for ``liveness.stall_grace_s`` closes the window
        degraded (returning normally; the caller decides full vs degraded
        from the counter). A rejected/discarded straggler does not reset
        the stall clock — only acceptances prove the phase is still making
        progress.

        The window boundary (deadline or stall) is only ever declared
        BETWEEN requests: a request being handled always runs to
        completion first, so a degraded close can never strand a
        half-applied update (a seed-dict entry whose model was never
        staged would break the nb_models == seed-watermark unmask
        invariant). Below quorum the deadline raises ``TimeoutError``
        between requests instead — the caller turns it into the diagnostic
        :class:`PhaseTimeout`."""
        quorum_armed = counter.quorum < counter.min
        stall_grace = self.shared.settings.liveness.stall_grace_s
        last_accept = time_mod.monotonic()
        while not counter.has_enough:
            now = time_mod.monotonic()
            time_left = deadline - now
            at_quorum = quorum_armed and counter.has_quorum
            if time_left <= 0 or (at_quorum and now - last_accept >= stall_grace):
                # the window is closing — but a request that arrived IN
                # time may still sit queued behind slow processing (it
                # might even lift the phase to quorum or min); declaring
                # the close without draining it would purge it
                env = self.shared.request_rx.try_recv()
                if env is None:
                    if at_quorum:
                        return  # degraded close (caller reads the counter)
                    raise asyncio.TimeoutError  # time.max expired below quorum
            else:
                wait = time_left
                if at_quorum:
                    wait = min(wait, stall_grace - (now - last_accept))
                try:
                    env = await asyncio.wait_for(
                        self.shared.request_rx.next_request(), wait
                    )
                except asyncio.TimeoutError:
                    continue  # re-evaluate the deadline / stall clock
            accepted_before = counter.accepted
            await self._process_single(env, counter)
            if counter.accepted > accepted_before:
                last_accept = time_mod.monotonic()

    async def _process_single(self, env, counter: _Counter) -> None:
        if isinstance(env.request, CoalescedUpdates):
            # unpack the micro-batch: every member is counted, handled and
            # answered exactly as if it had arrived alone (count.min/max
            # protocol semantics are per UPDATE, not per envelope), then the
            # phase gets one batch-done hook for the stacked fold dispatch
            try:
                await self.coalesced_batch_start(env.request.members)
                for member_env in env.request.envelopes(env.request_id):
                    await self._process_single(member_env, counter)
                await self.coalesced_batch_done(len(env.request))
            except BaseException as err:
                # infrastructure failure OR cancellation (phase window
                # expiring) mid-batch: EVERY future must still resolve — a
                # dangling member would wedge the coalescer (and its shard
                # worker) for the life of the process
                failure = (
                    err
                    if isinstance(err, RequestError)
                    else RequestError(
                        RequestError.Kind.INTERNAL, str(err) or type(err).__name__
                    )
                )
                self._respond(env, failure)  # fans out to pending members
                raise
            self._respond(env, None)
            return
        if isinstance(env.request, PartialAggregate):
            await self._process_partial(env, counter)
            return
        if counter.has_overmuch:
            counter.discarded += 1
            if self.shared.metrics is not None:
                self.shared.metrics.message_discarded(self.shared.round_id, self.NAME.value)
            self._respond(env, RequestError(RequestError.Kind.MESSAGE_DISCARDED))
            return
        t0 = time_mod.monotonic()
        try:
            with tracing.use_request_id(env.request_id), tracing.span(
                "handle_request", phase=self.NAME.value
            ):
                await self.handle_request(env.request)
        except RequestError as err:
            counter.rejected += 1
            self._record_handled(t0)
            if self.shared.metrics is not None:
                self.shared.metrics.message_rejected(self.shared.round_id, self.NAME.value)
            self._respond(env, err)
            return
        except BaseException as err:
            # infrastructure failure (e.g. storage outage) or cancellation
            # (phase window expiring mid-handle): resolve the requester's
            # future before the phase error propagates, or the client would
            # wait forever on a round that already failed
            self._respond(
                env,
                RequestError(RequestError.Kind.INTERNAL, str(err) or type(err).__name__),
            )
            raise
        counter.accepted += 1
        self._record_handled(t0)
        if self.shared.metrics is not None:
            self.shared.metrics.message_accepted(self.shared.round_id, self.NAME.value)
        self._respond(env, None)

    async def _process_partial(self, env, counter: _Counter) -> None:
        """One edge envelope, accepted WHOLE or rejected WHOLE.

        The window accounting treats the envelope as its member count
        (count.min/max/quorum are per UPDATE, not per envelope): an
        envelope that would overshoot ``count.max`` is discarded atomically
        — never split across the boundary — and an accepted one advances
        the counter (and the stall clock) by every member it carried. The
        overshoot check itself lives in the handler so the watermark can
        ack a replayed envelope idempotently even at a nearly-closed
        window (its members already count).
        """
        k = len(env.request)
        t0 = time_mod.monotonic()
        try:
            with tracing.use_request_id(env.request_id), tracing.span(
                "handle_partial", phase=self.NAME.value
            ), trace.get_tracer().span(
                SPAN_PARTIAL,
                link=trace.parse_header(getattr(env.request, "trace", None)),
                edge_id=getattr(env.request, "edge_id", ""),
                members=k,
            ):
                await self.handle_partial(
                    env.request, counter.max - counter.accepted
                )
        except EnvelopeReplay:
            # already folded (the edge retried after a lost ack): success,
            # but the window counter must NOT advance a second time
            self._record_handled(t0)
            self._respond(env, None)
            return
        except RequestError as err:
            self._record_handled(t0)
            if err.kind is RequestError.Kind.MESSAGE_DISCARDED:
                counter.discarded += 1
                if self.shared.metrics is not None:
                    self.shared.metrics.message_discarded(
                        self.shared.round_id, self.NAME.value
                    )
            else:
                counter.rejected += 1
                if self.shared.metrics is not None:
                    self.shared.metrics.message_rejected(
                        self.shared.round_id, self.NAME.value
                    )
            self._respond(env, err)
            return
        except BaseException as err:
            self._respond(
                env,
                RequestError(RequestError.Kind.INTERNAL, str(err) or type(err).__name__),
            )
            raise
        counter.accepted += k
        self._record_handled(t0)
        if self.shared.metrics is not None:
            for _ in range(k):  # dashboards count UPDATES, not envelopes
                self.shared.metrics.message_accepted(self.shared.round_id, self.NAME.value)
        self._respond(env, None)

    def _record_handled(self, t0: float) -> None:
        """Per-request handler latency; registry-only (the bridge implements
        it, line-protocol sinks and test stubs need not)."""
        metrics = self.shared.metrics
        if metrics is not None and hasattr(metrics, "request_handled"):
            metrics.request_handled(
                self.shared.round_id, self.NAME.value, time_mod.monotonic() - t0
            )

    @staticmethod
    def _respond(env, error: Optional[Exception]) -> None:
        if error is not None and isinstance(env.request, CoalescedUpdates):
            # purge / infrastructure failure on a whole micro-batch: members
            # the phase never reached inherit the envelope's verdict
            env.request.reject_members(error)
        if env.response.done():
            return
        if error is None:
            env.response.set_result(None)
        else:
            env.response.set_exception(error)
