"""Request channel between the services and the state machine.

Functional port of the reference's request plumbing (reference:
rust/xaynet-server/src/state_machine/requests.rs:27-205): services submit
typed requests over an unbounded queue; each request carries a one-shot
response future resolved by the phase that handles it. Requests from prior
phases are purged with a rejection at phase end.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from enum import Enum
from typing import Optional, Union

from ..utils import tracing

from ..core.common import LocalSeedDict
from ..core.mask.object import MaskObject
from ..core.message import Message, Sum, Sum2, Update
from ..telemetry.registry import get_registry

# depth of the services -> state-machine queue: the leading indicator of a
# phase falling behind its ingest (scraped via GET /metrics). Labelled per
# TENANT: each tenant runs its own channel, and one tenant's close/purge
# must never zero (or double-count into) another tenant's depth — the
# cross-tenant isolation contract of docs/DESIGN.md §19.
_QUEUE_DEPTH = get_registry().gauge(
    "xaynet_request_queue_depth",
    "State-machine requests enqueued and not yet handled by a phase, "
    "by tenant.",
    ("tenant",),
)


class RequestError(Exception):
    """A request was rejected by the state machine."""

    class Kind(str, Enum):
        MESSAGE_REJECTED = "the message was rejected"
        MESSAGE_DISCARDED = "the message was discarded"
        INTERNAL = "internal error"

    def __init__(self, kind: "RequestError.Kind", detail: str = ""):
        super().__init__(f"{kind.value}{': ' + detail if detail else ''}")
        self.kind = kind


@dataclass
class SumRequest:
    participant_pk: bytes
    ephm_pk: bytes


@dataclass
class UpdateRequest:
    participant_pk: bytes
    local_seed_dict: LocalSeedDict
    masked_model: MaskObject


@dataclass
class Sum2Request:
    participant_pk: bytes
    model_mask: MaskObject


@dataclass
class CoalescedUpdates:
    """A micro-batch of verified ``UpdateRequest``s travelling as ONE
    channel envelope (built by ``ingest.coalescer``).

    Each member keeps its own response future: the phase resolves them
    individually, so one rejected update never fails its batch-mates, and
    the seed-dict insert stays paired with its masked model per member.
    ``request_ids`` (parallel to ``members``, optional) preserves each
    message's tracing id through the batch.
    """

    members: list[UpdateRequest]
    responses: list[asyncio.Future]
    request_ids: Optional[list[str]] = None

    def __len__(self) -> int:
        return len(self.members)

    def envelopes(self, fallback_request_id: str = "-"):
        """One per-member ``_Envelope``, carrying the member's own tracing
        id (so batched log lines keep per-message correlation)."""
        ids = self.request_ids or [fallback_request_id] * len(self.members)
        return [
            _Envelope(req, fut, rid)
            for req, fut, rid in zip(self.members, self.responses, ids)
        ]

    def reject_members(self, error: Exception) -> None:
        """Resolve every still-pending member future with ``error`` (purge
        at phase end, channel shutdown, infrastructure failure)."""
        for fut in self.responses:
            if not fut.done():
                fut.set_exception(error)


@dataclass
class PartialAggregate:
    """An edge aggregator's pre-folded window: the modular sum of
    ``len(members)`` verified masked updates plus every member's seed dict,
    travelling upstream as ONE envelope (``xaynet_tpu_torch.edge``).

    The envelope is ATOMIC: the update phase folds it as a single
    ``masked_add`` dispatch and advances ``nb_models`` by the member count
    with all seed dicts inserted, or rejects it whole — it is never split
    across a window boundary or a degraded close. ``(edge_id, window_seq)``
    is the per-edge watermark: a redelivered envelope (the edge retried
    after a lost acknowledgement) is rejected as stale instead of folded
    twice, which would break the nb_models == seed-watermark invariant.
    """

    edge_id: str
    window_seq: int
    round_seed: bytes
    members: list[bytes]  # update participant pks, envelope order
    seed_dicts: dict[bytes, LocalSeedDict]  # update pk -> local seed dict
    masked: MaskObject  # modular sum of the members' masked models
    # the shipping edge's trace context ("trace_id-span_id", the envelope's
    # `trace` header field): the update phase's fold span adopts the trace
    # id so a two-tier round stitches into ONE trace (docs/DESIGN.md §16)
    trace: Optional[str] = None

    def __len__(self) -> int:
        return len(self.members)


class EnvelopeReplay(Exception):
    """The EXACT envelope at the per-edge watermark was redelivered — the
    edge retried after a lost acknowledgement, and everything it carries is
    already folded. The phase answers SUCCESS without folding or advancing
    the count window (idempotent ack), so the edge does not misreport a
    folded envelope as rejected data loss."""


StateMachineRequest = Union[
    SumRequest, UpdateRequest, Sum2Request, CoalescedUpdates, PartialAggregate
]


def request_from_message(message: Message) -> StateMachineRequest:
    """Converts a verified message into a state-machine request
    (reference: requests.rs:88-114)."""
    payload = message.payload
    if isinstance(payload, Sum):
        return SumRequest(participant_pk=message.participant_pk, ephm_pk=payload.ephm_pk)
    if isinstance(payload, Update):
        return UpdateRequest(
            participant_pk=message.participant_pk,
            local_seed_dict=payload.local_seed_dict,
            masked_model=payload.masked_model,
        )
    if isinstance(payload, Sum2):
        return Sum2Request(participant_pk=message.participant_pk, model_mask=payload.model_mask)
    raise ValueError(f"cannot convert payload {type(payload)} into a request")


@dataclass
class _Envelope:
    request: StateMachineRequest
    response: asyncio.Future
    request_id: str = "-"


class RequestReceiver:
    """The state machine's end of the request channel.

    ``maxsize`` bounds the channel (0 = unbounded, the historical default;
    deployments running the admission-controlled ingest pipeline are bounded
    upstream by the intake shards). The depth gauge tracks REAL envelopes
    only — the shutdown sentinel is never counted — and is kept in sync on
    enqueue, dequeue, phase-end purge (via ``try_recv``) and close.
    """

    def __init__(self, maxsize: int = 0, tenant: str = "default"):
        # one queue carries both envelopes and the single shutdown sentinel;
        # the +1 slack below keeps a full bounded channel closable
        self._queue: asyncio.Queue[Optional[_Envelope]] = (
            # unbounded only on request: ingest deployments bound upstream
            asyncio.Queue()  # lint: unbounded-ok
            if maxsize <= 0
            else asyncio.Queue(maxsize + 1)
        )
        self.maxsize = maxsize
        self.tenant = tenant
        self._gauge = _QUEUE_DEPTH.labels(tenant=tenant)
        self._depth = 0
        self._closed = False

    def _enqueue(self, env: _Envelope) -> None:
        if self._closed:
            raise RequestError(RequestError.Kind.INTERNAL, "state machine is shut down")
        if self.maxsize and self._depth >= self.maxsize:
            raise RequestError(RequestError.Kind.INTERNAL, "request channel full")
        self._queue.put_nowait(env)
        self._depth += 1
        self._gauge.set(self._depth)

    def _dequeued(self, env: Optional[_Envelope]) -> Optional[_Envelope]:
        if env is not None:
            self._depth -= 1
            self._gauge.set(self._depth)
        return env

    async def next_request(self) -> _Envelope:
        env = self._dequeued(await self._queue.get())
        if env is None:
            raise ChannelClosed()
        return env

    def try_recv(self) -> Optional[_Envelope]:
        """Non-blocking receive; None when the queue is momentarily empty."""
        try:
            env = self._queue.get_nowait()
        except asyncio.QueueEmpty:
            return None
        env = self._dequeued(env)
        if env is None:
            raise ChannelClosed()
        return env

    def close(self) -> None:
        """Shut the channel: every queued request is rejected immediately so
        an in-flight ``request()`` can never hang on a dead state machine.

        Scope: strictly THIS channel. The purge resolves only futures
        queued here, and only this tenant's depth gauge child zeroes —
        closing one tenant's channel must never strand or misaccount
        another tenant's in-flight requests (docs/DESIGN.md §19)."""
        if self._closed:
            return
        self._closed = True
        error = RequestError(RequestError.Kind.INTERNAL, "state machine is shut down")
        while True:
            try:
                env = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            if env is None:
                continue
            if isinstance(env.request, CoalescedUpdates):
                env.request.reject_members(error)
            if not env.response.done():
                env.response.set_exception(error)
        self._depth = 0
        self._gauge.set(0)
        self._queue.put_nowait(None)

    def sender(self) -> "RequestSender":
        return RequestSender(self)


class ChannelClosed(Exception):
    """The request channel was shut down."""


class RequestSender:
    """The services' end of the request channel (cloneable)."""

    def __init__(self, receiver: RequestReceiver):
        self._receiver = receiver

    def close(self) -> None:
        """Shut the channel from the services' side.

        The runner uses this on the cancel path: a cancelled state machine
        never reaches the Shutdown phase (which closes the channel in normal
        termination), and draining components — the ingest pipeline's final
        coalescer flush in particular — must fail fast instead of awaiting a
        request nobody will ever handle.
        """
        self._receiver.close()

    async def request(self, req: StateMachineRequest) -> None:
        """Submit a request and await the state machine's verdict.

        Raises ``RequestError`` when the request is rejected/discarded.
        """
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._receiver._enqueue(_Envelope(req, fut, tracing.current_request_id()))
        await fut
