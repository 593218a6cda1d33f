"""Message-processing pipeline and data fetchers.

Functional port of the reference's tower service stack (reference:
rust/xaynet-server/src/services/messages/mod.rs:30-118):

    Decryptor -> MessageParser (phase filter + signature verification)
    -> MultipartHandler (chunk reassembly) -> TaskValidator -> StateMachine

CPU-heavy stages (sealed-box open, Ed25519 verify) run on a thread pool so
the asyncio loop stays responsive — the analogue of the reference's rayon
offload with a concurrency limit.

``Fetcher`` exposes the latest event-bus values to the API layer
(reference: rust/xaynet-server/src/services/fetchers/mod.rs:27-42).
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..core.common import RoundParameters
from ..core.crypto.encrypt import DecryptError, EncryptKeyPair
from ..core.crypto.sign import is_eligible, verify_detached
from ..core.mask.serialization import DecodeError
from ..core.message import Chunk, Message, Sum, Sum2, Tag, Update, peek_header
from ..core.message.encoder import MessageBuilder
from ..telemetry.registry import get_registry
from ..utils import tracing
from .events import EventSubscriber, PhaseName
from .requests import RequestSender, request_from_message

_PHASE_TAGS = {
    PhaseName.SUM: Tag.SUM,
    PhaseName.UPDATE: Tag.UPDATE,
    PhaseName.SUM2: Tag.SUM2,
}

# ms-scale crypto stages; the 'total' series includes the state-machine wait
_PIPELINE_SECONDS = get_registry().histogram(
    "xaynet_message_pipeline_seconds",
    "Message-pipeline stage wall time (decrypt_parse = sealed-box open + "
    "signature verify on the thread pool; total = end-to-end handling).",
    ("stage",),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
)
_MULTIPART_BUFFERS = get_registry().gauge(
    "xaynet_multipart_buffers",
    "Multipart reassembly buffers currently held (bounded, oldest-evicted).",
)


class ServiceError(Exception):
    """A message was dropped by the pipeline (with the stage as context)."""

    def __init__(self, stage: str, detail: str):
        super().__init__(f"{stage}: {detail}")
        self.stage = stage


class PetMessageHandler:
    """End-to-end handling of one encrypted PET message."""

    def __init__(
        self,
        events: EventSubscriber,
        request_tx: RequestSender,
        max_workers: int = 4,
        wire_ingest: bool = False,
    ):
        self.events = events
        self.request_tx = request_tx
        # device-ingest coordinators parse Update masked models LAZILY (raw
        # element block kept; unpack + validity run on the accelerator in
        # validate_aggregation, before the seed-dict insert)
        self.wire_ingest = wire_ingest
        self._pool = ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="pet-msg")
        # multipart reassembly buffers keyed by (participant_pk, message_id);
        # bounded: abandoned reassemblies are evicted oldest-first so a
        # client cannot grow coordinator memory without completing messages
        self._multipart: dict[tuple[bytes, int], MessageBuilder] = {}
        self.max_multipart_buffers = 4096

    async def handle_message(self, encrypted: bytes) -> None:
        """Decrypt, verify, validate and forward one message.

        Raises ``ServiceError`` (pipeline drop) or ``RequestError`` (state
        machine rejection).
        """
        tracing.new_request_id()
        with tracing.span("handle_message", size=len(encrypted)):
            with _PIPELINE_SECONDS.labels(stage="total").time():
                with _PIPELINE_SECONDS.labels(stage="decrypt_parse").time():
                    message = await self._parse_message(encrypted)
                if message is None:
                    return  # multipart message still incomplete
                with tracing.span("task_validator"):
                    self._validate_task(message)
                await self.request_tx.request(request_from_message(message))

    # --- pipeline stages --------------------------------------------------

    def _decrypt_parse_one(
        self, encrypted: bytes, keys: EncryptKeyPair, phase: PhaseName
    ) -> Message:
        """Sealed-box open + phase filter + signature verify + parse.

        Synchronous CPU body shared by the per-message path and the batched
        ingest workers; always runs on a worker thread.
        """
        # sealed-box open (CPU) — reference: decryptor.rs:48-69. Passing our
        # public key skips a per-message X25519 recompute of it (milliseconds
        # per message on the pure-python fallback)
        try:
            raw = keys.secret.decrypt(encrypted, keys.public)
        except (DecryptError, ValueError) as e:
            raise ServiceError("decrypt", str(e)) from e
        # phase filter before the expensive signature check
        # (reference: message_parser.rs:88-141)
        try:
            _, tag, _ = peek_header(raw)
        except DecodeError as e:
            raise ServiceError("parse", str(e)) from e
        expected = _PHASE_TAGS.get(phase)
        if expected is None or tag != expected:
            # the tag rides in the decrypted header, so the taint pass sees
            # plaintext-derived bytes here — but a message-type enum name is
            # a one-byte projection, not key material
            raise ServiceError(  # lint: taint-ok: one-byte message-type tag, not key bytes
                "phase-filter", f"{tag.name} message during {phase.value}"
            )
        # signature verification + full parse
        try:
            return Message.from_bytes(raw, verify=True, lazy_update_vect=self.wire_ingest)
        except DecodeError as e:
            raise ServiceError("parse", str(e)) from e

    async def _parse_message(self, encrypted: bytes) -> Optional[Message]:
        loop = asyncio.get_running_loop()
        keys: EncryptKeyPair = self.events.keys.get_latest().event
        phase: PhaseName = self.events.phase.get_latest().event
        message = await loop.run_in_executor(
            self._pool, self._decrypt_parse_one, encrypted, keys, phase
        )
        if message.is_multipart:
            return self._handle_chunk(message)
        return message

    async def process_batch(self, batch: list[bytes]) -> list:
        """Decrypt + verify + task-validate a whole batch in ONE thread-pool
        hop (the ingest workers' entry point).

        Returns one slot per input, aligned: a verified ``Message``, a
        ``ServiceError`` (the drop, with its stage), or ``None`` (multipart
        chunk absorbed, message still incomplete). Unlike
        ``handle_message`` nothing is forwarded to the state machine — the
        caller owns request submission and batching policy.
        """
        loop = asyncio.get_running_loop()
        keys: EncryptKeyPair = self.events.keys.get_latest().event
        phase: PhaseName = self.events.phase.get_latest().event
        params: RoundParameters = self.events.params.get_latest().event

        def run() -> list:
            out = []
            for encrypted in batch:
                try:
                    message = self._decrypt_parse_one(encrypted, keys, phase)
                    if not message.is_multipart:
                        self._validate_task_with(message, params)
                    out.append(message)
                except ServiceError as e:
                    out.append(e)
            return out

        with _PIPELINE_SECONDS.labels(stage="decrypt_parse_batch").time():
            results = await loop.run_in_executor(self._pool, run)
        final = []
        for res in results:
            if isinstance(res, ServiceError) or res is None or not res.is_multipart:
                final.append(res)
                continue
            # multipart reassembly state is loop-owned — finish on the loop
            try:
                message = self._handle_chunk(res)
                if message is not None:
                    self._validate_task_with(message, params)
                final.append(message)
            except ServiceError as e:
                final.append(e)
        return final

    def _handle_chunk(self, message: Message) -> Optional[Message]:
        """Reassembly per (participant, message_id)
        (reference: multipart/service.rs:26-117)."""
        chunk = message.payload
        assert isinstance(chunk, Chunk)
        key = (message.participant_pk, chunk.message_id)
        if key not in self._multipart and len(self._multipart) >= self.max_multipart_buffers:
            evicted = next(iter(self._multipart))
            del self._multipart[evicted]
        builder = self._multipart.setdefault(key, MessageBuilder())
        _MULTIPART_BUFFERS.set(len(self._multipart))
        if not builder.add(chunk):
            return None
        del self._multipart[key]
        _MULTIPART_BUFFERS.set(len(self._multipart))
        # streaming parse: chunk buffers are consumed as the parser reads,
        # never concatenated (reference: multipart/service.rs streaming
        # FromBytes re-parse; chunkable_iterator.rs:17-60)
        from ..core.message.payloads import parse_payload_stream

        try:
            payload = parse_payload_stream(
                message.tag, builder.take_reader(), lazy_update_vect=self.wire_ingest
            )
        except DecodeError as e:
            raise ServiceError("multipart", str(e)) from e
        return Message(
            participant_pk=message.participant_pk,
            coordinator_pk=message.coordinator_pk,
            payload=payload,
            tag=message.tag,
            is_multipart=False,
            signature=message.signature,
        )

    def _validate_task(self, message: Message) -> None:
        """Sum/update task eligibility (reference: task_validator.rs:40-88)."""
        self._validate_task_with(message, self.events.params.get_latest().event)

    @staticmethod
    def _validate_task_with(message: Message, params: RoundParameters) -> None:
        """Pure-compute validation body (thread-safe; params pre-fetched)."""
        seed = params.seed.as_bytes()
        payload = message.payload
        if isinstance(payload, (Sum, Sum2)):
            if not verify_detached(message.participant_pk, payload.sum_signature, seed + b"sum"):
                raise ServiceError("task-validator", "invalid sum task signature")
            if not is_eligible(payload.sum_signature, params.sum):
                raise ServiceError("task-validator", "not eligible for the sum task")
        elif isinstance(payload, Update):
            if not verify_detached(message.participant_pk, payload.sum_signature, seed + b"sum"):
                raise ServiceError("task-validator", "invalid sum task signature")
            if not verify_detached(
                message.participant_pk, payload.update_signature, seed + b"update"
            ):
                raise ServiceError("task-validator", "invalid update task signature")
            # an update participant must NOT be a sum participant, and must
            # be eligible for the update task
            if is_eligible(payload.sum_signature, params.sum):
                raise ServiceError("task-validator", "sum participant sent an update message")
            if not is_eligible(payload.update_signature, params.update):
                raise ServiceError("task-validator", "not eligible for the update task")
        else:
            raise ServiceError("task-validator", f"unexpected payload {type(payload)}")


class Fetcher:
    """Read access to the latest round data for the API layer."""

    def __init__(self, events: EventSubscriber):
        self.events = events

    def round_params(self) -> RoundParameters:
        return self.events.params.get_latest().event

    def phase(self) -> PhaseName:
        return self.events.phase.get_latest().event

    def sum_dict(self):
        return self.events.sum_dict.get_latest().event.dict

    def seed_dict(self):
        return self.events.seed_dict.get_latest().event.dict

    def seeds_for(self, pk: bytes):
        """The UpdateSeedDict slice for one sum participant (GET /seeds)."""
        seed_dict = self.seed_dict()
        if seed_dict is None:
            return None
        return seed_dict.get(pk)

    def model(self):
        return self.events.model.get_latest().event.model
