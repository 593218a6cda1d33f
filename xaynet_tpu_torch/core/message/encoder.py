"""Message encoding with multipart chunking and streaming reassembly.

Reference behavior (rust/xaynet-sdk/src/message_encoder/encoder.rs:14-180):
a payload larger than ``max_payload_size`` is split into signed ``Chunk``
messages (8-byte chunk header, shared random ``message_id``, ascending
chunk ids, LAST_CHUNK flag on the final part); each part is an
independently signed PET message carrying the original tag with the
MULTIPART flag set. The receiver reassembles by (participant_pk,
message_id) and re-parses the payload *incrementally* through a
``ChunkReader`` — the analogue of the reference's chunkable byte-iterator
(rust/xaynet-core/src/message/utils/chunkable_iterator.rs:17-60): chunk
buffers are consumed (and freed) as the parser advances, so a payload near
the protocol's 4 GiB message ceiling never needs a second contiguous copy.
"""

from __future__ import annotations

import os
import struct
from collections import deque
from typing import Iterator

import numpy as np

from .message import HEADER_LENGTH, Message
from .payloads import CHUNK_HEADER_LENGTH, Chunk

# minimum sensible ceiling: header + chunk header + 1 byte of progress
# (reference: rust/xaynet-sdk/src/settings/max_message_size.rs:4-80)
MIN_MESSAGE_SIZE = HEADER_LENGTH + CHUNK_HEADER_LENGTH + 1
DEFAULT_MAX_MESSAGE_SIZE = 4096


def max_payload_size(max_message_size: int) -> int:
    return max_message_size - HEADER_LENGTH


# the wire chunk id is u16 with id 0 reserved (reference chunk layout)
MAX_CHUNKS = 0xFFFF


class MessageEncoder:
    """Encodes (and signs) a message, chunking it when oversized.

    Parts are produced ON DEMAND (``part(i)``): a paused/retried multipart
    send holds one payload copy plus the index, never the full list of
    signed+sealed parts.
    """

    def __init__(
        self,
        message: Message,
        secret_signing_key: bytes,
        max_message_size: int | None = DEFAULT_MAX_MESSAGE_SIZE,
        message_id: int | None = None,  # pin when restoring an in-flight send
    ):
        self.message = message
        self.secret_signing_key = secret_signing_key
        self.max_message_size = max_message_size
        self._payload_bytes = message.payload.to_bytes()
        if (
            max_message_size is None
            or HEADER_LENGTH + len(self._payload_bytes) <= max_message_size
        ):
            self._budget = None
            self.n_parts = 1
        else:
            self._budget = max(max_message_size - HEADER_LENGTH - CHUNK_HEADER_LENGTH, 1)
            self.n_parts = -(-len(self._payload_bytes) // self._budget)
            if self.n_parts > MAX_CHUNKS:
                # the u16 chunk id cannot address more parts; wrapping would
                # corrupt reassembly silently — refuse loudly instead
                raise ValueError(
                    f"payload needs {self.n_parts} chunks but the wire chunk id "
                    f"is u16 (max {MAX_CHUNKS}); raise max_message_size "
                    f"(>= {HEADER_LENGTH + CHUNK_HEADER_LENGTH + -(-len(self._payload_bytes) // MAX_CHUNKS)})"
                )
            self.message_id = (
                message_id if message_id is not None else struct.unpack(">H", os.urandom(2))[0]
            )

    def part(self, i: int) -> bytes:
        """The ``i``-th signed wire part (0-based)."""
        if not 0 <= i < self.n_parts:
            raise IndexError(i)
        if self._budget is None:
            return self.message.to_bytes(self.secret_signing_key)
        chunk = Chunk(
            id=i + 1,
            message_id=self.message_id,
            last=(i == self.n_parts - 1),
            data=self._payload_bytes[i * self._budget : (i + 1) * self._budget],
            tag=self.message.tag,
        )
        part = Message(
            participant_pk=self.message.participant_pk,
            coordinator_pk=self.message.coordinator_pk,
            payload=chunk,
            tag=self.message.tag,
            is_multipart=True,
        )
        return part.to_bytes(self.secret_signing_key)

    def __iter__(self) -> Iterator[bytes]:
        for i in range(self.n_parts):
            yield self.part(i)


class ChunkReader:
    """Sequential reader over an ordered sequence of chunk buffers.

    The streaming-parse analogue of the reference's ``ChunkableIterator``
    (rust/xaynet-core/src/message/utils/chunkable_iterator.rs:17-60): small
    header reads may join a few bytes across a chunk boundary, but bulk
    element blocks are copied chunk-by-chunk straight into their destination
    array (``read_into``), and consumed chunks are dropped immediately — the
    payload is never materialized contiguously a second time.
    """

    def __init__(self, chunks: list[bytes]):
        self._chunks: deque[bytes] = deque(chunks)
        self._pos = 0  # read offset within the head chunk
        self.remaining = sum(len(c) for c in chunks)

    def _advance(self, take: int) -> None:
        self._pos += take
        self.remaining -= take
        if self._pos >= len(self._chunks[0]):
            self._chunks.popleft()  # frees the consumed chunk buffer
            self._pos = 0

    def read(self, n: int) -> bytes:
        """``n`` bytes as a (small) contiguous value — for headers/dicts."""
        if n > self.remaining:
            raise ValueError(f"chunk stream truncated: need {n}, have {self.remaining}")
        parts = []
        while n > 0:
            head = self._chunks[0]
            take = min(n, len(head) - self._pos)
            parts.append(head[self._pos : self._pos + take])
            self._advance(take)
            n -= take
        return parts[0] if len(parts) == 1 else b"".join(parts)

    def read_into(self, out: np.ndarray) -> None:
        """Fill a preallocated ``uint8[n]`` array — for bulk element blocks."""
        n = out.size
        if n > self.remaining:
            raise ValueError(f"chunk stream truncated: need {n}, have {self.remaining}")
        off = 0
        while off < n:
            head = self._chunks[0]
            take = min(n - off, len(head) - self._pos)
            out[off : off + take] = np.frombuffer(head, np.uint8, take, self._pos)
            self._advance(take)
            off += take


class MessageBuilder:
    """Server-side reassembly of one multipart message's chunks.

    Chunks may arrive out of order; they are keyed by chunk id and the
    message completes when the LAST_CHUNK id is known and all lower ids are
    present (reference: xaynet-server multipart/buffer.rs:8-60).
    """

    def __init__(self):
        self._chunks: dict[int, bytes] = {}
        self._last_id: int | None = None

    def add(self, chunk: Chunk) -> bool:
        """Adds a chunk; returns True when the message is complete."""
        self._chunks[chunk.id] = chunk.data
        if chunk.last:
            self._last_id = chunk.id
        return self.is_complete()

    def is_complete(self) -> bool:
        if self._last_id is None:
            return False
        return all(i in self._chunks for i in range(1, self._last_id + 1))

    def take_reader(self) -> ChunkReader:
        """Hand the buffered chunks off to a streaming reader.

        The builder's own references are dropped so each chunk's memory is
        owned solely by the reader and freed as parsing consumes it.
        """
        if not self.is_complete():
            raise ValueError("message is not complete")
        assert self._last_id is not None
        chunks = [self._chunks.pop(i) for i in range(1, self._last_id + 1)]
        return ChunkReader(chunks)

    def payload_bytes(self) -> bytes:
        if not self.is_complete():
            raise ValueError("message is not complete")
        assert self._last_id is not None
        return b"".join(self._chunks[i] for i in range(1, self._last_id + 1))
