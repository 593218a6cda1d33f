"""Bounded sharded intake queues with batched draining.

The port's copy of ``xaynet_tpu/ingest/intake.py``.

Each shard is a hard-bounded ``asyncio.Queue`` drained by its own decrypt
worker; arrivals spread round-robin so no single queue serializes the
fan-in. ``get_batch`` implements the linger discipline: take what is
immediately available, wait at most ``linger_s`` for the batch to fill,
never return empty — the worker amortizes one thread-pool hop over the
whole batch.
"""

from __future__ import annotations

import asyncio
import itertools

from ..telemetry.registry import get_registry

_OCCUPANCY = get_registry().histogram(
    "xaynet_ingest_shard_occupancy",
    "Shard queue depth observed at each enqueue (per shard).",
    ("shard",),
    buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096),
)
_OCCUPANCY_NOW = get_registry().gauge(
    "xaynet_ingest_occupancy",
    "Messages currently queued across all intake shards.",
)


class ShardFull(Exception):
    """The shard's hard bound rejected the put."""


class IntakeShard:
    """One bounded intake queue.

    ``max_occupancy`` records the high-water mark ever observed — the
    integration tests assert it never exceeds the configured bound.
    """

    def __init__(self, index: int, bound: int):
        if bound < 1:
            raise ValueError("shard bound must be >= 1")
        self.index = index
        self.bound = bound
        self._queue: asyncio.Queue[bytes] = asyncio.Queue(maxsize=bound)
        self.max_occupancy = 0  # guarded-by: event-loop
        self._hist = _OCCUPANCY.labels(shard=str(index))

    @property
    def occupancy(self) -> int:
        return self._queue.qsize()

    def put_nowait(self, item: bytes) -> None:
        try:
            self._queue.put_nowait(item)
        except asyncio.QueueFull:
            raise ShardFull(f"shard {self.index} at bound {self.bound}") from None
        depth = self._queue.qsize()
        self.max_occupancy = max(self.max_occupancy, depth)
        self._hist.observe(depth)

    async def get_batch(self, max_batch: int, linger_s: float) -> list[bytes]:
        """At least one item; up to ``max_batch``, lingering ``linger_s``."""
        batch = [await self._queue.get()]
        loop = asyncio.get_running_loop()
        deadline = loop.time() + linger_s
        while len(batch) < max_batch:
            try:
                batch.append(self._queue.get_nowait())
                continue
            except asyncio.QueueEmpty:
                pass
            remaining = deadline - loop.time()
            if remaining <= 0:
                break
            try:
                batch.append(await asyncio.wait_for(self._queue.get(), remaining))
            except asyncio.TimeoutError:
                break
        return batch


class ShardedIntake:
    """Round-robin fan-out over ``n`` bounded shards."""

    def __init__(self, shards: int, bound_per_shard: int):
        if shards < 1:
            raise ValueError("need at least one shard")
        self.shards = [IntakeShard(i, bound_per_shard) for i in range(shards)]
        self.capacity = shards * bound_per_shard
        self._rr = itertools.cycle(range(shards))  # guarded-by: event-loop

    @property
    def occupancy(self) -> int:
        return sum(s.occupancy for s in self.shards)

    @property
    def max_occupancy(self) -> int:
        return max(s.max_occupancy for s in self.shards)

    def put_nowait(self, item: bytes) -> None:
        """Enqueue on the next shard with room (starting round-robin).

        Raises ``ShardFull`` only when EVERY shard is at its bound.
        """
        start = next(self._rr)
        n = len(self.shards)
        for off in range(n):
            shard = self.shards[(start + off) % n]
            try:
                shard.put_nowait(item)
                _OCCUPANCY_NOW.set(self.occupancy)
                return
            except ShardFull:
                continue
        raise ShardFull("all intake shards at bound")

    def drained(self) -> None:
        """Refresh the occupancy gauge after a worker drained a batch."""
        _OCCUPANCY_NOW.set(self.occupancy)
