"""The event-driven replay driver: forged uploads over real REST.

Port of ``xaynet_tpu/loadgen/driver.py`` (the same code, on the port's
``sdk.client.HttpClient``); ``post_s`` adds each accepted upload's POST
seconds, the per-POST distribution a replay reports.

One driver process owns one population shard and replays it against the
coordinator's actual HTTP boundary — real sockets, real admission control,
real 429s — pacing sends by the schedule's event feed under a concurrency
gate. Multi-tenant spread assigns participants round-robin across the
``/t/<tenant>/`` routes; pointing ``targets`` at edge-runner URLs instead
of the coordinator exercises the two-tier fan-in (the edge API is
coordinator-shaped, ``edge.rest``). Shed uploads retry with the server's
Retry-After (bounded), which is what a real SDK's resilient client does.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

from ..sdk.client import ClientError, ClientShedError, HttpClient


@dataclass
class DriverStats:
    """Outcome counts of one replay (per driver process)."""

    sent: int = 0
    accepted: int = 0  # 200 — taken at the REST boundary
    shed: int = 0  # 429 verdicts observed (retries may still land)
    shed_without_retry_after: int = 0  # of those, 429s that carried no Retry-After
    abandoned: int = 0  # gave up after max_shed_retries
    errors: int = 0  # transport/protocol failures
    wall_s: float = 0.0
    by_target: dict = field(default_factory=dict)
    post_s: list = field(default_factory=list)  # seconds of each accepted POST

    def merge(self, other: "DriverStats") -> "DriverStats":
        self.sent += other.sent
        self.accepted += other.accepted
        self.shed += other.shed
        self.shed_without_retry_after += other.shed_without_retry_after
        self.abandoned += other.abandoned
        self.errors += other.errors
        self.wall_s = max(self.wall_s, other.wall_s)
        for k, v in other.by_target.items():
            self.by_target[k] = self.by_target.get(k, 0) + v
        self.post_s.extend(other.post_s)
        return self

    def to_dict(self) -> dict:
        return {
            "sent": self.sent,
            "accepted": self.accepted,
            "shed": self.shed,
            "shed_without_retry_after": self.shed_without_retry_after,
            "abandoned": self.abandoned,
            "errors": self.errors,
            "wall_s": round(self.wall_s, 3),
            "accepted_per_s": round(self.accepted / self.wall_s, 2)
            if self.wall_s > 0
            else 0.0,
            "by_target": dict(self.by_target),
            "post_s": list(self.post_s),
        }


class ReplayDriver:
    """Replays one shard's sealed messages against one or more targets."""

    def __init__(
        self,
        targets: list[str] | str,
        *,
        concurrency: int = 64,
        timeout: float = 30.0,
        max_shed_retries: int = 3,
    ):
        if isinstance(targets, str):
            targets = [targets]
        if not targets:
            raise ValueError("need at least one target URL")
        # one pooled client per target: tenant routes ("host:port/t/a") and
        # edge endpoints are both just base URLs to the driver
        self._clients = [(url, HttpClient(url, timeout=timeout)) for url in targets]
        self.concurrency = max(1, concurrency)
        self.max_shed_retries = max(0, max_shed_retries)

    def close(self) -> None:
        for _, client in self._clients:
            client.close()

    async def replay(self, messages: list, schedule=None) -> DriverStats:
        """Send every message at its scheduled offset; returns the stats.

        ``schedule`` is a ``ReplaySchedule`` (or anything with
        ``events()``); ``None`` sends everything immediately (pure
        throughput shape). Participant ``i`` goes to target ``i % len``.
        """
        events = (
            schedule.events()
            if schedule is not None
            else [(0.0, i) for i in range(len(messages))]
        )
        stats = DriverStats()
        gate = asyncio.Semaphore(self.concurrency)
        start = time.monotonic()

        async def one(offset: float, index: int) -> None:
            delay = offset - (time.monotonic() - start)
            if delay > 0:
                # outside the gate: a paced sender must not hold a slot
                # while it waits for its own arrival time
                await asyncio.sleep(delay)
            url, client = self._clients[index % len(self._clients)]
            async with gate:
                stats.sent += 1
                for attempt in range(self.max_shed_retries + 1):
                    try:
                        t = time.monotonic()
                        await client.send_message(messages[index])
                        stats.post_s.append(time.monotonic() - t)
                        stats.accepted += 1
                        stats.by_target[url] = stats.by_target.get(url, 0) + 1
                        return
                    except ClientShedError as err:
                        stats.shed += 1
                        if err.retry_after is None:
                            stats.shed_without_retry_after += 1
                        if attempt >= self.max_shed_retries:
                            stats.abandoned += 1
                            return
                        await asyncio.sleep(min(2.0, err.retry_after or 0.1))
                    except (ClientError, OSError, asyncio.TimeoutError):
                        stats.errors += 1
                        return

        await asyncio.gather(*(one(offset, i) for offset, i in events))
        stats.wall_s = time.monotonic() - start
        return stats
