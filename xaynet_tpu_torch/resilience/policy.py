"""Retry policy: capped exponential backoff with decorrelated jitter.

Transient infrastructure faults (a dropped Redis connection, an S3 5xx, a
filesystem hiccup) should be retried *in place* instead of failing the
phase and throwing away an entire round of accepted updates. The policy
here is the AWS "decorrelated jitter" variant: each delay is drawn
uniformly from ``[base, prev_delay * 3]``, clamped to ``[base, cap]`` —
retries spread out quickly without synchronizing across callers, and the
schedule is fully deterministic under a seeded RNG (chaos tests replay it).

Classification lives here too: :func:`is_transient` decides whether a
raised error is worth retrying. Storage backends can mark errors
explicitly (``TransientStorageError`` / an ``exc.transient`` attribute);
everything else falls back to a conservative type + message heuristic.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

from ..storage.traits import StorageError
from ..telemetry.registry import get_registry

_registry = get_registry()
RETRIES = _registry.counter(
    "xaynet_resilience_retries_total",
    "Retried operations after a transient failure, by site.",
    ("site",),
)
GIVEUPS = _registry.counter(
    "xaynet_resilience_giveups_total",
    "Operations abandoned after exhausting the retry policy, by site.",
    ("site",),
)
RETRY_BACKOFF_SECONDS = _registry.counter(
    "xaynet_resilience_backoff_seconds_total",
    "Total seconds spent sleeping between retries, by site.",
    ("site",),
)

# message fragments that mark an unclassified error as worth retrying
_TRANSIENT_HINTS = (
    "connection",
    "timeout",
    "timed out",
    "temporarily",
    "unavailable",
    "unreachable",
    "reset",
    "broken pipe",
    "try again",
    "injected transient",
)


def is_transient(exc: BaseException) -> bool:
    """Is this raised error worth retrying in place?

    Explicit markers win: an ``exc.transient`` attribute (set by
    ``TransientStorageError`` and fault injection) is authoritative in both
    directions. Otherwise connection-ish builtin types are transient, and a
    ``StorageError`` is sniffed by message — better to retry a permanent
    error a few times than to throw away a round on a blip.
    """
    marker = getattr(exc, "transient", None)
    if marker is not None:
        return bool(marker)
    if isinstance(exc, (ConnectionError, TimeoutError, asyncio.TimeoutError)):
        return True
    if isinstance(exc, OSError):
        return True
    if isinstance(exc, StorageError):
        text = str(exc).lower()
        return any(hint in text for hint in _TRANSIENT_HINTS)
    return False


@dataclass
class RetryPolicy:
    """Decorrelated-jitter exponential backoff with attempt/deadline caps.

    ``max_attempts`` counts *calls* (1 = no retry at all). ``deadline_s``
    bounds the total time spent inside :meth:`call_async` including sleeps;
    when the next sleep would cross the deadline the policy gives up early.
    A seeded ``rng`` makes the schedule reproducible.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.025
    max_delay_s: float = 2.0
    deadline_s: float = 30.0
    rng: random.Random = field(default_factory=random.Random)

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay_s <= 0 or self.max_delay_s < self.base_delay_s:
            raise ValueError("need 0 < base_delay_s <= max_delay_s")
        if self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")

    def delays(self) -> Iterator[float]:
        """The backoff schedule: one delay per retry (attempts - 1 total)."""
        prev = self.base_delay_s
        for _ in range(self.max_attempts - 1):
            prev = min(self.max_delay_s, self.rng.uniform(self.base_delay_s, prev * 3))
            yield prev

    async def call_async(
        self,
        fn: Callable,
        *args,
        site: str = "unnamed",
        classify: Callable[[BaseException], bool] = is_transient,
        no_retry: tuple = (),
        delay_floor: Optional[Callable[[BaseException], Optional[float]]] = None,
        **kwargs,
    ):
        """Run ``fn(*args, **kwargs)``, retrying transient failures.

        Non-transient errors (and ``no_retry`` types) propagate untouched on
        the first failure. When the policy is exhausted the LAST transient
        error propagates (not a wrapper): callers keep their existing
        except clauses, and the giveup is recorded on the metrics instead.
        ``delay_floor(err)`` may return a minimum for the next sleep — the
        SDK client feeds a server-sent ``Retry-After`` through it so a
        shedding coordinator is never hammered faster than it asked.
        """
        t0 = time.monotonic()
        attempts = 0
        schedule = self.delays()
        while True:
            attempts += 1
            try:
                return await fn(*args, **kwargs)
            except no_retry:
                raise
            except asyncio.CancelledError:
                # cancellation is a control signal, never a fault to retry
                # (no classify hook can override this)
                raise
            except BaseException as err:
                if not classify(err):
                    raise
                delay = next(schedule, None)
                if delay is not None and delay_floor is not None:
                    floor = delay_floor(err)
                    if floor:
                        delay = max(delay, float(floor))
                elapsed = time.monotonic() - t0
                if delay is None or elapsed + delay > self.deadline_s:
                    GIVEUPS.labels(site=site).inc()
                    raise
                RETRIES.labels(site=site).inc()
                RETRY_BACKOFF_SECONDS.labels(site=site).inc(delay)
                await asyncio.sleep(delay)


def policy_from_settings(resilience, rng: Optional[random.Random] = None) -> RetryPolicy:
    """Build the storage-call policy from a ``ResilienceSettings`` section."""
    return RetryPolicy(
        max_attempts=resilience.retry_max_attempts,
        base_delay_s=resilience.retry_base_ms / 1000.0,
        max_delay_s=resilience.retry_max_ms / 1000.0,
        deadline_s=resilience.retry_deadline_s,
        rng=rng if rng is not None else random.Random(),
    )
