"""Failure phase: error capture, store readiness, and round recovery.

Reference behavior
(rust/xaynet-server/src/state_machine/phases/failure.rs:30-106): a broken
request channel shuts the coordinator down; any other phase error waits for
storage readiness and restarts the round at Idle.

Resilience extensions (docs/DESIGN.md §9):

- the readiness wait uses the capped-exponential + jitter backoff policy
  instead of a fixed 1 s sleep, and the time spent waiting is metered
  (``xaynet_store_unready_seconds_total``) instead of log-only;
- when a valid mid-round checkpoint exists for the CURRENT round, the
  phase prefers **round resume** (re-entering Update with the aggregate
  restored) over a round restart — bounded by
  ``resilience.max_resume_attempts`` per round so a deterministically
  failing resume cannot loop forever.
"""

from __future__ import annotations

import asyncio
import logging

from ...resilience import checkpoint as ckpt_mod
from ...resilience.policy import RetryPolicy
from ...telemetry.registry import get_registry
from ..events import PhaseName
from ..requests import ChannelClosed
from .base import PhaseState

logger = logging.getLogger("xaynet.coordinator")

STORE_UNREADY_SECONDS = get_registry().counter(
    "xaynet_store_unready_seconds_total",
    "Seconds the Failure phase spent waiting for storage readiness.",
)
STORE_READY_CHECKS = get_registry().counter(
    "xaynet_store_ready_checks_total",
    "Failure-phase storage readiness probes, by outcome.",
    ("outcome",),
)


class Failure(PhaseState):
    NAME = PhaseName.FAILURE

    def __init__(self, shared, error: Exception, failed_phase: PhaseName | None = None):
        super().__init__(shared)
        self.error = error
        self.failed_phase = failed_phase

    async def process(self) -> None:
        logger.warning("round %d failed: %s", self.shared.round_id, self.error)
        if self.shared.metrics is not None:
            self.shared.metrics.event(self.shared.round_id, "phase_error", str(self.error))

    async def run_phase(self):
        self._announce()
        await self.process()
        if isinstance(self.error, ChannelClosed):
            from .shutdown import Shutdown

            return Shutdown(self.shared)
        await self._wait_for_store_readiness()
        resumed = await self._try_resume()
        if resumed is not None:
            return resumed
        if self.shared.round_ctl is not None:
            # only a true round RESTART feeds the controller's shrink
            # streak — a checkpoint resume keeps the round alive, and its
            # eventual completion/failure is what gets counted
            self.shared.round_ctl.round_failed()
        # tenant lifecycle (docs/DESIGN.md §23): a failed round is both a
        # breaker strike for quarantine AND a round boundary for a pending
        # drain — a resume above is neither (the round is still alive)
        from ...tenancy import lifecycle as _lifecycle

        _lifecycle.note_round_failed(self.shared.tenant)
        from .idle import Idle

        return Idle(self.shared)

    async def _wait_for_store_readiness(self) -> None:
        """Block until the store answers, backing off with jitter.

        Readiness has no give-up — the coordinator is useless without its
        store — so once the policy's ramp-up schedule is exhausted the
        probe cadence SETTLES at the cap (it must not saw-tooth back to
        the base delay and hammer a dead backend forever).
        """
        res = self.shared.settings.resilience
        policy = RetryPolicy(
            max_attempts=max(res.retry_max_attempts, 2),
            base_delay_s=max(res.retry_base_ms / 1000.0, 0.05),
            max_delay_s=max(res.retry_max_ms / 1000.0, 1.0),
            deadline_s=res.retry_deadline_s,
        )

        def delays():
            yield from policy.delays()
            while True:
                yield policy.max_delay_s

        for delay in delays():
            try:
                await self.shared.store.is_ready()
                STORE_READY_CHECKS.labels(outcome="ready").inc()
                return
            except Exception as err:
                STORE_READY_CHECKS.labels(outcome="unready").inc()
                STORE_UNREADY_SECONDS.inc(delay)
                logger.warning(
                    "store not ready: %s; retrying in %.2fs", err, delay
                )
                await asyncio.sleep(delay)

    async def _try_resume(self):
        """Re-enter the journaled phase instead of restarting the round.

        Returns the resumed phase or None. Every code path is fail-soft: a
        broken journal read/validation degrades to the Idle restart the
        pre-resilience coordinator always did.
        """
        res = self.shared.settings.resilience
        if not res.checkpoint_enabled:
            return None
        failed = self.failed_phase.value if self.failed_phase is not None else "unknown"
        attempts = self.shared.resume_attempts  # lint: tenant-ok: budget lives on this tenant's own Shared
        if attempts >= res.max_resume_attempts:
            logger.warning(
                "round %d: resume budget exhausted (%d); restarting round",
                self.shared.round_id,
                attempts,
            )
            ckpt_mod.RESUMES.labels(outcome="budget_exhausted").inc()
            ckpt_mod.RESUME_TOTAL.labels(phase=failed, outcome="budget_exhausted").inc()
            return None
        ckpt = await ckpt_mod.load(self.shared.store)
        if ckpt is None:
            return None
        if self.failed_phase is not None and self.failed_phase.value != ckpt.phase:
            # a journal entry for another phase cannot help THIS failure:
            # participants of the failed phase would never resend into a
            # re-entered earlier phase, so the resume just times out (e.g.
            # sum2 failed before its base entry landed, journal still says
            # "update") — restart the round instead of burning budget
            logger.warning(
                "round %d: journal phase %r != failed phase %r; restarting round",
                self.shared.round_id,
                ckpt.phase,
                failed,
            )
            ckpt_mod.RESUMES.labels(outcome="invalid").inc()
            ckpt_mod.RESUME_TOTAL.labels(phase=ckpt.phase, outcome="invalid").inc()
            return None
        try:
            reason = await ckpt_mod.validate(ckpt, self.shared.state, self.shared.store)
        except Exception as err:
            reason = f"validation failed: {err}"
        if reason is not None:
            logger.warning(  # lint: taint-ok: validation reason carries counts/names only, never key bytes
                "round %d: journal entry not resumable (%s); restarting round",
                self.shared.round_id,
                reason,
            )
            ckpt_mod.RESUMES.labels(outcome="invalid").inc()
            ckpt_mod.RESUME_TOTAL.labels(phase=ckpt.phase, outcome="invalid").inc()
            return None
        self.shared.resume_attempts = attempts + 1  # lint: tenant-ok: budget lives on this tenant's own Shared
        ckpt_mod.RESUMES.labels(outcome="resumed").inc()
        ckpt_mod.RESUME_TOTAL.labels(phase=ckpt.phase, outcome="resumed").inc()
        logger.info(
            "round %d: resuming %s phase from journal (%d models, attempt %d/%d)",
            self.shared.round_id,
            ckpt.phase,
            ckpt.nb_models,
            attempts + 1,
            res.max_resume_attempts,
        )
        from .resume import resume_phase

        return resume_phase(self.shared, ckpt)
