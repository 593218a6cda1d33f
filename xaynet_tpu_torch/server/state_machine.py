"""The coordinator state machine and its initializer.

Reference surface: rust/xaynet-server/src/state_machine/mod.rs:124-180 (the
phase loop) and initializer.rs:97-281 (fresh start vs. restore-from-store
with model-length validation).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from ..device import resolve_device
from ..resilience import checkpoint as ckpt_mod
from ..storage.traits import Store
from ..telemetry.bridge import BridgedMetrics
from .coordinator import CoordinatorState
from .events import EventPublisher, EventSubscriber, ModelUpdate, PhaseName
from .phases import Idle, PhaseState, Shared
from .requests import RequestReceiver, RequestSender
from .settings import Settings

logger = logging.getLogger("xaynet.coordinator")


class StateMachine:
    """Runs phases until shutdown; single writer of all round state."""

    def __init__(self, initial: PhaseState):
        self._phase: Optional[PhaseState] = initial

    @property
    def phase(self) -> Optional[PhaseState]:
        return self._phase

    async def next(self) -> bool:
        """Runs one phase; returns False when the machine has shut down."""
        if self._phase is None:
            return False
        self._phase = await self._phase.run_phase()
        return self._phase is not None

    async def run(self) -> None:
        while await self.next():
            pass
        logger.info("state machine terminated")


class RestoreError(RuntimeError):
    """Coordinator restore failed (dangling model id, length mismatch, ...)."""


class StateMachineInitializer:
    """Builds (StateMachine, RequestSender, EventSubscriber) from settings."""

    def __init__(self, settings: Settings, store: Store, metrics=None,
                 tenant: str = "default", device=None):
        settings.validate()
        self.settings = settings
        self.store = store
        # the torch device of the round's aggregator: CUDA unless ``device``
        # says otherwise (raising without one), whatever [aggregation]
        # device says
        self.device = resolve_device(device)
        # the tenant id this machine's round state belongs to: threads into
        # Shared (pool leases, scheduler slots, span/flight labels) and the
        # per-tenant round counters (docs/DESIGN.md §19)
        self.tenant = tenant
        # phase histograms and message counters must reach GET /metrics even
        # when no external sink is configured: default to a registry-only
        # bridge (callers may still inject any recorder, e.g. test spies)
        self.metrics = metrics if metrics is not None else BridgedMetrics()

    async def init(self) -> tuple[StateMachine, RequestSender, EventSubscriber]:
        """Fresh start (or restore when enabled and state exists)."""
        if self.settings.restore.enable:
            restored = await self._try_restore()
            if restored is not None:
                return restored
            logger.info("no coordinator state found; starting fresh")
        else:
            logger.info("restore disabled; deleting coordinator data")
            await self.store.coordinator.delete_coordinator_data()
        state = CoordinatorState.from_settings(self.settings)
        return self._assemble(state, ModelUpdate.invalidate())

    async def _try_restore(self):
        raw = await self.store.coordinator.coordinator_state()
        if raw is None:
            return None
        state = CoordinatorState.from_bytes(raw)
        logger.info("restored coordinator state at round %d", state.round_id)
        # restore the latest global model, validating its length
        # (reference: initializer.rs:199-271)
        model_update = ModelUpdate.invalidate()
        model_id = await self.store.coordinator.latest_global_model_id()
        if model_id is not None:
            blob = await self.store.models.global_model(model_id)
            if blob is None:
                raise RestoreError(
                    f"latest global model id {model_id} points to no stored model"
                )
            model = np.frombuffer(blob, dtype=np.float64)
            if model.shape[0] != state.round_params.model_length:
                raise RestoreError(
                    f"restored model length {model.shape[0]} != configured "
                    f"{state.round_params.model_length}"
                )
            model_update = ModelUpdate.new(model)
        resume = await self._try_resume_round(state)
        return self._assemble(state, model_update, initial_factory=resume)

    async def _try_resume_round(self, state: CoordinatorState):
        """Resume path for a coordinator killed MID-ROUND: when a valid
        journal entry exists for the restored round, the machine starts in
        the journaled phase (sum, update, sum2 or unmask) with the round
        state restored instead of at Idle — previously accepted messages
        survive the restart (docs/DESIGN.md §9). ``reseed=True``: the
        process died, so the store's round dictionaries are replayed from
        the journal (idempotent on durable backends) and
        accepted-but-unjournaled orphans pruned so their un-acked clients
        can retry. Returns a phase factory or None."""
        if not self.settings.resilience.checkpoint_enabled:
            return None
        ckpt = await ckpt_mod.load(self.store)
        if ckpt is None:
            return None
        try:
            reason = await ckpt_mod.validate(ckpt, state, self.store, reseed=True)
        except Exception as err:
            reason = f"validation failed: {err}"
        if reason is not None:
            logger.warning(  # lint: taint-ok: reason carries counts/names only, never key bytes
                "round journal not resumable (%s); starting at Idle", reason
            )
            ckpt_mod.RESUMES.labels(outcome="invalid").inc()
            ckpt_mod.RESUME_TOTAL.labels(phase=ckpt.phase, outcome="invalid").inc()
            return None
        ckpt_mod.RESUMES.labels(outcome="resumed").inc()
        ckpt_mod.RESUME_TOTAL.labels(phase=ckpt.phase, outcome="resumed").inc()
        logger.info(
            "resuming round %d %s phase from journal (%d models restored)",
            state.round_id,
            ckpt.phase,
            ckpt.nb_models,
        )

        def factory(shared: Shared) -> PhaseState:
            from .phases.resume import resume_phase

            shared.resume_attempts += 1  # lint: tenant-ok: budget lives on this tenant's own Shared
            return resume_phase(shared, ckpt)

        return factory

    def _assemble(
        self,
        state: CoordinatorState,
        model_update: ModelUpdate,
        initial_factory=None,
    ):
        events = EventPublisher(
            round_id=state.round_id,
            keys=state.keys,
            params=state.round_params,
            phase=PhaseName.IDLE,
            model=model_update,
        )
        request_rx = RequestReceiver(tenant=self.tenant)
        round_ctl = None
        if self.settings.liveness.adaptive:
            from .round_controller import RoundController

            round_ctl = RoundController(self.settings)
        shared = Shared(
            state=state,
            request_rx=request_rx,
            events=events,
            store=self.store,
            settings=self.settings,
            metrics=self.metrics,
            round_ctl=round_ctl,
            tenant=self.tenant,
            device=self.device,
        )
        initial = initial_factory(shared) if initial_factory is not None else Idle(shared)
        machine = StateMachine(initial)
        return machine, request_rx.sender(), events.subscribe()
