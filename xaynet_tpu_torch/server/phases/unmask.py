"""Unmask phase: elect the winning mask and reveal the new global model.

Reference behavior
(rust/xaynet-server/src/state_machine/phases/unmask.rs:56-219): fetch the
two best-scored masks; the winner must be the *unique* maximum (equal top
scores are ambiguous -> round failure); validate and unmask the aggregate;
persist the global model under ``{round_id}_{hex(seed)}`` with the latest-id
pointer; publish proof to the trust anchor; broadcast the new model.

The aggregate arrives as a ``DeviceAggregation`` view
(``aggregation.finalize_inplace``):
the subtract runs on the device against the accumulator where it lies,
and only the unmasked result crosses to the host. The fixed-point decode
uses the double-double fast path for f32 configs (core/mask/encode.py).
"""

from __future__ import annotations

import asyncio
import logging

import numpy as np

from ...core.mask.masking import UnmaskingError
from ...core.mask.object import MaskObject
from ...resilience.chaos import maybe_kill
from ...telemetry import profiling
from ...telemetry.registry import get_registry
from ..aggregation import DeviceAggregation
from ..events import ModelUpdate, PhaseName
from .base import PhaseError, PhaseState

logger = logging.getLogger("xaynet.coordinator")

POINTER_UPDATE_FAILURES = get_registry().counter(
    "xaynet_model_pointer_update_failures_total",
    "latest_global_model_id pointer updates abandoned after retries "
    "(the model blob IS stored; only the latest-pointer is stale).",
)


class Unmask(PhaseState):
    NAME = PhaseName.UNMASK

    def __init__(self, shared, model_agg: DeviceAggregation):
        super().__init__(shared)
        self.model_agg = model_agg
        self.global_model: np.ndarray | None = None

    async def process(self) -> None:
        if self.shared.metrics is not None:
            n_masks = await self.shared.store.coordinator.number_of_unique_masks()
            self.shared.metrics.masks_total(self.shared.round_id, n_masks)
        best = await self.shared.store.coordinator.best_masks()
        if best is None:
            raise PhaseError("NoMask", "no masks submitted")
        mask = self._freeze_mask_dict(best)
        try:
            self.model_agg.validate_unmasking(mask)
        except UnmaskingError as err:
            raise PhaseError("Unmasking", err.kind) from err
        # the device view's subtract waits on its CUDA device before the
        # timing closes
        self.global_model = profiling.timed_kernel(
            "unmask",
            len(self.model_agg),
            lambda: self.model_agg.unmask_array(mask),
            device=self.model_agg.torch_device,
        )
        await self._save_global_model()
        # chaos hook (kill-matrix harness): the publish window — the model
        # is persisted but the journal not yet retired; a restart must
        # republish idempotently (ModelStorage contract), never corrupt
        maybe_kill("unmask:publish")
        await self._publish_proof()
        # round-end page release (docs/DESIGN.md §19): the accumulator's
        # pool pages go back the moment the unmasked model is decoded and
        # persisted — this is the clean half of the leases == releases
        # round invariant (Idle's reclaim is the crash-path backstop)
        release = getattr(self.model_agg, "release_pool", None)
        if release is not None:
            release()
        if self.shared.settings.resilience.checkpoint_enabled:
            # retire the round journal: the model is published and the
            # pool pages are back — nothing left for a resume to redo
            # (Idle's delete is the backstop for disabled-journal configs)
            await self.shared.store.coordinator.delete_round_checkpoint()

    def broadcast(self) -> None:
        assert self.global_model is not None
        self.shared.events.broadcast_model(ModelUpdate.new(self.global_model))

    async def next(self):
        if self.shared.round_ctl is not None:
            # the round is complete: feed the controller's hysteresis (full
            # vs degraded is derived from the per-phase window outcomes)
            self.shared.round_ctl.round_completed()
        # tenant lifecycle (docs/DESIGN.md §23): a completed round is the
        # breaker's probe success (quarantine lift) and a drain boundary
        from ...tenancy import lifecycle as _lifecycle

        _lifecycle.note_round_completed(self.shared.tenant)
        from .idle import Idle

        return Idle(self.shared)

    # --- internals --------------------------------------------------------

    @staticmethod
    def _freeze_mask_dict(best: list[tuple[MaskObject, int]]) -> MaskObject:
        """Unique-maximum election (unmask.rs:96-115)."""
        winner, winner_count = None, 0
        for mask, count in best:
            if count > winner_count:
                winner, winner_count = mask, count
            elif count == winner_count:
                winner = None
        if winner is None:
            raise PhaseError("AmbiguousMasks", "top masks share the same score")
        return winner

    async def _save_global_model(self) -> None:
        assert self.global_model is not None
        data = np.asarray(self.global_model, dtype=np.float64).tobytes()
        model_id = await self.shared.store.models.set_global_model(
            self.shared.state.round_id,
            self.shared.state.round_params.seed.as_bytes(),
            data,
        )
        # best-effort per the reference (unmask.rs:191-198) — the retry
        # itself lives in the ResilientStore layer every storage call flows
        # through (stacking a second schedule here would retry up to
        # attempts² times against a backend the breaker already declared
        # dead). What this phase adds is the COUNT: a permanently broken
        # pointer must be visible on /metrics, not buried in a warning log.
        # The phase still completes either way (clients fall back to
        # fetching the model by explicit id).
        try:
            await self.shared.store.coordinator.set_latest_global_model_id(model_id)
        except asyncio.CancelledError:
            raise
        except Exception as err:
            POINTER_UPDATE_FAILURES.inc()
            logger.warning("failed to update latest global model id: %s", err)

    async def _publish_proof(self) -> None:
        if self.shared.store.trust_anchor is None:
            return
        assert self.global_model is not None
        data = np.asarray(self.global_model, dtype=np.float64).tobytes()
        await self.shared.store.trust_anchor.publish_proof(data)
