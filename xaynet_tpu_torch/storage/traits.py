"""Storage interfaces for the coordinator.

Functional port of the reference's storage traits (reference:
rust/xaynet-server/src/storage/traits.rs:31-311): ``CoordinatorStorage``
(round dictionaries, mask scores, state), ``ModelStorage`` (global models),
``TrustAnchor`` (proof publication), and the typed *protocol* errors that
drive client-visible behavior (distinct from infrastructure errors, which
surface as exceptions).

All methods are async: backends range from the in-process dict store used
in single-process deployments and tests to external services.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from enum import Enum
from typing import Optional

from ..core.common import LocalSeedDict, SeedDict, SumDict
from ..core.mask.object import MaskObject


class StorageError(RuntimeError):
    """Infrastructure failure (connection lost, serialization bug, ...).

    ``transient`` drives the resilience layer's retry decision: ``True``
    means retry in place, ``False`` means fail immediately, ``None`` (the
    default) defers to ``resilience.policy.is_transient``'s heuristics.
    """

    transient: Optional[bool] = None


class TransientStorageError(StorageError):
    """A storage failure the backend knows is retryable (connection drop,
    timeout, throttling) — the resilience layer retries these in place.

    CONTRACT: transient means the operation was guaranteed NOT executed
    (or the operation is idempotent). A failure where the command may have
    executed server-side (reply lost mid-command) must be marked
    ``transient = False`` — replaying a conditional insert whose first
    attempt landed surfaces its dedup verdict and desyncs the seed
    dictionary from the model aggregate."""

    transient = True


class SumPartAddError(Enum):
    ALREADY_EXISTS = "sum participant already exists"


class LocalSeedDictAddError(Enum):
    LENGTH_MISMATCH = "local seed dict length != sum dict length"
    UNKNOWN_SUM_PARTICIPANT = "local dict contains an unknown sum participant"
    UPDATE_PK_ALREADY_SUBMITTED = "update participant already submitted an update"
    UPDATE_PK_ALREADY_EXISTS_IN_UPDATE_SEED_DICT = (
        "update participant already exists in the inner update seed dict"
    )


class MaskScoreIncrError(Enum):
    UNKNOWN_SUM_PK = "unknown sum participant"
    MASK_ALREADY_SUBMITTED = "sum participant submitted a mask already"


class CoordinatorStorage(ABC):
    """Round-state storage: dictionaries, mask scores, coordinator state.

    Protocol errors are *returned* (``Optional[...Error]``, ``None`` on
    success) rather than raised — they are expected per-request outcomes the
    state machine reports back to clients; raised exceptions mean the
    backend itself failed.
    """

    @abstractmethod
    async def set_coordinator_state(self, state: bytes) -> None: ...

    @abstractmethod
    async def coordinator_state(self) -> Optional[bytes]: ...

    @abstractmethod
    async def add_sum_participant(
        self, pk: bytes, ephm_pk: bytes
    ) -> Optional[SumPartAddError]: ...

    @abstractmethod
    async def sum_dict(self) -> Optional[SumDict]: ...

    @abstractmethod
    async def add_local_seed_dict(
        self, update_pk: bytes, local_seed_dict: LocalSeedDict
    ) -> Optional[LocalSeedDictAddError]: ...

    @abstractmethod
    async def seed_dict(self) -> Optional[SeedDict]: ...

    @abstractmethod
    async def incr_mask_score(
        self, pk: bytes, mask: MaskObject
    ) -> Optional[MaskScoreIncrError]: ...

    @abstractmethod
    async def best_masks(self) -> Optional[list[tuple[MaskObject, int]]]: ...

    @abstractmethod
    async def number_of_unique_masks(self) -> int: ...

    @abstractmethod
    async def delete_coordinator_data(self) -> None:
        """Delete all coordinator data including the coordinator state."""

    @abstractmethod
    async def delete_dicts(self) -> None:
        """Delete the round dictionaries (sum/seed/mask), keep the state."""

    @abstractmethod
    async def set_latest_global_model_id(self, model_id: str) -> None: ...

    @abstractmethod
    async def latest_global_model_id(self) -> Optional[str]: ...

    @abstractmethod
    async def is_ready(self) -> None:
        """Raises ``StorageError`` when the backend is unreachable."""

    # --- journal resume (resilience) --------------------------------------

    async def restore_round_dicts(self, sum_dict, seed_dicts, mask_votes) -> None:
        """Replay journaled round dictionaries through the protocol
        primitives — idempotent on EVERY backend: entries the store still
        holds answer with their conditional-insert protocol verdict, which
        is exactly the outcome a replay wants ignored. ``seed_dicts`` is
        the journal's ``{update_pk: {sum_pk: seed bytes}}`` replay form;
        ``mask_votes`` is ``[(sum_pk, serialized mask bytes)]``. Replay
        order matters: sum membership gates both seed-dict inserts and
        mask votes."""
        from ..core.mask.seed import EncryptedMaskSeed
        from ..core.mask.serialization import parse_mask_object

        for pk, ephm in sum_dict.items():
            await self.add_sum_participant(bytes(pk), bytes(ephm))
        for update_pk, local in seed_dicts.items():
            await self.add_local_seed_dict(
                bytes(update_pk),
                {bytes(spk): EncryptedMaskSeed(bytes(seed)) for spk, seed in local.items()},
            )
        for pk, blob in mask_votes:
            mask, _ = parse_mask_object(bytes(blob))
            await self.incr_mask_score(bytes(pk), mask)

    async def prune_update_participants(self, keep_pks) -> bool:
        """Drop update participants the store holds but the journal never
        recorded (accepted-but-unjournaled: the coordinator died between
        the seed-dict insert and the journal write, so the client never
        saw the ack and WILL retry — the prune makes that retry succeed).
        Returns False when the backend cannot prune; the caller's
        seed-watermark check then rejects the resume instead."""
        return False

    # --- mid-round checkpoint (resilience) --------------------------------
    # Concrete defaults: the checkpoint is round-volatile state with the
    # same lifetime as the dictionaries, so an in-process fallback is
    # correct for every backend; durable backends (file, redis) override
    # to persist it alongside the coordinator state.

    async def set_round_checkpoint(self, data: bytes) -> None:
        """Persist the serialized mid-round aggregate checkpoint."""
        self._round_checkpoint_mem = bytes(data)

    async def round_checkpoint(self) -> Optional[bytes]:
        """The last persisted checkpoint, or None."""
        return getattr(self, "_round_checkpoint_mem", None)

    async def delete_round_checkpoint(self) -> None:
        """Drop the checkpoint (new round, or invalidated resume)."""
        self._round_checkpoint_mem = None


class ModelStorage(ABC):
    """Global-model blob storage."""

    @staticmethod
    def create_global_model_id(round_id: int, round_seed: bytes) -> str:
        """Canonical id: ``{round_id}_{hex(round_seed)}`` (traits.rs:195-198)."""
        return f"{round_id}_{round_seed.hex()}"

    @abstractmethod
    async def set_global_model(
        self, round_id: int, round_seed: bytes, model_data: bytes
    ) -> str:
        """Stores the model; refuses to overwrite an existing id with
        DIFFERENT bytes. Re-storing identical bytes returns the id —
        a publish-window resume (the coordinator died after persisting
        the model but before retiring the journal entry) republishes
        the exact same model and must be an idempotent success."""

    @abstractmethod
    async def global_model(self, model_id: str) -> Optional[bytes]: ...

    @abstractmethod
    async def is_ready(self) -> None: ...


class TrustAnchor(ABC):
    """Publishes proofs of global models to an external anchor."""

    @abstractmethod
    async def publish_proof(self, model_data: bytes) -> None: ...

    @abstractmethod
    async def is_ready(self) -> None: ...


class Store:
    """Composition of the three storage interfaces (storage/store.rs:32-212)."""

    def __init__(
        self,
        coordinator: CoordinatorStorage,
        models: ModelStorage,
        trust_anchor: Optional[TrustAnchor] = None,
    ):
        self.coordinator = coordinator
        self.models = models
        self.trust_anchor = trust_anchor

    async def is_ready(self) -> None:
        await self.coordinator.is_ready()
        await self.models.is_ready()
        if self.trust_anchor is not None:
            await self.trust_anchor.is_ready()
