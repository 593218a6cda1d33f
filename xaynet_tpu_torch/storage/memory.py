"""In-process storage backend.

Implements the same atomic conditional-insert semantics the reference
enforces with Redis Lua scripts (reference:
rust/xaynet-server/src/storage/coordinator_storage/redis/mod.rs:208-343):
seed-dict inserts validate length against the sum dict, membership and
single submission before writing; mask scores require sum membership and a
single submission per participant. Atomicity here comes from the asyncio
single-thread execution model (no awaits inside the critical sections).

Masks in the score dict are keyed by their serialized bytes, mirroring the
Redis sorted-set keyed by the serialized mask object.
"""

from __future__ import annotations

from typing import Optional

from ..core.common import LocalSeedDict, SeedDict, SumDict
from ..core.mask.object import MaskObject
from ..core.mask.serialization import parse_mask_object, serialize_mask_object
from .traits import (
    CoordinatorStorage,
    LocalSeedDictAddError,
    MaskScoreIncrError,
    ModelStorage,
    StorageError,
    SumPartAddError,
    TrustAnchor,
)


class InMemoryCoordinatorStorage(CoordinatorStorage):
    def __init__(self):
        self._state: Optional[bytes] = None
        self._sum_dict: dict[bytes, bytes] = {}
        self._seed_dict: dict[bytes, dict[bytes, object]] = {}
        self._update_submitted: set[bytes] = set()
        self._mask_scores: dict[bytes, int] = {}
        self._mask_submitted: set[bytes] = set()
        self._latest_global_model_id: Optional[str] = None

    async def set_coordinator_state(self, state: bytes) -> None:
        self._state = bytes(state)

    async def coordinator_state(self) -> Optional[bytes]:
        return self._state

    async def add_sum_participant(self, pk: bytes, ephm_pk: bytes) -> Optional[SumPartAddError]:
        if pk in self._sum_dict:
            return SumPartAddError.ALREADY_EXISTS
        self._sum_dict[pk] = ephm_pk
        return None

    async def sum_dict(self) -> Optional[SumDict]:
        return dict(self._sum_dict) if self._sum_dict else None

    async def add_local_seed_dict(
        self, update_pk: bytes, local_seed_dict: LocalSeedDict
    ) -> Optional[LocalSeedDictAddError]:
        # same validations as the reference's Lua script (redis/mod.rs:208-267)
        if len(local_seed_dict) != len(self._sum_dict):
            return LocalSeedDictAddError.LENGTH_MISMATCH
        if any(pk not in self._sum_dict for pk in local_seed_dict):
            return LocalSeedDictAddError.UNKNOWN_SUM_PARTICIPANT
        if update_pk in self._update_submitted:
            return LocalSeedDictAddError.UPDATE_PK_ALREADY_SUBMITTED
        for sum_pk in local_seed_dict:
            if update_pk in self._seed_dict.get(sum_pk, {}):
                return LocalSeedDictAddError.UPDATE_PK_ALREADY_EXISTS_IN_UPDATE_SEED_DICT
        for sum_pk, seed in local_seed_dict.items():
            self._seed_dict.setdefault(sum_pk, {})[update_pk] = seed
        self._update_submitted.add(update_pk)
        return None

    async def seed_dict(self) -> Optional[SeedDict]:
        if not self._seed_dict:
            return None
        return {sum_pk: dict(inner) for sum_pk, inner in self._seed_dict.items()}

    async def incr_mask_score(self, pk: bytes, mask: MaskObject) -> Optional[MaskScoreIncrError]:
        # same validations as the reference's Lua script (redis/mod.rs:303-343)
        if pk not in self._sum_dict:
            return MaskScoreIncrError.UNKNOWN_SUM_PK
        if pk in self._mask_submitted:
            return MaskScoreIncrError.MASK_ALREADY_SUBMITTED
        key = serialize_mask_object(mask)
        self._mask_scores[key] = self._mask_scores.get(key, 0) + 1
        self._mask_submitted.add(pk)
        return None

    async def best_masks(self) -> Optional[list[tuple[MaskObject, int]]]:
        if not self._mask_scores:
            return None
        top = sorted(self._mask_scores.items(), key=lambda kv: kv[1], reverse=True)[:2]
        return [(parse_mask_object(data)[0], score) for data, score in top]

    async def number_of_unique_masks(self) -> int:
        return len(self._mask_scores)

    async def delete_coordinator_data(self) -> None:
        self._state = None
        self._latest_global_model_id = None
        await self.delete_round_checkpoint()
        await self.delete_dicts()

    async def delete_dicts(self) -> None:
        self._sum_dict.clear()
        self._seed_dict.clear()
        self._update_submitted.clear()
        self._mask_scores.clear()
        self._mask_submitted.clear()

    async def set_latest_global_model_id(self, model_id: str) -> None:
        self._latest_global_model_id = model_id

    async def latest_global_model_id(self) -> Optional[str]:
        return self._latest_global_model_id

    async def prune_update_participants(self, keep_pks) -> bool:
        keep = set(keep_pks)
        for inner in self._seed_dict.values():
            for pk in [p for p in inner if p not in keep]:
                del inner[pk]
        self._update_submitted = {pk for pk in self._update_submitted if pk in keep}
        return True

    async def is_ready(self) -> None:
        return None


class InMemoryModelStorage(ModelStorage):
    def __init__(self):
        self._models: dict[str, bytes] = {}

    async def set_global_model(self, round_id: int, round_seed: bytes, model_data: bytes) -> str:
        model_id = self.create_global_model_id(round_id, round_seed)
        existing = self._models.get(model_id)
        if existing is not None:
            if existing == bytes(model_data):
                return model_id  # publish-window resume: idempotent republish
            raise StorageError(f"global model {model_id} already exists")
        self._models[model_id] = bytes(model_data)
        return model_id

    async def global_model(self, model_id: str) -> Optional[bytes]:
        return self._models.get(model_id)

    async def is_ready(self) -> None:
        return None


class FilesystemModelStorage(ModelStorage):
    """Model blobs on a local/NFS/FUSE path (the S3/Minio analogue)."""

    def __init__(self, root: str):
        import os

        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, model_id: str) -> str:
        import os

        safe = model_id.replace("/", "_")
        return os.path.join(self.root, safe + ".bin")

    async def set_global_model(self, round_id: int, round_seed: bytes, model_data: bytes) -> str:
        import os

        model_id = self.create_global_model_id(round_id, round_seed)
        path = self._path(model_id)
        if os.path.exists(path):
            with open(path, "rb") as f:
                if f.read() == bytes(model_data):
                    return model_id  # publish-window resume: idempotent republish
            raise StorageError(f"global model {model_id} already exists")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(model_data)
        os.replace(tmp, path)
        return model_id

    async def global_model(self, model_id: str) -> Optional[bytes]:
        import os

        path = self._path(model_id)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    async def is_ready(self) -> None:
        import os

        if not os.path.isdir(self.root):
            raise StorageError(f"model store root {self.root} missing")


class NoOpModelStorage(ModelStorage):
    """Persistence disabled (reference: model_storage/noop.rs)."""

    async def set_global_model(self, round_id: int, round_seed: bytes, model_data: bytes) -> str:
        return self.create_global_model_id(round_id, round_seed)

    async def global_model(self, model_id: str) -> Optional[bytes]:
        return None

    async def is_ready(self) -> None:
        return None


class NoOpTrustAnchor(TrustAnchor):
    async def publish_proof(self, model_data: bytes) -> None:
        return None

    async def is_ready(self) -> None:
        return None


class FileCoordinatorStorage(InMemoryCoordinatorStorage):
    """In-memory round dictionaries + file-persisted durable state.

    The reference keeps everything in Redis; for single-node deployments
    without an external store, the *durable* subset (coordinator state and
    the latest-global-model pointer — exactly what restore reads,
    reference: initializer.rs:162-271) persists to a JSON file. Round
    dictionaries live in memory only — but the round JOURNAL (the binary
    ``.ckpt`` sibling) carries its own copy of them, and a boot restore
    replays them back through ``restore_round_dicts``, so a crash
    anywhere in the round resumes instead of restarting it.
    """

    def __init__(self, path: str):
        super().__init__()
        import json
        import os

        self.path = path
        if os.path.exists(path):
            with open(path) as f:
                saved = json.load(f)
            if saved.get("state") is not None:
                self._state = bytes.fromhex(saved["state"])
            self._latest_global_model_id = saved.get("latest_global_model_id")

    def _persist(self) -> None:
        import json
        import os

        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "state": self._state.hex() if self._state else None,
                    "latest_global_model_id": self._latest_global_model_id,
                },
                f,
            )
        os.replace(tmp, self.path)

    async def set_coordinator_state(self, state: bytes) -> None:
        await super().set_coordinator_state(state)
        self._persist()

    async def set_latest_global_model_id(self, model_id: str) -> None:
        await super().set_latest_global_model_id(model_id)
        self._persist()

    async def delete_coordinator_data(self) -> None:
        await super().delete_coordinator_data()
        self._persist()

    # --- mid-round checkpoint: binary sibling file (the aggregate snapshot
    # can be model-sized; it does not belong hex-encoded inside the JSON) --

    def _ckpt_path(self) -> str:
        return self.path + ".ckpt"

    async def set_round_checkpoint(self, data: bytes) -> None:
        import asyncio

        # model-sized blob: the file write goes through the executor so the
        # event loop keeps serving the API during a checkpoint
        await asyncio.get_running_loop().run_in_executor(
            None, self._write_ckpt, data
        )

    def _write_ckpt(self, data: bytes) -> None:
        import os

        tmp = self._ckpt_path() + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._ckpt_path())

    async def round_checkpoint(self) -> Optional[bytes]:
        import asyncio

        return await asyncio.get_running_loop().run_in_executor(None, self._read_ckpt)

    def _read_ckpt(self) -> Optional[bytes]:
        import os

        if not os.path.exists(self._ckpt_path()):
            return None
        with open(self._ckpt_path(), "rb") as f:
            return f.read()

    async def delete_round_checkpoint(self) -> None:
        import os

        try:
            os.remove(self._ckpt_path())
        except FileNotFoundError:
            pass
