"""Durable phase-tagged round journal.

The coordinator persists one journal entry per round through the store
(``set_round_checkpoint``), tagged with the phase it allows re-entering:

- ``sum``: the sum dictionary as it accumulates (one rewrite per accepted
  sum participant) — a restart mid-sum re-seeds the dictionary and runs a
  reduced window for the participants still missing;
- ``update``: the drained aggregate + the sealed sum dictionary + every
  journaled seed dict, written on the ``CheckpointManager`` cadence (and
  on every fold when ``checkpoint_every_batches = 1``, which makes the
  journal write part of the accept path: an acknowledged update is a
  journaled update);
- ``sum2``: the finished aggregate plus the mask-dict votes as they
  accumulate (one rewrite per accepted vote);
- ``unmask``: the drained-but-unpublished aggregate with the final votes —
  covering the publish window; the entry is deleted only AFTER the global
  model is persisted.

A journal entry is consistent exactly when its ``nb_models`` equals the
number of update participants whose seed dicts it carries — the PET unmask
step subtracts the mask sum over ALL seeds in the seed dictionary, so an
aggregate missing any seeded update (or containing an unseeded one) would
unmask to garbage. ``validate`` enforces that invariant plus the identity
of the round (id, seed, mask config, model length) before any resume; with
``reseed=True`` (boot restore) it first replays the journaled dictionaries
into the store through the normal protocol primitives (idempotent: the
conditional-insert verdicts of already-present entries are ignored) and
prunes update participants the store kept but the journal never recorded
(accepted-but-unjournaled: the client never saw the ack and will retry).

Wire format v2 (``XNCKPT2``): magic, u32-le JSON-header length, JSON
header, then raw payload sections in order — vector accumulator (uint32-le
wire ``[model_len, L]`` or packed per-shard planar planes), unit
accumulator, concatenated serialized mask votes. Every section's sha256 is
in the header — a torn write must fail validation, never resume. ``XNCKPT1``
blobs (update-only snapshots from older coordinators) still read.
"""

from __future__ import annotations

import hashlib
import json
import logging
import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..telemetry.registry import get_registry

logger = logging.getLogger("xaynet.resilience")

_registry = get_registry()
CHECKPOINTS = _registry.counter(
    "xaynet_resilience_checkpoints_total",
    "Round journal entries written, by outcome.",
    ("outcome",),
)
CHECKPOINT_SECONDS = _registry.histogram(
    "xaynet_resilience_checkpoint_seconds",
    "Wall time of one checkpoint write (drain + snapshot + store).",
)
RESUMES = _registry.counter(
    "xaynet_resilience_round_resumes_total",
    "Round resume attempts from a mid-round checkpoint, by outcome.",
    ("outcome",),
)
RESUME_TOTAL = _registry.counter(
    "xaynet_resume_total",
    "Journal resume attempts, by the phase the entry re-enters and outcome "
    "(resumed | invalid | budget_exhausted).",
    ("phase", "outcome"),
)
RECOVERY_SECONDS = _registry.gauge(
    "xaynet_recovery_seconds",
    "Restart-to-serving wall of the last boot: process entry to the REST "
    "API accepting requests (includes store restore + journal resume).",
)
SAVE_FAILURES = _registry.counter(
    "xaynet_checkpoint_save_failures_total",
    "Journal writes abandoned after the storage retry policy was exhausted "
    "(the round continues; the journal lags until the next save).",
)

MAGIC = b"XNCKPT1"
MAGIC2 = b"XNCKPT2"

RESUMABLE_PHASES = ("sum", "update", "sum2", "unmask")


class CheckpointError(ValueError):
    """Corrupt or inconsistent checkpoint blob."""


@dataclass
class AggSnapshot:
    """One exact host copy of the aggregate, as the journal stores it:
    either the gathered wire layout or packed per-shard planar planes
    (``[(lo, hi, uint32[L, hi-lo])]`` in padded model-axis coordinates) —
    device rounds checkpoint shard-by-shard without a full gather."""

    nb_models: int
    unit: np.ndarray
    vect: Optional[np.ndarray] = None  # uint32 wire [model_len, L]
    planes: Optional[list] = None  # [(lo, hi, uint32[L, hi-lo])]


@dataclass
class RoundCheckpoint:
    """One phase-tagged journal entry: everything needed to re-enter
    ``phase`` with the round state restored."""

    round_id: int
    phase: str  # one of RESUMABLE_PHASES
    round_seed: bytes
    mask_config: list  # [vect enums..., unit enums...] by name
    model_length: int
    nb_models: int
    seed_watermark: int  # distinct update pks in the journaled seed dicts
    vect: np.ndarray  # uint32 wire layout [model_len, L]; may be empty
    unit: np.ndarray  # uint32 [L_unit]; may be empty
    version: int = 2
    # round dictionaries, in replay form (hex-safe bytes everywhere):
    sum_dict: dict = field(default_factory=dict)  # {sum_pk: ephm_pk}
    # {update_pk: {sum_pk: encrypted seed bytes}} — the LOCAL seed dict
    # shape add_local_seed_dict replays directly
    seed_dicts: dict = field(default_factory=dict)
    mask_votes: list = field(default_factory=list)  # [(sum_pk, mask bytes)]
    # packed per-shard planar planes [(lo, hi, uint32[L, hi-lo])]; when set,
    # ``vect`` is empty and ``wire_vect()`` reassembles on demand
    planes: Optional[list] = None

    # -- derived -----------------------------------------------------------

    def wire_vect(self) -> np.ndarray:
        """The aggregate in wire layout ``uint32[model_len, L]`` — assembled
        from the per-shard planes when the entry was written shard-packed
        (host restore path / validation; the device restore path consumes
        ``planes`` directly, shard by shard)."""
        if self.planes:
            rows = int(self.planes[0][2].shape[0])
            width = max(int(hi) for _, hi, _ in self.planes)
            planar = np.zeros((rows, width), dtype=np.uint32)
            for lo, hi, plane in self.planes:
                planar[:, int(lo) : int(hi)] = plane
            return np.ascontiguousarray(planar[:, : self.model_length].T)
        return self.vect

    # -- serialization -----------------------------------------------------

    def to_bytes(self) -> bytes:
        if self.version < 2:
            return self._to_bytes_v1()
        vect = np.ascontiguousarray(self.vect, dtype=np.uint32)
        unit = np.ascontiguousarray(self.unit, dtype=np.uint32)
        vect_raw = vect.tobytes()
        unit_raw = unit.tobytes()
        votes_raw = b"".join(bytes(mask) for _, mask in self.mask_votes)
        planes_meta = None
        planes_raw = b""
        if self.planes is not None:
            planes_meta = []
            chunks = []
            for lo, hi, plane in self.planes:
                plane = np.ascontiguousarray(plane, dtype=np.uint32)
                planes_meta.append([int(lo), int(hi), *map(int, plane.shape)])
                chunks.append(plane.tobytes())
            planes_raw = b"".join(chunks)
        header = json.dumps(  # lint: taint-ok: durable journal; seeds stay sealed, round seed is the identity check
            {
                "version": 2,
                "round_id": self.round_id,
                "phase": self.phase,
                "round_seed": self.round_seed.hex(),
                "mask_config": self.mask_config,
                "model_length": self.model_length,
                "nb_models": self.nb_models,
                "seed_watermark": self.seed_watermark,
                "vect_shape": list(vect.shape),
                "unit_shape": list(unit.shape),
                "vect_sha256": hashlib.sha256(vect_raw).hexdigest(),
                "unit_sha256": hashlib.sha256(unit_raw).hexdigest(),
                "sum_dict": {
                    pk.hex(): ephm.hex() for pk, ephm in self.sum_dict.items()
                },
                "seed_dicts": {
                    pk.hex(): {spk.hex(): bytes(seed).hex() for spk, seed in local.items()}
                    for pk, local in self.seed_dicts.items()
                },
                "votes": [[pk.hex(), len(bytes(mask))] for pk, mask in self.mask_votes],
                "votes_sha256": hashlib.sha256(votes_raw).hexdigest(),
                "planes": planes_meta,
                "planes_sha256": hashlib.sha256(planes_raw).hexdigest(),
            }
        ).encode()
        return (
            MAGIC2
            + struct.pack("<I", len(header))
            + header
            + vect_raw
            + unit_raw
            + votes_raw
            + planes_raw
        )

    def _to_bytes_v1(self) -> bytes:
        """The update-only XNCKPT1 snapshot (kept writable for the
        backward-compat tests; new entries always write v2)."""
        vect = np.ascontiguousarray(self.vect, dtype=np.uint32)
        unit = np.ascontiguousarray(self.unit, dtype=np.uint32)
        vect_raw = vect.tobytes()
        unit_raw = unit.tobytes()
        header = json.dumps(  # lint: taint-ok: durable journal (v1); round seed is the restore identity check
            {
                "round_id": self.round_id,
                "phase": self.phase,
                "round_seed": self.round_seed.hex(),
                "mask_config": self.mask_config,
                "model_length": self.model_length,
                "nb_models": self.nb_models,
                "seed_watermark": self.seed_watermark,
                "vect_shape": list(vect.shape),
                "unit_shape": list(unit.shape),
                "vect_sha256": hashlib.sha256(vect_raw).hexdigest(),
                "unit_sha256": hashlib.sha256(unit_raw).hexdigest(),
            }
        ).encode()
        return MAGIC + struct.pack("<I", len(header)) + header + vect_raw + unit_raw

    @classmethod
    def from_bytes(cls, blob: bytes) -> "RoundCheckpoint":
        if len(blob) < len(MAGIC) + 4:
            raise CheckpointError("bad checkpoint magic")
        magic = blob[: len(MAGIC)]
        if magic not in (MAGIC, MAGIC2):
            raise CheckpointError("bad checkpoint magic")
        off = len(magic)
        (hlen,) = struct.unpack_from("<I", blob, off)
        off += 4
        try:
            header = json.loads(blob[off : off + hlen].decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise CheckpointError(f"bad checkpoint header: {e}") from e
        off += hlen
        vect_shape = tuple(header["vect_shape"])
        unit_shape = tuple(header["unit_shape"])
        vect_len = int(np.prod(vect_shape)) * 4 if vect_shape else 4
        unit_len = int(np.prod(unit_shape)) * 4 if unit_shape else 4
        if magic == MAGIC:
            if len(blob) != off + vect_len + unit_len:
                raise CheckpointError("truncated checkpoint payload")
            vect_raw = blob[off : off + vect_len]
            unit_raw = blob[off + vect_len :]
            votes_raw = b""
            planes_raw = b""
            votes_meta: list = []
            planes_meta = None
        else:
            # v2 sections may be genuinely empty (a sum-phase entry has no
            # aggregate): an empty shape means zero bytes, not one element
            vect_len = int(np.prod(vect_shape, initial=1)) * 4 if all(vect_shape) else 0
            unit_len = int(np.prod(unit_shape, initial=1)) * 4 if all(unit_shape) else 0
            votes_meta = header.get("votes") or []
            votes_len = sum(int(n) for _, n in votes_meta)
            planes_meta = header.get("planes")
            planes_len = (
                sum(int(r) * int(c) * 4 for _, _, r, c in planes_meta)
                if planes_meta
                else 0
            )
            if len(blob) != off + vect_len + unit_len + votes_len + planes_len:
                raise CheckpointError("truncated checkpoint payload")
            vect_raw = blob[off : off + vect_len]
            off += vect_len
            unit_raw = blob[off : off + unit_len]
            off += unit_len
            votes_raw = blob[off : off + votes_len]
            off += votes_len
            planes_raw = blob[off:]
        if hashlib.sha256(vect_raw).hexdigest() != header["vect_sha256"]:
            raise CheckpointError("vector accumulator digest mismatch")
        if hashlib.sha256(unit_raw).hexdigest() != header["unit_sha256"]:
            raise CheckpointError("unit accumulator digest mismatch")
        if magic == MAGIC2:
            if hashlib.sha256(votes_raw).hexdigest() != header["votes_sha256"]:
                raise CheckpointError("mask vote digest mismatch")
            if hashlib.sha256(planes_raw).hexdigest() != header["planes_sha256"]:
                raise CheckpointError("shard plane digest mismatch")
        mask_votes = []
        pos = 0
        for pk_hex, n in votes_meta:
            mask_votes.append((bytes.fromhex(pk_hex), votes_raw[pos : pos + int(n)]))
            pos += int(n)
        planes = None
        if planes_meta:
            planes = []
            pos = 0
            for lo, hi, r, c in planes_meta:
                n = int(r) * int(c) * 4
                planes.append(
                    (
                        int(lo),
                        int(hi),
                        np.frombuffer(planes_raw[pos : pos + n], dtype=np.uint32).reshape(
                            int(r), int(c)
                        ),
                    )
                )
                pos += n
        empty2 = np.zeros((0, 0), dtype=np.uint32)
        return cls(
            round_id=int(header["round_id"]),
            phase=str(header["phase"]),
            round_seed=bytes.fromhex(header["round_seed"]),
            mask_config=list(header["mask_config"]),
            model_length=int(header["model_length"]),
            nb_models=int(header["nb_models"]),
            seed_watermark=int(header["seed_watermark"]),
            vect=(
                np.frombuffer(vect_raw, dtype=np.uint32).reshape(vect_shape)
                if vect_raw
                else empty2
            ),
            unit=(
                np.frombuffer(unit_raw, dtype=np.uint32).reshape(unit_shape)
                if unit_raw
                else np.zeros((0,), dtype=np.uint32)
            ),
            version=1 if magic == MAGIC else 2,
            sum_dict={
                bytes.fromhex(pk): bytes.fromhex(ephm)
                for pk, ephm in (header.get("sum_dict") or {}).items()
            },
            seed_dicts={
                bytes.fromhex(pk): {
                    bytes.fromhex(spk): bytes.fromhex(seed)
                    for spk, seed in local.items()
                }
                for pk, local in (header.get("seed_dicts") or {}).items()
            },
            mask_votes=mask_votes,
            planes=planes,
        )


def mask_config_names(config_pair) -> list:
    """Stable identity of a ``MaskConfigPair`` for checkpoint validation."""
    out = []
    for cfg in (config_pair.vect, config_pair.unit):
        out.append(
            [cfg.group_type.name, cfg.data_type.name, cfg.bound_type.name, cfg.model_type.name]
        )
    return out


def seed_dict_watermark(seed_dict) -> int:
    """Distinct update participants present in a (possibly None) seed dict."""
    if not seed_dict:
        return 0
    pks: set = set()
    for inner in seed_dict.values():
        pks.update(inner.keys())
    return len(pks)


def invert_seed_dict(seed_dict) -> dict:
    """Store seed-dict form ``{sum_pk: {update_pk: seed}}`` -> the journal's
    replay form ``{update_pk: {sum_pk: seed bytes}}`` (each inner dict is
    exactly one ``add_local_seed_dict`` call)."""
    out: dict = {}
    if not seed_dict:
        return out
    for sum_pk, inner in seed_dict.items():
        for update_pk, seed in inner.items():
            raw = seed.as_bytes() if hasattr(seed, "as_bytes") else bytes(seed)
            out.setdefault(update_pk, {})[sum_pk] = raw
    return out


def entry(
    shared,
    phase: str,
    snap: Optional[AggSnapshot] = None,
    *,
    sum_dict=None,
    seed_dicts=None,
    mask_votes=None,
) -> RoundCheckpoint:
    """Build a journal entry for the CURRENT round from a (possibly absent)
    aggregate snapshot plus the round dictionaries in replay form."""
    state = shared.state
    seed_dicts = dict(seed_dicts or {})
    return RoundCheckpoint(
        round_id=shared.round_id,
        phase=phase,
        round_seed=state.round_params.seed.as_bytes(),
        mask_config=mask_config_names(state.round_params.mask_config),
        model_length=state.round_params.model_length,
        nb_models=snap.nb_models if snap is not None else 0,
        seed_watermark=len(seed_dicts),
        vect=(
            snap.vect
            if snap is not None and snap.vect is not None
            else np.zeros((0, 0), dtype=np.uint32)
        ),
        unit=snap.unit if snap is not None else np.zeros((0,), dtype=np.uint32),
        sum_dict=dict(sum_dict or {}),
        seed_dicts=seed_dicts,
        mask_votes=list(mask_votes or []),
        planes=snap.planes if snap is not None else None,
    )


async def write_entry(shared, ckpt: RoundCheckpoint) -> bool:
    """Serialize + persist one journal entry, fail-soft.

    The store call rides the ResilientStore retry policy (runner wraps
    every storage method); exhaustion lands on
    ``xaynet_checkpoint_save_failures_total`` and the round CONTINUES — a
    journal write must never fail the phase it exists to protect.
    """
    import asyncio

    try:
        loop = asyncio.get_running_loop()
        # serialization sha256-hashes the model-sized aggregate — CPU work
        # that must not stall the loop serving the API
        blob = await loop.run_in_executor(None, ckpt.to_bytes)
        await shared.store.coordinator.set_round_checkpoint(blob)
    except asyncio.CancelledError:
        raise
    except Exception as e:
        logger.warning(
            "round %d: journal write (%s) failed: %s", shared.round_id, ckpt.phase, e
        )
        CHECKPOINTS.labels(outcome="failed").inc()
        SAVE_FAILURES.inc()
        return False
    CHECKPOINTS.labels(outcome="saved").inc()
    return True


async def validate(
    ckpt: "RoundCheckpoint", state, store, *, reseed: bool = False
) -> Optional[str]:
    """None when the journal entry may be resumed; else the rejection reason.

    ``state`` is the restored ``CoordinatorState``; ``store`` the Store the
    round dictionaries live in. With ``reseed`` (boot restore: the process
    died, the store's round dictionaries may be gone or may hold
    accepted-but-unjournaled orphans) the journaled dictionaries are first
    replayed through the protocol primitives — idempotent, every backend —
    and orphan update participants pruned so their un-acked clients can
    retry. The watermark check is the consistency linchpin (see module
    docstring); it runs against the store AFTER any replay.
    """
    if ckpt.phase not in RESUMABLE_PHASES:
        return f"unsupported checkpoint phase {ckpt.phase!r}"
    if ckpt.version < 2 and ckpt.phase != "update":
        return f"v1 checkpoint cannot resume phase {ckpt.phase!r}"
    if ckpt.round_id != state.round_id:
        return f"checkpoint round {ckpt.round_id} != state round {state.round_id}"
    if ckpt.round_seed != state.round_params.seed.as_bytes():
        return "checkpoint round seed != state round seed"
    if ckpt.mask_config != mask_config_names(state.round_params.mask_config):
        return "checkpoint mask config != state mask config"
    if ckpt.model_length != state.round_params.model_length:
        return (
            f"checkpoint model length {ckpt.model_length} != configured "
            f"{state.round_params.model_length}"
        )
    if ckpt.nb_models:
        if ckpt.planes:
            if max(int(hi) for _, hi, _ in ckpt.planes) < ckpt.model_length:
                return "checkpoint shard planes narrower than the model"
        elif ckpt.vect.ndim != 2 or ckpt.vect.shape[0] != ckpt.model_length:
            return f"checkpoint vector shape {ckpt.vect.shape} inconsistent"
    if ckpt.nb_models != ckpt.seed_watermark:
        return (
            f"checkpoint nb_models {ckpt.nb_models} != seed watermark "
            f"{ckpt.seed_watermark}: the aggregate and the seed dicts diverged"
        )
    if ckpt.version >= 2 and len(ckpt.seed_dicts) != ckpt.seed_watermark:
        return "journaled seed dicts inconsistent with the watermark"
    if reseed and ckpt.version >= 2:
        await store.coordinator.restore_round_dicts(
            ckpt.sum_dict, ckpt.seed_dicts, ckpt.mask_votes
        )
        await store.coordinator.prune_update_participants(set(ckpt.seed_dicts))
    watermark = seed_dict_watermark(await store.coordinator.seed_dict())
    if watermark != ckpt.seed_watermark:
        return (
            f"seed-dict watermark {watermark} != checkpoint "
            f"{ckpt.seed_watermark} (nb_models {ckpt.nb_models}): updates were "
            "accepted after the last checkpoint; their masked models are lost"
        )
    if ckpt.version >= 2 and ckpt.sum_dict:
        store_sum = await store.coordinator.sum_dict() or {}
        if len(store_sum) < len(ckpt.sum_dict):
            return "store sum dictionary lost entries the journal recorded"
    return None


async def load(store) -> Optional["RoundCheckpoint"]:
    """Read + parse the persisted journal entry; None when absent or corrupt
    (a corrupt checkpoint must degrade to a round restart, never crash the
    initializer)."""
    try:
        blob = await store.coordinator.round_checkpoint()
    except Exception as e:
        logger.warning("checkpoint read failed: %s", e)
        return None
    if blob is None:
        return None
    try:
        return RoundCheckpoint.from_bytes(blob)
    except CheckpointError as e:
        logger.warning("discarding corrupt round checkpoint: %s", e)
        return None


class CheckpointManager:
    """Save-cadence policy for the update phase.

    ``maybe_save`` is called after every fold batch; it persists when
    ``every_batches`` batches have accumulated since the last save or
    ``every_s`` seconds have elapsed — whichever comes first. Saving is a
    synchronization point (the streaming pipeline drains so the snapshot is
    exact); the cadence bounds how much device work one checkpoint costs.
    A failed save is logged + metered and the round continues — losing a
    checkpoint must never fail the phase it exists to protect.
    """

    def __init__(self, shared, aggregator, every_batches: int, every_s: float):
        self.shared = shared
        self.aggregator = aggregator
        self.every_batches = max(1, int(every_batches))
        self.every_s = float(every_s)
        self._batches_since = 0
        self._last_save = None  # monotonic; set on first batch
        self.saves = 0

    async def maybe_save(self) -> bool:
        import time

        now = time.monotonic()
        if self._last_save is None:
            self._last_save = now
        self._batches_since += 1
        due = self._batches_since >= self.every_batches or (
            self.every_s > 0 and now - self._last_save >= self.every_s
        )
        if not due:
            return False
        return await self._save(now)

    async def save_now(self) -> bool:
        """Force one journal write NOW (graceful-signal flush: a SIGTERM
        between cadence points must not drop up to ``every_batches`` of
        accepted updates)."""
        import time

        return await self._save(time.monotonic())

    async def _save(self, now: float) -> bool:
        import asyncio

        self._batches_since = 0
        self._last_save = now
        try:
            with CHECKPOINT_SECONDS.time():
                loop = asyncio.get_running_loop()
                # drain + snapshot off the event loop: the drain blocks on
                # in-flight device folds
                snap = await loop.run_in_executor(
                    None, self.aggregator.snapshot_journal
                )
                coord = self.shared.store.coordinator
                seed_dict = await coord.seed_dict()
                sum_dict = await coord.sum_dict()
                ckpt = entry(
                    self.shared,
                    "update",
                    snap,
                    sum_dict=sum_dict,
                    seed_dicts=invert_seed_dict(seed_dict),
                )
                if not await write_entry(self.shared, ckpt):
                    return False
        except asyncio.CancelledError:
            raise
        except Exception as e:
            logger.warning("round %d: checkpoint save failed: %s", self.shared.round_id, e)
            CHECKPOINTS.labels(outcome="failed").inc()
            SAVE_FAILURES.inc()
            return False
        self.saves += 1
        logger.info(
            "round %d: journaled update aggregate (%d models, watermark %d)",
            self.shared.round_id,
            ckpt.nb_models,
            ckpt.seed_watermark,
        )
        return True
