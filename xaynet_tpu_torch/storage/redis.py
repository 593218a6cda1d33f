"""Redis coordinator-storage backend (RESP client from scratch).

The port's copy of ``xaynet_tpu/storage/redis.py``: the same keys, Lua
scripts, key prefix and replay discipline, so a round journal one package
writes into Redis resumes in the other. Functional port of the
reference's Redis backend (reference:
rust/xaynet-server/src/storage/coordinator_storage/redis/mod.rs): the same
data model (sum_dict hash, per-sum-pk seed hashes, update_participants set,
mask_submitted set, mask_dict sorted set keyed by the serialized mask) and
the same *atomic Lua scripts* for the conditional inserts
(redis/mod.rs:208-267 for seed dicts, :303-343 for mask scores).

No third-party client: a minimal RESP2 protocol implementation over asyncio
streams (`RespClient`). Use this backend when running several coordinator
replicas or when round state must survive a coordinator crash with an
external store; the in-process backend provides the same semantics for
single-process deployments.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..core.mask.object import MaskObject
from ..core.mask.seed import EncryptedMaskSeed
from ..core.mask.serialization import parse_mask_object, serialize_mask_object
from .traits import (
    CoordinatorStorage,
    LocalSeedDictAddError,
    MaskScoreIncrError,
    StorageError,
    SumPartAddError,
    TransientStorageError,
)

# --- RESP2 client ----------------------------------------------------------


class RespClient:
    """Minimal Redis protocol client (RESP2) over asyncio streams.

    Connection management mirrors the reference's ``ConnectionManager``
    (reference: redis/mod.rs:95-103): commands transparently reconnect with
    exponential backoff when the connection drops or the server is briefly
    away. Replay discipline: a command is only re-sent when either (a) the
    failure happened before any bytes went out (connect failure), or (b)
    the caller marked it ``replay_safe`` (reads and idempotent SETs). The
    conditional-insert Lua scripts are NOT replay safe — replaying one that
    executed but lost its reply would surface a dedup error for a write
    that actually landed, desynchronizing the seed dict from the model
    aggregate — so those surface a ``StorageError`` instead, which routes
    the round to the Failure phase exactly like the reference's failed
    in-flight commands.
    """

    RETRY_ATTEMPTS = 4
    RETRY_BASE_DELAY = 0.05  # seconds; doubles per attempt
    IDLE_PROBE_AFTER = 1.0  # validate connections idle longer than this

    def __init__(self, host: str = "127.0.0.1", port: int = 6379, db: int = 0):
        self.host, self.port, self.db = host, port, db
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._lock = asyncio.Lock()
        self._last_use = 0.0

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
        if self.db:
            await self.command(b"SELECT", str(self.db).encode())

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:  # lint: swallow-ok (best-effort socket teardown)
                pass
        self._reader = self._writer = None

    async def command(self, *parts: bytes, replay_safe: bool = True):
        """Sends one command and decodes one reply (auto-reconnect + backoff).

        ``replay_safe=False``: once the request bytes may have reached the
        server, a connection failure raises instead of re-sending.
        """
        async with self._lock:
            last: Exception | None = None
            for attempt in range(self.RETRY_ATTEMPTS):
                sent = False
                try:
                    if (
                        not replay_safe
                        and self._writer is not None
                        and asyncio.get_running_loop().time() - self._last_use
                        > self.IDLE_PROBE_AFTER
                    ):
                        # validate a stale-looking idle connection first, so
                        # only genuine mid-command drops become hard failures
                        # (hot-path commands skip the probe entirely)
                        try:
                            await self._roundtrip((b"PING",))
                        except (ConnectionError, OSError, asyncio.IncompleteReadError):
                            self._drop_connection()
                    if self._writer is None:
                        await self._connect_locked()
                    sent = True  # _roundtrip writes before reading
                    result = await self._roundtrip(parts)
                    self._last_use = asyncio.get_running_loop().time()
                    return result
                except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
                    last = e
                    self._drop_connection()
                    if sent and not replay_safe:
                        # the command MAY have executed server-side: mark the
                        # error permanent so the resilience layer never
                        # retries it — a replayed conditional insert would
                        # surface ALREADY_* for our own landed write and
                        # desync the seed dict from the model aggregate
                        err = StorageError(
                            f"redis connection lost mid-command (not replayed): {e}"
                        )
                        err.transient = False
                        raise err from e
                    if attempt + 1 < self.RETRY_ATTEMPTS:
                        await asyncio.sleep(self.RETRY_BASE_DELAY * (2**attempt))
            raise TransientStorageError(
                f"redis unreachable after {self.RETRY_ATTEMPTS} attempts: {last}"
            )

    def _drop_connection(self) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:  # lint: swallow-ok (best-effort socket teardown)
                pass
        self._reader = self._writer = None

    async def _connect_locked(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
        if self.db:
            await self._roundtrip((b"SELECT", str(self.db).encode()))

    async def _roundtrip(self, parts: tuple[bytes, ...]):
        assert self._writer is not None and self._reader is not None
        out = [b"*%d\r\n" % len(parts)]
        for p in parts:
            out.append(b"$%d\r\n%s\r\n" % (len(p), p))
        self._writer.write(b"".join(out))
        await self._writer.drain()
        return await self._read_reply()

    async def _read_reply(self):
        assert self._reader is not None
        line = await self._reader.readline()
        if not line:
            raise ConnectionError("redis connection closed")
        kind, rest = line[:1], line[1:-2]
        if kind == b"+":
            return rest
        if kind == b"-":
            raise StorageError(f"redis error: {rest.decode()}")
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = await self._reader.readexactly(n + 2)
            return data[:-2]
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [await self._read_reply() for _ in range(n)]
        raise StorageError(f"unexpected RESP reply type {kind!r}")


# --- Lua scripts (same validation logic as the reference's) ----------------

# KEYS[1]=sum_dict, ARGV[1]=pk, ARGV[2]=ephm_pk
ADD_SUM_PARTICIPANT = b"""
if redis.call("HSETNX", KEYS[1], ARGV[1], ARGV[2]) == 1 then
  return 1
end
return 0
"""

# KEYS[1]=sum_dict, KEYS[2]=update_participants, KEYS[3]=seed-dict key
# prefix (the tenant prefix + "seed_dict:" — built Lua-side so the per-sum
# hashes land under the SAME prefixed namespace seed_dict() reads and the
# prefix-scoped delete scans), ARGV[1]=update_pk, ARGV[2..]=alternating
# sum_pk, seed
ADD_LOCAL_SEED_DICT = b"""
local n_entries = (#ARGV - 1) / 2
if n_entries ~= redis.call("HLEN", KEYS[1]) then
  return -1
end
for i = 2, #ARGV, 2 do
  if redis.call("HEXISTS", KEYS[1], ARGV[i]) == 0 then
    return -2
  end
end
if redis.call("SISMEMBER", KEYS[2], ARGV[1]) == 1 then
  return -3
end
for i = 2, #ARGV, 2 do
  if redis.call("HEXISTS", KEYS[3] .. ARGV[i], ARGV[1]) == 1 then
    return -4
  end
end
for i = 2, #ARGV, 2 do
  redis.call("HSET", KEYS[3] .. ARGV[i], ARGV[1], ARGV[i + 1])
end
redis.call("SADD", KEYS[2], ARGV[1])
return 0
"""

# KEYS[1]=sum_dict, KEYS[2]=mask_submitted, KEYS[3]=mask_dict,
# ARGV[1]=pk, ARGV[2]=serialized mask
INCR_MASK_SCORE = b"""
if redis.call("HEXISTS", KEYS[1], ARGV[1]) == 0 then
  return -1
end
if redis.call("SISMEMBER", KEYS[2], ARGV[1]) == 1 then
  return -2
end
redis.call("SADD", KEYS[2], ARGV[1])
redis.call("ZINCRBY", KEYS[3], 1, ARGV[2])
return 0
"""

_K_STATE = b"coordinator_state"
_K_SUM_DICT = b"sum_dict"
_K_UPDATE_SET = b"update_participants"
_K_MASK_SUBMITTED = b"mask_submitted"
_K_MASK_DICT = b"mask_dict"
_K_LATEST_MODEL = b"latest_global_model_id"
_K_ROUND_CKPT = b"round_checkpoint"


class RedisCoordinatorStorage(CoordinatorStorage):
    """Coordinator storage over Redis with Lua-scripted atomicity."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379, db: int = 0,
                 key_prefix: str = ""):
        # `key_prefix` namespaces every round-state key (multi-tenant
        # coordinators share one redis db with per-tenant prefixes,
        # docs/DESIGN.md §19); "" keeps the historical flat keyspace
        self.client = RespClient(host, port, db)
        self._p = key_prefix.encode()

    def _k(self, key: bytes) -> bytes:
        return self._p + key

    async def set_coordinator_state(self, state: bytes) -> None:
        await self.client.command(b"SET", self._k(_K_STATE), state)

    async def coordinator_state(self) -> Optional[bytes]:
        return await self.client.command(b"GET", self._k(_K_STATE))

    async def add_sum_participant(self, pk: bytes, ephm_pk: bytes) -> Optional[SumPartAddError]:
        ok = await self.client.command(
            b"EVAL", ADD_SUM_PARTICIPANT, b"1", self._k(_K_SUM_DICT), pk, ephm_pk,
            replay_safe=False,
        )
        return None if ok == 1 else SumPartAddError.ALREADY_EXISTS

    async def sum_dict(self):
        flat = await self.client.command(b"HGETALL", self._k(_K_SUM_DICT))
        if not flat:
            return None
        return {flat[i]: flat[i + 1] for i in range(0, len(flat), 2)}

    async def add_local_seed_dict(
        self, update_pk: bytes, local_seed_dict
    ) -> Optional[LocalSeedDictAddError]:
        argv: list[bytes] = [update_pk]
        for sum_pk, seed in local_seed_dict.items():
            seed_bytes = seed.as_bytes() if isinstance(seed, EncryptedMaskSeed) else bytes(seed)
            argv += [sum_pk, seed_bytes]
        code = await self.client.command(
            b"EVAL", ADD_LOCAL_SEED_DICT, b"3",
            self._k(_K_SUM_DICT), self._k(_K_UPDATE_SET), self._k(b"seed_dict:"),
            *argv,
            replay_safe=False,
        )
        return {
            0: None,
            -1: LocalSeedDictAddError.LENGTH_MISMATCH,
            -2: LocalSeedDictAddError.UNKNOWN_SUM_PARTICIPANT,
            -3: LocalSeedDictAddError.UPDATE_PK_ALREADY_SUBMITTED,
            -4: LocalSeedDictAddError.UPDATE_PK_ALREADY_EXISTS_IN_UPDATE_SEED_DICT,
        }[int(code)]

    async def seed_dict(self):
        sums = await self.sum_dict()
        if not sums:
            return None
        out = {}
        for sum_pk in sums:
            flat = await self.client.command(b"HGETALL", self._k(b"seed_dict:") + sum_pk)
            out[sum_pk] = {
                flat[i]: EncryptedMaskSeed(flat[i + 1]) for i in range(0, len(flat), 2)
            }
        return out if any(out.values()) else None

    async def prune_update_participants(self, keep_pks) -> bool:
        # journal resume (docs/DESIGN.md §9): redis round state survives a
        # coordinator crash, so an update accepted between the last journal
        # write and the kill is still here — but its client never saw the
        # ack and will retry; dropping the orphan seeds + membership makes
        # that retry succeed instead of bouncing off ALREADY_SUBMITTED
        keep = set(keep_pks)
        members = await self.client.command(b"SMEMBERS", self._k(_K_UPDATE_SET)) or []
        orphans = [pk for pk in members if pk not in keep]
        if not orphans:
            return True
        sums = await self.client.command(b"HKEYS", self._k(_K_SUM_DICT)) or []
        for sum_pk in sums:
            await self.client.command(b"HDEL", self._k(b"seed_dict:") + sum_pk, *orphans)
        await self.client.command(b"SREM", self._k(_K_UPDATE_SET), *orphans)
        return True

    async def incr_mask_score(self, pk: bytes, mask: MaskObject) -> Optional[MaskScoreIncrError]:
        code = await self.client.command(
            b"EVAL",
            INCR_MASK_SCORE,
            b"3",
            self._k(_K_SUM_DICT),
            self._k(_K_MASK_SUBMITTED),
            self._k(_K_MASK_DICT),
            pk,
            serialize_mask_object(mask),
            replay_safe=False,
        )
        return {
            0: None,
            -1: MaskScoreIncrError.UNKNOWN_SUM_PK,
            -2: MaskScoreIncrError.MASK_ALREADY_SUBMITTED,
        }[int(code)]

    async def best_masks(self):
        reply = await self.client.command(
            b"ZREVRANGE", self._k(_K_MASK_DICT), b"0", b"1", b"WITHSCORES"
        )
        if not reply:
            return None
        out = []
        for i in range(0, len(reply), 2):
            mask, _ = parse_mask_object(reply[i])
            out.append((mask, int(float(reply[i + 1]))))
        return out

    async def number_of_unique_masks(self) -> int:
        return int(await self.client.command(b"ZCARD", self._k(_K_MASK_DICT)))

    async def delete_coordinator_data(self) -> None:
        if not self._p:
            await self.client.command(b"FLUSHDB")
            return
        # prefixed (multi-tenant) keyspaces: flush ONLY this tenant's keys
        # — FLUSHDB would wipe every other tenant sharing the db. Cursor
        # SCAN, not KEYS: a blocking full-keyspace walk would stall every
        # OTHER tenant's round operations on a shared production server
        cursor = b"0"
        while True:
            reply = await self.client.command(
                b"SCAN", cursor, b"MATCH", self._p + b"*", b"COUNT", b"500"
            )
            cursor, keys = reply[0], reply[1]
            if keys:
                await self.client.command(b"DEL", *keys)
            if cursor in (b"0", 0, "0"):
                break

    async def delete_dicts(self) -> None:
        sums = await self.client.command(b"HKEYS", self._k(_K_SUM_DICT)) or []
        keys = [self._k(_K_SUM_DICT), self._k(_K_UPDATE_SET), self._k(_K_MASK_SUBMITTED), self._k(_K_MASK_DICT)]
        keys += [self._k(b"seed_dict:") + pk for pk in sums]
        await self.client.command(b"DEL", *keys)

    async def set_latest_global_model_id(self, model_id: str) -> None:
        await self.client.command(b"SET", self._k(_K_LATEST_MODEL), model_id.encode())

    async def latest_global_model_id(self) -> Optional[str]:
        v = await self.client.command(b"GET", self._k(_K_LATEST_MODEL))
        return v.decode() if v is not None else None

    async def set_round_checkpoint(self, data: bytes) -> None:
        await self.client.command(b"SET", self._k(_K_ROUND_CKPT), data)

    async def round_checkpoint(self):
        return await self.client.command(b"GET", self._k(_K_ROUND_CKPT))

    async def delete_round_checkpoint(self) -> None:
        await self.client.command(b"DEL", self._k(_K_ROUND_CKPT))

    async def is_ready(self) -> None:
        pong = await self.client.command(b"PING")
        if pong != b"PONG":
            raise StorageError(f"unexpected PING reply {pong!r}")
