"""The port's Redis and S3 stores (``xaynet_tpu_torch.storage``) against the
JAX package's.

Redis: the same operations go to the JAX store, against the JAX tests'
``FakeRedis``, and to the port's store, against the same fake with the
port's Lua runner in its ``EVAL``. The replies and the fakes' strings,
hashes, sets and sorted sets after them must be identical, flat and under
a tenant prefix; ``best_masks`` must rank and break ties alike. The port's
client reconnects, backs off, and does not replay a conditional insert
whose reply was lost, as the JAX client does. S3: ``sign_v4`` equals the
JAX signer for fixed inputs, and the port's store runs its cycle against
the JAX tests' ``FakeS3`` (which checks every signature with the JAX
signer): bad credentials, the conditional-put race and an unreachable
endpoint give the same typed errors. Tolerance zero.
"""

from __future__ import annotations

import asyncio
import random

import pytest
from test_redis_storage import FakeRedis
from test_s3_storage import ACCESS, REGION, SECRET, FakeS3

from xaynet_tpu.core.mask import BoundType, DataType, GroupType, MaskConfig, ModelType
from xaynet_tpu.core.mask import MaskObject as JaxMaskObject
from xaynet_tpu.server import runner as jax_runner
from xaynet_tpu.server import settings as jax_settings
from xaynet_tpu.storage import s3 as jax_s3
from xaynet_tpu.storage.redis import RedisCoordinatorStorage as JaxRedisStorage

from xaynet_tpu_torch.core.mask import MaskObject as PortMaskObject
from xaynet_tpu_torch.core.mask.config import BoundType as PB, DataType as PD
from xaynet_tpu_torch.core.mask.config import GroupType as PG, MaskConfig as PortMaskConfig
from xaynet_tpu_torch.core.mask.config import ModelType as PM
from xaynet_tpu_torch.core.mask.serialization import serialize_mask_object
from xaynet_tpu_torch.core.mask.seed import EncryptedMaskSeed
from xaynet_tpu_torch.server import runner as port_runner
from xaynet_tpu_torch.server import settings as port_settings
from xaynet_tpu_torch.storage import RedisCoordinatorStorage, S3ModelStorage, sign_v4
from xaynet_tpu_torch.storage.traits import StorageError
from xaynet_tpu_torch.utils import lua_mini as port_lua

JAX_CFG = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)
PORT_CFG = PortMaskConfig(PG.PRIME, PD.F32, PB.B0, PM.M3)


class JaxFakeRedis(FakeRedis):
    """The JAX tests' fake RESP server, plus the commands a journal resume
    sends (``prune_update_participants``: SMEMBERS, HDEL, SREM)."""

    def _dispatch(self, parts):
        cmd = parts[0].upper()
        if cmd == b"SMEMBERS":
            return self._array(sorted(self.sets.get(parts[1], set())))
        if cmd == b"HDEL":
            h = self.hashes.get(parts[1], {})
            n = sum(h.pop(f, None) is not None for f in parts[2:])
            if not h:
                self.hashes.pop(parts[1], None)
            return self._int(n)
        if cmd == b"SREM":
            members = self.sets.get(parts[1], set())
            n = sum(m in members for m in parts[2:])
            members.difference_update(parts[2:])
            if not members:
                self.sets.pop(parts[1], None)
            return self._int(n)
        return super()._dispatch(parts)


class PortFakeRedis(JaxFakeRedis):
    """The same fake with the port's Lua runner in its ``EVAL``."""

    def _eval(self, script, parts):
        nkeys = int(parts[2])
        keys, argv = parts[3 : 3 + nkeys], parts[3 + nkeys :]
        try:
            result = port_lua.run_script(script, keys, argv, self._commands)
        except port_lua.LuaError as e:
            return b"-ERR Error running script: %s\r\n" % str(e).encode()
        return self._to_resp(result)


def _masks(seed: int, n: int = 4):
    """The same mask object in both packages."""
    rng = random.Random(seed)
    order = PORT_CFG.order
    ints = [rng.randrange(order) for _ in range(n + 1)]
    return (
        JaxMaskObject.new(JAX_CFG.pair(), ints[1:], ints[0]),
        PortMaskObject.new(PORT_CFG.pair(), ints[1:], ints[0]),
    )


def _plain(value):
    """A reply of either package as comparable plain values."""
    if value is None or isinstance(value, (bytes, int, str, bool)):
        return value
    if hasattr(value, "name") and hasattr(value, "value"):  # an error enum
        return value.name
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if hasattr(value, "as_bytes"):  # EncryptedMaskSeed
        return value.as_bytes()
    raise AssertionError(f"unexpected reply {value!r}")


async def _script(store, pkg: str):
    """One sequence of operations; returns every reply."""
    masks = [_masks(i)[0 if pkg == "jax" else 1] for i in range(1, 4)]
    s = [bytes([i]) * 32 for i in range(1, 5)]
    u = [bytes([0x40 + i]) * 32 for i in range(1, 4)]
    seed80 = bytes(range(80))
    out = []
    await store.set_coordinator_state(b"state-1")
    out.append(await store.coordinator_state())
    for pk in s:
        out.append(await store.add_sum_participant(pk, b"e" * 32))
    out.append(await store.add_sum_participant(s[0], b"x" * 32))
    out.append(await store.sum_dict())
    full = {pk: seed80 for pk in s}
    out.append(await store.add_local_seed_dict(u[0], {s[0]: seed80}))
    out.append(await store.add_local_seed_dict(u[0], {**full, b"zz" * 16: seed80}))
    out.append(await store.add_local_seed_dict(u[0], {**dict(list(full.items())[:3]),
                                                      b"zz" * 16: seed80}))  # fmt: skip
    for pk in u:
        out.append(await store.add_local_seed_dict(pk, full))
    out.append(await store.add_local_seed_dict(u[0], full))
    out.append(await store.seed_dict())
    out.append(await store.prune_update_participants(u[:2]))
    out.append(await store.seed_dict())
    out.append(await store.incr_mask_score(b"??" * 16, masks[0]))
    for pk, mask in zip(s, (masks[0], masks[1], masks[0], masks[2])):
        out.append(await store.incr_mask_score(pk, mask))
    out.append(await store.incr_mask_score(s[0], masks[1]))
    out.append(await store.number_of_unique_masks())
    out.append([(serialize(m), n) for m, n in await store.best_masks()])
    await store.set_latest_global_model_id("7_cafe")
    out.append(await store.latest_global_model_id())
    await store.set_round_checkpoint(b"\x00journal" * 1000)
    out.append(await store.round_checkpoint())
    return out


def serialize(mask) -> bytes:
    if isinstance(mask, PortMaskObject):
        return serialize_mask_object(mask)
    from xaynet_tpu.core.mask.serialization import serialize_mask_object as jax_serialize

    return jax_serialize(mask)


def _fake_state(fake: FakeRedis) -> tuple:
    return fake.strings, fake.hashes, fake.sets, fake.zsets


@pytest.mark.parametrize("prefix", ["", "t:alpha:"], ids=["flat", "tenant"])
@pytest.mark.parametrize("ending", ["kept", "delete-dicts", "delete-all"])
def test_same_operations_leave_identical_redis_state(prefix, ending):
    async def run(pkg: str):
        fake = JaxFakeRedis() if pkg == "jax" else PortFakeRedis()
        port = await fake.start()
        cls = JaxRedisStorage if pkg == "jax" else RedisCoordinatorStorage
        store = cls(port=port, key_prefix=prefix)
        try:
            replies = await _script(store, pkg)
            if ending == "delete-dicts":
                await store.delete_dicts()
                replies.append(await store.sum_dict())
            elif ending == "delete-all":
                await store.delete_round_checkpoint()
                await store.delete_coordinator_data()
                replies.append(await store.coordinator_state())
            return [_plain(r) for r in replies], _fake_state(fake)
        finally:
            await store.client.close()
            await fake.stop()

    ours, ours_state = asyncio.run(run("port"))
    theirs, their_state = asyncio.run(run("jax"))
    assert ours == theirs
    assert ours_state == their_state
    keys = {k for space in ours_state for k in space}
    assert bool(keys) == (ending != "delete-all")
    assert all(k.startswith(prefix.encode()) for k in keys)


@pytest.mark.parametrize("votes", [(3, 1, 1), (1, 1, 1), (2, 2, 1), (1, 2, 3)],
                         ids=["leader-tie", "three-way-tie", "top-tie", "ascending"])
def test_best_masks_rank_and_break_ties_alike(votes):
    async def run(pkg: str):
        fake = JaxFakeRedis() if pkg == "jax" else PortFakeRedis()
        port = await fake.start()
        store = (JaxRedisStorage if pkg == "jax" else RedisCoordinatorStorage)(port=port)
        try:
            pks = [bytes([i]) * 32 for i in range(1, sum(votes) + 1)]
            for pk in pks:
                assert await store.add_sum_participant(pk, b"e" * 32) is None
            it = iter(pks)
            for seed, n in enumerate(votes, start=1):
                mask = _masks(seed)[0 if pkg == "jax" else 1]
                for _ in range(n):
                    assert await store.incr_mask_score(next(it), mask) is None
            return [(serialize(m), n) for m, n in await store.best_masks()]
        finally:
            await store.client.close()
            await fake.stop()

    ours, theirs = asyncio.run(run("port")), asyncio.run(run("jax"))
    assert ours == theirs
    assert len(ours) == 2 and ours[0][1] == max(votes)


async def _reconnect(fake, port, store):
    await store.set_coordinator_state(b"before-crash")
    await fake.stop()
    await fake.start(port)  # state survives, as with AOF persistence
    assert await store.coordinator_state() == b"before-crash"
    await store.set_coordinator_state(b"after-restart")
    assert await store.coordinator_state() == b"after-restart"


async def _backoff(fake, port, store):
    await store.set_coordinator_state(b"x")
    await fake.stop()

    async def resurrect():
        await asyncio.sleep(0.12)  # within the backoff budget
        await fake.start(port)

    task = asyncio.create_task(resurrect())
    assert await store.coordinator_state() == b"x"
    await task


async def _lost_reply(fake, port, store):
    await store.set_coordinator_state(b"x")
    fake.kill_next_eval_reply = True
    with pytest.raises(StorageError, match="not replayed") as err:
        await store.add_sum_participant(b"s1" * 16, b"e1" * 16)
    assert err.value.transient is False
    assert (b"s1" * 16) in fake.hashes.get(b"sum_dict", {})  # the write landed
    assert await store.coordinator_state() == b"x"  # and the client recovers


async def _unreachable(fake, port, store):
    await fake.stop()
    with pytest.raises(StorageError, match="unreachable"):
        await store.is_ready()
    await fake.start(port)


CLIENT_CASES = {"reconnect": _reconnect, "backoff": _backoff, "lost-reply": _lost_reply,
                "unreachable": _unreachable}  # fmt: skip


@pytest.mark.parametrize("case", list(CLIENT_CASES))
def test_port_client_reconnects_and_never_replays_a_conditional_insert(case):
    async def run():
        fake = PortFakeRedis()
        port = await fake.start()
        store = RedisCoordinatorStorage(port=port)
        store.client.RETRY_BASE_DELAY = 0.05 if case == "backoff" else 0.01
        try:
            await CLIENT_CASES[case](fake, port, store)
        finally:
            await store.client.close()
            await fake.stop()

    asyncio.run(run())


@pytest.mark.parametrize("tenant", ["default", "alpha"])
def test_runner_scopes_tenant_keys_as_the_jax_runner(tenant):
    """``init_store`` builds the Redis store with the JAX runner's key
    prefix (``t:<tenant>:``, none for the default tenant) and the S3 store
    with the same endpoint, bucket and credentials."""

    def settings(mod):
        s = mod.Settings.default()
        s.storage.coordinator, s.storage.backend = "redis", "s3"
        s.storage.redis_port, s.storage.redis_db = 6390, 2
        s.storage.s3_endpoint, s.storage.s3_bucket = "http://127.0.0.1:9100", "models"
        s.storage.s3_access_key, s.storage.s3_secret_key = ACCESS, SECRET
        return s

    ours = port_runner.init_store(settings(port_settings), tenant)
    theirs = jax_runner.init_store(settings(jax_settings), tenant)
    assert isinstance(ours.coordinator, RedisCoordinatorStorage)
    assert isinstance(ours.models, S3ModelStorage)
    assert ours.coordinator._p == theirs.coordinator._p
    assert (ours.coordinator.client.port, ours.coordinator.client.db) == (6390, 2)
    assert ours.models.__dict__ == theirs.models.__dict__


SIGNED = {
    "put-object": ("PUT", "127.0.0.1:9000", "/global-models/7_" + "ab" * 32,
                   "3f" * 32, "20261018T092247Z", "us-east-1"),
    "head-bucket": ("HEAD", "minio:9000", "/global-models", jax_s3._EMPTY_SHA256,
                    "20250101T000000Z", "eu-central-1"),
    "get-quoted-path": ("GET", "s3.example.com", "/bucket/a key+x", jax_s3._EMPTY_SHA256,
                        "20240229T235959Z", "us-west-2"),
}  # fmt: skip


@pytest.mark.parametrize("case", list(SIGNED))
def test_sign_v4_equals_the_jax_signer(case):
    method, host, path, payload, date, region = SIGNED[case]
    kw = dict(access_key=ACCESS, secret_key=SECRET, region=region, payload_hash=payload,
              amz_date=date)  # fmt: skip
    assert sign_v4(method, host, path, **kw) == jax_s3.sign_v4(method, host, path, **kw)


async def _s3_cycle(fake, store):
    with pytest.raises(StorageError):
        await store.is_ready()  # no bucket yet
    await store.create_bucket()
    await store.create_bucket()  # 409 already-owned is not an error
    await store.is_ready()
    seed = b"\x5a" * 32
    model_id = await store.set_global_model(7, seed, b"model-bytes-7")
    assert model_id == f"7_{seed.hex()}" == jax_s3.S3ModelStorage.create_global_model_id(7, seed)
    assert await store.global_model(model_id) == b"model-bytes-7"
    assert await store.global_model("0_" + "00" * 32) is None
    with pytest.raises(StorageError, match="already exists"):
        await store.set_global_model(7, seed, b"other-bytes")
    assert fake.buckets[store.bucket] == {model_id: b"model-bytes-7"}


async def _s3_bad_credentials(fake, store):
    store.secret_key = "wrong-secret"
    with pytest.raises(StorageError, match="403|failed"):
        await store.create_bucket()
    assert fake.buckets == {}


async def _s3_race(fake, store):
    await store.create_bucket()
    seed = b"\x11" * 32
    await store.set_global_model(3, seed, b"first")
    model_id = store.create_global_model_id(3, seed)
    # the racing writer: no HEAD, the conditional PUT straight away
    resp = await store._request(
        "PUT", f"/{store.bucket}/{model_id}", b"second", {"if-none-match": "*"}
    )
    assert resp.status == 412
    assert await store.global_model(model_id) == b"first"


async def _s3_unreachable(fake, store):
    await fake.stop()
    with pytest.raises(StorageError, match="unreachable") as err:
        await store.is_ready()
    assert err.value.transient is True


S3_CASES = {"cycle": _s3_cycle, "bad-credentials": _s3_bad_credentials, "race": _s3_race,
            "unreachable": _s3_unreachable}  # fmt: skip


@pytest.mark.parametrize("case", list(S3_CASES))
def test_port_s3_store_against_the_signature_checking_fake(case):
    async def run():
        fake = FakeS3()
        port = await fake.start()
        store = S3ModelStorage(endpoint=f"http://127.0.0.1:{port}", bucket="global-models",
                               access_key=ACCESS, secret_key=SECRET, region=REGION)  # fmt: skip
        try:
            await S3_CASES[case](fake, store)
        finally:
            if case != "unreachable":
                await fake.stop()

    asyncio.run(run())


def test_seed_dict_round_trips_encrypted_seeds():
    """Seeds come back as the port's ``EncryptedMaskSeed``, byte for byte."""

    async def run():
        fake = PortFakeRedis()
        port = await fake.start()
        store = RedisCoordinatorStorage(port=port)
        try:
            seed = EncryptedMaskSeed(bytes(range(80)))
            assert await store.add_sum_participant(b"s" * 32, b"e" * 32) is None
            assert await store.add_local_seed_dict(b"u" * 32, {b"s" * 32: seed}) is None
            got = (await store.seed_dict())[b"s" * 32][b"u" * 32]
            assert isinstance(got, EncryptedMaskSeed) and got.as_bytes() == seed.as_bytes()
        finally:
            await store.client.close()
            await fake.stop()

    asyncio.run(run())
