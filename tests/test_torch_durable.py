"""The durable coordinator on the port: Redis and S3 stores, kill -9 and
resume.

A round runs with ``coordinator = "redis"``, ``backend = "s3"``, the round
journal (``[resilience] checkpoint_enabled``, one entry per fold at batch
1) and ``[restore] enable``, against the JAX tests' fake Redis (the port's
Lua runner in its ``EVAL``) and their SigV4-checking fake S3, both in this
process. The port's coordinator is the CLI a user runs, ``python -m
xaynet_tpu_torch.server.runner -c <cfg> --device cpu``, in a subprocess;
the JAX one runs in-process, where cancelling its machine with no journal
flush stands in for a crash. The JAX SDK's participants (one sum, three
updates) keep their state across the gap.

- **kill-in-update**: SIGKILL once the journal holds two of the three
  updates; the same command resumes the Update phase, the third update and
  the Sum2 finish the round.
- **kill-in-sum2**: SIGKILL once ``/healthz`` says ``sum2`` and the journal
  holds the entry tagged ``sum2``; the resumed coordinator uploads the
  journaled accumulator (read back byte-identical: its log line's sha256
  is the journal's) and the sum participant's Sum2 finishes the round.
- **jax-journal-to-port** / **port-journal-to-jax**: the journal one
  package wrote into Redis resumes Sum2 in the other.

Each resumed round keeps its id and seed, never logs "not resumable", and
publishes a model byte-identical to an uninterrupted round's
(**uninterrupted**) and to the JAX coordinator's in-memory round, stored in
S3 under ``{round_id}_{hex(seed)}``; a second conditional put of that id is
refused. The resumed port coordinator stops on SIGTERM with exit 0.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
from test_s3_storage import ACCESS, REGION, SECRET, FakeS3
from test_torch_coordinator import (
    LOCALS,
    N_SUM,
    N_UPDATE,
    REPO,
    SUM_PROB,
    UPDATE_PROB,
    ArrayModelStore,
    _drive,
    _free_port,
    _jax_round,
    _participants,
    _wait_for_phase,
)
from test_torch_storage import PortFakeRedis

from xaynet_tpu.sdk.client import HttpClient, InProcessClient
from xaynet_tpu.sdk.state_machine import StateMachine as ParticipantSM
from xaynet_tpu.server import settings as jax_settings
from xaynet_tpu.server.services import Fetcher as JaxFetcher
from xaynet_tpu.server.services import PetMessageHandler as JaxHandler
from xaynet_tpu.server.state_machine import StateMachineInitializer as JaxInitializer
from xaynet_tpu.storage.memory import NoOpTrustAnchor as JaxAnchor
from xaynet_tpu.storage.redis import RedisCoordinatorStorage as JaxRedis
from xaynet_tpu.storage.s3 import S3ModelStorage as JaxS3
from xaynet_tpu.storage.traits import Store as JaxStore

from xaynet_tpu_torch.resilience.checkpoint import RoundCheckpoint
from xaynet_tpu_torch.storage import S3ModelStorage
from xaynet_tpu_torch.storage.traits import StorageError

MODEL_LEN = 600
BUCKET = "global-models"

CONFIG = """
[api]
bind_address = "127.0.0.1:{api_port}"
[pet.sum]
prob = {sum_prob}
[pet.sum.count]
min = {n_sum}
max = {n_sum}
[pet.sum.time]
min = 0.0
max = 60.0
[pet.update]
prob = {update_prob}
[pet.update.count]
min = {n_update}
max = {n_update}
[pet.update.time]
min = 0.0
max = 60.0
[pet.sum2.count]
min = {n_sum}
max = {n_sum}
[pet.sum2.time]
min = 0.0
max = 60.0
[model]
length = {length}
[aggregation]
batch_size = 1
[storage]
coordinator = "redis"
redis_port = {redis_port}
backend = "s3"
s3_endpoint = "http://127.0.0.1:{s3_port}"
s3_bucket = "{bucket}"
s3_access_key = "{access}"
s3_secret_key = "{secret}"
s3_region = "{region}"
[restore]
enable = true
[resilience]
checkpoint_enabled = true
checkpoint_every_batches = 1
retry_base_ms = 1.0
retry_max_ms = 20.0
[log]
filter = "info"
"""


class PortProcess:
    """The port's coordinator CLI in a subprocess, on the CPU."""

    kind = "port"

    def __init__(self, cfg: str, api_port: int, log_path: str):
        self.url = f"http://127.0.0.1:{api_port}"
        self.log_path = log_path
        env = dict(os.environ, OMP_NUM_THREADS="2")
        with open(log_path, "a") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "xaynet_tpu_torch.server.runner", "-c", cfg,
                 "--device", "cpu"],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
            )  # fmt: skip

    async def phase(self, want: str) -> int:
        """Waits for phase ``want``; returns the round id."""
        return (await _wait_for_phase(self.url, want, timeout=60.0))["round_id"]

    def client(self):
        return HttpClient(self.url)

    async def model(self):
        return await HttpClient(self.url).get_model()

    async def seed(self) -> bytes:
        return (await HttpClient(self.url).get_round_params()).seed.as_bytes()

    async def crash(self) -> None:
        self.proc.kill()
        await self._exit(10.0)

    async def stop(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        return await self._exit(30.0)

    async def _exit(self, timeout: float) -> int:
        deadline = time.monotonic() + timeout
        while self.proc.poll() is None:
            if time.monotonic() > deadline:
                self.proc.kill()
                raise TimeoutError("the coordinator did not exit")
            await asyncio.sleep(0.05)
        return self.proc.returncode

    def log(self) -> str:
        with open(self.log_path) as f:
            return f.read()


class JaxInProcess:
    """The JAX coordinator in this process on the Redis and S3 fakes."""

    kind = "jax"

    async def start(self, cfg: str) -> "JaxInProcess":
        settings = jax_settings.Settings.load(cfg, env={})
        st = settings.storage
        self.store = JaxStore(
            JaxRedis(port=st.redis_port),
            JaxS3(st.s3_endpoint, st.s3_bucket, st.s3_access_key, st.s3_secret_key,
                  st.s3_region),
            JaxAnchor(),
        )  # fmt: skip
        await self.store.models.create_bucket()
        machine, request_tx, events = await JaxInitializer(settings, self.store).init()
        self.handler, self.fetcher = JaxHandler(events, request_tx), JaxFetcher(events)
        self.task = asyncio.create_task(machine.run())
        return self

    async def phase(self, want: str) -> int:
        for _ in range(6000):
            if self.fetcher.phase().value == want:
                return self.fetcher.events.params.get_latest().round_id
            await asyncio.sleep(0.01)
        raise TimeoutError(f"the JAX coordinator never reached {want!r}")

    def client(self):
        return InProcessClient(self.fetcher, self.handler)

    async def model(self):
        return self.fetcher.model()

    async def seed(self) -> bytes:
        return self.fetcher.round_params().seed.as_bytes()

    async def crash(self) -> None:
        # no journal flush: the machine stops where it is, its socket drops
        self.task.cancel()
        await asyncio.gather(self.task, return_exceptions=True)
        await self.store.coordinator.client.close()

    async def stop(self) -> int:
        await self.crash()
        return 0


def _journal(fake) -> RoundCheckpoint | None:
    blob = fake.strings.get(b"round_checkpoint")
    return None if blob is None else RoundCheckpoint.from_bytes(blob)


async def _until(pred, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        await asyncio.sleep(0.02)
    raise TimeoutError(what)


def _rebind(sm, client, store):
    """The same participant state on another coordinator's client."""
    return ParticipantSM.restore(sm.save(), client, store)


# writer, phase to kill in (None: no kill), resumer
CASES = {
    "uninterrupted": ("port", None, None),
    "kill-in-update": ("port", "update", "port"),
    "kill-in-sum2": ("port", "sum2", "port"),
    "jax-journal-to-port": ("jax", "sum2", "port"),
    "port-journal-to-jax": ("port", "sum2", "jax"),
}


@pytest.fixture(scope="module")
def jax_model() -> np.ndarray:
    return np.asarray(asyncio.run(asyncio.wait_for(_jax_round(), timeout=120)))


@pytest.mark.parametrize("case", list(CASES))
def test_durable_round_resumes_with_the_same_model(case, tmp_path, jax_model):
    writer, kill_in, resumer = CASES[case]

    async def run():
        redis, s3 = PortFakeRedis(), FakeS3()
        redis_port, s3_port = await redis.start(), await s3.start()
        api_port = _free_port()
        cfg = tmp_path / "config.toml"
        cfg.write_text(CONFIG.format(
            api_port=api_port, redis_port=redis_port, s3_port=s3_port, bucket=BUCKET,
            access=ACCESS, secret=SECRET, region=REGION, length=MODEL_LEN, n_sum=N_SUM,
            n_update=N_UPDATE, sum_prob=SUM_PROB, update_prob=UPDATE_PROB,
        ))  # fmt: skip
        log = str(tmp_path / "coordinator.log")
        procs = []

        async def start(kind):
            coord = PortProcess(str(cfg), api_port, log) if kind == "port" else None
            coord = coord or await JaxInProcess().start(str(cfg))
            procs.append(coord)
            return coord

        try:
            first = await start(writer)
            round_id = await first.phase("sum")
            seed = await first.seed()
            summer, *updaters = _participants(seed, first.client)

            async def summed():
                return summer.phase.value == "sum2"

            assert await _drive(summer, summed)
            await first.phase("update")
            sent = 2 if kill_in == "update" else N_UPDATE
            for sm in updaters[:sent]:
                async def awaiting(sm=sm):
                    return sm.phase.value == "awaiting"

                assert await _drive(sm, awaiting)
            journaled = None
            if kill_in == "update":
                await _until(lambda: (j := _journal(redis)) is not None and j.phase == "update"
                             and j.nb_models == 2, "no update entry with 2 models")  # fmt: skip
            elif kill_in == "sum2":
                await first.phase("sum2")
                await _until(lambda: (j := _journal(redis)) is not None and j.phase == "sum2",
                             "no journal entry tagged sum2")  # fmt: skip
            if kill_in is not None:
                journaled = _journal(redis)
                await first.crash()
                second = await start(resumer)
                # resumed in the journaled phase of the same round, not at Idle
                assert await second.phase(kill_in) == round_id == journaled.round_id
                if second.kind == "jax" or first.kind == "jax":
                    summer = _rebind(summer, second.client(), ArrayModelStore(None))
                    updaters = [_rebind(sm, second.client(), ArrayModelStore(local))
                                for sm, local in zip(updaters, LOCALS)]  # fmt: skip
            else:
                second = first
            assert await second.seed() == seed

            async def done():
                return (await second.model()) is not None

            rest = [summer] + updaters[sent:]
            assert all(await asyncio.gather(*(_drive(sm, done) for sm in rest)))
            model = np.asarray(await second.model(), dtype=np.float64)

            # the model in S3 under the round's canonical id, and no overwrite
            model_id = (redis.strings[b"latest_global_model_id"]).decode()
            assert model_id.endswith("_" + seed.hex())
            assert s3.buckets[BUCKET][model_id] == model.tobytes()
            store = S3ModelStorage(f"http://127.0.0.1:{s3_port}", BUCKET, ACCESS, SECRET,
                                   REGION)  # fmt: skip
            assert await store.global_model(model_id) == model.tobytes()
            assert model_id == f"{round_id}_{seed.hex()}"
            with pytest.raises(StorageError, match="already exists"):
                await store.set_global_model(round_id, seed, model.tobytes())

            rc = await second.stop()
            return model, journaled, rc, procs
        finally:
            for coord in procs:
                if coord.kind == "port" and coord.proc.poll() is None:
                    coord.proc.kill()
            await redis.stop()
            await s3.stop()

    model, journaled, rc, procs = asyncio.run(asyncio.wait_for(run(), timeout=240))
    assert model.shape == (MODEL_LEN,)
    assert np.array_equal(model, jax_model)
    port_logs = [c.log() for c in procs if c.kind == "port"]
    assert port_logs and not any("not resumable" in text for text in port_logs)
    if procs[-1].kind == "port":
        assert rc == 0 and "coordinator stopped" in port_logs[-1]
    if kill_in is not None and resumer == "port":
        text = port_logs[-1]
        assert f"resuming round {journaled.round_id} {journaled.phase} phase" in text
        digest = hashlib.sha256(
            np.ascontiguousarray(journaled.wire_vect(), dtype=np.uint32)
        ).hexdigest()
        assert f"read back byte-identical (sha256 {digest})" in text
