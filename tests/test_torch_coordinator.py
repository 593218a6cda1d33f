"""The port's coordinator (``xaynet_tpu_torch.server``) against the JAX one.

A PET round runs over the real socket through the port's ``serve(...,
device="cpu")`` and ``RestServer``, driven by the JAX package's SDK
participants (``ParticipantSM`` + ``HttpClient``); the same local models and
scalars go through the JAX coordinator in-process (its REST server hangs in
``stop()`` on Python 3.12, see ``test_rest_server_stops_with_keep_alive_open``).
The masks cancel, so the global models must be byte-identical whatever the
round seeds, and both within 1e-9 of the mean. Small sizes: model length
600, one sum and three update participants.

Also: a journal the JAX coordinator wrote mid-update resumes in the port's
coordinator; the port's REST server stops promptly with a keep-alive
connection open; the port's settings refuse what it does not have and read
the shipped config as the JAX package's do.
"""

from __future__ import annotations

import asyncio
import socket
import time
from fractions import Fraction
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from xaynet_tpu.sdk.client import HttpClient, InProcessClient
from xaynet_tpu.sdk.simulation import keys_for_task
from xaynet_tpu.sdk.state_machine import PetSettings as ParticipantSettings
from xaynet_tpu.sdk.state_machine import StateMachine as ParticipantSM
from xaynet_tpu.sdk.traits import ModelStore
from xaynet_tpu.server import settings as jax_settings
from xaynet_tpu.server.services import Fetcher as JaxFetcher
from xaynet_tpu.server.services import PetMessageHandler as JaxHandler
from xaynet_tpu.server.state_machine import StateMachineInitializer as JaxInitializer
from xaynet_tpu.storage.memory import FileCoordinatorStorage as JaxFileStorage
from xaynet_tpu.storage.memory import InMemoryCoordinatorStorage as JaxMemStorage
from xaynet_tpu.storage.memory import InMemoryModelStorage as JaxModels
from xaynet_tpu.storage.memory import NoOpTrustAnchor as JaxAnchor
from xaynet_tpu.storage.traits import Store as JaxStore
from xaynet_tpu.resilience import checkpoint as jax_ckpt

from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator
from xaynet_tpu_torch.server import runner
from xaynet_tpu_torch.server.aggregation import StagedAggregator, build_staged_aggregator
from xaynet_tpu_torch.server import settings as port_settings
from xaynet_tpu_torch.server.rest import RestServer

REPO = Path(__file__).resolve().parents[1]
N_SUM, N_UPDATE, MODEL_LEN = 1, 3, 600
SUM_PROB, UPDATE_PROB = 0.4, 0.5
LOCALS = np.random.default_rng(11).uniform(-1, 1, (N_UPDATE, MODEL_LEN)).astype(np.float32)
MEAN = LOCALS.astype(np.float64).sum(axis=0) / N_UPDATE


class ArrayModelStore(ModelStore):
    def __init__(self, model):
        self.model = model

    async def load_model(self):
        return self.model


def _settings(mod, **aggregation):
    """Round settings of either package (``mod`` is its ``settings``
    module): count windows with min = max, so each phase closes on its
    last message."""

    def phase(n, prob):
        return mod.PhaseSettings(
            prob=prob, count=mod.CountSettings(n, n), time=mod.TimeSettings(0.0, 60.0)
        )

    s = mod.Settings(
        pet=mod.PetSettings(
            sum=phase(N_SUM, SUM_PROB),
            update=phase(N_UPDATE, UPDATE_PROB),
            sum2=mod.Sum2Settings(
                count=mod.CountSettings(N_SUM, N_SUM), time=mod.TimeSettings(0.0, 60.0)
            ),
        )
    )
    s.model.length = MODEL_LEN
    s.resilience.retry_base_ms = 1.0
    s.resilience.retry_max_ms = 20.0
    for key, value in aggregation.items():
        setattr(s.aggregation, key, value)
    return s


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _participants(seed, client_for, max_message_size=None, skip_updates=0):
    """One sum and the update participants (from ``skip_updates`` on), with
    the shared local models; ``client_for()`` makes each one's client."""
    out = []
    for i in range(N_SUM):
        keys = keys_for_task(seed, SUM_PROB, UPDATE_PROB, "sum", start=i * 1000)
        out.append(ParticipantSM(
            ParticipantSettings(keys=keys, max_message_size=max_message_size),
            client_for(), ArrayModelStore(None),
        ))  # fmt: skip
    for i in range(skip_updates, N_UPDATE):
        keys = keys_for_task(seed, SUM_PROB, UPDATE_PROB, "update", start=(20 + i) * 1000)
        out.append(ParticipantSM(
            ParticipantSettings(keys=keys, scalar=Fraction(1, N_UPDATE),
                                max_message_size=max_message_size),
            client_for(), ArrayModelStore(LOCALS[i]),
        ))  # fmt: skip
    return out


async def _drive(sm, done, steps=1000):
    for _ in range(steps):
        try:
            await sm.transition()
        except Exception:  # the SDK retries on its next tick
            pass
        if await done():
            return True
        await asyncio.sleep(0.01)
    return False


# --------------------------------------------------------------------------
# the JAX coordinator: in-process, as tests/test_round.py drives it
# --------------------------------------------------------------------------


async def _jax_round() -> np.ndarray:
    settings = _settings(jax_settings)
    store = JaxStore(JaxMemStorage(), JaxModels(), JaxAnchor())
    machine, request_tx, events = await JaxInitializer(settings, store).init()
    handler, fetcher = JaxHandler(events, request_tx), JaxFetcher(events)
    task = asyncio.create_task(machine.run())
    try:
        while fetcher.phase().value != "sum":
            await asyncio.sleep(0.01)
        seed = fetcher.round_params().seed.as_bytes()
        sms = _participants(seed, lambda: InProcessClient(fetcher, handler))

        async def done():
            return fetcher.model() is not None

        assert all(await asyncio.gather(*(_drive(sm, done) for sm in sms)))
        return np.asarray(fetcher.model())
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)


@pytest.fixture(scope="module")
def jax_model() -> np.ndarray:
    model = asyncio.run(asyncio.wait_for(_jax_round(), timeout=120))
    np.testing.assert_allclose(model, MEAN, atol=1e-9)
    return model


# --------------------------------------------------------------------------
# the port's coordinator: serve() over the socket
# --------------------------------------------------------------------------


async def _wait_for_phase(url: str, want: str, timeout: float = 30.0) -> dict:
    import json

    host, port = url.rsplit("/", 1)[-1].split(":")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            reader, writer = await asyncio.open_connection(host, int(port))
            writer.write(b"GET /healthz HTTP/1.1\r\nConnection: close\r\n\r\n")
            await writer.drain()
            raw = await reader.read()
            writer.close()
            body = json.loads(raw.split(b"\r\n\r\n", 1)[1])
            if body["phase"] == want:
                return body
        except (OSError, ValueError, IndexError):
            pass
        await asyncio.sleep(0.02)
    raise TimeoutError(f"coordinator never reached phase {want!r}")


async def _port_round(settings, max_message_size=None, skip_updates=0, before=None):
    """Serve ``settings`` on a free port with ``device="cpu"``, run one round
    with the SDK participants over HTTP and return the global model."""
    port = _free_port()
    settings.api.bind_address = f"127.0.0.1:{port}"
    url = f"http://127.0.0.1:{port}"
    server = asyncio.create_task(runner.serve(settings, device="cpu"))
    try:
        await _wait_for_phase(url, before or "sum")
        probe = HttpClient(url)
        params = await probe.get_round_params()
        sms = _participants(params.seed.as_bytes(), lambda: HttpClient(url),
                            max_message_size, skip_updates)  # fmt: skip

        async def done():
            return (await probe.get_model()) is not None

        assert all(await asyncio.gather(*(_drive(sm, done) for sm in sms)))
        return np.asarray(await probe.get_model())
    finally:
        server.cancel()
        await asyncio.wait_for(server, timeout=10)


ROUNDS = {
    "device": dict(device=True),
    "device-wire-ingest": dict(device=True, wire_ingest=True),
    "device-multipart": dict(device=True, multipart=True),
    "device-wire-ingest-multipart": dict(device=True, wire_ingest=True, multipart=True),
    # [aggregation] device = false picks the JAX package's host fold; the
    # port folds through the same pipeline on the device it was given
    "host": dict(device=False),
    "host-multipart": dict(device=False, multipart=True),
}


@pytest.mark.parametrize("case", list(ROUNDS))
def test_port_round_over_socket_matches_jax_coordinator(case, jax_model, monkeypatch):
    spec = dict(ROUNDS[case])
    multipart = spec.pop("multipart", False)
    settings = _settings(port_settings, batch_size=2, **spec)
    calls = {"wire": 0}
    real = DeviceAggregator.validate_wire_updates

    def counted(self, blocks):
        calls["wire"] += len(blocks)
        return real(self, blocks)

    monkeypatch.setattr(DeviceAggregator, "validate_wire_updates", counted)
    folded_by = set()
    real_flush = StagedAggregator.flush

    def flush(self):
        folded_by.add(self.kernel_used)
        return real_flush(self)

    monkeypatch.setattr(StagedAggregator, "flush", flush)
    model = asyncio.run(asyncio.wait_for(
        _port_round(settings, max_message_size=1024 if multipart else None), timeout=120
    ))  # fmt: skip
    assert model.shape == (MODEL_LEN,)
    assert np.array_equal(model, jax_model)
    np.testing.assert_allclose(model, MEAN, atol=1e-9)
    # with wire ingest every update was validated on the device path, from
    # its lazily parsed wire block (multipart: through the stream parser)
    assert calls["wire"] == (N_UPDATE if spec.get("wire_ingest") else 0)
    # every round folds through the port's pipeline, on the CPU device the
    # test passed (the plain versions), whatever [aggregation] device says
    assert folded_by == {"plain"}


def test_pipeline_depths_reach_the_round_aggregator():
    """``[aggregation] dispatch_ahead`` and ``staging_buffers`` size the
    round's streaming pipeline, as they size the JAX package's."""
    settings = _settings(port_settings, dispatch_ahead=3, staging_buffers=5, batch_size=4)
    settings.validate()
    round_params = SimpleNamespace(
        mask_config=settings.mask.to_config().pair(), model_length=MODEL_LEN
    )
    shared = SimpleNamespace(
        settings=settings, device="cpu", tenant="default",
        state=SimpleNamespace(round_params=round_params),
    )
    agg = build_staged_aggregator(shared)
    stream = agg._stream
    assert (stream.dispatch_ahead, stream.staging_buffers, stream.max_batch) == (3, 5, 4)
    stream.close()


def test_jax_journal_resumes_in_port_coordinator(tmp_path, jax_model):
    """The JAX coordinator journals two of three updates and stops; the
    port's coordinator, pointed at the same file store, resumes the update
    phase with them and finishes the round with the JAX model."""

    def with_journal(s):
        s.restore.enable = True
        s.resilience.checkpoint_enabled = True
        s.resilience.checkpoint_every_batches = 1
        s.aggregation.batch_size = 1
        s.storage.coordinator = "file"
        s.storage.model_dir = str(tmp_path)
        return s

    state_file = str(tmp_path / "coordinator_state.json")
    blobs = {}

    async def jax_half():
        settings = with_journal(_settings(jax_settings))
        store = JaxStore(JaxFileStorage(state_file), JaxModels(), JaxAnchor())
        machine, request_tx, events = await JaxInitializer(settings, store).init()
        handler, fetcher = JaxHandler(events, request_tx), JaxFetcher(events)
        task = asyncio.create_task(machine.run())
        try:
            while fetcher.phase().value != "sum":
                await asyncio.sleep(0.01)
            seed = fetcher.round_params().seed.as_bytes()
            summer, *updaters = _participants(seed, lambda: InProcessClient(fetcher, handler))

            async def summed():
                return summer.phase.value == "sum2"

            assert await _drive(summer, summed)
            while fetcher.phase().value != "update":
                await asyncio.sleep(0.01)
            for sm in updaters[:2]:
                async def sent(sm=sm):
                    return sm.phase.value == "awaiting"

                assert await _drive(sm, sent)

            async def journaled():
                blob = await store.coordinator.round_checkpoint()
                return blob is not None and jax_ckpt.RoundCheckpoint.from_bytes(blob).nb_models == 2

            for _ in range(500):
                if await journaled():
                    break
                await asyncio.sleep(0.01)
            assert await journaled()
            blobs["summer"] = summer.save()
            return seed
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)

    async def port_half(seed):
        settings = with_journal(_settings(port_settings, device=True))
        port = _free_port()
        settings.api.bind_address = f"127.0.0.1:{port}"
        url = f"http://127.0.0.1:{port}"
        server = asyncio.create_task(runner.serve(settings, device="cpu"))
        try:
            await _wait_for_phase(url, "update")
            probe = HttpClient(url)
            assert (await probe.get_round_params()).seed.as_bytes() == seed  # same round
            summer = ParticipantSM.restore(blobs["summer"], HttpClient(url), ArrayModelStore(None))
            last = _participants(seed, lambda: HttpClient(url), skip_updates=2)[-1]

            async def done():
                return (await probe.get_model()) is not None

            assert all(await asyncio.gather(_drive(summer, done), _drive(last, done)))
            return np.asarray(await probe.get_model())
        finally:
            server.cancel()
            await asyncio.wait_for(server, timeout=10)

    seed = asyncio.run(asyncio.wait_for(jax_half(), timeout=120))
    model = asyncio.run(asyncio.wait_for(port_half(seed), timeout=120))
    assert np.array_equal(model, jax_model)


def test_rest_server_stops_with_keep_alive_open():
    """``stop()`` closes the open connections before it waits for the
    listener: a participant's idle keep-alive connection must not hold it
    for ``read_timeout`` (120 s)."""

    async def run():
        rest = RestServer(fetcher=None, handler=None)
        host, port = await rest.start("127.0.0.1", 0)
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(b"GET /nowhere HTTP/1.1\r\nConnection: keep-alive\r\n\r\n")
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 404") and b"keep-alive" in head
        t = time.monotonic()
        await asyncio.wait_for(rest.stop(), timeout=2.0)
        elapsed = time.monotonic() - t
        assert await reader.read() == b"not found"  # the body, then EOF
        writer.close()
        return elapsed

    assert asyncio.run(run()) < 2.0


UNSUPPORTED = {
    "tenant-file-kernel-xla": ("aggregation", "kernel", "xla", "Queue 2"),
    "kernel-xla": ("aggregation", "kernel", "xla", "Queue 2"),
    "kernel-pallas": ("aggregation", "kernel", "pallas", "Queue 2"),
    "kernel-native": ("aggregation", "kernel", "native-u64", "Queue 2"),
    "shard-parallel": ("aggregation", "shard_parallel", False, "item 10"),
    "shard-threads": ("aggregation", "shard_threads", 4, "item 10"),
}
# refused until the port had them: the edge tier (item 18), the
# speculative sum2's knobs (item 9b) and the redis and s3 stores (item 19);
# now accepted as the JAX package does
ACCEPTED = {
    "redis": ("storage", "coordinator", "redis"),
    "s3": ("storage", "backend", "s3"),
    "tenancy-edge": ("edge", "enabled", True),
    "edge": ("edge", "enabled", True),
    "speculative-derive": ("overlap", "speculative_derive", False),
    "spec-group": ("overlap", "spec_group", 4),
}


@pytest.mark.parametrize("case", list(UNSUPPORTED) + list(ACCEPTED))
def test_port_settings_refuse_what_the_port_lacks(case, tmp_path):
    """Each key the port lacks is refused by name, where the JAX package
    accepts the same settings. The port serves tenants (``[tenancy]
    enabled``), and a tenant's own settings file is held to the same
    refusals. The edge tier (alone and with tenancy), non-default
    ``[overlap] speculative_derive`` / ``spec_group`` and the ``redis`` and
    ``s3`` stores are accepted, as in the JAX package."""
    settings = _settings(port_settings, device=True)
    theirs = _settings(jax_settings, device=True)
    if case.startswith("tenan"):
        for s in (settings, theirs):
            s.tenancy.enabled = True
            s.tenancy.tenants = ["t0"]
    if case in ACCEPTED:
        section, key, value = ACCEPTED[case]
        for s in (settings, theirs):
            setattr(getattr(s, section), key, value)
            s.validate()  # both packages accept it
        assert getattr(getattr(settings, section), key) == value
        return
    section, key, value, item = UNSUPPORTED[case]
    if case == "tenant-file-kernel-xla":
        from xaynet_tpu.server import runner as jax_runner

        settings.validate()  # tenancy alone is accepted
        (tmp_path / "t0.toml").write_text(f'[{section}]\n{key} = "{value}"\n')
        for s in (settings, theirs):
            s.tenancy.config_dir = str(tmp_path)
        assert getattr(getattr(jax_runner._tenant_settings(theirs, "t0"), section), key) == value
        with pytest.raises(port_settings.SettingsError, match=item):
            runner._tenant_settings(settings, "t0")
        return
    setattr(getattr(settings, section), key, value)
    setattr(getattr(theirs, section), key, value)
    theirs.validate()  # the JAX package accepts the same settings
    with pytest.raises(port_settings.SettingsError, match=item):
        settings.validate()


@pytest.mark.parametrize("tenancy", [False, True], ids=["alone", "tenancy"])
def test_port_settings_accept_ingest(tenancy, tmp_path):
    """``[ingest] enabled = true`` loads and validates in the port as in the
    JAX package, alone and with ``[tenancy] enabled`` (the base settings
    and a tenant's own file), with the JAX soak's ingest keys."""
    text = (
        "[ingest]\nenabled = true\nshards = 2\nqueue_bound = 4096\n"
        "retry_after_seconds = 0.2\nwire_format = \"packed\"\n"
    )
    if tenancy:
        (tmp_path / "t0.toml").write_text(text)
        text += f'[tenancy]\nenabled = true\ntenants = "t0"\nconfig_dir = "{tmp_path}"\n'
    cfg = tmp_path / "config.toml"
    cfg.write_text(text)
    ours = port_settings.Settings.load(str(cfg), env={})
    theirs = jax_settings.Settings.load(str(cfg), env={})
    assert ours.ingest.__dict__ == theirs.ingest.__dict__
    assert ours.ingest.enabled and ours.ingest.queue_bound == 4096
    assert ours.tenancy.enabled is tenancy
    if tenancy:
        tset = runner._tenant_settings(ours, "t0")
        assert tset.ingest.enabled and not tset.tenancy.enabled


def test_shipped_config_loads_in_port():
    """Every key of the shipped config parses in the port's settings."""
    ours = port_settings.Settings.load(str(REPO / "configs" / "config.toml"), env={})
    theirs = jax_settings.Settings.load(str(REPO / "configs" / "config.toml"), env={})
    assert ours.aggregation.__dict__ == theirs.aggregation.__dict__
    assert ours.model.length == theirs.model.length
