"""The port's participant SDK (``xaynet_tpu_torch.sdk``) against the JAX one.

The same inputs, made from numpy seeds, go through the JAX package's SDK
and the port's, both on the CPU: the port's participant masks its update
with ``ops.masking.mask_update`` (the plain K2 + K1 on a CPU device) and
sums the Sum2 masks with ``ops.masking.sum_masks`` (the plain K2), where
the JAX SDK uses the host ``Masker`` and host ``Aggregation``. Tolerance:
none. Update payloads (and the sealed messages, with the sealing's
ephemeral key fixed), Sum2 mask objects and saved states are compared byte
for byte; the decoded global models of whole rounds must equal the JAX
package's float for float.

Rounds: the port's coordinator (``serve(..., device="cpu")``) with the
port's SDK over the socket, in the configurations
``tests/test_torch_coordinator.py`` runs with the JAX SDK; the JAX
coordinator in-process with the port's SDK through ``InProcessClient``
(its REST server hangs in ``stop()`` on Python 3.12); the port's
``LocalFederation``. Small sizes: model length 600 to 1,500, one sum and
three update participants.

Also: saved participant states restore across the two SDKs and finish the
round; the resilient client's cases of ``tests/test_sdk_resilient.py``; a
participant without a device raises ``DeviceUnavailable`` where there is no
CUDA.
"""

from __future__ import annotations

import asyncio
import random
import time
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from xaynet_tpu.core.common import RoundParameters as JaxRoundParameters
from xaynet_tpu.core.crypto import encrypt as jax_encrypt
from xaynet_tpu.core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
from xaynet_tpu.core.mask.seed import MaskSeed as JaxMaskSeed
from xaynet_tpu.sdk import state_machine as jax_sm
from xaynet_tpu.sdk.client import InProcessClient as JaxInProcessClient
from xaynet_tpu.sdk.simulation import keys_for_task as jax_keys_for_task
from xaynet_tpu.server import settings as jax_settings
from xaynet_tpu.server.requests import RequestError as JaxRequestError
from xaynet_tpu.server.services import Fetcher as JaxFetcher
from xaynet_tpu.server.services import PetMessageHandler as JaxHandler
from xaynet_tpu.server.services import ServiceError as JaxServiceError
from xaynet_tpu.server.state_machine import StateMachineInitializer as JaxInitializer
from xaynet_tpu.storage.memory import InMemoryCoordinatorStorage as JaxMemStorage
from xaynet_tpu.storage.memory import InMemoryModelStorage as JaxModels
from xaynet_tpu.storage.memory import NoOpTrustAnchor as JaxAnchor
from xaynet_tpu.storage.traits import Store as JaxStore

from xaynet_tpu_torch.core.common import RoundParameters, RoundSeed
from xaynet_tpu_torch.core.crypto import encrypt
from xaynet_tpu_torch.core.crypto.encrypt import EncryptKeyPair
from xaynet_tpu_torch.core.mask.seed import EncryptedMaskSeed, MaskSeed
from xaynet_tpu_torch.device import DeviceUnavailable
from xaynet_tpu_torch.parallel.aggregator import DeviceAggregator
from xaynet_tpu_torch.resilience import FaultPlan, RetryPolicy, clear_plan, install_plan
from xaynet_tpu_torch.sdk.api import ParticipantABC
from xaynet_tpu_torch.sdk.client import (
    ClientPermanentError,
    ClientShedError,
    ClientTransientError,
    HttpClient,
    InProcessClient,
    ResilientClient,
    classify_status,
)
from xaynet_tpu_torch.sdk.federation import LocalFederation
from xaynet_tpu_torch.sdk.participant import Participant
from xaynet_tpu_torch.sdk.simulation import flood, keys_for_task, plan_churn
from xaynet_tpu_torch.sdk.state_machine import (
    PetSettings,
    PhaseKind,
    StateMachine,
    TransitionOutcome,
)
from xaynet_tpu_torch.sdk.traits import ModelStore, XaynetClient
from xaynet_tpu_torch.server import runner
from xaynet_tpu_torch.server import settings as port_settings
from xaynet_tpu_torch.server.aggregation import StagedAggregator

torch.set_num_threads(1)
N_SUM, N_UPDATE, MODEL_LEN = 1, 3, 600
SUM_PROB, UPDATE_PROB = 0.4, 0.5
LOCALS = np.random.default_rng(11).uniform(-1, 1, (N_UPDATE, MODEL_LEN)).astype(np.float32)
MEAN = LOCALS.astype(np.float64).sum(axis=0) / N_UPDATE
SHIPPED = MaskConfig(GroupType.PRIME, DataType.F32, BoundType.B0, ModelType.M3)
# the mask configs of the device steps: the shipped one and one of each
# other group type, with a model length each
MASK_CONFIGS = {
    "prime-f32-b0-m3": (SHIPPED, 1000),
    "power2-f32-b2-m3": (
        MaskConfig(GroupType.POWER2, DataType.F32, BoundType.B2, ModelType.M3), 700,
    ),
    "integer-f64-b2-m6": (
        MaskConfig(GroupType.INTEGER, DataType.F64, BoundType.B2, ModelType.M6), 1500,
    ),
}  # fmt: skip


class ArrayModelStore(ModelStore):
    def __init__(self, model):
        self.model = model

    async def load_model(self):
        return self.model


@pytest.fixture
def fixed_sealing(monkeypatch):
    """Sealed boxes of both packages draw the same ephemeral key, so sealed
    bytes compare (the SDK's own work, signing and masking, is already
    deterministic with a pinned mask seed)."""
    for mod in (jax_encrypt, encrypt):
        if mod._HAVE_CRYPTO:
            real = mod.X25519PrivateKey
            fixed = SimpleNamespace(
                from_private_bytes=real.from_private_bytes,
                generate=lambda real=real: real.from_private_bytes(bytes(range(32))),
            )
            monkeypatch.setattr(mod, "X25519PrivateKey", fixed)
        else:
            monkeypatch.setattr(mod, "os", SimpleNamespace(urandom=lambda n: bytes(range(n))))


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without CUDA, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# --------------------------------------------------------------------------
# the two device steps, one machine of each SDK on the same inputs
# --------------------------------------------------------------------------


class _Scripted:
    """A coordinator that answers with fixed round parameters and sum
    dictionary, and records what it is sent (either SDK's client)."""

    def __init__(self, params, sums=None):
        self.params, self.sums, self.sent = params, sums, []

    async def get_round_params(self):
        return self.params

    async def get_sums(self):
        return self.sums

    async def get_seeds(self, pk):
        return None

    async def get_model(self):
        return None

    async def send_message(self, encrypted):
        self.sent.append(encrypted)


def _round_dict(config: MaskConfig, length: int, wire_format: int = 1) -> dict:
    params = RoundParameters(
        pk=EncryptKeyPair.derive_from_seed(b"\x01" * 32).public.as_bytes(),
        sum=0.0,
        update=0.999,
        seed=RoundSeed(b"\x07" * 32),
        mask_config=_port_pair(config),
        model_length=length,
        wire_format=wire_format,
    )
    return params.to_dict()


def _port_pair(config: MaskConfig):
    from xaynet_tpu_torch import convert

    return convert.config_pair(config.pair())


def _update_payload(sdk: str, config: MaskConfig, length: int, wire_format: int,
                    model: np.ndarray) -> tuple[bytes, list[bytes]]:
    """One update participant of ``sdk`` ("jax" or "port") with a pinned
    mask seed: the Update payload's bytes and the sealed messages sent."""
    d = _round_dict(config, length, wire_format)
    sums = {b"\x02" * 32: EncryptKeyPair.derive_from_seed(b"\x03" * 32).public.as_bytes()}
    if sdk == "jax":
        params = JaxRoundParameters.from_dict(d)
        keys = jax_keys_for_task(params.seed.as_bytes(), params.sum, params.update, "update")
        settings = jax_sm.PetSettings(keys=keys, scalar=Fraction(1, 3), max_message_size=None,
                                      mask_seed=b"\x2a" * 32)  # fmt: skip
        machine_cls = jax_sm.StateMachine
    else:
        params = RoundParameters.from_dict(d)
        keys = keys_for_task(params.seed.as_bytes(), params.sum, params.update, "update")
        settings = PetSettings(keys=keys, scalar=Fraction(1, 3), max_message_size=None,
                               mask_seed=b"\x2a" * 32, device="cpu")  # fmt: skip
        machine_cls = StateMachine
    client = _Scripted(params, sums)
    sm = machine_cls(settings, client, ArrayModelStore(model))
    payloads = []
    real_send = sm._send

    async def send(payload, next_phase):
        payloads.append(payload.to_bytes())
        return await real_send(payload, next_phase)

    sm._send = send

    async def run():
        await sm.transition()
        assert sm.phase.value == "update"
        await sm.transition()
        assert sm.phase.value == "awaiting"

    asyncio.run(run())
    assert len(payloads) == 1
    return payloads[0], client.sent


@pytest.mark.parametrize(
    "case,wire_format",
    [("prime-f32-b0-m3", 1), ("prime-f32-b0-m3", 2), ("power2-f32-b2-m3", 1),
     ("integer-f64-b2-m6", 1)],
)  # fmt: skip
def test_step_update_payload_bytes_match_jax_sdk(case, wire_format, fixed_sealing):
    """With a pinned ``mask_seed`` the port's Update payload (masked on the
    plain K2 + K1) and the sealed message equal the JAX SDK's (host
    ``Masker``) byte for byte."""
    config, length = MASK_CONFIGS[case]
    bound = 0.9 if config.bound_type is BoundType.B0 else 90.0
    dtype = np.float64 if config.data_type is DataType.F64 else np.float32
    model = np.random.default_rng(length).uniform(-bound, bound, length).astype(dtype)
    jax_payload, jax_sent = _update_payload("jax", config, length, wire_format, model)
    port_payload, port_sent = _update_payload("port", config, length, wire_format, model)
    assert port_payload == jax_payload
    assert port_sent == jax_sent and len(port_sent) == 1


@pytest.mark.parametrize("case", ["prime-f32-b0-m3", "power2-f32-b2-m3"])
@pytest.mark.parametrize("n_seeds", [1, 3, 9])
def test_aggregate_masks_matches_jax_host_path(case, n_seeds):
    """The Sum2 mask of 1, 3 and 9 seeds (9 crosses ``sum_masks``' group
    of 8) equals the JAX SDK's host ``Aggregation`` of ``derive_mask``."""
    config, length = MASK_CONFIGS[case]
    rng = np.random.default_rng(n_seeds)
    raw = [rng.bytes(32) for _ in range(n_seeds)]
    keys = keys_for_task(b"\x07" * 32, 0.0, 0.999, "update")
    jax_machine = jax_sm.StateMachine(
        jax_sm.PetSettings(keys=jax_keys_for_task(b"\x07" * 32, 0.0, 0.999, "update"),
                           device_sum2=False),
        _Scripted(None), ArrayModelStore(None),
    )  # fmt: skip
    port_machine = StateMachine(PetSettings(keys=keys, device="cpu"), _Scripted(None),
                                ArrayModelStore(None))  # fmt: skip
    want = jax_machine._aggregate_masks([JaxMaskSeed(s) for s in raw], length, config.pair())
    got = port_machine._aggregate_masks([MaskSeed(s) for s in raw], length,
                                        _port_pair(config))  # fmt: skip
    for a, b in ((got.vect.data, want.vect.data), (got.unit.data, want.unit.data)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert got.vect.config.to_bytes() == want.vect.config.to_bytes()


# --------------------------------------------------------------------------
# whole rounds
# --------------------------------------------------------------------------


def _settings(mod, **aggregation):
    """Round settings of either package: count windows with min = max."""

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


def _participants(sdk: str, seed: bytes, client_for, max_message_size=None):
    """One sum and three update participants of ``sdk``, with the shared
    local models; ``client_for()`` makes each one's client."""
    if sdk == "jax":
        make, settings, keys_for = jax_sm.StateMachine, jax_sm.PetSettings, jax_keys_for_task
        extra = {}
    else:
        make, settings, keys_for = StateMachine, PetSettings, keys_for_task
        extra = {"device": "cpu"}
    out = []
    for i in range(N_SUM):
        keys = keys_for(seed, SUM_PROB, UPDATE_PROB, "sum", start=i * 1000)
        out.append(make(settings(keys=keys, max_message_size=max_message_size, **extra),
                        client_for(), ArrayModelStore(None)))  # fmt: skip
    for i in range(N_UPDATE):
        keys = keys_for(seed, SUM_PROB, UPDATE_PROB, "update", start=(20 + i) * 1000)
        out.append(make(
            settings(keys=keys, scalar=Fraction(1, N_UPDATE), max_message_size=max_message_size,
                     **extra),
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


class _PortFetcher:
    """The JAX coordinator's fetcher, answering in the port's types (its
    round parameters and encrypted seeds are the JAX package's classes)."""

    def __init__(self, fetcher):
        self.fetcher = fetcher

    def round_params(self):
        return RoundParameters.from_dict(self.fetcher.round_params().to_dict())

    def sum_dict(self):
        return self.fetcher.sum_dict()

    def seeds_for(self, pk):
        seeds = self.fetcher.seeds_for(pk)
        if seeds is None:
            return None
        return {k: EncryptedMaskSeed(v.as_bytes()) for k, v in seeds.items()}

    def model(self):
        return self.fetcher.model()


class _PortHandler:
    """The JAX coordinator's message handler, whose rejections (the JAX
    package's ``ServiceError`` / ``RequestError``) are swallowed as the
    port's ``InProcessClient`` swallows its own."""

    def __init__(self, handler):
        self.handler = handler

    async def handle_message(self, encrypted):
        try:
            await self.handler.handle_message(encrypted)
        except (JaxServiceError, JaxRequestError):
            pass


async def _jax_coordinator_round(sdk: str, drive=None) -> np.ndarray:
    """A round of the JAX coordinator in-process with ``sdk``'s
    participants; ``drive(sms, fetcher, handler)`` replaces the plain drive."""
    settings = _settings(jax_settings)
    store = JaxStore(JaxMemStorage(), JaxModels(), JaxAnchor())
    machine, request_tx, events = await JaxInitializer(settings, store).init()
    handler, fetcher = JaxHandler(events, request_tx), JaxFetcher(events)
    task = asyncio.create_task(machine.run())
    try:
        while fetcher.phase().value != "sum":
            await asyncio.sleep(0.01)
        seed = fetcher.round_params().seed.as_bytes()
        if sdk == "jax":
            def client_for():
                return JaxInProcessClient(fetcher, handler)
        else:
            def client_for():
                return InProcessClient(_PortFetcher(fetcher), _PortHandler(handler))

        async def done():
            return fetcher.model() is not None

        if drive is not None:
            await drive(seed, client_for, done)
        else:
            sms = _participants(sdk, seed, client_for)
            assert all(await asyncio.gather(*(_drive(sm, done) for sm in sms)))
        return np.asarray(fetcher.model())
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)


@pytest.fixture(scope="module")
def jax_model() -> np.ndarray:
    """The JAX coordinator's model with the JAX SDK's participants."""
    model = asyncio.run(asyncio.wait_for(_jax_coordinator_round("jax"), timeout=120))
    np.testing.assert_allclose(model, MEAN, atol=1e-9)
    return model


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


async def _wait_for_phase(url: str, want: str, timeout: float = 30.0) -> None:
    probe = HttpClient(url, keep_alive=False)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            await probe.get_round_params()
            return
        except ClientTransientError:
            await asyncio.sleep(0.02)
    raise TimeoutError(f"coordinator never answered GET /params ({want})")


async def _port_round(settings, max_message_size=None) -> np.ndarray:
    """Serve ``settings`` on a free port with ``device="cpu"``, run one round
    with the port's SDK participants over HTTP, return the global model."""
    port = _free_port()
    settings.api.bind_address = f"127.0.0.1:{port}"
    url = f"http://127.0.0.1:{port}"
    server = asyncio.create_task(runner.serve(settings, device="cpu"))
    try:
        await _wait_for_phase(url, "sum")
        probe = HttpClient(url)
        params = await probe.get_round_params()
        sms = _participants("port", params.seed.as_bytes(), lambda: HttpClient(url),
                            max_message_size)  # fmt: skip

        async def done():
            return (await probe.get_model()) is not None

        assert all(await asyncio.gather(*(_drive(sm, done) for sm in sms)))
        return np.asarray(await probe.get_model())
    finally:
        server.cancel()
        await asyncio.wait_for(server, timeout=10)


# the configurations tests/test_torch_coordinator.py runs with the JAX SDK
ROUNDS = {
    "device": dict(device=True),
    "device-wire-ingest": dict(device=True, wire_ingest=True),
    "device-multipart": dict(device=True, multipart=True),
    "device-wire-ingest-multipart": dict(device=True, wire_ingest=True, multipart=True),
    "host": dict(device=False),
    "host-multipart": dict(device=False, multipart=True),
}


@pytest.mark.parametrize("case", list(ROUNDS))
def test_port_sdk_round_over_socket_matches_jax(case, jax_model, monkeypatch):
    """The port's coordinator and the port's SDK over the socket give the
    model of the JAX coordinator with the JAX SDK, float for float; every
    flush folds on the plain pipeline of the CPU device."""
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
    assert model.shape == (MODEL_LEN,) and model.dtype == jax_model.dtype
    assert model.tobytes() == jax_model.tobytes()
    assert calls["wire"] == (N_UPDATE if spec.get("wire_ingest") else 0)
    assert folded_by == {"plain"}


def test_jax_coordinator_with_port_sdk_matches(jax_model):
    """The reverse pairing: the JAX coordinator in-process with the port's
    participants through ``InProcessClient`` gives the same model."""
    model = asyncio.run(asyncio.wait_for(_jax_coordinator_round("port"), timeout=120))
    assert model.tobytes() == jax_model.tobytes()


class _Trainer(ParticipantABC):
    def __init__(self, model):
        self.model = model
        self.seen = []

    def train_round(self, training_input):
        return self.model

    def on_new_global_model(self, model):
        self.seen.append(model)


def test_local_federation_on_cpu_matches_jax(jax_model):
    """The port's ``LocalFederation`` (its coordinator and participants on
    one CPU device) gives the JAX coordinator's model for the same local
    models; the participants split messages into 4 KiB parts."""
    trainers = [_Trainer(None)] + [_Trainer(m) for m in LOCALS]
    fed = LocalFederation(model_length=MODEL_LEN, n_sum=N_SUM, n_update=N_UPDATE,
                          phase_timeout=60.0, device="cpu")  # fmt: skip
    try:
        (result,) = list(fed.rounds(trainers, n_rounds=1, round_timeout=120))
    finally:
        fed.stop()
    assert result.round_id == 1
    assert result.global_model.tobytes() == jax_model.tobytes()
    assert all(t.seen and t.seen[-1].tobytes() == jax_model.tobytes() for t in trainers)


# --------------------------------------------------------------------------
# saved states across the two SDKs
# --------------------------------------------------------------------------


class _Flaky:
    """Wraps a client; its send fails (transiently) after ``parts``
    delivered parts, so a multipart upload stops half way."""

    transient_error = type("Flaky", (ConnectionError,), {"transient": True})

    def __init__(self, inner, parts=None):
        self.inner, self.parts = inner, parts

    def __getattr__(self, name):
        return getattr(self.inner, name)

    async def send_message(self, encrypted):
        if self.parts is not None:
            if self.parts == 0:
                raise self.transient_error("link down")
            self.parts -= 1
        await self.inner.send_message(encrypted)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_saved_state_resumes_in_the_other_sdk(direction, jax_model):
    """Each participant runs part of the round in one SDK and is saved: the
    sum participant after its sum message, each update participant half way
    through its multipart upload. The other SDK restores every state and
    finishes the round with the same model."""
    first, second = direction.split("-to-")
    restore = {"jax": jax_sm.StateMachine.restore,
               "port": lambda *a: StateMachine.restore(*a, device="cpu")}[second]  # fmt: skip

    async def drive(seed, client_for, done):
        flaky = []

        def flaky_client():
            flaky.append(_Flaky(client_for()))
            return flaky[-1]

        sms = _participants(first, seed, flaky_client, max_message_size=1024)
        summer, *updaters = sms

        async def summed():
            return summer.phase.value == "sum2"

        assert await _drive(summer, summed)
        for client, sm in zip(flaky[1:], updaters):
            client.parts = 2

            async def half_sent(sm=sm):
                return sm._pending is not None and sm._pending.next_index == 2

            assert await _drive(sm, half_sent)
        states = [sm.save() for sm in sms]
        resumed = [restore(state, client_for(), ArrayModelStore(None)) for state in states]
        assert [sm.phase.value for sm in resumed] == ["sum2"] + ["update"] * N_UPDATE
        assert all(sm._pending.next_index == 2 for sm in resumed[1:])
        assert all(await asyncio.gather(*(_drive(sm, done) for sm in resumed)))

    sdk = "port" if second == "port" else "jax"
    model = asyncio.run(asyncio.wait_for(_jax_coordinator_round(sdk, drive), timeout=120))
    assert model.tobytes() == jax_model.tobytes()


def test_saved_states_are_the_same_bytes(fixed_sealing):
    """A state saved by either SDK, restored by the other and saved again,
    is the bytes it was (the device is not part of the state)."""
    d = _round_dict(SHIPPED, 16)
    keys = keys_for_task(b"\x07" * 32, 0.0, 0.999, "update")
    port = StateMachine(PetSettings(keys=keys, scalar=Fraction(2, 7), mask_kernel="fused-pallas",
                                    mask_seed=b"\x01" * 32, device="cpu"),
                        _Scripted(RoundParameters.from_dict(d)), ArrayModelStore(None))  # fmt: skip
    asyncio.run(port.transition())
    state = port.save()
    jax_again = jax_sm.StateMachine.restore(state, _Scripted(None), ArrayModelStore(None))
    assert jax_again.save() == state
    port_again = StateMachine.restore(jax_again.save(), _Scripted(None), ArrayModelStore(None),
                                      device="cpu")  # fmt: skip
    assert port_again.save() == state
    assert port_again.mask_kernel == "fused-pallas" and port_again.device.type == "cpu"


def test_mask_kernel_route_names():
    """The fused route names (K2) are accepted; the JAX package's host and
    batch routes are refused by name, also from a state the JAX SDK saved."""
    keys = keys_for_task(b"\x07" * 32, 0.0, 0.999, "update")
    for name in ("auto", "fused-pallas", "fused-pallas-interpret"):
        assert PetSettings(keys=keys, mask_kernel=name, device="cpu").mask_kernel == name
    for name in ("batch", "host-threaded", "host-chunked"):
        with pytest.raises(ValueError, match=f"'{name}'.*ROADMAP Queue 2"):
            PetSettings(keys=keys, mask_kernel=name, device="cpu")
    with pytest.raises(ValueError, match="must be one of"):
        PetSettings(keys=keys, mask_kernel="pallas", device="cpu")
    jax_keys = jax_keys_for_task(b"\x07" * 32, 0.0, 0.999, "update")
    state = jax_sm.StateMachine(
        jax_sm.PetSettings(keys=jax_keys, mask_kernel="host-threaded"),
        _Scripted(None), ArrayModelStore(None),
    ).save()  # fmt: skip
    with pytest.raises(ValueError, match="'host-threaded'.*ROADMAP Queue 2"):
        StateMachine.restore(state, _Scripted(None), ArrayModelStore(None), device="cpu")


# --------------------------------------------------------------------------
# the participant's device
# --------------------------------------------------------------------------


def test_participant_without_device_raises_where_there_is_no_cuda(no_cuda):
    """Without a device a participant runs on CUDA, so on a machine without
    it ``Participant``, ``StateMachine`` and ``LocalFederation`` raise
    rather than mask on the CPU; a CPU device runs when asked."""
    keys = keys_for_task(b"\x07" * 32, 0.0, 0.999, "update")
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        Participant("http://127.0.0.1:9", keys=keys)
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        StateMachine(PetSettings(keys=keys), _Scripted(None), ArrayModelStore(None))
    state = StateMachine(PetSettings(keys=keys, device="cpu"), _Scripted(None),
                         ArrayModelStore(None)).save()  # fmt: skip
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        StateMachine.restore(state, _Scripted(None), ArrayModelStore(None))
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        LocalFederation(model_length=8)
    participant = Participant("http://127.0.0.1:9", keys=keys, device="cpu")
    assert participant._sm.device.type == "cpu"
    participant.close()


# --------------------------------------------------------------------------
# the resilient client (the cases of tests/test_sdk_resilient.py)
# --------------------------------------------------------------------------


@pytest.fixture
def no_fault_plan():
    clear_plan()
    yield
    clear_plan()


def _fast_policy(attempts=4) -> RetryPolicy:
    return RetryPolicy(max_attempts=attempts, base_delay_s=0.001, max_delay_s=0.005,
                       deadline_s=5.0, rng=random.Random(3))  # fmt: skip


@pytest.mark.parametrize(
    "status,kind",
    [(429, "shed")]
    + [(s, "transient") for s in (408, 425, 500, 502, 503, 504, 507, 520, 529, 599)]
    + [(s, "permanent") for s in (400, 403, 404, 413, 501, 301, 302, 307, 308)],
)  # fmt: skip
def test_classify_status_hierarchy(status, kind):
    """429 is shed (with its Retry-After), any 5xx but 501 and 408/425 are
    transient, the rest permanent; a 3xx is a failed call too (the client
    never follows redirects)."""
    err = classify_status(status, 2.5, "GET /params")
    assert err.status == status
    if kind == "shed":
        assert isinstance(err, ClientShedError) and err.transient and err.retry_after == 2.5
    elif kind == "transient":
        assert isinstance(err, ClientTransientError) and err.transient
        assert not isinstance(err, ClientShedError) and err.retry_after == 2.5
    else:
        assert isinstance(err, ClientPermanentError) and not err.transient
        with pytest.raises(ClientPermanentError):
            HttpClient("http://h")._raise_for_status(status, {}, "GET /params")


def test_typed_markers_drive_the_classifiers():
    from xaynet_tpu_torch.resilience.policy import is_transient
    from xaynet_tpu_torch.sdk.state_machine import _is_transient_client_error

    assert is_transient(ClientTransientError("x")) and not is_transient(ClientPermanentError("x"))
    HttpClient("http://h")._raise_for_status(200, {}, "GET /params")  # 2xx passes
    # the FSM's stay-in-phase retry must not spin on a local fault
    assert _is_transient_client_error(ClientTransientError("x"))
    assert _is_transient_client_error(ConnectionResetError())
    assert _is_transient_client_error(asyncio.TimeoutError())
    assert not _is_transient_client_error(ClientPermanentError("x"))
    assert not _is_transient_client_error(FileNotFoundError("model.npz"))
    assert not _is_transient_client_error(PermissionError("denied"))


def test_http_client_stalled_peer_times_out_transient():
    """A peer that sends the status line then stalls mid-body surfaces as a
    fast ClientTransientError (idle read timeout). The stub server closes
    the stalled connection before ``wait_closed()``, which on Python 3.12
    waits for every open connection."""

    async def run():
        writers = []

        async def handler(reader, writer):
            writers.append(writer)
            await reader.readline()
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 10\r\n\r\n")
            await writer.drain()
            await asyncio.sleep(10)  # the body never arrives

        server = await asyncio.start_server(handler, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        client = HttpClient(f"http://127.0.0.1:{port}", timeout=0.2)
        t0 = time.monotonic()
        with pytest.raises(ClientTransientError):
            await client.get_model()
        assert time.monotonic() - t0 < 5.0  # idle timeout, not the 10s stall
        for writer in writers:
            writer.close()
        server.close()
        await server.wait_closed()

    asyncio.run(asyncio.wait_for(run(), 20))


class _FlakyClient(XaynetClient):
    """Scripted inner client: pops one error per call until the script is
    exhausted, then succeeds."""

    def __init__(self, errors=()):
        self.errors = list(errors)
        self.calls = {"params": 0, "sums": 0, "seeds": 0, "model": 0, "send": 0}
        self.sent = []

    def _maybe_fail(self, endpoint):
        self.calls[endpoint] += 1
        if self.errors:
            raise self.errors.pop(0)

    async def get_round_params(self):
        self._maybe_fail("params")
        return "params"

    async def get_sums(self):
        self._maybe_fail("sums")
        return {}

    async def get_seeds(self, pk):
        self._maybe_fail("seeds")
        return {}

    async def get_model(self):
        self._maybe_fail("model")
        return None

    async def send_message(self, encrypted):
        self._maybe_fail("send")
        self.sent.append(encrypted)


@pytest.mark.parametrize(
    "errors,call,attempts,outcome",
    [
        # transient failures retry in place, then the call succeeds
        ([ClientTransientError("a"), ClientTransientError("b")], "params", 4, "params"),
        # a permanent failure propagates on the first attempt
        ([ClientPermanentError("no", status=404)], "model", 4, ClientPermanentError),
        # the policy gives up after its attempts; the LAST error propagates
        ([ClientTransientError(f"t{i}") for i in range(10)], "sums", 3, "t2"),
    ],
    ids=["transient-then-success", "permanent-first-attempt", "gives-up-raises-last"],
)  # fmt: skip
def test_resilient_client_retry_outcomes(errors, call, attempts, outcome):
    inner = _FlakyClient(errors)
    client = ResilientClient(inner, policy=_fast_policy(attempts))
    fn = {"params": client.get_round_params, "model": client.get_model,
          "sums": client.get_sums}[call]  # fmt: skip
    if outcome == "params":
        assert asyncio.run(fn()) == "params"
        assert inner.calls[call] == 3
    elif outcome is ClientPermanentError:
        with pytest.raises(ClientPermanentError):
            asyncio.run(fn())
        assert inner.calls[call] == 1
    else:
        with pytest.raises(ClientTransientError) as ei:
            asyncio.run(fn())
        assert str(ei.value) == outcome and inner.calls[call] == attempts


def test_resilient_client_honors_retry_after_floor():
    floor = 0.15
    inner = _FlakyClient([ClientShedError("shed", status=429, retry_after=floor)])
    client = ResilientClient(inner, policy=_fast_policy())
    t0 = time.monotonic()
    asyncio.run(client.send_message(b"x"))
    assert time.monotonic() - t0 >= floor  # the ~1 ms jitter delay, floored
    assert inner.sent == [b"x"]


def test_sdk_fault_sites_drop_straggle_send(no_fault_plan):
    install_plan(FaultPlan.parse(
        "seed=5;sdk.drop:error,nth=1;sdk.straggle:latency,delay=0.1,nth=2;sdk.send:error,nth=1"
    ))  # fmt: skip
    inner = _FlakyClient()
    client = ResilientClient(inner, policy=_fast_policy())
    asyncio.run(client.send_message(b"one"))  # dropped on the wire
    assert inner.sent == []
    t0 = time.monotonic()
    asyncio.run(client.send_message(b"two"))  # straggles, first attempt fails, retried
    assert time.monotonic() - t0 >= 0.1
    assert inner.sent == [b"two"]
    asyncio.run(client.send_message(b"three"))
    assert inner.sent == [b"two", b"three"]


def _update_machine(client) -> StateMachine:
    """A machine whose key takes the UPDATE task for the scripted round."""
    params = client.params
    keys = keys_for_task(params.seed.as_bytes(), params.sum, params.update, "update")
    return StateMachine(
        PetSettings(keys=keys, scalar=Fraction(1, 1), max_message_size=None, device="cpu"),
        client,
        ArrayModelStore(np.zeros(4, dtype=np.float32)),
    )


class _ErrorScripted(_Scripted):
    def __init__(self, sums_errors=(), send_errors=()):
        super().__init__(RoundParameters.from_dict(_round_dict(SHIPPED, 4)),
                         {b"\x02" * 32: b"\x03" * 32})  # fmt: skip
        self.sums_errors, self.send_errors = list(sums_errors), list(send_errors)

    async def get_sums(self):
        if self.sums_errors:
            raise self.sums_errors.pop(0)
        return self.sums

    async def send_message(self, encrypted):
        if self.send_errors:
            raise self.send_errors.pop(0)
        self.sent.append(encrypted)


@pytest.mark.parametrize("where", ["sums", "send"])
def test_sm_stays_in_phase_on_transient_failure_and_resumes(where):
    """A transient failure of ``GET /sums`` or of the upload keeps the
    machine in its phase (PENDING, signatures and send cursor kept); the
    next tick resumes within the round and uploads once."""

    async def run():
        err = [ClientTransientError("conn reset")]
        client = _ErrorScripted(**{f"{where}_errors": err})
        sm = _update_machine(client)
        assert await sm.transition() == TransitionOutcome.COMPLETE
        assert sm.phase == PhaseKind.UPDATE
        sig_before = sm.update_signature
        assert await sm.transition() == TransitionOutcome.PENDING
        assert sm.phase == PhaseKind.UPDATE and sm.update_signature == sig_before
        assert (sm._pending is not None) == (where == "send")
        assert await sm.transition() == TransitionOutcome.COMPLETE
        assert len(client.sent) == 1 and sm.phase == PhaseKind.AWAITING

    asyncio.run(asyncio.wait_for(run(), 30))


def test_sm_abandons_send_on_permanent_rejection():
    async def run():
        client = _ErrorScripted(send_errors=[ClientPermanentError("too large", status=413)])
        sm = _update_machine(client)
        await sm.transition()
        assert sm.phase == PhaseKind.UPDATE
        assert await sm.transition() == TransitionOutcome.COMPLETE  # masks, send -> 413
        assert sm.phase == PhaseKind.AWAITING and sm._pending is None
        assert await sm.transition() == TransitionOutcome.PENDING  # idles, no resend
        assert client.sent == []

    asyncio.run(asyncio.wait_for(run(), 30))


def test_plan_churn_deterministic_and_disjoint():
    d1, s1 = plan_churn(10, 0.3, 2, seed=42)
    assert (d1, s1) == plan_churn(10, 0.3, 2, seed=42)
    assert len(d1) == 3 and len(s1) == 2 and not (d1 & s1)
    d3, s3 = plan_churn(10, 0.3, 2, seed=43)
    assert d3 != d1 or s3 != s1
    with pytest.raises(ValueError):
        plan_churn(10, 1.0, 0, seed=1)


def test_flood_dropout_withholds_and_stragglers_delay():
    received = []

    async def sink(blob: bytes) -> None:
        received.append(blob)

    stats = asyncio.run(asyncio.wait_for(flood(
        sink, RoundParameters.from_dict(_round_dict(SHIPPED, 4)), {b"\x02" * 32: b"\x03" * 32},
        8, dropout_rate=0.25, stragglers=2, straggle_delay_s=0.05, churn_seed=11,
        build=lambda i: bytes([i]),
    ), 30))  # fmt: skip
    assert stats.dropped == len(stats.dropped_indices) == 2 and stats.straggled == 2
    assert stats.sent == stats.accepted == 6
    assert sorted(b[0] for b in received) == [
        i for i in range(8) if i not in stats.dropped_indices
    ]
