"""The port's load generator (``xaynet_tpu_torch.loadgen``) against the JAX
package's (``xaynet_tpu.loadgen``).

The same inputs, made from numpy seeds, go through both packages on the
CPU (the port's K2 runs its plain version on CPU tensors). Tolerance: none.
The population engine's masked rows, the forged uploads (decrypted with
the same coordinator key, with the sealing's ephemeral keys fixed in both
packages), the replay schedules and the sharding helpers are compared
byte for byte and event for event; each forged upload parses in both
packages' message parsers, for wire v1 and v2.

One round end to end: the port's coordinator (``serve(..., device="cpu")``
in a thread), one sum participant on the port's SDK, and
``loadgen.runner.run`` forging and replaying the updates from two spawned
driver processes; the global model must equal ``sim.SimRound`` over the
forged population's ground truth, byte for byte. A failed driver fails
``run``, and a run without a card raises before any driver starts.
"""

from __future__ import annotations

import asyncio
import socket
import threading
import time
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from xaynet_tpu.core.common import RoundParameters as JaxRoundParameters
from xaynet_tpu.core.common import RoundSeed as JaxRoundSeed
from xaynet_tpu.core.crypto import encrypt as jax_encrypt
from xaynet_tpu.core.mask.config import BoundType as JaxBound
from xaynet_tpu.core.mask.config import DataType as JaxData
from xaynet_tpu.core.mask.config import GroupType as JaxGroup
from xaynet_tpu.core.mask.config import MaskConfig as JaxMaskConfig
from xaynet_tpu.core.mask.config import ModelType as JaxModel
from xaynet_tpu.core.message import Message as JaxMessage
from xaynet_tpu.loadgen import ChurnSpec as JaxChurnSpec
from xaynet_tpu.loadgen import PopulationEngine as JaxEngine
from xaynet_tpu.loadgen import ReplaySchedule as JaxSchedule
from xaynet_tpu.loadgen import forge_population as jax_forge
from xaynet_tpu.loadgen import runner as jax_runner

from xaynet_tpu_torch import convert
from xaynet_tpu_torch.core.common import RoundParameters, RoundSeed
from xaynet_tpu_torch.core.crypto import encrypt
from xaynet_tpu_torch.core.crypto.encrypt import EncryptKeyPair
from xaynet_tpu_torch.core.mask.seed import EncryptedMaskSeed
from xaynet_tpu_torch.core.message import Message
from xaynet_tpu_torch.device import DeviceUnavailable
from xaynet_tpu_torch.loadgen import (
    ChurnSpec,
    PopulationEngine,
    ReplaySchedule,
    forge_population,
)
from xaynet_tpu_torch.loadgen import runner
from xaynet_tpu_torch.loadgen.build import population_inputs
from xaynet_tpu_torch.ops import kernels
from xaynet_tpu_torch.sim import SimRound, SimSpec

torch.set_num_threads(1)

# the engine's configs: the shipped one, and one of each other group type
ENGINE_CONFIGS = {
    "prime-f32-b0-m3": JaxMaskConfig(JaxGroup.PRIME, JaxData.F32, JaxBound.B0, JaxModel.M3),
    "integer-f32-b0-m6": JaxMaskConfig(JaxGroup.INTEGER, JaxData.F32, JaxBound.B0, JaxModel.M6),
    "power2-f64-b2-m3": JaxMaskConfig(JaxGroup.POWER2, JaxData.F64, JaxBound.B2, JaxModel.M3),
}
SHIPPED = ENGINE_CONFIGS["prime-f32-b0-m3"]


@pytest.fixture
def fixed_sealing(monkeypatch):
    """Sealed boxes of both packages draw the same ephemeral key, so the
    seed dictionaries inside forged uploads compare byte for byte."""
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


@pytest.mark.parametrize("name", list(ENGINE_CONFIGS))
def test_engine_matches_jax_engine(name):
    """P = 11 in blocks of 4: a ragged tail (the JAX engine pads it)."""
    jax_pair = ENGINE_CONFIGS[name].pair()
    n, p = 33, 11
    rng = np.random.default_rng(3)
    seeds = [rng.bytes(32) for _ in range(p)]
    weights = rng.uniform(-1, 1, (p, n)).astype(np.float32)
    scalar = Fraction(1, p)
    want_v, want_u = JaxEngine(jax_pair, n, block_size=4).emit(seeds, weights, scalar)
    eng = PopulationEngine(convert.config_pair(jax_pair), n, block_size=4, device="cpu")
    got_v, got_u = eng.emit(seeds, weights, scalar)
    assert eng.program_calls == 3
    for got, want in ((got_v, want_v), (got_u, want_u)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


def test_engine_input_validation_and_device():
    pair = convert.config_pair(SHIPPED.pair())
    eng = PopulationEngine(pair, 8, block_size=4, device="cpu")
    with pytest.raises(ValueError, match="weights"):
        eng.emit([bytes(32)] * 2, np.zeros((2, 9), np.float32))
    with pytest.raises(ValueError, match="seeds"):
        eng.emit(np.zeros((2, 4), np.uint32), np.zeros((2, 8), np.float32))
    with pytest.raises(ValueError, match="participant"):
        eng.emit([], np.zeros((0, 8), np.float32))
    for bad in (dict(model_length=0), dict(model_length=8, block_size=0)):
        with pytest.raises(ValueError):
            PopulationEngine(pair, **{"block_size": 4, **bad}, device="cpu")


def _rounds(wire_format: int, model_length: int = 40):
    coord = EncryptKeyPair.derive_from_seed(b"\x03" * 32)
    common = dict(pk=coord.public.as_bytes(), sum=0.5, update=0.9, model_length=model_length,
                  wire_format=wire_format)  # fmt: skip
    jax_params = JaxRoundParameters(seed=JaxRoundSeed(b"\x2a" * 32), mask_config=SHIPPED.pair(),
                                    **common)  # fmt: skip
    params = RoundParameters(seed=RoundSeed(b"\x2a" * 32),
                             mask_config=convert.config_pair(SHIPPED.pair()), **common)  # fmt: skip
    return coord, jax_params, params


@pytest.mark.parametrize("wire_format", [1, 2])
def test_forged_uploads_equal_jax_and_parse_in_both(wire_format, fixed_sealing):
    """Decrypted with the coordinator's key, the port's forged messages are
    the JAX forge's bytes; each parses (signatures verified) in both
    packages' parsers with the negotiated framing, and its seed dict opens
    with the sum participant's ephemeral key."""
    coord, jax_params, params = _rounds(wire_format)
    ephm = EncryptKeyPair.derive_from_seed(b"\x04" * 32)
    sum_dict = {b"\x05" * 32: ephm.public.as_bytes()}
    kw = dict(model_length=40, block_size=2, key_start=5, rng_seed=9)
    want = jax_forge(jax_params, sum_dict, 3, **kw)
    got = forge_population(params, sum_dict, 3, device="cpu", **kw)
    assert got.mask_seeds == want.mask_seeds and got.key_starts == want.key_starts
    assert np.array_equal(got.weights, want.weights) and got.scalar == want.scalar
    for ours, theirs in zip(got.messages, want.messages):
        plain = coord.secret.decrypt(ours, coord.public)
        assert plain == coord.secret.decrypt(theirs, coord.public)
        for parse in (Message.from_bytes, JaxMessage.from_bytes):
            payload = parse(plain, verify=True, lazy_update_vect=True).payload
            assert payload.wire_planar is (wire_format >= 2)
        entry = Message.from_bytes(plain).payload.local_seed_dict[b"\x05" * 32]
        if not isinstance(entry, EncryptedMaskSeed):
            entry = EncryptedMaskSeed(bytes(entry))
        assert len(entry.decrypt(ephm.secret, ephm.public).as_bytes()) == 32


def test_forge_is_deterministic_and_key_partitioned():
    coord, _, params = _rounds(2)
    ephm = EncryptKeyPair.generate()
    sum_dict = {b"\x05" * 32: ephm.public.as_bytes()}
    kw = dict(model_length=24, block_size=8, rng_seed=11, device="cpu")
    a = forge_population(params, sum_dict, 4, key_start=7, key_spacing=3, **kw)
    b = forge_population(params, sum_dict, 4, key_start=7, key_spacing=3, **kw)
    assert a.key_starts == b.key_starts == [7, 10, 13, 16]
    assert a.mask_seeds == b.mask_seeds and np.array_equal(a.weights, b.weights)
    pka = [Message.from_bytes(coord.secret.decrypt(m, coord.public)).participant_pk
           for m in a.messages]  # fmt: skip
    pkb = [Message.from_bytes(coord.secret.decrypt(m, coord.public)).participant_pk
           for m in b.messages]  # fmt: skip
    assert pka == pkb and len(set(pka)) == 4
    weights, seeds = population_inputs(4, 24, 11)
    assert seeds == a.mask_seeds and np.array_equal(weights, a.weights)


@pytest.mark.parametrize("ramp", [0.0, 2.0])
@pytest.mark.parametrize("churn", [(0.0, 0, 0.0, 1), (0.25, 3, 0.5, 9), (0.1, 5, 1.5, 10)])
def test_replay_schedule_matches_jax(churn, ramp):
    got = ReplaySchedule(40, ChurnSpec(*churn), ramp_s=ramp)
    want = JaxSchedule(40, JaxChurnSpec(*churn), ramp_s=ramp)
    assert got.events() == want.events()
    assert got.senders == want.senders
    assert got.dropped == want.dropped and got.straggled == want.straggled
    with pytest.raises(ValueError):
        ReplaySchedule(0)
    with pytest.raises(ValueError):
        ReplaySchedule(3, ramp_s=-1.0)


def test_shard_sizes_targets_and_defaults_match_jax():
    for n, d in ((10, 3), (2, 4), (0, 1), (1, 1), (100_000, 7), (2000, 2)):
        assert runner.shard_sizes(n, d) == jax_runner.shard_sizes(n, d)
    for url, tenants in (("http://h:1/", ""), ("http://h:1", "a, b"), ("http://h:1/", "x,,y")):
        assert runner.targets_for(url, tenants) == jax_runner.targets_for(url, tenants)
    assert runner.KEY_SPACING == jax_runner.KEY_SPACING
    ours, theirs = runner.default_cfg(), jax_runner.default_cfg()
    assert ours.pop("device") == "cuda"
    assert ours == theirs


def test_ground_truth_is_the_drivers_populations():
    cfg = dict(runner.default_cfg(), participants=7, drivers=3, model_length=5, seed=4)
    seeds, weights, scalar = runner.ground_truth(cfg)
    assert len(seeds) == 7 and weights.shape == (7, 5) and scalar == Fraction(1, 7)
    w1, s1 = population_inputs(2, 5, 5)  # shard 1: participants 3 and 4
    assert seeds[3:5] == s1 and np.array_equal(weights[3:5], w1)
    with pytest.raises(ValueError, match="one target"):
        runner.ground_truth(dict(cfg, tenants="a,b"))
    with pytest.raises(ValueError, match="model length"):
        runner.ground_truth(dict(cfg, model_length=None))
    with pytest.raises(ValueError, match="dropout_rate = 0.1"):
        runner.ground_truth(dict(cfg, dropout_rate=0.1))
    assert runner.ground_truth(dict(cfg, stragglers=2))[0] == seeds
    # one round behind two edges (shared_round): each shard forges target
    # by target, participant g to target g % 2, from seed + shard * 2 + t
    shared = dict(cfg, targets=["http://e0", "http://e1"], shared_round=True)
    seeds2, weights2, scalar2 = runner.ground_truth(shared)
    assert len(seeds2) == 7 and weights2.shape == (7, 5) and scalar2 == Fraction(1, 7)
    w, s = population_inputs(2, 5, 4)  # shard 0 (participants 0-2), target 0: 0 and 2
    assert seeds2[:2] == s and np.array_equal(weights2[:2], w)
    w, s = population_inputs(1, 5, 4 + 2 * 1 + 0)  # shard 1 (3, 4), target 0: 4
    assert seeds2[3:4] == s
    with pytest.raises(ValueError, match="one target"):
        runner.ground_truth(dict(shared, shared_round=False))


def test_run_without_a_card_raises_before_spawning(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(runner.mp, "get_context", lambda *a: spawned.append(a))
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        runner.run(dict(runner.default_cfg(), participants=2))
    assert spawned == []


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_failed_driver_fails_the_run():
    """Nothing listens at the URL: each driver's GET /params fails, and the
    run raises with every driver's error instead of returning stats."""
    cfg = dict(runner.default_cfg(), url=f"http://127.0.0.1:{_free_port()}", participants=4,
               drivers=2, device="cpu", timeout=2.0, sum_wait_s=1.0)  # fmt: skip
    with pytest.raises(RuntimeError, match="driver 0: .*driver 1: "):
        runner.run(cfg)


class _Coordinator:
    """The port's ``serve(settings, device="cpu")`` on a loop in a thread."""

    def __init__(self, settings):
        from xaynet_tpu_torch.server.runner import serve

        self.loop = asyncio.new_event_loop()
        ready = threading.Event()

        def main():
            asyncio.set_event_loop(self.loop)
            self.task = self.loop.create_task(serve(settings, device="cpu"))
            ready.set()
            try:
                self.loop.run_until_complete(self.task)
            except asyncio.CancelledError:
                pass
            finally:
                self.loop.close()

        self.thread = threading.Thread(target=main, daemon=True)
        self.thread.start()
        ready.wait(30)

    def stop(self):
        self.loop.call_soon_threadsafe(self.task.cancel)
        self.thread.join(30)
        assert not self.thread.is_alive()


def test_loadgen_round_matches_sim_round(tmp_path):
    """A round of the port's coordinator fed by two spawned drivers (wire v2
    uploads, wire ingest) and one SDK sum participant: every forged update
    is accepted and the global model equals the sim of the forged
    population's ground truth, byte for byte."""
    from xaynet_tpu_torch.sdk.client import ClientError, HttpClient
    from xaynet_tpu_torch.sdk.simulation import keys_for_task
    from xaynet_tpu_torch.sdk.state_machine import PetSettings, StateMachine
    from xaynet_tpu_torch.sdk.traits import ModelStore
    from xaynet_tpu_torch.server.settings import CountSettings, Settings

    class NoModel(ModelStore):
        async def load_model(self):
            return None

    n_up, length = 30, 16
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    settings = Settings.default()
    settings.api.bind_address = f"127.0.0.1:{port}"
    settings.model.length = length
    settings.pet.sum.prob, settings.pet.update.prob = 0.5, 0.9
    settings.pet.sum.count = CountSettings(min=1, max=1)
    settings.pet.update.count = CountSettings(min=n_up, max=n_up)
    settings.pet.sum2.count = CountSettings(min=1, max=1)
    settings.aggregation.device = True
    settings.aggregation.wire_ingest = True
    settings.ingest.wire_format = "packed"
    settings.storage.model_dir = str(tmp_path)
    coordinator = _Coordinator(settings)
    probe = HttpClient(url, keep_alive=False)

    async def until(pred, what, timeout=60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if await pred():
                    return
            except ClientError:  # the coordinator is not listening yet
                pass
            await asyncio.sleep(0.05)
        raise AssertionError(f"timed out waiting for {what}")

    async def step_until(sm, phase):
        async def moved():
            await sm.transition()
            return sm.phase.value == phase

        await until(moved, f"the sum participant's {phase}")

    try:
        async def sum_phase():
            async def listening():
                return await probe.get_round_params()

            await until(listening, "the coordinator's GET /params")
            params = await probe.get_round_params()
            keys = keys_for_task(params.seed.as_bytes(), params.sum, params.update, "sum")
            sm = StateMachine(PetSettings(keys=keys, device="cpu"), HttpClient(url), NoModel())
            await step_until(sm, "sum2")
            return sm

        summer = asyncio.run(sum_phase())
        cfg = dict(runner.default_cfg(), url=url, participants=n_up, drivers=2, block_size=8,
                   concurrency=8, model_length=length, wire="auto", device="cpu",
                   sum_wait_s=30.0)  # fmt: skip
        stats = runner.run(cfg)
        assert stats["accepted"] == n_up and stats["errors"] == stats["abandoned"] == 0
        assert stats["post_s"]["n"] == n_up and stats["post_s"]["max"] >= stats["post_s"]["p50"]
        assert set(stats["drivers"]) == {"0", "1"}
        assert sum(stats["launches"].values()) == 0  # the plain versions on the CPU

        async def finish():
            await step_until(summer, "awaiting")

            async def model_ready():
                return (await probe.get_model()) is not None

            await until(model_ready, "the global model")
            return np.asarray(await probe.get_model())

        model = asyncio.run(finish())
    finally:
        probe.close()
        coordinator.stop()
    seeds, weights, scalar = runner.ground_truth(cfg)
    pair = convert.config_pair(SHIPPED.pair())
    sim = SimRound(SimSpec(pair, length, block_size=8), device="cpu").run(seeds, weights, scalar)
    assert model.dtype == np.float64 and model.tobytes() == sim.global_model.tobytes()
    assert kernels.LAUNCHES["mask_fold_rows"] == 0
