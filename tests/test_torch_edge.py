"""The port's edge tier (``xaynet_tpu_torch.edge``) against the JAX
package's (``xaynet_tpu.edge``), on the CPU.

Mirrors ``tests/test_edge_tier.py`` and ``tests/test_protocol_edge.py``:

- envelope bytes: the port's ``to_bytes`` equals the JAX package's for the
  same window, and each side parses the other's bytes; corruption fails;
- the partition merge: K random partitions folded through edge partials
  equal the flat fold, byte for byte;
- a two-tier round (the port's coordinator with ``[edge] enabled`` on the
  CPU, two port ``EdgeService`` processes' worth of edges on the event
  loop, port SDK participants) whose global model equals, byte for byte,
  the JAX package's two-tier round and the port's flat round on the same
  models, with the coordinator folding fewer envelopes than updates;
- the per-edge watermark and the envelope's atomicity, ``start_seq`` after
  a crashed incarnation, a coalesced batch straddling a window's end, an
  edge crash mid-window (participants fall back upstream);
- the stitched trace of a two-tier round (one trace id across the REST,
  ingest, stream, phase, edge and SDK spans);
- a tenant's drain with the edge tier on: it stops the envelope path
  (closes the request channel), closes the round's aggregator, then
  reclaims, and an envelope after the drain is refused.

Tolerance: none. Masked aggregates are exact; the decoded models are
compared as bytes.
"""

from __future__ import annotations

import asyncio
import json
import socket
import sys
from fractions import Fraction
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import xaynet_tpu.edge as jax_edge
import xaynet_tpu_torch.edge as port_edge
from xaynet_tpu.core.crypto.encrypt import PublicEncryptKey as JPublicEncryptKey
from xaynet_tpu.core.crypto.sign import SigningKeyPair as JSigningKeyPair
from xaynet_tpu.core.mask.masking import Masker as JMasker
from xaynet_tpu.core.mask.model import Scalar as JScalar
from xaynet_tpu.edge.rest import EdgeRestServer as JEdgeRestServer
from xaynet_tpu.sdk import client as jax_client
from xaynet_tpu.sdk import simulation as jax_sim
from xaynet_tpu.sdk import state_machine as jax_sm
from xaynet_tpu.sdk.traits import ModelStore as JModelStore
from xaynet_tpu.server import requests as jax_requests
from xaynet_tpu.server import rest as jax_rest
from xaynet_tpu.server import services as jax_services
from xaynet_tpu.server import settings as jax_settings
from xaynet_tpu.server.state_machine import StateMachineInitializer as JInitializer
from xaynet_tpu.storage import memory as jax_memory
from xaynet_tpu.storage.traits import Store as JStore
from xaynet_tpu_torch import convert
from xaynet_tpu_torch.core.mask.masking import Aggregation
from xaynet_tpu_torch.core.mask.seed import EncryptedMaskSeed
from xaynet_tpu_torch.edge.rest import EdgeRestServer
from xaynet_tpu_torch.sdk import client as port_client
from xaynet_tpu_torch.sdk import simulation as port_sim
from xaynet_tpu_torch.sdk import state_machine as port_sm
from xaynet_tpu_torch.sdk.traits import ModelStore
from xaynet_tpu_torch.server import requests as port_requests
from xaynet_tpu_torch.server import rest as port_rest
from xaynet_tpu_torch.server import runner
from xaynet_tpu_torch.server import services as port_services
from xaynet_tpu_torch.server import settings as port_settings
from xaynet_tpu_torch.server.state_machine import StateMachineInitializer
from xaynet_tpu_torch.storage import memory as port_memory
from xaynet_tpu_torch.storage.traits import Store
from xaynet_tpu_torch.telemetry.registry import get_registry
from xaynet_tpu_torch.tenancy import lifecycle as port_lifecycle
from xaynet_tpu_torch.tenancy import pool as port_pool_mod
from xaynet_tpu_torch.tenancy import scheduler as port_sched_mod

REPO = Path(__file__).resolve().parents[1]
SUM_PROB, UPDATE_PROB = 0.4, 0.5
MODEL_LEN = 7


class _ArrayModelStore:
    def __init__(self, model=None):
        self.model = model

    async def load_model(self):
        return self.model


class _PortStore(_ArrayModelStore, ModelStore):
    pass


class _JaxStore(_ArrayModelStore, JModelStore):
    pass


def _pkg(name: str) -> SimpleNamespace:
    """The JAX package's or the port's classes under one set of names."""
    if name == "jax":
        return SimpleNamespace(
            name=name, edge=jax_edge, settings=jax_settings, requests=jax_requests,
            client=jax_client, sim=jax_sim, RestServer=jax_rest.RestServer,
            EdgeRestServer=JEdgeRestServer, services=jax_services,
            Store=lambda: JStore(jax_memory.InMemoryCoordinatorStorage(),
                                 jax_memory.InMemoryModelStorage(), jax_memory.NoOpTrustAnchor()),
            init=lambda s, store: JInitializer(s, store).init(),
            participant=lambda keys, url: jax_sm.StateMachine(
                jax_sm.PetSettings(keys=keys), jax_client.ResilientClient(jax_client.HttpClient(url)),
                _JaxStore(None)),
        )  # fmt: skip
    return SimpleNamespace(
        name=name, edge=port_edge, settings=port_settings, requests=port_requests,
        client=port_client, sim=port_sim, RestServer=port_rest.RestServer,
        EdgeRestServer=EdgeRestServer, services=port_services,
        Store=lambda: Store(port_memory.InMemoryCoordinatorStorage(),
                            port_memory.InMemoryModelStorage(), port_memory.NoOpTrustAnchor()),
        init=lambda s, store: StateMachineInitializer(s, store, device="cpu").init(),
        participant=lambda keys, url: port_sm.StateMachine(
            port_sm.PetSettings(keys=keys, device="cpu"),
            port_client.ResilientClient(port_client.HttpClient(url)), _PortStore(None)),
    )  # fmt: skip


PORT = _pkg("port")


def _settings(pkg, n_update: int, phase_max: float = 30.0):
    s = pkg.settings
    settings = s.Settings(
        pet=s.PetSettings(
            sum=s.PhaseSettings(prob=SUM_PROB, count=s.CountSettings(1, 1),
                                time=s.TimeSettings(0, phase_max)),
            update=s.PhaseSettings(prob=UPDATE_PROB, count=s.CountSettings(n_update, n_update),
                                   time=s.TimeSettings(0, phase_max)),
            sum2=s.Sum2Settings(count=s.CountSettings(1, 1), time=s.TimeSettings(0, phase_max)),
        )
    )  # fmt: skip
    settings.model.length = MODEL_LEN
    settings.edge.enabled = True
    return settings


class _Coordinator:
    """In-process coordinator + REST server with the edge API enabled."""

    def __init__(self, pkg, settings):
        self.pkg, self.settings = pkg, settings

    async def __aenter__(self):
        pkg = self.pkg
        self.store = pkg.Store()
        machine, request_tx, events = await pkg.init(self.settings, self.store)
        self.machine = machine
        self.handler = pkg.services.PetMessageHandler(events, request_tx)
        self.fetcher = pkg.services.Fetcher(events)
        self.request_tx = request_tx
        self.edge_api = pkg.edge.EdgeCoordinatorApi(events, request_tx)
        self.rest = pkg.RestServer(self.fetcher, self.handler, edge_api=self.edge_api)
        self.host, self.port = await self.rest.start("127.0.0.1", 0)
        self.machine_task = asyncio.create_task(machine.run())
        return self

    async def __aexit__(self, *exc):
        self.machine_task.cancel()
        await self.rest.stop()
        try:
            await self.machine_task
        except (asyncio.CancelledError, Exception):
            pass

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def wait_phase(self, name: str) -> None:
        while self.fetcher.phase().value != name:
            await asyncio.sleep(0.01)


class _Edge:
    """One in-process edge (EdgeService + participant-facing REST)."""

    def __init__(self, pkg, upstream_url: str, edge_id: str, max_members: int = 64,
                 linger_s: float = 0.05):
        settings = pkg.settings.Settings.default()
        settings.edge = pkg.settings.EdgeSettings(upstream_url=upstream_url, edge_id=edge_id,
                                                  max_members=max_members, linger_s=linger_s,
                                                  poll_s=0.02)  # fmt: skip
        self.service = pkg.edge.EdgeService(settings)
        self.rest = pkg.EdgeRestServer(self.service)

    async def __aenter__(self):
        self.host, self.port = await self.rest.start("127.0.0.1", 0)
        await self.service.start()
        return self

    async def __aexit__(self, *exc):
        await self.rest.stop()
        await self.service.stop()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def wait_update_phase(self) -> None:
        while not self.service.accepting_updates:
            await asyncio.sleep(0.01)


def _requests(config, sum_dict, models, scalar, key_start=5000):
    """JAX-package ``UpdateRequest``s (distinct pks, a masked model and a
    local seed dict each) and the same requests as the port's objects."""
    jax_reqs, port_reqs = [], []
    for i, model in enumerate(models):
        keys = JSigningKeyPair.derive_from_seed((key_start + i).to_bytes(32, "little"))
        seed, masked = JMasker(config).mask(JScalar.from_fraction(scalar), np.asarray(model))
        local = {spk: seed.encrypt(JPublicEncryptKey(epk)) for spk, epk in sum_dict.items()}
        jax_reqs.append(jax_requests.UpdateRequest(keys.public, local, masked))
        port_reqs.append(port_requests.UpdateRequest(
            keys.public, {spk: EncryptedMaskSeed(v.as_bytes()) for spk, v in local.items()},
            convert.mask_object(masked)))  # fmt: skip
    return jax_reqs, port_reqs


def _config(pkg=None):
    return jax_settings.MaskSettings().to_config().pair()


async def _drive_round(pkg, coord, models, update_targets, before_updates=None):
    """One full PET round over REST (``tests/test_edge_tier.py``'s driver on
    ``pkg``'s SDK); update uploads go round-robin to ``update_targets``."""
    probe = pkg.client.HttpClient(coord.url)
    await coord.wait_phase("sum")
    params = await probe.get_round_params()
    seed = params.seed.as_bytes()
    n = len(models)
    for target in update_targets:
        set_round_trace = getattr(target, "set_round_trace", None)
        if set_round_trace is not None:
            set_round_trace(seed)
    summer = pkg.participant(pkg.sim.keys_for_task(seed, SUM_PROB, UPDATE_PROB, "sum", start=0),
                             coord.url)  # fmt: skip

    async def drive_summer():
        for _ in range(4000):
            try:
                await summer.transition()
            except Exception:
                pass
            model = await probe.get_model()
            if model is not None and summer.phase.value == "awaiting":
                return
            await asyncio.sleep(0.01)

    summer_task = asyncio.create_task(drive_summer())
    try:
        await coord.wait_phase("update")
        sum_dict = None
        while not sum_dict:
            sum_dict = await probe.get_sums()
            await asyncio.sleep(0.01)
        if before_updates is not None:
            await before_updates()
        sealed = [
            pkg.sim.build_update_message(
                params, pkg.sim.keys_for_task(seed, SUM_PROB, UPDATE_PROB, "update",
                                              start=(20 + i) * 1000),
                sum_dict, models[i], Fraction(1, n))
            for i in range(n)
        ]  # fmt: skip
        await asyncio.gather(*(update_targets[i % len(update_targets)].send_message(blob)
                               for i, blob in enumerate(sealed)))  # fmt: skip
        await asyncio.wait_for(summer_task, timeout=90)
    finally:
        if not summer_task.done():
            summer_task.cancel()
    model = await probe.get_model()
    probe.close()
    summer.client.close()
    assert model is not None
    return np.asarray(model)


# --- envelope wire format ----------------------------------------------------


def test_envelope_bytes_match_jax_and_each_side_parses_the_other():
    config = _config()
    rng = np.random.default_rng(3)
    models = [rng.uniform(-1, 1, MODEL_LEN).astype(np.float32) for _ in range(3)]
    jreqs, preqs = _requests(config, {b"\x01" * 32: b"\x02" * 32}, models, Fraction(1, 3))
    jagg = jax_edge.EdgeAggregator(config, MODEL_LEN, max_members=8, start_seq=41)
    pagg = port_edge.EdgeAggregator(convert.config_pair(config), MODEL_LEN, max_members=8,
                                    start_seq=41)  # fmt: skip
    for jr, pr in zip(jreqs, preqs):
        jagg.admit(jr)
        pagg.admit(pr)
    jenv, penv = jagg.seal("edge-a", b"\x07" * 32), pagg.seal("edge-a", b"\x07" * 32)
    for env in (jenv, penv):
        env.trace = "0123456789abcdef0123456789abcdef-0123456789abcdef"
    blob = penv.to_bytes()
    assert blob == jenv.to_bytes()
    assert penv.window_seq == 41 and pagg.window_seq == 42
    back = port_edge.PartialAggregateEnvelope.from_bytes(jenv.to_bytes())
    assert back.to_bytes() == blob and back.trace == jenv.trace
    jback = jax_edge.PartialAggregateEnvelope.from_bytes(blob)
    assert jback.to_bytes() == blob and jback.members == penv.members
    assert back.masked.vect.data.tobytes() == jenv.masked.vect.data.tobytes()
    # a shipped member is refused, as in the JAX package
    with pytest.raises(port_edge.EdgeAdmitError, match="duplicate"):
        pagg.admit(preqs[0])
    corrupt = bytearray(blob)
    corrupt[-1] ^= 0x01
    for bad in (bytes(corrupt), blob[: len(blob) // 2], b"NOTMAGIC" + blob):
        with pytest.raises(port_edge.EnvelopeError):
            port_edge.PartialAggregateEnvelope.from_bytes(bad)
        with pytest.raises(jax_edge.EnvelopeError):
            jax_edge.PartialAggregateEnvelope.from_bytes(bad)


def test_window_full_and_empty_seal():
    config = convert.config_pair(_config())
    rng = np.random.default_rng(4)
    _, preqs = _requests(_config(), {b"\x01" * 32: b"\x02" * 32},
                         [rng.uniform(-1, 1, MODEL_LEN).astype(np.float32) for _ in range(2)],
                         Fraction(1, 2))  # fmt: skip
    agg = port_edge.EdgeAggregator(config, MODEL_LEN, max_members=1)
    with pytest.raises(ValueError, match="empty window"):
        agg.seal("e", b"\x00" * 32)
    agg.admit(preqs[0])
    assert agg.full and agg.pending == 1
    with pytest.raises(port_edge.EdgeAdmitError, match="window-full"):
        agg.admit(preqs[1])
    with pytest.raises(ValueError):
        port_edge.EdgeAggregator(config, MODEL_LEN, max_members=0)


# --- partition-merge property ------------------------------------------------


def test_partition_merge_byte_identical_to_flat_fold():
    """K random partitions of one update set, each sealed by a port edge and
    parsed back, merged with ``aggregate_partial``: byte-identical to the
    flat fold, and the merged seed dict is independent of the merge
    order."""
    config = _config()
    pconfig = convert.config_pair(config)
    rng = np.random.default_rng(11)
    n = 12
    models = [rng.uniform(-1, 1, MODEL_LEN).astype(np.float32) for _ in range(n)]
    sum_dict = {b"\x01" * 32: b"\x02" * 32, b"\x03" * 32: b"\x04" * 32}
    _, reqs = _requests(config, sum_dict, models, Fraction(1, n))
    flat = Aggregation(pconfig, MODEL_LEN)
    flat_seed_dict: dict = {}
    for req in reqs:
        flat.aggregate(req.masked_model)
        for sum_pk, enc in req.local_seed_dict.items():
            flat_seed_dict.setdefault(sum_pk, {})[req.participant_pk] = enc.as_bytes()
    for trial in range(4):
        prng = np.random.default_rng(100 + trial)
        k = int(prng.integers(1, 5))
        assignment = prng.integers(0, k, size=n)
        merged = Aggregation(pconfig, MODEL_LEN)
        merged_seed_dict: dict = {}
        total = 0
        for part in list(prng.permutation(k)):
            ids = [i for i in range(n) if assignment[i] == part]
            if not ids:
                continue
            edge = port_edge.EdgeAggregator(pconfig, MODEL_LEN, max_members=n)
            for i in ids:
                edge.admit(reqs[i])
            env = port_edge.PartialAggregateEnvelope.from_bytes(
                edge.seal(f"edge-{part}", b"\x07" * 32).to_bytes())
            merged.aggregate_partial(env.masked, len(env))
            total += len(env)
            for pk in env.members:
                for sum_pk, enc in env.seed_dicts[pk].items():
                    merged_seed_dict.setdefault(sum_pk, {})[pk] = enc.as_bytes()
        assert total == n and merged.nb_models == flat.nb_models == n
        assert merged.object.vect.data.tobytes() == flat.object.vect.data.tobytes()
        assert merged.object.unit.data.tobytes() == flat.object.unit.data.tobytes()
        assert merged_seed_dict == flat_seed_dict


# --- two-tier round ----------------------------------------------------------


async def _two_tier(pkg, models, registry):
    def sample(name, labels=None):
        return registry.sample_value(name, labels) or 0.0

    n = len(models)
    folded0 = sample("xaynet_edge_members_folded_total")
    accepted0 = sample("xaynet_edge_envelopes_total", {"outcome": "accepted"})
    async with _Coordinator(pkg, _settings(pkg, n)) as coord:
        async with _Edge(pkg, coord.url, "edge-a", max_members=4) as ea, \
                _Edge(pkg, coord.url, "edge-b", max_members=4) as eb:  # fmt: skip
            await coord.wait_phase("sum")
            targets = [pkg.client.HttpClient(ea.url), pkg.client.HttpClient(eb.url)]

            async def edges_see_update_phase():
                await ea.wait_update_phase()
                await eb.wait_update_phase()

            try:
                model = await asyncio.wait_for(
                    _drive_round(pkg, coord, models, targets,
                                 before_updates=edges_see_update_phase), 120)  # fmt: skip
            finally:
                for t in targets:  # no keep-alive connection outlives its server
                    t.close()
            health = ea.service.health()
    folded = sample("xaynet_edge_members_folded_total") - folded0
    envelopes = sample("xaynet_edge_envelopes_total", {"outcome": "accepted"}) - accepted0
    return model, folded, envelopes, health


def test_two_tier_round_byte_identical_to_jax_and_flat():
    """A 2-edge x 8-participant round on the port: the global model equals
    the JAX package's two-tier round and the port's flat round byte for
    byte, every update folded through envelopes, 2-4 envelopes for 8
    updates."""
    from xaynet_tpu.telemetry.registry import get_registry as jax_registry

    async def run():
        n = 8
        rng = np.random.default_rng(5)
        models = [rng.uniform(-1, 1, MODEL_LEN).astype(np.float32) for _ in range(n)]
        ours = await _two_tier(PORT, models, get_registry())
        theirs = await _two_tier(_pkg("jax"), models, jax_registry())
        async with _Coordinator(PORT, _settings(PORT, n)) as coord:
            flat = await asyncio.wait_for(
                _drive_round(PORT, coord, models, [port_client.HttpClient(coord.url)]), 120)
        return models, ours, theirs, flat

    models, ours, theirs, flat = asyncio.run(run())
    expected = sum(m.astype(np.float64) for m in models) / len(models)
    np.testing.assert_allclose(ours[0], expected, atol=1e-9)
    assert ours[0].tobytes() == theirs[0].tobytes() == flat.tobytes()
    assert ours[1] == theirs[1] == len(models)
    assert 1 <= ours[2] <= len(models) / 2
    edge = ours[3]["edge"]
    assert edge["synced"] and edge["edge_id"] == "edge-a" and edge["shipped"] >= 1
    assert edge["rejected"] == edge["dropped"] == 0


# --- watermark + atomicity ---------------------------------------------------


def test_envelope_watermark_and_atomicity():
    """On the port's coordinator: a replay at the watermark is acked
    without a second fold, an envelope overlapping a seeded member is
    refused whole, an older window is stale, a wrong round and a garbled
    envelope are refused, and the round unmasks exactly the folded
    members (nb_models agreed with the seed watermark)."""

    async def run():
        n_min = 6
        config = _config()
        pconfig = convert.config_pair(config)
        rng = np.random.default_rng(9)
        models = [rng.uniform(-1, 1, MODEL_LEN).astype(np.float32) for _ in range(8)]
        expected = sum(models[i].astype(np.float64) for i in (0, 1, 2, 3, 4, 6)) / 6
        async with _Coordinator(PORT, _settings(PORT, n_min)) as coord:
            probe = port_client.HttpClient(coord.url)
            await coord.wait_phase("sum")
            params = await probe.get_round_params()
            seed = params.seed.as_bytes()
            summer = PORT.participant(port_sim.keys_for_task(seed, SUM_PROB, UPDATE_PROB, "sum"),
                                      coord.url)  # fmt: skip

            async def drive_summer():
                for _ in range(4000):
                    try:
                        await summer.transition()
                    except Exception:
                        pass
                    model = await probe.get_model()
                    if model is not None and summer.phase.value == "awaiting":
                        return
                    await asyncio.sleep(0.01)

            summer_task = asyncio.create_task(drive_summer())
            try:
                await coord.wait_phase("update")
                sum_dict = None
                while not sum_dict:
                    sum_dict = await probe.get_sums()
                    await asyncio.sleep(0.01)
                _, reqs = _requests(config, sum_dict, models, Fraction(1, 6), key_start=7000)
                aggs: dict = {}

                def seal(member_reqs, edge_id):
                    edge = aggs.setdefault(edge_id, port_edge.EdgeAggregator(pconfig, MODEL_LEN,
                                                                             max_members=8))
                    for r in member_reqs:
                        edge.admit(r)
                    return edge.seal(edge_id, seed)

                api = coord.edge_api
                env_a = seal(reqs[0:3], "edge-a")
                assert (await api.submit_envelope(env_a.to_bytes()))[0]
                ok, detail = await api.submit_envelope(env_a.to_bytes())  # lost-ack replay
                assert ok, detail
                env_overlap = seal([reqs[2], reqs[6]], "edge-b")
                ok, detail = await api.submit_envelope(env_overlap.to_bytes())
                assert not ok and "already seeded" in detail
                seeded = {pk for inner in (await coord.store.coordinator.seed_dict() or {}).values()
                          for pk in inner}  # fmt: skip
                assert reqs[6].participant_pk not in seeded
                assert (await api.submit_envelope(seal([reqs[6]], "edge-a").to_bytes()))[0]
                ok, detail = await api.submit_envelope(env_a.to_bytes())
                assert not ok and "stale" in detail
                env_wrong = seal([reqs[7]], "edge-c")
                env_wrong.round_seed = b"\x00" * 32
                ok, detail = await api.submit_envelope(env_wrong.to_bytes())
                assert not ok and "another round" in detail
                with pytest.raises(port_edge.EnvelopeError):
                    await api.submit_envelope(b"XNEDGE1garbage")
                # over REST: 400 garbled, 409 refused, 401 with a token set
                status = await _post(coord, "/edge/envelope", b"XNEDGE1garbage")
                assert status == 400
                assert await _post(coord, "/edge/envelope", env_a.to_bytes()) == 409
                coord.edge_api.token = "s3cret"
                assert await _post(coord, "/edge/envelope", env_a.to_bytes()) == 401
                coord.edge_api.token = ""
                assert (await api.submit_envelope(seal(reqs[3:5], "edge-b").to_bytes()))[0]
                await asyncio.wait_for(summer_task, timeout=60)
            finally:
                if not summer_task.done():
                    summer_task.cancel()
            return np.asarray(await probe.get_model()), expected

    model, expected = asyncio.run(run())
    np.testing.assert_allclose(model, expected, atol=1e-9)


async def _post(coord, path: str, body: bytes, headers: dict | None = None) -> int:
    reader, writer = await asyncio.open_connection(coord.host, coord.port)
    head = f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Length: {len(body)}\r\n"
    for k, v in (headers or {}).items():
        head += f"{k}: {v}\r\n"
    writer.write(head.encode() + b"Connection: close\r\n\r\n" + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    writer.close()
    return status


# --- restart sequences and straddling windows -------------------------------


def test_aggregator_start_seq_continues_past_a_crashed_incarnation():
    config = _config()
    pconfig = convert.config_pair(config)
    seqs = []
    for incarnation, starts in ((0, [9_500]), (1, [9_600, 9_700])):
        edge = port_edge.EdgeAggregator(pconfig, MODEL_LEN, max_members=4, start_seq=1_000)
        for key_start in starts:
            _, reqs = _requests(config, {b"s" * 32: b"e" * 32}, [np.ones(MODEL_LEN)],
                                Fraction(1, 1), key_start=key_start)  # fmt: skip
            edge.admit(reqs[0])
            seqs.append(edge.seal("edge-r", b"\x05" * 32).window_seq)
    assert seqs == [1_000, 1_000, 1_001]


def test_coalesced_batch_straddling_window_boundary_seals_mid_batch():
    """A coalesced batch of 5 against ``max_members = 2`` seals two full
    windows mid-batch (2 + 2 + 1) instead of bouncing tail members."""

    async def run():
        n = 5
        rng = np.random.default_rng(23)
        models = [rng.uniform(-1, 1, MODEL_LEN).astype(np.float32) for _ in range(n)]
        async with _Coordinator(PORT, _settings(PORT, n)) as coord:
            probe = port_client.HttpClient(coord.url)
            async with _Edge(PORT, coord.url, "edge-straddle", max_members=2) as edge:

                async def inject_batch():
                    await edge.wait_update_phase()
                    sum_dict = await probe.get_sums()
                    _, reqs = _requests(_config(), sum_dict, models, Fraction(1, n),
                                        key_start=11_000)  # fmt: skip
                    loop = asyncio.get_running_loop()
                    futures = [loop.create_future() for _ in reqs]
                    await edge.service.request_tx.request(
                        port_requests.CoalescedUpdates(members=reqs, responses=futures))
                    results = await asyncio.gather(*futures, return_exceptions=True)
                    assert not [r for r in results if isinstance(r, Exception)]

                model = await _drive_round(PORT, coord, [], [port_client.HttpClient(coord.url)],
                                           before_updates=inject_batch)  # fmt: skip
                return model, models, edge.service.shipped

    model, models, shipped = asyncio.run(run())
    np.testing.assert_allclose(model, sum(m.astype(np.float64) for m in models) / 5, atol=1e-9)
    assert shipped >= 3


def test_edge_crash_mid_window_participants_fall_back_upstream():
    """An edge that dies before shipping its window loses nothing durable:
    the participants retry upstream directly and the round completes with
    exactly the final member set."""

    async def run():
        n = 4
        rng = np.random.default_rng(17)
        models = [rng.uniform(-1, 1, MODEL_LEN).astype(np.float32) for _ in range(n)]
        async with _Coordinator(PORT, _settings(PORT, n)) as coord:
            probe = port_client.HttpClient(coord.url)
            async with _Edge(PORT, coord.url, "edge-crash", max_members=64, linger_s=30.0) as edge:
                await coord.wait_phase("sum")
                params = await probe.get_round_params()
                seed = params.seed.as_bytes()
                summer = PORT.participant(
                    port_sim.keys_for_task(seed, SUM_PROB, UPDATE_PROB, "sum"), coord.url)

                async def drive_summer():
                    for _ in range(4000):
                        try:
                            await summer.transition()
                        except Exception:
                            pass
                        model = await probe.get_model()
                        if model is not None and summer.phase.value == "awaiting":
                            return
                        await asyncio.sleep(0.01)

                summer_task = asyncio.create_task(drive_summer())
                try:
                    await coord.wait_phase("update")
                    sum_dict = None
                    while not sum_dict:
                        sum_dict = await probe.get_sums()
                        await asyncio.sleep(0.01)
                    await edge.wait_update_phase()
                    sealed = [port_sim.build_update_message(
                        params, port_sim.keys_for_task(seed, SUM_PROB, UPDATE_PROB, "update",
                                                       start=(40 + i) * 1000),
                        sum_dict, models[i], Fraction(1, n)) for i in range(n)]  # fmt: skip
                    edge_client = port_client.HttpClient(edge.url)
                    for blob in sealed[: n // 2]:
                        await edge_client.send_message(blob)
                    while edge.service.aggregator.pending < n // 2:
                        await asyncio.sleep(0.01)
                    assert edge.service.shipped == 0
                    await edge.service.stop()  # the crash
                    direct = port_client.HttpClient(coord.url)
                    for blob in sealed:
                        await direct.send_message(blob)
                    await asyncio.wait_for(summer_task, timeout=60)
                finally:
                    if not summer_task.done():
                        summer_task.cancel()
                return np.asarray(await probe.get_model()), models

    model, models = asyncio.run(run())
    np.testing.assert_allclose(model, sum(m.astype(np.float64) for m in models) / 4, atol=1e-9)


# --- distributed round tracing -----------------------------------------------


def test_two_tier_round_single_stitched_trace(tmp_path):
    """A two-tier round with the device path on the CPU (the streaming
    pipeline's ``stream.*`` spans) exports ONE trace that passes the trace
    validator, with the rest, ingest, stream, phase, edge and sdk spans
    under one trace id, and the coordinator's fold span linking the edge's
    seal span."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from tools import trace_report
    from xaynet_tpu_torch.telemetry import tracing

    tracer = tracing.get_tracer()
    old_mode, old_dir = tracer.mode, tracer.trace_dir
    tracer.configure(mode="on", trace_dir=str(tmp_path))

    async def run():
        n = 4
        rng = np.random.default_rng(9)
        models = [rng.uniform(-1, 1, MODEL_LEN).astype(np.float32) for _ in range(n)]
        settings = _settings(PORT, n)
        settings.aggregation.device = True
        settings.aggregation.batch_size = 2
        async with _Coordinator(PORT, settings) as coord:
            async with _Edge(PORT, coord.url, "edge-tr", max_members=2) as edge:
                await coord.wait_phase("sum")
                targets = [port_client.ResilientClient(port_client.HttpClient(edge.url))]

                async def edge_ready():
                    await edge.wait_update_phase()

                try:
                    await asyncio.wait_for(
                        _drive_round(PORT, coord, models, targets, before_updates=edge_ready),
                        120)  # fmt: skip
                    for _ in range(400):
                        if list(tmp_path.glob("round_*.trace.json")):
                            break
                        await asyncio.sleep(0.05)
                finally:
                    for t in targets:
                        t.close()

    try:
        asyncio.run(run())
        files = sorted(tmp_path.glob("round_*.trace.json"))
        assert files, "no per-round trace exported"
        events = trace_report.load_events(str(files[0]))
        assert trace_report.validate(events) == []
        (round_event,) = [e for e in events if e["name"] == "round"]
        trace_id = round_event["args"]["trace"]
        stitched = [e for e in events if e["args"].get("trace") == trace_id]
        assert {"rest", "ingest", "stream", "phase", "edge", "sdk"} <= {e["cat"] for e in stitched}
        folds = [e for e in stitched if e["name"] == "edge.upstream_fold"]
        seals = {e["args"]["span"] for e in stitched if e["name"] == "edge.seal"}
        assert folds and any(e["args"].get("link") in seals for e in folds)
    finally:
        tracer.configure(mode=old_mode, trace_dir=old_dir)
        tracer.end_round()


# --- the coordinator's side with tenancy: stop, close, reclaim ---------------


@pytest.fixture
def port_singletons():
    pool, sched = port_pool_mod._pool, port_sched_mod._scheduler
    yield
    port_pool_mod._pool, port_sched_mod._scheduler = pool, sched


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_tenant_drain_stops_the_envelope_path_then_closes_then_reclaims(port_singletons):
    """Two tenants with ``[edge] enabled`` in one ``serve()`` (CPU). Tenant
    ``b`` reaches its Update phase, folds one envelope over ``POST
    /t/b/edge/envelope`` (200), then is drained: the teardown closes b's
    request channel (the envelope path: an envelope then answers 503),
    closes the round's aggregator, and only then reclaims b's pages; after
    the drain ``/t/b/edge/round`` is 404. ``/t/a/edge/round`` serves a's
    round throughout."""

    async def run():
        settings = port_settings.Settings.default()
        settings.api.bind_address = f"127.0.0.1:{_free_port()}"
        settings.model.length = MODEL_LEN
        settings.pet.sum.prob, settings.pet.update.prob = SUM_PROB, UPDATE_PROB
        settings.pet.update.count = port_settings.CountSettings(4, 4)
        settings.edge.enabled = True
        settings.aggregation.device = True
        settings.tenancy.enabled = True
        settings.tenancy.tenants = ["a", "b"]
        settings.tenancy.drain_timeout_s = 0.2
        up = asyncio.Event()
        real_listener = runner._start_listener

        async def listener(rest, s, t0):
            await real_listener(rest, s, t0)
            up.set()

        runner._start_listener = listener
        server = asyncio.create_task(runner.serve(settings, device="cpu"))
        try:
            await asyncio.wait({server, asyncio.ensure_future(up.wait())},
                               return_when=asyncio.FIRST_COMPLETED)  # fmt: skip
            if server.done():
                server.result()
            host, port = settings.api.bind_address.split(":")
            coord = SimpleNamespace(host=host, port=int(port))
            base = f"http://{host}:{port}/t/b"
            manager = port_lifecycle.get_manager()
            ctx = manager.registry.get("b")
            probe = port_client.HttpClient(base)
            while (await probe.get_round_params()) is None:
                await asyncio.sleep(0.01)
            params = await probe.get_round_params()
            seed = params.seed.as_bytes()
            summer = PORT.participant(port_sim.keys_for_task(seed, SUM_PROB, UPDATE_PROB, "sum"),
                                      base)  # fmt: skip
            sum_dict = None
            for _ in range(2000):
                try:
                    await summer.transition()
                except Exception:
                    pass
                sum_dict = await probe.get_sums()
                if sum_dict:
                    break
                await asyncio.sleep(0.01)
            assert sum_dict
            while ctx.machine.phase.shared.round_aggregator is None:
                await asyncio.sleep(0.01)
            agg = ctx.machine.phase.shared.round_aggregator
            config = _config()
            pconfig = convert.config_pair(config)
            rng = np.random.default_rng(31)
            models = [rng.uniform(-1, 1, MODEL_LEN).astype(np.float32) for _ in range(2)]
            _, reqs = _requests(config, sum_dict, models, Fraction(1, 4), key_start=13_000)
            edge = port_edge.EdgeAggregator(pconfig, MODEL_LEN)
            for r in reqs:
                edge.admit(r)
            env = edge.seal("edge-t", seed)
            status_ok = await _post(coord, "/t/b/edge/envelope", env.to_bytes())
            folded = agg.nb_models
            order = []
            real_close_tx = ctx.request_tx.close
            real_agg_close = agg.close
            pool = port_pool_mod.get_pool()
            real_reclaim = pool.reclaim
            statuses_during = []

            def close_tx():
                order.append("request_tx.close")
                real_close_tx()

            def agg_close():
                order.append("aggregator.close")
                real_agg_close()

            def reclaim(tenant):
                order.append(f"pool.reclaim({tenant})")
                return real_reclaim(tenant)

            ctx.request_tx.close = close_tx
            agg.close = agg_close
            pool.reclaim = reclaim
            try:
                drained = await manager.offboard("b")
            finally:
                del pool.reclaim
            statuses_during.append(await _post(coord, "/t/b/edge/envelope", env.to_bytes()))
            a_round = json.loads((await port_client.HttpClient(f"http://{host}:{port}/t/a")
                                  ._request("GET", "/edge/round"))[2])  # fmt: skip
            return status_ok, folded, order, drained, statuses_during, a_round
        finally:
            runner._start_listener = real_listener
            server.cancel()
            await asyncio.gather(server, return_exceptions=True)

    status_ok, folded, order, drained, after, a_round = asyncio.run(run())
    assert status_ok == 200
    assert folded == 2  # one envelope of 2 members
    assert order == ["request_tx.close", "aggregator.close", "pool.reclaim(b)"]
    assert drained["state"] == "drained"
    assert after == [404]
    assert a_round["phase"] in ("sum", "idle", "update") and "secret_key" in a_round
