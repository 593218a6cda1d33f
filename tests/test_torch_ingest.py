"""The port's ingest pipeline (``xaynet_tpu_torch.ingest``) against the JAX one.

The same inputs, made from a seed with numpy, go through both packages:

- the admission controller's verdicts and ``Retry-After`` over one
  occupancy sequence, for several watermark pairs;
- the sharded intake's round-robin placement, ``ShardFull`` and batched
  draining (no linger), and the coalescer's envelope boundaries for
  ``max_batch`` and explicit ``flush()`` points;
- ``RateWindow`` under an injected clock, and the ``ingress`` and health
  snapshots of a pipeline;
- one CPU round: the port's coordinator (``device="cpu"``, device wire
  ingest, v2 uploads) behind its ``RestServer`` with ``[ingest] enabled``,
  and the JAX coordinator in-process behind its own pipeline (never its
  ``RestServer``, whose ``stop()`` hangs on Python 3.12). The update
  uploads queue while the decrypt workers are parked, so the coalescer
  provably groups them; the global models must be byte-identical, with
  fewer fold dispatches than updates and the intake within its bound.
  ``/healthz``'s ``ingest``, ``ingress`` and ``pipeline`` sections carry
  the JAX package's keys, and ``GET /statusz`` renders;
- a saturated intake sheds with 429 and ``Retry-After`` over the port's
  socket exactly where the JAX server's router does, and recovers;
- two tenants with ingest through ``serve()``: the per-tenant budget is
  charged and discharged, a tenant over its share sheds while the other
  is admitted (the verdicts the JAX pipelines give), and a drain stops the
  tenant's pipeline before it reclaims and leaves its budget at 0.

Every asyncio test runs under ``asyncio.wait_for``; waits are on events
(phase changes, a worker's processed batch), never on sleeps.
"""

from __future__ import annotations

import asyncio
import json
import socket
from contextlib import contextmanager
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest

from xaynet_tpu import ingest as jax_ingest
from xaynet_tpu.ingest import intake as jax_intake
from xaynet_tpu.ingest import pipeline as jax_pipeline
from xaynet_tpu.parallel import streaming as jax_streaming
from xaynet_tpu.sdk.client import InProcessClient as JaxInProcessClient
from xaynet_tpu.sdk.simulation import build_update_message as jax_build_update
from xaynet_tpu.sdk.simulation import keys_for_task
from xaynet_tpu.sdk.state_machine import PetSettings as JaxPetSettings
from xaynet_tpu.sdk.state_machine import StateMachine as JaxParticipant
from xaynet_tpu.server import rest as jax_rest
from xaynet_tpu.server import requests as jax_requests
from xaynet_tpu.server import settings as jax_settings
from xaynet_tpu.server.services import Fetcher as JaxFetcher
from xaynet_tpu.server.services import PetMessageHandler as JaxHandler
from xaynet_tpu.server.state_machine import StateMachineInitializer as JaxInitializer
from xaynet_tpu.storage.memory import InMemoryCoordinatorStorage as JaxCoordStore
from xaynet_tpu.storage.memory import InMemoryModelStorage as JaxModels
from xaynet_tpu.storage.memory import NoOpTrustAnchor as JaxAnchor
from xaynet_tpu.storage.traits import Store as JaxStore
from xaynet_tpu.tenancy import TenantAdmissionBudget as JaxBudget

from xaynet_tpu_torch import ingest as port_ingest
from xaynet_tpu_torch.ingest import intake as port_intake
from xaynet_tpu_torch.ingest import pipeline as port_pipeline
from xaynet_tpu_torch.parallel import streaming as port_streaming
from xaynet_tpu_torch.sdk.client import HttpClient as PortHttpClient
from xaynet_tpu_torch.sdk.simulation import build_update_message as port_build_update
from xaynet_tpu_torch.sdk.state_machine import PetSettings as PortPetSettings
from xaynet_tpu_torch.sdk.state_machine import StateMachine as PortParticipant
from xaynet_tpu_torch.server import requests as port_requests
from xaynet_tpu_torch.server import runner
from xaynet_tpu_torch.server import settings as port_settings
from xaynet_tpu_torch.server.aggregation import StagedAggregator
from xaynet_tpu_torch.server.phases import update as port_update_phase
from xaynet_tpu_torch.server.rest import RestServer
from xaynet_tpu_torch.server.services import Fetcher, PetMessageHandler
from xaynet_tpu_torch.server.state_machine import StateMachineInitializer
from xaynet_tpu_torch.storage.memory import (
    InMemoryCoordinatorStorage,
    InMemoryModelStorage,
    NoOpTrustAnchor,
)
from xaynet_tpu_torch.storage.traits import Store
from xaynet_tpu_torch.telemetry.registry import get_registry
from xaynet_tpu_torch.tenancy import TenantAdmissionBudget as PortBudget
from xaynet_tpu_torch.tenancy import lifecycle as port_lifecycle
from xaynet_tpu_torch.tenancy import pool as port_pool_mod
from xaynet_tpu_torch.tenancy import scheduler as port_sched_mod

PACKAGES = {
    "jax": SimpleNamespace(ingest=jax_ingest, intake=jax_intake, pipeline=jax_pipeline,
                           requests=jax_requests, settings=jax_settings),
    "port": SimpleNamespace(ingest=port_ingest, intake=port_intake, pipeline=port_pipeline,
                            requests=port_requests, settings=port_settings),
}  # fmt: skip
N_SUM, N_UPDATE, MODEL_LEN = 1, 6, 64
SUM_PROB, UPDATE_PROB = 0.4, 0.5
QUEUE_BOUND = 8
LOCALS = np.random.default_rng(17).uniform(-1, 1, (N_UPDATE, MODEL_LEN)).astype(np.float32)
MEAN = LOCALS.astype(np.float64).sum(axis=0) / N_UPDATE
GARBAGE = b"\x00" * 400  # long enough to pass the pre-filter, fails decryption


def _run(coro, timeout: float = 120.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# --------------------------------------------------------------------------
# admission, intake, coalescer, RateWindow: the same sequences in both
# --------------------------------------------------------------------------

WATERMARKS = {  # capacity, high, low, retry_after_seconds
    "default": (10, 0.8, 0.5, 1.0),
    "full": (4, 1.0, 1.0, 0.2),
    "wide": (100, 0.5, 0.25, 2.0),
    "flat": (7, 0.6, 0.6, 0.5),
    "soak": (8192, 0.8, 0.5, 0.2),
}


def _admission_trace(pkg, case: str) -> list:
    capacity, high, low, retry = WATERMARKS[case]
    ctl = pkg.ingest.AdmissionController(capacity, high, low, retry)
    rng = np.random.default_rng(len(case))
    out = [("marks", ctl.high_mark, ctl.low_mark)]
    for step in range(300):
        occupancy = int(rng.integers(0, capacity + 1))
        op = int(rng.integers(0, 3))
        if op == 0:
            ctl.observe(occupancy)
            out.append(("observe", occupancy, ctl.saturated))
            continue
        verdict = ctl.admit(occupancy) if op == 1 else ctl.shed_shard_full(occupancy)
        out.append((op, occupancy, verdict.verdict.value, verdict.retry_after, ctl.saturated))
    return out


@pytest.mark.parametrize("case", list(WATERMARKS))
def test_admission_verdicts_match_jax(case):
    assert _admission_trace(PACKAGES["port"], case) == _admission_trace(PACKAGES["jax"], case)


INTAKE_CASES = {"one-shard": (1, 3), "two-shards": (2, 4), "three-shards": (3, 2)}


async def _intake_trace(pkg, case: str) -> list:
    shards, bound = INTAKE_CASES[case]
    intake = pkg.intake.ShardedIntake(shards, bound)
    rng = np.random.default_rng(shards * 100 + bound)
    out, item = [], 0
    for _ in range(200):
        if rng.random() < 0.65:
            before = [s.occupancy for s in intake.shards]
            try:
                intake.put_nowait(item)
                after = [s.occupancy for s in intake.shards]
                out.append(("put", item, [a - b for a, b in zip(after, before)].index(1)))
            except pkg.intake.ShardFull:
                out.append(("full", item))
            item += 1
        else:
            busy = [s for s in intake.shards if s.occupancy]
            if not busy:
                continue
            shard = busy[int(rng.integers(0, len(busy)))]
            batch = await shard.get_batch(int(rng.integers(1, 4)), 0.0)
            intake.drained()
            out.append(("drain", shard.index, batch))
        out.append(([s.occupancy for s in intake.shards], intake.max_occupancy))
    assert intake.max_occupancy <= bound
    return out


@pytest.mark.parametrize("case", list(INTAKE_CASES))
def test_intake_round_robin_and_shard_full_match_jax(case):
    port = _run(_intake_trace(PACKAGES["port"], case))
    assert any(e[0] == "full" for e in port if isinstance(e[0], str))
    assert port == _run(_intake_trace(PACKAGES["jax"], case))


class _RecordingTx:
    """A request sender that records each envelope's size and resolves its
    members, or rejects the ``reject_at``-th envelope."""

    def __init__(self, pkg, reject_at: int = -1):
        self.pkg, self.reject_at, self.sizes = pkg, reject_at, []

    async def request(self, batch) -> None:
        self.sizes.append(len(batch))
        if len(self.sizes) - 1 == self.reject_at:
            raise self.pkg.requests.RequestError(
                self.pkg.requests.RequestError.Kind.INTERNAL, "purged")
        for fut in batch.responses:
            fut.set_result(None)


async def _coalescer_trace(pkg, max_batch: int) -> dict:
    tx = _RecordingTx(pkg, reject_at=2)
    # a linger of an hour never fires: every boundary is max_batch or flush()
    coalescer = pkg.ingest.UpdateCoalescer(tx, max_batch=max_batch, linger_s=3600.0)
    rng = np.random.default_rng(max_batch)
    futures = []
    for i in range(60):
        futures.append(await coalescer.add(SimpleNamespace(index=i)))
        if rng.random() < 0.15:
            await coalescer.flush()
    pending = coalescer.pending
    await coalescer.close()
    return {"sizes": tx.sizes, "pending_before_close": pending,
            "batches": coalescer.batches_sent, "members": coalescer.members_sent,
            "rejected": [i for i, f in enumerate(futures) if f.exception() is not None]}  # fmt: skip


@pytest.mark.parametrize("max_batch", [1, 4, 32])
def test_coalescer_envelopes_match_jax(max_batch):
    port = _run(_coalescer_trace(PACKAGES["port"], max_batch))
    assert port["members"] == 60 and sum(port["sizes"]) == 60
    assert max(port["sizes"]) <= max_batch and port["rejected"]
    assert port == _run(_coalescer_trace(PACKAGES["jax"], max_batch))


def _rate_trace(pkg, window: int) -> list:
    w = pkg.pipeline.RateWindow(window_s=window)
    rng = np.random.default_rng(window)
    t, out = 1000.0, []
    for _ in range(200):
        t += float(rng.exponential(0.7))
        if rng.random() < 0.7:
            w.add(int(rng.integers(1, 5)), now=t)
        out.append(w.rate(now=t + float(rng.uniform(0, 2 * window))))
    return out


@pytest.mark.parametrize("window", [1, 5, 10])
def test_rate_window_matches_jax(window):
    assert _rate_trace(PACKAGES["port"], window) == _rate_trace(PACKAGES["jax"], window)


def _stats_pipeline(pkg, budget=None):
    latest = SimpleNamespace(event=pkg.pipeline.PhaseName.UPDATE)
    events = SimpleNamespace(phase=SimpleNamespace(get_latest=lambda: latest))
    settings = pkg.settings.IngestSettings(enabled=True, shards=3, queue_bound=4)
    return pkg.pipeline.IngestPipeline(None, None, events, settings, tenant="t0", budget=budget)


@pytest.mark.parametrize("with_budget", [False, True], ids=["plain", "budget"])
def test_ingress_stats_and_health_match_jax(with_budget):
    snaps = {}
    for name, pkg in PACKAGES.items():
        budget_cls = JaxBudget if name == "jax" else PortBudget
        pipe = _stats_pipeline(pkg, budget_cls(16, 0.5) if with_budget else None)
        for planar in (True, True, False, None):
            payload = SimpleNamespace() if planar is None else SimpleNamespace(wire_planar=planar)
            pipe._count_accepted(SimpleNamespace(payload=payload))
        pipe._count_shed()
        snaps[name] = (pipe.ingress_stats(), pipe.health())
    assert snaps["port"] == snaps["jax"]
    stats, health = snaps["port"]
    assert stats["accepted_total"] == 4 and stats["wire"] == {"packed": 2, "legacy": 1}
    assert ("budget_limit" in health) is with_budget


# --------------------------------------------------------------------------
# a CPU round through each package's pipeline
# --------------------------------------------------------------------------


def _round_settings(mod):
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
    s.ingest = mod.IngestSettings(
        enabled=True, shards=2, queue_bound=QUEUE_BOUND, high_watermark=1.0,
        low_watermark=0.5, coalesce_max_batch=4, wire_format="packed",
    )  # fmt: skip
    return s


async def _until_phase(events, want: str) -> None:
    while events.phase.get_latest().event.value != want:
        await events.phase.changed()


async def _until_model(events, fetcher) -> np.ndarray:
    while fetcher.model() is None:
        await events.model.changed()
    return np.asarray(fetcher.model())


async def _step_until(sm, want: str, steps: int = 20) -> None:
    """Step a participant until it is in ``want`` (each step that can make
    progress does: the coordinator already published what it needs)."""
    for _ in range(steps):
        await sm.transition()
        if sm.phase.value == want:
            return
    raise AssertionError(f"participant stuck in {sm.phase.value}, wanted {want}")


async def _http(host: str, port: int, method: str, path: str, body: bytes = b""):
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: t\r\nContent-Length: {len(body)}\r\n"
        "Connection: close\r\n\r\n".encode() + body
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    headers = {}
    for line in lines[1:]:
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    return int(lines[0].split()[1]), headers, payload


class _PipelineClient(JaxInProcessClient):
    """The JAX SDK's in-process client, its messages through the pipeline."""

    def __init__(self, fetcher, handler, pipeline):
        super().__init__(fetcher, handler)
        self.pipeline = pipeline

    async def send_message(self, encrypted: bytes) -> None:
        await self.pipeline.submit(encrypted)


async def _queue_then_release(pipeline, submit, blobs) -> int:
    """Park the decrypt workers, queue every upload, release them: the
    coalescer then groups the queued updates whatever the timing."""
    await pipeline.stop()
    await asyncio.gather(*(submit(b) for b in blobs))
    queued = pipeline.intake.occupancy
    await pipeline.start()
    return queued


async def _jax_round() -> dict:
    settings = _round_settings(jax_settings)
    store = JaxStore(JaxCoordStore(), JaxModels(), JaxAnchor())
    machine, request_tx, events = await JaxInitializer(settings, store).init()
    handler, fetcher = JaxHandler(events, request_tx), JaxFetcher(events)
    pipeline = jax_ingest.IngestPipeline(handler, request_tx, events, settings.ingest)
    await pipeline.start()
    rest = jax_rest.RestServer(fetcher, handler, pipeline=pipeline)  # routed, never started
    task = asyncio.create_task(machine.run())
    try:
        await _until_phase(events, "sum")
        params = fetcher.round_params()
        seed = params.seed.as_bytes()
        summer = JaxParticipant(
            JaxPetSettings(keys=keys_for_task(seed, SUM_PROB, UPDATE_PROB, "sum", start=0)),
            _PipelineClient(fetcher, handler, pipeline), _ArrayStore(None),
        )  # fmt: skip
        await _step_until(summer, "sum2")
        await _until_phase(events, "update")
        blobs = [
            jax_build_update(params, keys_for_task(seed, SUM_PROB, UPDATE_PROB, "update",
                                                   start=(20 + i) * 1000),
                             fetcher.sum_dict(), LOCALS[i], Fraction(1, N_UPDATE))
            for i in range(N_UPDATE)
        ]  # fmt: skip

        async def submit(blob):
            assert not (await pipeline.submit(blob)).shed

        queued = await _queue_then_release(pipeline, submit, blobs)
        await _until_phase(events, "sum2")
        await _step_until(summer, "awaiting")
        model = await _until_model(events, fetcher)
        health = json.loads((await rest._route("GET", "/healthz", b""))[1])
        return {"model": model, "queued": queued, "health": health,
                "max_occupancy": pipeline.intake.max_occupancy,
                "members_sent": pipeline.coalescer.members_sent}  # fmt: skip
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        request_tx.close()
        await pipeline.stop()


class _ArrayStore:
    def __init__(self, model):
        self.model = model

    async def load_model(self):
        return self.model


async def _port_round(monkeypatch) -> dict:
    dispatches, aggregators = [], []
    real_flush, real_build = StagedAggregator.flush, port_update_phase.build_staged_aggregator

    def counting_flush(self):
        if self.pending > 0:
            dispatches.append(self.pending)
        return real_flush(self)

    def spy_build(shared):
        aggregators.append(real_build(shared))
        return aggregators[-1]

    monkeypatch.setattr(StagedAggregator, "flush", counting_flush)
    monkeypatch.setattr(port_update_phase, "build_staged_aggregator", spy_build)
    settings = _round_settings(port_settings)
    settings.aggregation.device = True
    settings.aggregation.wire_ingest = True
    store = Store(InMemoryCoordinatorStorage(), InMemoryModelStorage(), NoOpTrustAnchor())
    machine, request_tx, events = await StateMachineInitializer(settings, store,
                                                                device="cpu").init()
    handler = PetMessageHandler(events, request_tx, wire_ingest=True)
    fetcher = Fetcher(events)
    pipeline = port_ingest.IngestPipeline(handler, request_tx, events, settings.ingest)
    await pipeline.start()
    rest = RestServer(fetcher, handler, pipeline=pipeline)
    host, port = await rest.start("127.0.0.1", 0)
    url = f"http://{host}:{port}"
    task = asyncio.create_task(machine.run())
    client = PortHttpClient(url)
    try:
        await _until_phase(events, "sum")
        params = fetcher.round_params()
        seed = params.seed.as_bytes()
        summer = PortParticipant(
            PortPetSettings(keys=keys_for_task(seed, SUM_PROB, UPDATE_PROB, "sum", start=0),
                            device="cpu"),
            client, _ArrayStore(None),
        )  # fmt: skip
        await _step_until(summer, "sum2")
        await _until_phase(events, "update")
        blobs = [
            port_build_update(params, keys_for_task(seed, SUM_PROB, UPDATE_PROB, "update",
                                                    start=(20 + i) * 1000),
                              fetcher.sum_dict(), LOCALS[i], Fraction(1, N_UPDATE))
            for i in range(N_UPDATE)
        ]  # fmt: skip
        statuses = []

        async def submit(blob):
            statuses.append((await _http(host, port, "POST", "/message", blob))[0])

        queued = await _queue_then_release(pipeline, submit, blobs)
        await _until_phase(events, "sum2")
        await _step_until(summer, "awaiting")
        model = await _until_model(events, fetcher)
        health = json.loads((await _http(host, port, "GET", "/healthz"))[2])
        statusz = await _http(host, port, "GET", "/statusz")
        agg = aggregators[0]
        return {"model": model, "queued": queued, "health": health, "statusz": statusz,
                "statuses": statuses, "dispatches": dispatches,
                "max_occupancy": pipeline.intake.max_occupancy,
                "members_sent": pipeline.coalescer.members_sent,
                "prevalidated_chunks": agg.prevalidated_chunks,
                "member_checks": agg.member_checks, "kernel_used": agg.kernel_used}  # fmt: skip
    finally:
        client.close()
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        request_tx.close()
        await rest.stop()
        await pipeline.stop()


# the per-shard gauge families (shard-parallel folds, ROADMAP item 10), in
# both packages: a shard-parallel pipeline that ran earlier in the process
# (another test file in the same worker) leaves a child per shard, which
# /healthz and the round report then list
_SHARD_FAMILIES = ("xaynet_streaming_shard_staging_depth",
                   "xaynet_streaming_shard_inflight_folds",
                   "xaynet_streaming_shard_overlap_ratio")  # fmt: skip


@contextmanager
def _no_shard_children():
    """Both registries without per-shard children while the block runs (a
    one-device round makes none); the children come back after it."""
    from xaynet_tpu.telemetry.registry import get_registry as jax_registry

    saved = []
    for registry in (get_registry(), jax_registry()):
        for name in _SHARD_FAMILIES:
            family = registry.get(name)
            if family is not None:
                saved.append((family, dict(family._children)))
                family._children.clear()
    try:
        yield
    finally:
        for family, children in saved:
            family._children.update(children)


@pytest.fixture(scope="module")
def rounds():
    with _no_shard_children():
        with pytest.MonkeyPatch.context() as mp:
            port = _run(_port_round(mp))
        yield {"port": port, "jax": _run(_jax_round())}


def test_cpu_round_through_pipeline_matches_jax(rounds):
    port, jax = rounds["port"], rounds["jax"]
    assert port["statuses"] == [200] * N_UPDATE
    assert port["queued"] == jax["queued"] == N_UPDATE
    np.testing.assert_allclose(port["model"], MEAN, atol=1e-9)
    assert port["model"].tobytes() == jax["model"].tobytes()
    assert port["members_sent"] == jax["members_sent"] == N_UPDATE
    assert 0 < port["max_occupancy"] <= QUEUE_BOUND
    # coalescing: fewer fold dispatches than updates, all of them folded
    assert 1 <= len(port["dispatches"]) < N_UPDATE and sum(port["dispatches"]) == N_UPDATE
    # each micro-batch of v2 uploads was checked in one K4 call (plain
    # version here), so fewer checks than updates
    assert port["kernel_used"] == "plain" and port["prevalidated_chunks"] >= 1
    assert port["prevalidated_chunks"] + port["member_checks"] < N_UPDATE


def test_healthz_sections_match_jax(rounds):
    port, jax = rounds["port"]["health"], rounds["jax"]["health"]
    for section in ("ingest", "ingress", "pipeline"):
        assert section in port and section in jax, section
        assert set(port[section]) == set(jax[section]), section
    assert "shards" not in port["pipeline"]  # one device, no shards
    assert set(port) == set(jax)
    # the sum, update and sum2 messages all went through the pipeline
    accepted = 2 * N_SUM + N_UPDATE
    assert port["ingress"]["accepted_total"] == jax["ingress"]["accepted_total"] == accepted
    assert port["ingress"]["wire"] == {"packed": N_UPDATE, "legacy": 0}
    assert port["ingest"]["saturated"] is False and port["ingest"]["running"] is True
    assert port["pipeline"]["degraded"] is False and port["pipeline"]["inflight_folds"] >= 0


def test_round_report_carries_the_streaming_section(rounds):
    """The round report's ``streaming`` section reads the gauges the port's
    pipeline declares in the port's registry, with the JAX package's keys."""
    from xaynet_tpu.telemetry import report as jax_report
    from xaynet_tpu.telemetry.registry import get_registry as jax_registry
    from xaynet_tpu_torch.telemetry import report as port_report

    assert get_registry().get("xaynet_streaming_overlap_ratio") is port_streaming.OVERLAP_RATIO
    assert jax_registry().get("xaynet_streaming_overlap_ratio") is jax_streaming.OVERLAP_RATIO
    port, jax = port_report._streaming_snapshot(), jax_report._streaming_snapshot()
    assert port is not None and jax is not None
    assert set(port) == set(jax) == {"overlap_ratio", "degraded"}
    assert 0.0 <= port["overlap_ratio"] <= 1.0 and port["degraded"] is False


def test_statusz_renders_ingress_and_streaming(rounds):
    status, headers, body = rounds["port"]["statusz"]
    html = body.decode()
    assert status == 200 and headers["content-type"].startswith("text/html")
    assert "<h2>ingress</h2>" in html and "<h2>streaming pipeline</h2>" in html
    assert f"<td>{2 * N_SUM + N_UPDATE}</td>" in html


# --------------------------------------------------------------------------
# shedding over the socket, as the JAX server's router answers
# --------------------------------------------------------------------------


def _shed_settings(mod):
    s = _round_settings(mod)
    s.ingest = mod.IngestSettings(enabled=True, shards=1, queue_bound=4, high_watermark=0.5,
                                  low_watermark=0.25, retry_after_seconds=0.2)  # fmt: skip
    return s


def _track_processing(pipeline) -> asyncio.Event:
    """An event set once a worker has processed a batch and left the
    intake empty."""
    drained = asyncio.Event()
    process = pipeline._process

    async def tracked(batch, shard_index=-1):
        await process(batch, shard_index)
        if pipeline.intake.occupancy == 0:
            drained.set()

    pipeline._process = tracked
    return drained


async def _jax_shed_answers() -> list:
    settings = _shed_settings(jax_settings)
    store = JaxStore(JaxCoordStore(), JaxModels(), JaxAnchor())
    machine, request_tx, events = await JaxInitializer(settings, store).init()
    handler, fetcher = JaxHandler(events, request_tx), JaxFetcher(events)
    pipeline = jax_ingest.IngestPipeline(handler, request_tx, events, settings.ingest)
    rest = jax_rest.RestServer(fetcher, handler, pipeline=pipeline)  # routed, never started
    task = asyncio.create_task(machine.run())
    try:
        await _until_phase(events, "sum")
        out = [(await rest._route("POST", "/message", GARBAGE)) for _ in range(4)]
        return [(r[0], (r[3] or {}).get("Retry-After")) for r in out]
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)


def test_saturated_intake_sheds_429_and_recovers():
    registry = get_registry()

    def shed_total():
        return registry.sample_value("xaynet_ingest_shed_total") or 0

    async def run():
        settings = _shed_settings(port_settings)
        store = Store(InMemoryCoordinatorStorage(), InMemoryModelStorage(), NoOpTrustAnchor())
        machine, request_tx, events = await StateMachineInitializer(settings, store,
                                                                    device="cpu").init()
        handler, fetcher = PetMessageHandler(events, request_tx), Fetcher(events)
        # the workers stay parked: nothing drains, so occupancy climbs
        pipeline = port_ingest.IngestPipeline(handler, request_tx, events, settings.ingest)
        rest = RestServer(fetcher, handler, pipeline=pipeline)
        host, port = await rest.start("127.0.0.1", 0)
        task = asyncio.create_task(machine.run())
        try:
            await _until_phase(events, "sum")
            shed0 = shed_total()
            answers = []
            for _ in range(4):
                status, headers, _ = await _http(host, port, "POST", "/message", GARBAGE)
                answers.append((status, headers.get("retry-after")))
            shed = shed_total() - shed0
            saturated = json.loads((await _http(host, port, "GET", "/healthz"))[2])
            drained = _track_processing(pipeline)
            await pipeline.start()
            await drained.wait()
            after = await _http(host, port, "POST", "/message", GARBAGE)
            recovered = json.loads((await _http(host, port, "GET", "/healthz"))[2])
            return answers, shed, saturated, after[0], recovered
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await rest.stop()
            await pipeline.stop()

    answers, shed, saturated, after, recovered = _run(run())
    # saturation at 2 of 4: two admitted, then shed with Retry-After >= 1 s
    assert answers == [(200, None), (200, None), (429, "1"), (429, "1")]
    assert answers == _run(_jax_shed_answers())
    assert shed == 2
    assert saturated["status"] == "saturated" and saturated["ingest"]["occupancy"] == 2
    assert saturated["ingress"]["shed_total"] == 2
    assert after == 200
    assert recovered["status"] == "ok" and recovered["ingest"]["saturated"] is False
    assert recovered["ingress"]["rejected_total"] >= 2  # the garbage failed decryption


# --------------------------------------------------------------------------
# two tenants with ingest through serve()
# --------------------------------------------------------------------------


@pytest.fixture
def port_singletons():
    pool, sched = port_pool_mod._pool, port_sched_mod._scheduler
    yield
    port_pool_mod._pool, port_sched_mod._scheduler = pool, sched


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


TENANT_POSTS = ["a"] * 5 + ["b"] * 2  # capacity 8, share 0.5: a sheds its 5th


async def _jax_tenant_verdicts() -> list:
    budget = JaxBudget(8, 0.5)
    latest = SimpleNamespace(event=jax_pipeline.PhaseName.SUM)
    events = SimpleNamespace(phase=SimpleNamespace(get_latest=lambda: latest))
    settings = jax_settings.IngestSettings(enabled=True, shards=2, queue_bound=64,
                                           high_watermark=1.0)  # fmt: skip
    pipes = {t: jax_ingest.IngestPipeline(None, None, events, settings, tenant=t, budget=budget)
             for t in "ab"}  # fmt: skip
    out = []
    for t in TENANT_POSTS:
        v = await pipes[t].submit(GARBAGE)
        out.append(429 if v.shed else 200)
    return out + [budget.held("a"), budget.held("b")]


def test_tenants_with_ingest_charge_and_discharge_the_budget(tmp_path, port_singletons):
    registry = get_registry()
    tenant_shed = registry.get("xaynet_tenant_ingest_shed_total")

    async def run():
        settings = port_settings.Settings.default()
        settings.api.bind_address = f"127.0.0.1:{_free_port()}"
        settings.model.length = MODEL_LEN
        settings.ingest = port_settings.IngestSettings(enabled=True, shards=2, queue_bound=64,
                                                       high_watermark=1.0)  # fmt: skip
        settings.tenancy.enabled = True
        settings.tenancy.tenants = ["a", "b"]
        settings.tenancy.ingest_capacity = 8
        settings.tenancy.max_share = 0.5
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
            manager = port_lifecycle.get_manager()
            ctx = {t: manager.registry.get(t) for t in "ab"}
            host, port = settings.api.bind_address.split(":")
            port = int(port)
            for c in ctx.values():
                await c.pipeline.stop()  # parked: what is admitted stays charged
                await _until_phase(c.events, "sum")
            shed0 = tenant_shed.labels(tenant="a").value
            statuses = []
            for t in TENANT_POSTS:
                statuses.append((await _http(host, port, "POST", f"/t/{t}/message", GARBAGE))[0])
            budget = manager.budget
            held = [budget.held("a"), budget.held("b")]
            health = json.loads((await _http(host, port, "GET", "/t/a/healthz"))[2])
            shed = tenant_shed.labels(tenant="a").value - shed0
            # the workers drain a's intake: its share comes back
            drained = _track_processing(ctx["a"].pipeline)
            await ctx["a"].pipeline.start()
            await drained.wait()
            held_after_drain = budget.held("a")
            # b's drain: the teardown stops its pipeline before it reclaims
            order = []
            stop_b = ctx["b"].pipeline.stop
            real_reclaim = manager._reclaim_pages

            async def stop_pipeline():
                order.append(("pipeline.stop", budget.held("b")))
                await stop_b()

            def reclaim(tenant, agg):
                order.append(("reclaim", budget.held("b")))
                real_reclaim(tenant, agg)

            ctx["b"].pipeline.stop = stop_pipeline
            manager._reclaim_pages = reclaim
            drained_b = await manager.offboard("b")
            return statuses, held, health, shed, held_after_drain, order, drained_b, budget
        finally:
            runner._start_listener = real_listener
            server.cancel()
            await asyncio.gather(server, return_exceptions=True)

    statuses, held, health, shed, held_after, order, drained_b, budget = _run(run())
    jax = _run(_jax_tenant_verdicts())
    assert statuses + held == jax == [200, 200, 200, 200, 429, 200, 200, 4, 2]
    assert shed == 1
    assert health["ingest"]["tenant"] == "a"
    assert health["ingest"]["budget_held"] == 4 and health["ingest"]["budget_limit"] == 4
    assert held_after == 0
    assert drained_b["state"] == "drained"
    assert order == [("pipeline.stop", 2), ("reclaim", 0)]
    assert budget.held("b") == 0
