"""Coordinator process wiring and entry point.

Functional port of the reference's startup (reference:
rust/xaynet-server/src/bin/main.rs:29-138): settings -> logging -> metrics ->
store -> state-machine initializer -> REST server, with the state machine
and the API as the two long-lived tasks.

Run:  python -m xaynet_tpu_torch.server.runner -c configs/config.toml

With ``[tenancy] enabled`` :func:`serve` hands off to
:func:`serve_tenants`: one process serves several tenants' rounds on one
device, through one REST listener (``/t/<tenant>/...``), one page pool and
one fold-batch scheduler, each tenant with its own settings file
(``config_dir/<tenant>.toml``) and scoped store. The rounds' folds and
unmasks run on CUDA unless the caller of :func:`serve` passes another
torch device, whatever ``[aggregation] device`` says (the port has no host
fold beside the device one: on a CPU device the same pipeline takes the
plain versions); every tenant gets the same device. The device is
resolved before the REST API starts, and without a CUDA device the
process exits with an error instead of serving (it never folds on the CPU
in the card's place). With ``[ingest] enabled`` each round's ``POST
/message`` goes through an ingest pipeline (``ingest.IngestPipeline``:
admission, sharded intake, batched decrypt workers, the update
coalescer); a tenant's pipeline also charges the process-wide per-tenant
admission budget. The settings refuse what the port does not have
(``Settings.validate_port``).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import sys
import time
from typing import Optional

from ..storage.memory import (
    FileCoordinatorStorage,
    FilesystemModelStorage,
    InMemoryCoordinatorStorage,
    InMemoryModelStorage,
    NoOpTrustAnchor,
)
from ..device import DeviceUnavailable, resolve_device
from ..storage.traits import Store
from ..telemetry import BridgedMetrics, RoundReporter
from ..utils import tracing
from .metrics import InfluxHttpMetrics, InfluxLineMetrics, JsonlMetrics, LogMetrics
from .rest import RestServer
from .services import Fetcher, PetMessageHandler
from .settings import Settings
from .state_machine import StateMachineInitializer

logger = logging.getLogger("xaynet.coordinator")


def init_store(settings: Settings, tenant: str = "default") -> Store:
    # tenant-scoped storage keys (docs/DESIGN.md §19): a non-default tenant
    # gets a "t-<tenant>" subtree for the file / filesystem backends, so N
    # tenants share one model_dir without key collisions. The default
    # tenant keeps the flat layout (single-tenant deployments are
    # unchanged). The redis backend is not ported (ROADMAP item 19).
    scoped_dir = settings.storage.model_dir
    if tenant != "default":
        scoped_dir = os.path.join(settings.storage.model_dir, f"t-{tenant}")
    if settings.storage.coordinator == "file":
        os.makedirs(scoped_dir, exist_ok=True)
        coordinator = FileCoordinatorStorage(os.path.join(scoped_dir, "coordinator_state.json"))
    else:
        coordinator = InMemoryCoordinatorStorage()
    if settings.storage.backend == "filesystem":
        models = FilesystemModelStorage(scoped_dir)
    else:
        # memory archives EVERY round's model in RAM (a slow leak in a
        # long-running coordinator) — fine for tests/benches, wrong for
        # production; configs/config.toml documents filesystem as default
        logging.getLogger("xaynet.runner").warning(
            "model storage backend 'memory' keeps all round models in RAM; "
            "use [storage] backend = \"filesystem\" in production"
        )
        models = InMemoryModelStorage()
    return Store(coordinator, models, NoOpTrustAnchor())


def init_metrics(settings: Settings):
    if not settings.metrics.enable:
        return None
    if settings.metrics.sink == "jsonl":
        return JsonlMetrics(settings.metrics.path)
    if settings.metrics.sink == "influx":
        return InfluxLineMetrics(settings.metrics.path)
    if settings.metrics.sink == "influx-http":
        return InfluxHttpMetrics(settings.metrics.url, settings.metrics.database)
    return LogMetrics()


def init_logging(settings: Settings) -> None:
    """Default logging with request-id correlation: every record carries
    ``%(request_id)s`` (set by ``tracing.RequestIdFilter`` from the
    contextvar the message pipeline assigns), so one grep on an id yields
    the full path of a message through pipeline and state machine."""
    logging.basicConfig(
        level=getattr(logging, settings.log.filter.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s [%(request_id)s] %(message)s",
    )
    # the filter must sit on the handlers: logger-level filters don't apply
    # to records propagated from child loggers
    for handler in logging.getLogger().handlers:
        if not any(isinstance(f, tracing.RequestIdFilter) for f in handler.filters):
            handler.addFilter(tracing.RequestIdFilter())


def _install_process_hooks(settings: Settings) -> None:
    """What both boot paths install process-wide from the (base) settings:
    a configured fault plan (before any store is wrapped, so storage,
    ingest and streaming sites all see the same seeded schedule;
    tools/soak.py --faults drives this), the distributed round tracer and
    flight recorder (docs/DESIGN.md §16: [metrics] trace/trace_dir/
    flight_dir override the env defaults), and the SLO engine (per-tenant
    targets + burn-rate alerting over the round-wall timeline,
    docs/DESIGN.md §20)."""
    from ..telemetry import recorder as flight_recorder, slo as slo_engine, tracing as trace

    if settings.resilience.fault_plan:
        from ..resilience import FaultPlan, install_plan

        install_plan(FaultPlan.parse(settings.resilience.fault_plan))
        logger.warning("fault plan installed: %s", settings.resilience.fault_plan)
    trace.get_tracer().configure(
        # empty settings defer to the env defaults the Tracer already read
        # (XAYNET_TRACE / XAYNET_TRACE_DIR); explicit config wins
        mode=settings.metrics.trace or None,
        trace_dir=settings.metrics.trace_dir or None,
    )
    flight_recorder.get_recorder().configure(settings.metrics.flight_dir or None)
    slo_engine.configure(settings.slo)


async def _start_listener(rest: RestServer, settings: Settings, boot_t0: float) -> None:
    """Start the REST listener ([api] bind_address, TLS when configured)
    and record the restart-to-serving wall (docs/DESIGN.md §9): process
    entry to the API accepting requests, store restores and journal
    resumes included — the recovery-time number the kill-matrix bench
    gate tracks."""
    from ..resilience.checkpoint import RECOVERY_SECONDS

    host, _, port = settings.api.bind_address.partition(":")
    tls = None
    if settings.api.tls_certificate:
        import ssl

        tls = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        tls.load_cert_chain(settings.api.tls_certificate, settings.api.tls_key)
        if settings.api.tls_client_auth:
            tls.verify_mode = ssl.CERT_REQUIRED
            tls.load_verify_locations(settings.api.tls_client_auth)
    await rest.start(host or "127.0.0.1", int(port or 8081), tls)
    RECOVERY_SECONDS.set(time.monotonic() - boot_t0)


def _stop_signal() -> asyncio.Future:
    """A future SIGINT/SIGTERM cancel. Off the main thread (an in-process
    coordinator) or on a non-unix loop there are no handlers: the caller
    stops the coordinator by cancelling its task."""
    stop = asyncio.get_running_loop().create_future()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            asyncio.get_running_loop().add_signal_handler(sig, lambda: stop.cancel())
        except (NotImplementedError, RuntimeError):
            pass
    return stop


async def _shut_down(contexts: list, rest: RestServer, what: str) -> None:
    """The orderly stop of every served round (one context on the
    single-tenant path). Graceful-signal flush (docs/DESIGN.md §9): each
    running phase's journal hook is captured BEFORE its machine is
    cancelled — a SIGTERM between the update phase's save cadence points
    must not drop accepted updates. A cancelled machine never reaches the
    Shutdown phase, so each request channel is closed here, strictly per
    channel: queued and in-flight requests are rejected instead of
    awaiting a machine that will never answer. Each metrics bridge then
    flushes its in-flight round report and its dispatcher's queued tail,
    and the flight ring (recent spans + counter deltas) and the in-flight
    round's trace window land on disk, as a crash dump would."""
    from ..telemetry import recorder as flight_recorder, tracing as trace

    flushes = []
    for ctx in contexts:
        phase = ctx.machine.phase
        hook = getattr(phase.shared, "flush_hook", None) if phase is not None else None
        if hook is not None:
            flushes.append((ctx.tenant, hook))
    tasks = [ctx.task for ctx in contexts if ctx.task is not None]
    for task in tasks:
        task.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    for tenant, hook in flushes:
        try:
            await hook()
            logger.info("tenant %s: final journal entry flushed", tenant)
        except Exception as err:
            logger.warning("tenant %s: journal flush failed: %s", tenant, err)
    for ctx in contexts:
        ctx.request_tx.close()
    await rest.stop()
    for ctx in contexts:
        # the closed channels fail the pipelines' last coalescer flush fast
        if ctx.pipeline is not None:
            await ctx.pipeline.stop()
        ctx.metrics.close()
    flight_recorder.flight_dump("shutdown", f"{what} stopping (signal or machine exit)")
    trace.get_tracer().end_round()
    logger.info("%s stopped", what)


async def serve(settings: Settings, store: Optional[Store] = None, device=None) -> None:
    """Run the coordinator until SIGINT/SIGTERM or the machine's end.

    ``device`` is the torch device of the round's aggregator (``None``:
    CUDA, raising ``DeviceUnavailable`` without one); it is resolved before
    anything else starts. With ``[tenancy] enabled`` it runs
    :func:`serve_tenants` (``store`` must then be None: each tenant gets
    its own scoped store)."""
    from ..resilience import wrap_store
    from ..tenancy import DEFAULT_TENANT, TenantContext

    boot_t0 = time.monotonic()
    settings.validate()
    device = resolve_device(device)
    if settings.tenancy.enabled:
        if store is not None:
            raise ValueError("a multi-tenant coordinator builds one store per tenant")
        await serve_tenants(settings, device=device, boot_t0=boot_t0)
        return
    init_logging(settings)
    if settings.aggregation.device:
        logger.info("round aggregation on %s", device)
    else:
        logger.info(
            "round aggregation on %s ([aggregation] device = false names the JAX "
            "package's host fold; the port folds on the resolved device)", device
        )
    store = store if store is not None else init_store(settings)
    _install_process_hooks(settings)
    # every storage call flows through retry + circuit breaker from here on
    store = wrap_store(store, settings.resilience)
    # registry-first telemetry: the configured sink (if any) and the
    # per-round JSON reporter both consume the bridge's measurements
    reporter = (
        RoundReporter(settings.metrics.round_report_path)
        if settings.metrics.round_report_path
        else None
    )
    metrics = BridgedMetrics(sink=init_metrics(settings), reporter=reporter)
    initializer = StateMachineInitializer(settings, store, metrics, device=device)
    machine, request_tx, events = await initializer.init()

    handler = PetMessageHandler(
        events, request_tx, wire_ingest=settings.aggregation.wire_ingest
    )
    fetcher = Fetcher(events)
    pipeline = None
    if settings.ingest.enabled:
        from ..ingest import IngestPipeline

        pipeline = IngestPipeline(handler, request_tx, events, settings.ingest)
        await pipeline.start()
    rest = RestServer(fetcher, handler, registry=metrics.registry, pipeline=pipeline)
    await _start_listener(rest, settings, boot_t0)
    stop = _stop_signal()
    ctx = TenantContext(tenant=DEFAULT_TENANT, settings=settings, machine=machine,
                        request_tx=request_tx, pipeline=pipeline, metrics=metrics)  # fmt: skip
    ctx.task = asyncio.create_task(machine.run())
    try:
        await asyncio.wait([ctx.task, stop], return_when=asyncio.FIRST_COMPLETED)
    except asyncio.CancelledError:
        pass
    finally:
        await _shut_down([ctx], rest, "coordinator")


def _tenant_settings(base: Settings, tenant: str) -> Settings:
    """One tenant's effective settings: ``config_dir/<tenant>.toml`` when
    present (full settings file, the port's loader with env overrides and
    ``validate_port``, so a tenant file that sets what the port lacks is
    refused by name), else a copy of the base. The per-tenant copy never
    re-enters multi-tenant wiring (its [tenancy] section is cleared)."""
    import copy

    from .settings import TenancySettings

    cfg = None
    if base.tenancy.config_dir:
        path = os.path.join(base.tenancy.config_dir, f"{tenant}.toml")
        if os.path.exists(path):
            cfg = Settings.load(path)
            logger.info("tenant %s: settings loaded from %s", tenant, path)
    if cfg is None:
        cfg = copy.deepcopy(base)
    cfg.tenancy = TenancySettings()
    return cfg


async def _build_tenant_context(settings: Settings, tenant: str, budget, registry, device):
    """Build ONE tenant's full round pipeline and register it: scoped
    store, resilient wrapper, metrics bridge, phase machine (on
    ``device``), handler, fetcher and, with ``[ingest] enabled`` in the
    tenant's settings, its ingest pipeline charging ``budget`` (the
    process-wide ``TenantAdmissionBudget``). Shared by the serve_tenants boot
    loop and the lifecycle manager's runtime onboard — the runtime path
    builds tenants with exactly the wiring boot-time ones get. Returns
    ``(TenantContext, TenantRoutes)`` (the machine task is NOT started
    here; the caller owns task lifetime)."""
    from ..resilience import wrap_store
    from ..tenancy import TenantContext
    from .rest import TenantRoutes

    tset = _tenant_settings(settings, tenant)
    store = wrap_store(init_store(tset, tenant), tset.resilience, tenant=tenant)
    reporter = (
        RoundReporter(tset.metrics.round_report_path, tenant=tenant)
        if tset.metrics.round_report_path
        else None
    )
    metrics = BridgedMetrics(sink=init_metrics(tset), reporter=reporter)
    initializer = StateMachineInitializer(tset, store, metrics, tenant=tenant, device=device)
    machine, request_tx, events = await initializer.init()
    handler = PetMessageHandler(events, request_tx, wire_ingest=tset.aggregation.wire_ingest)
    fetcher = Fetcher(events)
    pipeline = None
    if tset.ingest.enabled:
        from ..ingest import IngestPipeline

        pipeline = IngestPipeline(
            handler, request_tx, events, tset.ingest, tenant=tenant, budget=budget
        )
        await pipeline.start()
    ctx = registry.add(
        TenantContext(
            tenant=tenant,
            settings=tset,
            store=store,
            machine=machine,
            request_tx=request_tx,
            events=events,
            handler=handler,
            fetcher=fetcher,
            pipeline=pipeline,
            metrics=metrics,
        )
    )
    logger.info(
        "tenant %s: model_len=%d group=%s on %s (round pipeline up)",
        tenant,
        tset.model.length,
        tset.mask.group_type.name,
        device,
    )
    return ctx, TenantRoutes(fetcher=fetcher, handler=handler, pipeline=pipeline)


async def serve_tenants(settings: Settings, device=None, boot_t0: Optional[float] = None) -> None:
    """Multi-tenant coordinator (docs/DESIGN.md §19, §23): one process
    serves every ``[tenancy] tenants`` id — each a full, independent round
    pipeline (scoped store, request channel, phase machine) — on ONE
    device (``device``; None: CUDA), with ONE page pool, ONE fold-batch
    scheduler and ONE REST listener routing ``/t/<tenant>/...`` (the first
    tenant also serves the bare legacy routes). With ``[tenancy]
    admin_token`` set, the tenant set is ELASTIC: ``/admin/tenants``
    onboards, drains and reconfigures tenants at runtime through the
    lifecycle manager."""
    from ..telemetry import slo as slo_engine
    from ..tenancy import (
        TenantAdmissionBudget,
        TenantLifecycle,
        TenantRegistry,
        configure_pool,
        configure_scheduler,
        install_manager,
    )
    from .rest import TenantRoutes

    boot_t0 = time.monotonic() if boot_t0 is None else boot_t0
    settings.validate()
    device = resolve_device(device)
    init_logging(settings)
    ten = settings.tenancy
    configure_pool(ten.page_kib, ten.slab_pages, ten.host_pages, ten.device_pages)
    configure_scheduler(ten.max_inflight_folds)
    # per-tenant admission budget over the process-wide intake: the
    # tenants' ingest pipelines charge it (§19)
    budget = TenantAdmissionBudget(ten.ingest_capacity, ten.max_share)
    # process-wide, from the base settings (the SLO engine keeps per-tenant
    # state inside, tenant targets included)
    _install_process_hooks(settings)

    registry = TenantRegistry()
    routes: dict[str, TenantRoutes] = {}
    for tenant in ten.tenants:
        _, troutes = await _build_tenant_context(settings, tenant, budget, registry, device)
        routes[tenant] = troutes

    # elastic lifecycle (docs/DESIGN.md §23): the manager owns runtime
    # onboard/drain over the SAME builder the boot loop used, fault
    # quarantine fed by the phase close paths, and the SLO->scheduler
    # demotion feedback loop
    lifecycle = TenantLifecycle(
        ten,
        registry,
        routes,
        budget=budget,
        builder=lambda t: _build_tenant_context(settings, t, budget, registry, device),
    )
    install_manager(lifecycle)
    lifecycle.install_slo_hook(slo_engine.get_engine())
    for tenant in registry.ids():
        lifecycle.mark_serving(tenant)

    default = registry.default
    rest = RestServer(
        default.fetcher,
        default.handler,
        registry=default.metrics.registry,
        pipeline=default.pipeline,
        tenants=routes,
        lifecycle=lifecycle,
        admin_token=ten.admin_token,
        default_tenant=default.tenant,
    )
    # every tenant's store restore + journal resume ran before the
    # listener comes up (each tenant resumes from its scoped journal)
    await _start_listener(rest, settings, boot_t0)
    logger.info(
        "multi-tenant coordinator up: %d tenants (%s), default=%s, on %s",
        len(registry),
        ", ".join(registry.ids()),
        default.tenant,
        device,
    )
    stop = _stop_signal()
    for ctx in registry.contexts():
        ctx.task = asyncio.create_task(ctx.machine.run(), name=f"machine-{ctx.tenant}")
    try:
        # the task set is DYNAMIC under the elastic lifecycle: drained
        # tenants' tasks get cancelled (that must not stop the process),
        # onboarded tenants add new ones — so re-derive the watch set from
        # the registry each pass and only exit when a task belonging to a
        # still-registered tenant finishes (a machine reaching Shutdown)
        # or the stop future fires. A pass also wakes every second, so a
        # tenant onboarded meanwhile joins the watch set.
        while True:
            tasks = [c.task for c in registry.contexts() if c.task is not None]
            done, _ = await asyncio.wait(
                [*tasks, stop], timeout=1.0, return_when=asyncio.FIRST_COMPLETED
            )
            if stop in done:
                break
            live = {c.task for c in registry.contexts()}
            if any(t in live for t in done):
                break
    except asyncio.CancelledError:
        pass
    finally:
        install_manager(None)
        await _shut_down(registry.contexts(), rest, "multi-tenant coordinator")


def main() -> None:
    parser = argparse.ArgumentParser(description="xaynet-tpu coordinator (PyTorch/CUDA port)")
    parser.add_argument("-c", "--config", help="TOML configuration file", default=None)
    args = parser.parse_args()
    settings = Settings.load(args.config)
    try:
        asyncio.run(serve(settings))
    except DeviceUnavailable as err:
        sys.exit(f"coordinator not started: {err}")


if __name__ == "__main__":
    main()
