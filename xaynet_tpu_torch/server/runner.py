"""Coordinator process wiring and entry point.

Functional port of the reference's startup (reference:
rust/xaynet-server/src/bin/main.rs:29-138): settings -> logging -> metrics ->
store -> state-machine initializer -> REST server, with the state machine
and the API as the two long-lived tasks.

Run:  python -m xaynet_tpu_torch.server.runner -c configs/config.toml

The port's runner serves one tenant. The round's fold and unmask run on
CUDA unless the caller of :func:`serve` passes another torch device,
whatever ``[aggregation] device`` says (the port has no host fold beside
the device one: on a CPU device the same pipeline takes the plain
versions). The device is resolved before the REST API starts, and without
a CUDA device the process exits with an error instead of serving (it
never folds on the CPU in the card's place). The settings refuse what the
port does not have (``Settings.validate_port``).
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


def init_store(settings: Settings) -> Store:
    if settings.storage.coordinator == "file":
        os.makedirs(settings.storage.model_dir, exist_ok=True)
        coordinator = FileCoordinatorStorage(
            os.path.join(settings.storage.model_dir, "coordinator_state.json")
        )
    else:
        coordinator = InMemoryCoordinatorStorage()
    if settings.storage.backend == "filesystem":
        models = FilesystemModelStorage(settings.storage.model_dir)
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


async def serve(settings: Settings, store: Optional[Store] = None, device=None) -> None:
    """Run the coordinator until SIGINT/SIGTERM or the machine's end.

    ``device`` is the torch device of the round's aggregator (``None``:
    CUDA, raising ``DeviceUnavailable`` without one); it is resolved before
    anything else starts."""
    boot_t0 = time.monotonic()
    settings.validate()
    device = resolve_device(device)
    init_logging(settings)
    if settings.aggregation.device:
        logger.info("round aggregation on %s", device)
    else:
        logger.info(
            "round aggregation on %s ([aggregation] device = false names the JAX "
            "package's host fold; the port folds on the resolved device)", device
        )
    store = store if store is not None else init_store(settings)
    # deterministic chaos: a configured fault plan installs process-wide
    # BEFORE the resilient wrapper, so storage/ingest/streaming sites all
    # see the same seeded schedule (tools/soak.py --faults drives this)
    if settings.resilience.fault_plan:
        from ..resilience import FaultPlan, install_plan

        install_plan(FaultPlan.parse(settings.resilience.fault_plan))
        logger.warning("fault plan installed: %s", settings.resilience.fault_plan)
    # every storage call flows through retry + circuit breaker from here on
    from ..resilience import wrap_store

    store = wrap_store(store, settings.resilience)
    # registry-first telemetry: the configured sink (if any) and the
    # per-round JSON reporter both consume the bridge's measurements
    reporter = (
        RoundReporter(settings.metrics.round_report_path)
        if settings.metrics.round_report_path
        else None
    )
    metrics = BridgedMetrics(sink=init_metrics(settings), reporter=reporter)
    # distributed round tracing + flight recorder (docs/DESIGN.md §16):
    # [metrics] trace/trace_dir/flight_dir override the env defaults
    from ..telemetry import recorder as flight_recorder, tracing as trace

    trace.get_tracer().configure(
        # empty settings defer to the env defaults the Tracer already read
        # (XAYNET_TRACE / XAYNET_TRACE_DIR); explicit config wins
        mode=settings.metrics.trace or None,
        trace_dir=settings.metrics.trace_dir or None,
    )
    flight_recorder.get_recorder().configure(settings.metrics.flight_dir or None)
    # per-tenant SLO targets + burn-rate alerting over the always-on
    # round-wall timeline (docs/DESIGN.md §20)
    from ..telemetry import slo as slo_engine

    slo_engine.configure(settings.slo)
    initializer = StateMachineInitializer(settings, store, metrics, device=device)
    machine, request_tx, events = await initializer.init()

    handler = PetMessageHandler(
        events, request_tx, wire_ingest=settings.aggregation.wire_ingest
    )
    fetcher = Fetcher(events)
    rest = RestServer(fetcher, handler, registry=metrics.registry)
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
    # restart-to-serving wall (docs/DESIGN.md §9): process entry to the API
    # accepting requests, store restore + journal resume included — THE
    # recovery-time number the kill-matrix bench gate tracks
    from ..resilience.checkpoint import RECOVERY_SECONDS

    RECOVERY_SECONDS.set(time.monotonic() - boot_t0)

    stop = asyncio.get_running_loop().create_future()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            asyncio.get_running_loop().add_signal_handler(sig, lambda: stop.cancel())
        except (NotImplementedError, RuntimeError):
            # non-unix, or a loop outside the main thread (an in-process
            # coordinator): the caller stops it by cancelling the task
            pass

    machine_task = asyncio.create_task(machine.run())
    try:
        done, _ = await asyncio.wait(
            [machine_task, stop], return_when=asyncio.FIRST_COMPLETED
        )
    except asyncio.CancelledError:
        pass
    finally:
        # graceful-signal flush (docs/DESIGN.md §9): capture the running
        # phase's journal hook BEFORE cancelling — a SIGTERM between the
        # update phase's save cadence points must not drop accepted updates
        phase = machine.phase
        flush = getattr(phase.shared, "flush_hook", None) if phase is not None else None
        machine_task.cancel()
        await asyncio.gather(machine_task, return_exceptions=True)
        if flush is not None:
            try:
                await flush()
                logger.info("graceful shutdown: final journal entry flushed")
            except Exception as err:
                logger.warning("graceful shutdown: journal flush failed: %s", err)
        # a cancelled machine never reaches the Shutdown phase, so close the
        # request channel here: queued/in-flight requests are rejected
        # instead of awaiting a state machine that will never answer
        request_tx.close()
        await rest.stop()
        # flush the in-flight round report and drain the dispatcher thread's
        # queued tail — without this the InfluxHttp dispatcher dies with
        # whatever was still batching
        metrics.close()
        # forensic tail: the flight ring (recent spans + counter deltas)
        # lands on disk with every orderly exit, so a post-mortem has the
        # same bundle a crash dump would carry
        flight_recorder.flight_dump(
            "shutdown", "coordinator stopping (signal or machine exit)"
        )
        # ... and the in-flight round's trace window (Chrome export)
        trace.get_tracer().end_round()
        logger.info("coordinator stopped")


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
