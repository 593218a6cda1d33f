"""Edge aggregator process wiring and entry point.

Run:  python -m xaynet_tpu_torch.edge.runner -c edge.toml

Port of ``xaynet_tpu/edge/runner.py``. An edge needs no card (it folds on
the host), so the runner takes no device. The config reuses the
coordinator's loader: ``[edge]`` names the upstream
coordinator and the window bounds, ``[api]`` binds the participant-facing
socket, ``[ingest]`` tunes the reused admission/intake machinery and
``[log]`` the logging — everything else is ignored by the edge role.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

from ..utils import tracing
from .rest import EdgeRestServer
from .service import EdgeService
from ..server.settings import Settings

logger = logging.getLogger("xaynet.edge")


async def serve(settings: Settings) -> None:
    settings.edge.validate_runner()
    logging.basicConfig(
        level=getattr(logging, settings.log.filter.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s [%(request_id)s] %(message)s",
    )
    for handler in logging.getLogger().handlers:
        if not any(isinstance(f, tracing.RequestIdFilter) for f in handler.filters):
            handler.addFilter(tracing.RequestIdFilter())

    service = EdgeService(settings)
    rest = EdgeRestServer(service)
    host, _, port = settings.api.bind_address.partition(":")
    bound_host, bound_port = await rest.start(host or "127.0.0.1", int(port or 8082))
    if not settings.edge.edge_id:
        # a stable-enough default identity: the bound participant socket
        service.edge_id = f"edge-{bound_host}:{bound_port}"
    await service.start()

    stop = asyncio.get_running_loop().create_future()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            asyncio.get_running_loop().add_signal_handler(sig, lambda: stop.cancel())
        except NotImplementedError:  # pragma: no cover (non-unix)
            pass
    try:
        await stop
    except asyncio.CancelledError:
        pass
    finally:
        await rest.stop()
        await service.stop()
        logger.info("edge %s stopped", service.edge_id)


def main() -> None:
    parser = argparse.ArgumentParser(description="xaynet-tpu edge aggregator (PyTorch port)")
    parser.add_argument("-c", "--config", help="TOML configuration file", default=None)
    parser.add_argument(
        "--upstream", help="override [edge] upstream_url", default=None
    )
    args = parser.parse_args()
    settings = Settings.load(args.config)
    if args.upstream:
        settings.edge.upstream_url = args.upstream
    asyncio.run(serve(settings))


if __name__ == "__main__":
    main()
