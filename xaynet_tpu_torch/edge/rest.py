"""Edge REST surface: a coordinator-shaped API for participants.

Participants point their SDK at an edge URL exactly as they would at a
coordinator — the API is the same. Behind it:

- ``POST /message`` during the update phase flows into the edge's OWN
  admission-controlled ingest pipeline (fold-locally path); during every
  other phase the opaque ciphertext is relayed upstream unchanged (sum and
  sum2 messages are per-message by construction — only updates
  pre-aggregate);
- ``GET /params`` serves the locally synced round parameters (identical
  bytes to upstream's — the edge learned them there);
- ``GET /sums`` / ``/seeds`` / ``/model`` proxy upstream one-shot (the
  participant's own resilient client retries a 502);
- ``GET /healthz`` carries the ``edge`` section (upstream link, window
  members, envelope backlog) through the shared ``health_extra`` hook;
- ``GET /metrics`` renders the process registry (``xaynet_edge_*``).

Port of ``xaynet_tpu/edge/rest.py``.
"""

from __future__ import annotations

import logging
import math

from ..sdk.client import ClientError, ClientShedError
from ..server.rest import RestServer
from ..server.services import Fetcher
from .service import EdgeService

logger = logging.getLogger("xaynet.edge")

# reads relayed verbatim from the upstream coordinator
_PROXY_PATHS = {"/sums", "/seeds", "/model"}


class EdgeRestServer(RestServer):
    """The participant-facing API of one edge process."""

    def __init__(self, service: EdgeService, registry=None):
        super().__init__(
            Fetcher(service.events_sub),
            service.handler,
            registry=registry,
            pipeline=service.pipeline,
            health_extra=service.health,
        )
        self.service = service

    async def _dispatch(self, method: str, path: str, query: str, body: bytes,
                        headers, routes):
        try:
            if method == "POST" and path == "/message":
                if self.service.accepting_updates:
                    # the local fold path: admission -> intake -> decrypt ->
                    # coalesce -> EdgeAggregator (super()'s pipeline branch)
                    return await super()._dispatch(
                        method, path, query, body, headers, routes
                    )
                return await self._forward(body)
            if method == "GET" and path in _PROXY_PATHS:
                return await self._proxy(path, query)
            if method == "GET" and path == "/params" and not self.service.synced:
                # no round learned yet: the local params are placeholders
                return await self._proxy(path, query)
        except Exception as err:  # proxy/forward faults must not 500-loop
            logger.warning("edge relay failed: %s %s: %s", method, path, err)
            return 502, str(err).encode(), "text/plain"
        return await super()._dispatch(method, path, query, body, headers, routes)

    async def _forward(self, body: bytes):
        """Relay an opaque upload upstream (non-update phases)."""
        try:
            await self.service.forward_upstream(body)
        except ClientShedError as err:
            retry = str(max(1, math.ceil(err.retry_after or 1.0)))
            return 429, b"upstream shedding; retry later", "text/plain", {
                "Retry-After": retry
            }
        except ClientError as err:
            return 502, f"upstream unavailable: {err}".encode(), "text/plain"
        return 200, b"", "text/plain"

    async def _proxy(self, path: str, query: str):
        """One-shot upstream read, status/body passed through verbatim."""
        target = path + (f"?{query}" if query else "")
        try:
            status, headers, payload = await self.service.upstream.proxy_get(target)
        except ClientError as err:
            return 502, f"upstream unavailable: {err}".encode(), "text/plain"
        return status, payload, headers.get("content-type", "application/octet-stream")
