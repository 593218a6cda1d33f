"""Edge -> coordinator client: round sync, envelope shipping, proxying.

Port of ``xaynet_tpu/edge/upstream.py`` on the port's SDK client.

Extends the SDK's keep-alive ``HttpClient`` with the edge-tier endpoints
(``GET /edge/round``, ``POST /edge/envelope``) and wraps them in the same
``ResilientClient`` retry semantics (decorrelated-jitter ``RetryPolicy``,
server-sent ``Retry-After`` as a backoff floor, typed transient/permanent
errors) — an edge lives or dies by its upstream link, so every
coordinator conversation flows through the resilient wrapper.

Proxy reads (``/sums``, ``/seeds``, ``/model`` forwarded for participants)
deliberately do a SINGLE attempt: the participant's own ResilientClient
already retries a 502, and stacking retry loops would amplify a
coordinator brown-out instead of shedding it.
"""

from __future__ import annotations

import json
from typing import Optional

from ..resilience.policy import RetryPolicy
from ..sdk.client import HttpClient, ResilientClient, default_client_policy
from ..telemetry import tracing as trace

EDGE_TOKEN_HEADER = "X-Edge-Token"

SPAN_EDGE_ROUND = trace.declare_span("sdk.edge_round")
SPAN_EDGE_ENVELOPE = trace.declare_span("sdk.edge_envelope")
SPAN_EDGE_FORWARD = trace.declare_span("sdk.edge_forward")


class UpstreamClient(HttpClient):
    """Raw transport to the upstream coordinator (edge endpoints added)."""

    def __init__(self, base_url: str, token: str = "", timeout: float = 30.0,
                 tls_context=None, keep_alive: bool = True):
        super().__init__(base_url, timeout=timeout, tls_context=tls_context,
                         keep_alive=keep_alive)
        self.token = token

    def _auth(self) -> Optional[dict]:
        return {EDGE_TOKEN_HEADER: self.token} if self.token else None

    async def get_edge_round(self) -> Optional[dict]:
        """Current round info for edges (params + round keys + phase);
        ``None`` while the coordinator has no round to serve (204)."""
        status, headers, body = await self._request(
            "GET", "/edge/round", headers=self._auth()
        )
        if status == 204:
            return None
        self._raise_for_status(status, headers, "GET /edge/round")
        return json.loads(body.decode())

    async def post_envelope(self, blob: bytes) -> None:
        """Ship one sealed partial-aggregate envelope; raises the typed
        hierarchy (409 -> permanent rejection: drop the envelope)."""
        status, headers, body = await self._request(
            "POST", "/edge/envelope", blob, headers=self._auth()
        )
        self._raise_for_status(
            status, headers, f"POST /edge/envelope: {body[:200]!r}"
        )

    async def forward_message(self, encrypted: bytes) -> None:
        """Relay a participant upload upstream unchanged (non-update
        phases, and the fallback when the local fold rejects a member)."""
        await self.send_message(encrypted)

    async def proxy_get(self, path: str) -> tuple[int, dict, bytes]:
        """One-shot read for the proxy routes; the raw (status, headers,
        body) triple is passed through to the participant."""
        return await self._request("GET", path)


class ResilientUpstream(ResilientClient):
    """Retry wrapper over :class:`UpstreamClient` (edge endpoints included)."""

    SPANS = {
        **ResilientClient.SPANS,
        "edge_round": SPAN_EDGE_ROUND,
        "edge_envelope": SPAN_EDGE_ENVELOPE,
        "edge_forward": SPAN_EDGE_FORWARD,
    }

    def __init__(self, inner: UpstreamClient, policy: Optional[RetryPolicy] = None):
        super().__init__(inner, policy if policy is not None else default_client_policy())

    async def get_edge_round(self) -> Optional[dict]:
        return await self._call("edge_round", self.inner.get_edge_round)

    async def post_envelope(self, blob: bytes) -> None:
        await self._call("edge_envelope", self.inner.post_envelope, blob)

    async def forward_message(self, encrypted: bytes) -> None:
        await self._call("edge_forward", self.inner.forward_message, encrypted)

    async def proxy_get(self, path: str) -> tuple[int, dict, bytes]:
        return await self.inner.proxy_get(path)  # single attempt, by design

    def close(self) -> None:
        self.inner.close()
