"""Coordinator REST API.

Functional port of the reference's HTTP surface (reference:
rust/xaynet-server/src/rest.rs:40-315):

- ``POST /message`` — opaque sealed-box message bytes
- ``GET /params``   — current round parameters
- ``GET /sums``     — sum dictionary (204 while absent)
- ``GET /seeds?pk=<hex>`` — a sum participant's seed slice (204 while absent)
- ``GET /model``    — latest global model bytes (204 while absent)
- ``GET /metrics``  — telemetry registry, Prometheus text exposition
- ``GET /healthz``  — liveness JSON (status, phase, round id, uptime)
- ``GET /statusz``  — live operator console, self-contained HTML (§20)
- ``GET /alerts``   — SLO engine state: active alerts + transition ring

With an ingest pipeline (``[ingest] enabled``, ``ingest.IngestPipeline``)
``POST /message`` goes through admission control: a saturated intake (or
a tenant over its share of the process-wide budget) answers 429 with a
``Retry-After`` of at least one second, and ``/healthz`` gains the
``ingest`` and ``ingress`` sections.

A multi-tenant coordinator (``runner.serve_tenants``) serves every route
of each tenant under ``/t/<tenant>/...``; the bare routes serve the first
tenant, an unknown tenant answers 404, and a draining or quarantined
tenant's ``POST /message`` sheds with 429. With an admin token the
authenticated ``/admin/tenants`` surface onboards, reconfigures and
drains tenants at runtime, and ``/healthz`` carries the tenants and the
shared page pool's stats.

Responses are JSON (parameters, dictionaries) or raw bytes (model) — a
readable stand-in for the reference's bincode bodies; both ends of the wire
are this framework. Implemented directly on asyncio streams (no third-party
HTTP dependency); optional TLS via ``ssl.SSLContext``.

The JAX package's edge-tier routes are not part of the port (settings
refuse the edge tier). ``stop()`` closes the connections it holds open before it waits for the
listener to close: from Python 3.12 ``asyncio.Server.wait_closed`` waits
for every connection, and a participant's idle keep-alive connection
would otherwise hold it for the whole ``read_timeout``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import ssl
import time
from dataclasses import dataclass
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..telemetry import tracing as trace
from ..telemetry.registry import MetricsRegistry, get_registry
from .requests import RequestError
from .services import Fetcher, PetMessageHandler, ServiceError

logger = logging.getLogger("xaynet.rest")


@dataclass
class TenantRoutes:
    """One tenant's REST surface: what ``/t/<tenant>/...`` dispatches to.

    The default tenant's routes double as the bare legacy paths
    (``/params`` == ``/t/<default>/params``), so single-tenant deployments
    and old SDKs keep working unchanged (docs/DESIGN.md §19).
    """

    fetcher: Fetcher
    handler: PetMessageHandler
    pipeline: object = None  # ingest.IngestPipeline


MAX_BODY = 1 << 32  # u32 length field ceiling, as in the reference

SPAN_REQUEST = trace.declare_span("rest.request")

# polled endpoints are untraced: monitoring (/metrics, /healthz) and the
# round-state reads the SDK polls every tick (/params at tens of Hz in a
# soak, /sums and /seeds while waiting for dictionaries). Their spans
# would crowd the bounded round buffer and — because the buffer drops the
# NEWEST spans at its cap — could evict the end-of-round phase spans the
# CI validator requires. The causal story lives in the traced writes:
# POST /message.
_UNTRACED_PATHS = {
    "/metrics", "/health", "/healthz", "/params", "/sums", "/seeds", "/model",
    "/statusz", "/alerts",
}

# known routes/methods keep the http counter's labels closed-cardinality —
# both tokens are attacker-controlled, and every distinct label value is a
# permanent registry child
_KNOWN_PATHS = {"/message", "/params", "/sums", "/seeds", "/model",
                "/health", "/healthz", "/metrics", "/statusz", "/alerts", "/admin/tenants"}
_KNOWN_METHODS = {"GET", "POST", "HEAD", "PUT", "DELETE", "OPTIONS", "PATCH"}


class RestServer:
    def __init__(
        self,
        fetcher: Fetcher,
        handler: PetMessageHandler,
        read_timeout: float = 120.0,
        registry: Optional[MetricsRegistry] = None,
        pipeline=None,
        tenants: Optional[dict[str, TenantRoutes]] = None,
        lifecycle=None,
        admin_token: str = "",
        default_tenant: str = "",
    ):
        # `registry` selects what GET /metrics renders. Hot-path modules
        # (request queue, message pipeline, kernel profiling, dispatcher)
        # record into the PROCESS registry at import time, so a custom
        # registry exposes only the families created against it (unit
        # tests); production keeps the default.
        # `pipeline` (ingest.IngestPipeline) switches the default routes'
        # POST /message to the admission-controlled path: 429 + Retry-After
        # under saturation, and /healthz gains the intake sections. None
        # keeps the direct path.
        # `tenants` maps tenant id -> TenantRoutes for /t/<tenant>/...
        # routing; the positional args above stay the DEFAULT tenant (and
        # the bare legacy routes). None = single-tenant, as before.
        # `lifecycle` (tenancy.TenantLifecycle) turns the tenant set
        # elastic: mutating traffic consults its admission verdicts
        # (draining / quarantined tenants shed with 429) and `admin_token`
        # enables the authenticated /admin/tenants surface (constant-time
        # compare; "" keeps it fully disabled).
        # `default_tenant` is the real id behind the bare legacy routes so
        # lifecycle admission applies to them too.
        self._default_routes = TenantRoutes(fetcher=fetcher, handler=handler, pipeline=pipeline)
        # the lifecycle manager mutates this dict at runtime (onboard
        # registers, offboard pops) — it must stay the SAME object the
        # manager holds, so adopt a provided dict instead of copying it
        self.tenants: dict[str, TenantRoutes] = tenants if tenants is not None else {}
        self.lifecycle = lifecycle
        self.admin_token = admin_token
        self.default_tenant = default_tenant
        self.read_timeout = read_timeout  # slow-client defense
        self.registry = registry if registry is not None else get_registry()
        self._started_at = time.monotonic()
        self._http_requests = self.registry.counter(
            "xaynet_http_requests_total",
            "REST requests by method, route, status code and tenant "
            "('' = the bare single-tenant routes).",
            ("method", "path", "status", "tenant"),
        )
        self._server: Optional[asyncio.AbstractServer] = None
        # the open connections' writers: stop() closes them
        self._writers: set[asyncio.StreamWriter] = set()

    async def start(
        self, host: str = "127.0.0.1", port: int = 8081, tls: Optional[ssl.SSLContext] = None
    ) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._handle_conn, host, port, ssl=tls)
        addr = self._server.sockets[0].getsockname()
        logger.info("REST API listening on %s:%d", addr[0], addr[1])
        return addr[0], addr[1]

    async def stop(self) -> None:
        """Stop listening, close every open connection, then wait for the
        listener to close (which, from Python 3.12, waits for them)."""
        if self._server is not None:
            self._server.close()
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()

    # --- request handling -------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._writers.add(writer)
        try:
            while True:
                request_line = await asyncio.wait_for(reader.readline(), self.read_timeout)
                if not request_line:
                    break
                try:
                    method, target, _ = request_line.decode().split(None, 2)
                except ValueError:
                    await self._respond(writer, 400, b"bad request")
                    break
                headers = {}
                while True:
                    line = await asyncio.wait_for(reader.readline(), self.read_timeout)
                    if line in (b"\r\n", b"\n", b""):
                        break
                    name, _, value = line.decode().partition(":")
                    headers[name.strip().lower()] = value.strip()
                length = int(headers.get("content-length", "0"))
                if length > MAX_BODY:
                    await self._respond(writer, 413, b"body too large")
                    break
                body = (
                    await asyncio.wait_for(reader.readexactly(length), self.read_timeout)
                    if length
                    else b""
                )
                keep_alive = headers.get("connection", "keep-alive").lower() != "close"
                status, payload, ctype, extra = await self._route(method, target, body, headers)
                await self._respond(writer, status, payload, ctype, keep_alive, extra)
                if not keep_alive:
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError, asyncio.TimeoutError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # lint: swallow-ok (best-effort socket teardown)
                pass

    def _resolve_tenant(self, path: str):
        """Split a ``/t/<tenant>/<sub>`` target into (tenant id, sub path,
        routes); bare paths resolve to the default tenant's routes with an
        empty tenant label. Unknown tenants resolve to ``routes=None``."""
        if path != "/t" and not path.startswith("/t/"):
            return "", path, self._default_routes
        parts = path.split("/", 3)  # ["", "t", tenant, rest]
        tid = parts[2] if len(parts) > 2 else ""
        routes = self.tenants.get(tid)
        sub = "/" + (parts[3] if len(parts) > 3 else "")
        return tid, sub, routes

    async def _route(self, method: str, target: str, body: bytes, headers=None):
        url = urlparse(target)
        headers = headers or {}
        if url.path == "/admin/tenants" or url.path.startswith("/admin/tenants/"):
            status, payload, ctype, extra = await self._admin_route(
                method, url.path, body, headers
            )
            self._http_requests.labels(
                method=method if method in _KNOWN_METHODS else "other",
                path="/admin/tenants",  # subpath ids stay out of the labels
                status=status,
                tenant="",
            ).inc()
            return status, payload, ctype, extra
        tenant, path, routes = self._resolve_tenant(url.path)
        if routes is None:
            # unknown tenant: closed-cardinality labels (the id is
            # attacker-controlled), no dispatch
            self._http_requests.labels(
                method=method if method in _KNOWN_METHODS else "other",
                path="other",
                status=404,
                tenant="other",
            ).inc()
            return 404, b"unknown tenant", "text/plain", None
        # elastic-lifecycle admission (docs/DESIGN.md §23): a draining or
        # quarantined tenant's MUTATING traffic sheds at the door with 429
        # (GET polls stay served — a draining tenant's in-flight round
        # still needs its participants to fetch params/sums/seeds)
        if self.lifecycle is not None and method == "POST" and path == "/message":
            admitted, retry_after = self.lifecycle.admit(tenant or self.default_tenant)
            if not admitted:
                extra = (
                    {"Retry-After": str(max(1, math.ceil(retry_after)))}
                    if retry_after
                    else None
                )
                self._http_requests.labels(
                    method=method, path=path, status=429, tenant=tenant
                ).inc()
                return 429, b"tenant not accepting traffic", "text/plain", extra
        # handlers return (status, payload, ctype) or + an extra-headers dict
        if path in _UNTRACED_PATHS:
            result = await self._dispatch(method, path, url.query, body, routes)
        else:
            # the request span adopts the caller's trace (X-Xaynet-Trace:
            # the SDK) and sets the ambient context
            remote = trace.parse_header(headers.get(trace.TRACE_HEADER.lower()))
            with trace.get_tracer().span(
                SPAN_REQUEST, link=remote, method=method, path=path, tenant=tenant
            ) as span:
                result = await self._dispatch(method, path, url.query, body, routes)
                span.set(status=result[0])
        status, payload, ctype = result[:3]
        extra = result[3] if len(result) > 3 else None
        self._http_requests.labels(
            method=method if method in _KNOWN_METHODS else "other",
            path=path if path in _KNOWN_PATHS else "other",
            status=status,
            # tenant ids come from the operator's [tenancy] config (a
            # validated closed set), never from the wire: unknown ids
            # bounced above with tenant="other"
            tenant=tenant,
        ).inc()
        return status, payload, ctype, extra

    async def _dispatch(self, method: str, path: str, query: str, body: bytes,
                        routes: TenantRoutes):
        try:
            if method == "POST" and path == "/message":
                return await self._post_message(body, routes)
            if method == "GET" and path == "/params":
                return 200, json.dumps(routes.fetcher.round_params().to_dict()).encode(), "application/json"
            if method == "GET" and path == "/sums":
                sums = routes.fetcher.sum_dict()
                if sums is None:
                    return 204, b"", "text/plain"
                return (
                    200,
                    json.dumps({k.hex(): v.hex() for k, v in sums.items()}).encode(),
                    "application/json",
                )
            if method == "GET" and path == "/seeds":
                qs = parse_qs(query)
                pk_hex = (qs.get("pk") or [""])[0]
                if not pk_hex:
                    return 400, b"missing pk", "text/plain"
                seeds = routes.fetcher.seeds_for(bytes.fromhex(pk_hex))
                if seeds is None:
                    return 204, b"", "text/plain"
                if (qs.get("fmt") or [""])[0] == "bin":
                    # batched binary fan-out (§21): 112 B/entry fixed
                    # frames, ~half the bytes of the hex-JSON shape — the
                    # response the loadgen fleet and new SDKs request
                    from ..core.mask.seed import pack_seed_entries

                    return 200, pack_seed_entries(seeds), "application/octet-stream"
                return (
                    200,
                    json.dumps({k.hex(): v.as_bytes().hex() for k, v in seeds.items()}).encode(),
                    "application/json",
                )
            if method == "GET" and path == "/metrics":
                return (
                    200,
                    self.registry.render().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            if method == "GET" and path == "/statusz":
                # live operator console (§20): rendered from registry /
                # timeline / SLO state and the ingest pipelines
                from .console import render_statusz

                return 200, render_statusz(self).encode(), "text/html; charset=utf-8"
            if method == "GET" and path == "/alerts":
                from ..telemetry.slo import get_engine

                return (
                    200,
                    json.dumps(get_engine().alerts_payload()).encode(),
                    "application/json",
                )
            if method == "GET" and path == "/healthz":
                # liveness + the coarse round position, cheap enough to poll
                payload = self._health_payload(routes)
                payload["status"] = "ok"
                payload["uptime_seconds"] = round(time.monotonic() - self._started_at, 3)
                if routes.pipeline is not None:
                    ingest = routes.pipeline.health()
                    # the ingress boundary gets its own top-level section
                    # (§21): acceptance rates, shard occupancy, wire mix
                    payload["ingress"] = ingest.pop("ingress", None)
                    payload["ingest"] = ingest
                    if ingest["saturated"]:
                        payload["status"] = "saturated"
                streaming = self._streaming_health()
                if streaming is not None:
                    payload["pipeline"] = streaming
                tenancy = self._tenancy_health()
                if tenancy is not None:
                    payload["tenancy"] = tenancy
                return 200, json.dumps(payload).encode(), "application/json"
            if method == "GET" and path == "/health":
                return 200, json.dumps(self._health_payload(routes)).encode(), "application/json"
            if method == "GET" and path == "/model":
                model = routes.fetcher.model()
                if model is None:
                    return 204, b"", "text/plain"
                # model DOWNLOAD response, not a request body
                body = np.asarray(model, np.float64).tobytes()  # lint: wirecopy-ok
                return 200, body, "application/octet-stream"
            return 404, b"not found", "text/plain"
        except Exception as err:
            logger.exception("request failed: %s %s", method, path)
            return 500, str(err).encode(), "text/plain"

    async def _admin_route(self, method: str, path: str, body: bytes, headers: dict):
        """The authenticated tenant-lifecycle surface (docs/DESIGN.md §23).

        - ``GET    /admin/tenants``        — lifecycle states of every tenant
        - ``POST   /admin/tenants``        — onboard: ``{"tenant": "<id>"}``
        - ``POST   /admin/tenants/<id>``   — reconfigure: ``{"weight", "tier"}``
        - ``DELETE /admin/tenants/<id>``   — graceful drain (+ hard-kill
          escalation after the drain budget)

        Fully disabled (404, indistinguishable from an unknown route)
        unless BOTH a lifecycle manager and a ``[tenancy] admin_token``
        are configured; the token check is constant-time. Status mapping:
        400 malformed id/body, 401 bad token, 409 incompatible lifecycle
        state (already serving, not drainable).
        """
        import hmac

        if self.lifecycle is None or not self.admin_token:
            return 404, b"not found", "text/plain", None
        supplied = headers.get("x-admin-token", "")
        if not hmac.compare_digest(supplied.encode(), self.admin_token.encode()):
            return 401, b"bad admin token", "text/plain", None
        from ..tenancy import LifecycleError

        sub = path[len("/admin/tenants"):].strip("/")
        try:
            if method == "GET" and not sub:
                return (
                    200,
                    json.dumps({"tenants": self.lifecycle.states()}).encode(),
                    "application/json",
                    None,
                )
            if method == "POST" and not sub:
                spec = json.loads(body or b"{}")
                result = await self.lifecycle.onboard(str(spec.get("tenant", "")))
                return 200, json.dumps(result).encode(), "application/json", None
            if method in ("POST", "PATCH") and sub:
                spec = json.loads(body or b"{}")
                result = self.lifecycle.reconfigure(
                    sub, weight=spec.get("weight"), tier=spec.get("tier")
                )
                return 200, json.dumps(result).encode(), "application/json", None
            if method == "DELETE" and sub:
                result = await self.lifecycle.offboard(sub)
                return 200, json.dumps(result).encode(), "application/json", None
            return 404, b"not found", "text/plain", None
        except LifecycleError as err:
            return 409, str(err).encode(), "text/plain", None
        except (ValueError, KeyError) as err:  # bad tenant id / bad JSON body
            return 400, str(err).encode(), "text/plain", None
        except Exception as err:
            logger.exception("admin request failed: %s %s", method, path)
            return 500, str(err).encode(), "text/plain", None

    def _tenancy_health(self) -> dict | None:
        """The multi-tenant /healthz section: registered tenants, each
        tenant's phase/round, and the shared pool's page accounting (its
        page-locked bytes too). ``None`` (no section) for single-tenant
        deployments."""
        if not self.tenants:
            return None
        from ..tenancy.pool import get_pool

        pool = get_pool()
        return {
            "tenants": {
                tid: {
                    "phase": r.fetcher.phase().value,
                    "round_id": r.fetcher.events.params.get_latest().round_id,
                }
                for tid, r in list(self.tenants.items())
            },
            "pool": {**pool.stats(), "pinned_bytes": pool.pinned_bytes()},
        }

    def _streaming_health(self) -> dict | None:
        """The streaming-fold ``pipeline`` section of /healthz, read from
        the telemetry registry (no jax import on the REST path): the
        global pipeline gauges plus, for shard-parallel folds, the
        per-shard staging depth / in-flight folds / overlap ratio keyed by
        shard index. ``None`` when no streaming pipeline ever ran in this
        process (host aggregation) — the section simply doesn't appear."""
        depth = self.registry.sample_value("xaynet_streaming_staging_depth")
        if depth is None:
            return None
        reg = self.registry
        section = {
            "staging_depth": depth,
            "inflight_folds": reg.sample_value("xaynet_streaming_inflight_folds") or 0,
            "overlap_ratio": reg.sample_value("xaynet_streaming_overlap_ratio") or 0.0,
            "degraded": bool(reg.sample_value("xaynet_streaming_degraded") or 0),
        }
        shards: dict[str, dict] = {}
        for metric, field in (
            ("xaynet_streaming_shard_staging_depth", "staging_depth"),
            ("xaynet_streaming_shard_inflight_folds", "inflight_folds"),
            ("xaynet_streaming_shard_overlap_ratio", "overlap_ratio"),
        ):
            family = reg.get(metric)
            if family is None:
                continue
            for key, child in family.children():
                shards.setdefault(key[0], {})[field] = child.value
        if shards:
            section["shards"] = {
                k: shards[k]
                for k in sorted(shards, key=lambda s: int(s) if s.isdigit() else -1)
            }
        return section

    def _health_payload(self, routes: TenantRoutes) -> dict:
        """Shared by /health (legacy shape) and /healthz (superset)."""
        return {
            "phase": routes.fetcher.phase().value,
            "round_id": routes.fetcher.events.params.get_latest().round_id,
        }

    async def _post_message(self, body: bytes, routes: TenantRoutes):
        if routes.pipeline is not None:
            verdict = await routes.pipeline.submit(body)
            if verdict.shed:
                retry = str(max(1, math.ceil(verdict.retry_after)))
                return 429, b"intake saturated; retry later", "text/plain", {"Retry-After": retry}
            # admitted (processed asynchronously) or pre-filter drop: both
            # answer 200, as the direct path does
            return 200, b"", "text/plain"
        try:
            await routes.handler.handle_message(body)
        except (ServiceError, RequestError) as err:
            # the reference answers 200 regardless and logs the drop —
            # clients learn outcomes from round progression, not the POST
            logger.debug("message dropped: %s", err)
        return 200, b"", "text/plain"

    @staticmethod
    async def _respond(
        writer: asyncio.StreamWriter,
        status: int,
        payload: bytes,
        ctype: str = "text/plain",
        keep_alive: bool = False,
        extra_headers: Optional[dict] = None,
    ) -> None:
        reason = {
            200: "OK",
            204: "No Content",
            400: "Bad Request",
            401: "Unauthorized",
            404: "Not Found",
            409: "Conflict",
            413: "Payload Too Large",
            429: "Too Many Requests",
            500: "Internal Server Error",
            502: "Bad Gateway",
            503: "Service Unavailable",
        }.get(status, "")
        extra = "".join(
            f"{name}: {value}\r\n" for name, value in (extra_headers or {}).items()
        )
        head = (
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(payload)}\r\n"
            f"{extra}"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n\r\n"
        ).encode()
        writer.write(head + payload)
        await writer.drain()
