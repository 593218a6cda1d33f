"""Coordinator clients: in-process (simulation/tests), HTTP, and the
retrying :class:`ResilientClient` wrapper.

Reference surface: rust/xaynet-sdk/src/client.rs:59-213 (five endpoints:
params / sums / seeds / model / message). The in-process client talks
directly to a coordinator's fetcher and message handler — the reference
proves the whole protocol is testable without a network
(SURVEY §4: in-process multi-node).

Error taxonomy (docs/DESIGN.md §10): every HTTP failure surfaces as a
typed :class:`ClientError` instead of a bare ``RuntimeError`` —
``ClientShedError`` for a 429 from the admission controller (carrying the
server's ``Retry-After``), ``ClientTransientError`` for connection-level
faults and retryable statuses, ``ClientPermanentError`` for everything a
retry cannot fix — so the retry wrapper and the participant state machine
classify without string-matching. ``ResilientClient`` wraps any
``XaynetClient`` with the resilience layer's decorrelated-jitter
``RetryPolicy``, honoring ``Retry-After`` as a backoff floor.

Copy of ``xaynet_tpu/sdk/client.py``: ``InProcessClient`` swallows this
package's ``ServiceError`` and ``RequestError`` (a handler of the JAX
package's coordinator raises its own classes, which it does not catch).
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

import numpy as np

from ..core.common import RoundParameters, UpdateSeedDict
from ..resilience.policy import RetryPolicy
from ..telemetry import tracing as trace
from ..telemetry.registry import get_registry
from .traits import XaynetClient

logger = logging.getLogger("xaynet.participant")

_registry = get_registry()
CLIENT_DROPS = _registry.counter(
    "xaynet_sdk_client_injected_drops_total",
    "SDK sends silently dropped by the installed fault plan (sdk.drop).",
)

# one span name per endpoint (closed set — the DESIGN §16 table row), plus
# the per-attempt child span the retry loop emits
SPAN_PARAMS = trace.declare_span("sdk.params")
SPAN_SUMS = trace.declare_span("sdk.sums")
SPAN_SEEDS = trace.declare_span("sdk.seeds")
SPAN_MODEL = trace.declare_span("sdk.model")
SPAN_SEND = trace.declare_span("sdk.send")
SPAN_ATTEMPT = trace.declare_span("sdk.attempt")
_ENDPOINT_SPANS = {
    "params": SPAN_PARAMS,
    "sums": SPAN_SUMS,
    "seeds": SPAN_SEEDS,
    "model": SPAN_MODEL,
    "send": SPAN_SEND,
}


class ClientError(Exception):
    """A coordinator call failed; ``transient`` drives retry decisions."""

    transient = False

    def __init__(self, message: str, status: Optional[int] = None,
                 retry_after: Optional[float] = None):
        super().__init__(message)
        self.status = status
        self.retry_after = retry_after


class ClientPermanentError(ClientError):
    """Retrying cannot help (4xx protocol errors, malformed responses)."""


class ClientTransientError(ClientError):
    """Worth retrying in place: connection faults, timeouts, 5xx."""

    transient = True


class ClientShedError(ClientTransientError):
    """HTTP 429 from the admission controller; ``retry_after`` is the
    server-requested backoff floor in seconds."""


# non-5xx statuses a retry can fix: request timeout and too-early
_TRANSIENT_STATUSES = frozenset({408, 425})


def classify_status(
    status: int, retry_after: Optional[float], context: str
) -> ClientError:
    """Map an HTTP error status onto the typed hierarchy: any 5xx is
    transient except 501 Not Implemented (that never heals) — proxies in
    front of a coordinator emit plenty beyond the 502/503/504 gateway
    family (507, 520-529, ...), and all of them mean "try again"."""
    message = f"{context} -> {status}"
    if status == 429:
        return ClientShedError(message, status=status, retry_after=retry_after)
    if status in _TRANSIENT_STATUSES or (500 <= status < 600 and status != 501):
        return ClientTransientError(message, status=status, retry_after=retry_after)
    return ClientPermanentError(message, status=status)


class InProcessClient(XaynetClient):
    """Direct wiring to an in-process coordinator (no sockets)."""

    def __init__(self, fetcher, message_handler):
        self.fetcher = fetcher
        self.handler = message_handler

    async def get_round_params(self) -> RoundParameters:
        return self.fetcher.round_params()

    async def get_sums(self) -> Optional[dict]:
        return self.fetcher.sum_dict()

    async def get_seeds(self, pk: bytes) -> Optional[UpdateSeedDict]:
        return self.fetcher.seeds_for(pk)

    async def get_model(self) -> Optional[np.ndarray]:
        return self.fetcher.model()

    async def send_message(self, encrypted: bytes) -> None:
        """Mirrors the REST semantics: drops/rejections are swallowed
        (POST /message answers 200 regardless; clients learn outcomes from
        round progression)."""
        from ..server.requests import RequestError
        from ..server.services import ServiceError

        try:
            await self.handler.handle_message(encrypted)
        except (ServiceError, RequestError):
            pass


class HttpClient(XaynetClient):
    """HTTP client for a remote coordinator (REST API, rest.py).

    Uses asyncio streams directly — no third-party HTTP dependency. This
    is the transport the resilient wrapper sits on; deployments should
    construct ``ResilientClient(HttpClient(url))`` (what ``Participant``
    does for URL arguments).
    """

    def __init__(
        self,
        base_url: str,
        timeout: float = 30.0,
        tls_context=None,
        keep_alive: bool = True,
        max_idle: int = 4,
    ):
        self.tls = tls_context
        if base_url.startswith("https://"):
            base_url = base_url[len("https://") :]
            if self.tls is None:
                import ssl

                self.tls = ssl.create_default_context()
        elif base_url.startswith("http://"):
            base_url = base_url[len("http://") :]
        # a path suffix scopes every request (multi-tenant coordinators
        # serve per-tenant routes under /t/<tenant>/..., docs/DESIGN.md
        # §19): "host:port/t/a" prefixes "/t/a" onto each request path
        base_url, _, prefix = base_url.partition("/")
        self.path_prefix = f"/{prefix.rstrip('/')}" if prefix else ""
        self.host, _, port = base_url.partition(":")
        self.port = int(port or (443 if self.tls is not None else 80))
        self.timeout = timeout
        # transport keep-alive: reuse one connection per host instead of
        # re-handshaking per request (ROADMAP item 5's transport tax). The
        # idle pool holds a handful of connections so concurrent callers
        # sharing this client each reuse their own instead of serializing;
        # ``keep_alive=False`` restores the historical one-shot behavior.
        self.keep_alive = keep_alive
        self.max_idle = max(1, max_idle)
        self._idle: list[tuple] = []  # (reader, writer, owning loop)
        self.connections_opened = 0  # reuse observability (tests/metrics)

    def close(self) -> None:
        """Drop every idle connection (best-effort; safe cross-loop)."""
        idle, self._idle = self._idle, []
        for _, writer, _ in idle:
            try:
                writer.close()
            except Exception:
                pass

    async def _connect(self):
        try:
            reader, writer = await asyncio.wait_for(
                # the SDK's one raw socket: this IS the wrapped transport
                asyncio.open_connection(  # lint: raw-http-ok
                    self.host, self.port, ssl=self.tls
                ),
                self.timeout,
            )
        except (OSError, asyncio.TimeoutError) as err:
            raise ClientTransientError(f"connect failed: {err}") from err
        self.connections_opened += 1
        return reader, writer

    def _checkout(self):
        """Pop an idle connection usable on the CURRENT loop (connections
        are loop-bound; callers like the soak tool run one ``asyncio.run``
        per request, so a cached stream from a dead loop must be skipped)."""
        loop = asyncio.get_running_loop()
        while self._idle:
            reader, writer, owner = self._idle.pop()
            if owner is loop and not writer.is_closing():
                return reader, writer
            try:
                writer.close()
            except Exception:
                pass
        return None

    def _checkin(self, reader, writer, reusable: bool) -> None:
        if (
            self.keep_alive
            and reusable
            and len(self._idle) < self.max_idle
            and not writer.is_closing()
        ):
            self._idle.append((reader, writer, asyncio.get_running_loop()))
            return
        writer.close()

    async def _request(
        self,
        method: str,
        path: str,
        body: bytes | None = None,
        headers: Optional[dict] = None,
    ) -> tuple[int, dict, bytes]:
        """One request; returns (status, lowercased headers, payload).

        Connection-level faults (refused, reset, timed out, truncated)
        surface as ``ClientTransientError`` — the transport layer cannot
        produce a permanent verdict, only a status line can. A REUSED
        connection that dies before yielding any response byte is the
        normal stale-keep-alive race (the server idled it out between our
        requests): retried once on a fresh connection before the error
        surfaces. ONLY that shape retries — once a response byte arrived
        (the request was definitely processed) or on a timeout (the peer
        may still be processing), a silent re-send could duplicate a
        non-idempotent POST; those surface to the caller's retry policy,
        which understands protocol-level idempotence.
        """
        if self.path_prefix:
            path = self.path_prefix + path
        ctx = trace.current_ctx()
        if ctx is not None:
            # propagate the trace across the wire: the coordinator's REST
            # request span adopts this id (docs/DESIGN.md §16)
            headers = dict(headers or {})
            headers[trace.TRACE_HEADER] = trace.format_header(ctx)
        reused = self._checkout() if self.keep_alive else None
        for attempt in ("reused", "fresh"):
            if reused is not None:
                reader, writer = reused
            else:
                reader, writer = await self._connect()
            response_begun: list = []
            try:
                status, resp_headers, payload = await self._exchange(
                    reader, writer, method, path, body, headers, response_begun
                )
            except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError,
                    ValueError, IndexError) as err:
                # ValueError/IndexError: garbled status line from a dying peer
                writer.close()
                if (
                    reused is not None
                    and attempt == "reused"
                    and not response_begun
                    and not isinstance(err, (asyncio.TimeoutError, TimeoutError))
                ):
                    reused = None  # stale pooled connection: one fresh retry
                    continue
                raise ClientTransientError(f"{method} {path}: {err}") from err
            except BaseException:
                writer.close()
                raise
            self._checkin(
                reader,
                writer,
                resp_headers.get("connection", "keep-alive").lower() != "close",
            )
            return status, resp_headers, payload
        raise AssertionError("unreachable")  # pragma: no cover

    async def _exchange(
        self, reader, writer, method: str, path: str, body: bytes | None,
        extra_headers: Optional[dict] = None, response_begun: Optional[list] = None,
    ) -> tuple[int, dict, bytes]:
        # self.timeout bounds each individual read as an IDLE timeout, not
        # the whole exchange: a peer that stalls mid-response fails fast
        # (transient, the wrapper retries), while a large model download
        # that keeps making progress on a slow link is never cut off
        extra = "".join(
            f"{name}: {value}\r\n" for name, value in (extra_headers or {}).items()
        )
        connection = "keep-alive" if self.keep_alive else "close"
        head = (
            f"{method} {path} HTTP/1.1\r\nHost: {self.host}\r\n"
            f"Content-Length: {len(body) if body else 0}\r\n"
            f"{extra}"
            f"Connection: {connection}\r\n\r\n"
        ).encode()
        writer.write(head + (body or b""))
        await asyncio.wait_for(writer.drain(), self.timeout)
        status_line = await asyncio.wait_for(reader.readline(), self.timeout)
        if status_line and response_begun is not None:
            response_begun.append(True)  # any byte back: request was processed
        status = int(status_line.split()[1])
        headers: dict[str, str] = {}
        content_length = 0
        while True:
            line = await asyncio.wait_for(reader.readline(), self.timeout)
            if line in (b"\r\n", b""):
                break
            name, _, value = line.decode().partition(":")
            headers[name.strip().lower()] = value.strip()
            if name.strip().lower() == "content-length":
                content_length = int(value.strip())
        chunks = []
        remaining = content_length
        while remaining > 0:
            chunk = await asyncio.wait_for(
                reader.read(min(remaining, 1 << 20)), self.timeout
            )
            if not chunk:  # peer closed mid-body
                raise asyncio.IncompleteReadError(b"".join(chunks), content_length)
            chunks.append(chunk)
            remaining -= len(chunk)
        return status, headers, b"".join(chunks)

    @staticmethod
    def _retry_after(headers: dict) -> Optional[float]:
        value = headers.get("retry-after")
        if value is None:
            return None
        try:
            return max(0.0, float(value))
        except ValueError:
            return None  # HTTP-date flavor: ignore, the backoff still works

    def _raise_for_status(self, status: int, headers: dict, context: str) -> None:
        # anything outside 2xx fails: the client never follows redirects, so
        # a 3xx "success" would silently lose the call behind a misconfigured
        # proxy (the body would be an HTML redirect page, not protocol JSON)
        if status < 300:
            return
        raise classify_status(status, self._retry_after(headers), context)

    async def get_round_params(self) -> RoundParameters:
        status, headers, body = await self._request("GET", "/params")
        self._raise_for_status(status, headers, "GET /params")
        return RoundParameters.from_dict(json.loads(body.decode()))

    async def get_sums(self) -> Optional[dict]:
        status, headers, body = await self._request("GET", "/sums")
        if status == 204:
            return None
        self._raise_for_status(status, headers, "GET /sums")
        raw = json.loads(body.decode())
        return {bytes.fromhex(k): bytes.fromhex(v) for k, v in raw.items()}

    async def get_seeds(self, pk: bytes) -> Optional[UpdateSeedDict]:
        from ..core.mask.seed import EncryptedMaskSeed, unpack_seed_entries

        # request the batched binary fan-out (§21: 112 B/entry fixed
        # frames); a pre-v2 coordinator ignores the fmt param and answers
        # JSON — dispatch on the response content type, so either end can
        # be upgraded first
        status, headers, body = await self._request(
            "GET", f"/seeds?pk={pk.hex()}&fmt=bin"
        )
        if status == 204:
            return None
        self._raise_for_status(status, headers, "GET /seeds")
        if headers.get("content-type", "").startswith("application/octet-stream"):
            return unpack_seed_entries(body)
        raw = json.loads(body.decode())
        return {bytes.fromhex(k): EncryptedMaskSeed(bytes.fromhex(v)) for k, v in raw.items()}

    async def get_model(self) -> Optional[np.ndarray]:
        status, headers, body = await self._request("GET", "/model")
        if status == 204:
            return None
        self._raise_for_status(status, headers, "GET /model")
        return np.frombuffer(body, dtype=np.float64)

    async def send_message(self, encrypted: bytes) -> None:
        status, headers, body = await self._request("POST", "/message", encrypted)
        self._raise_for_status(status, headers, f"POST /message: {body[:200]!r}")


def default_client_policy() -> RetryPolicy:
    """Participant-side retry defaults: a handful of quick in-tick retries.

    Deliberately shorter than the coordinator's storage policy — a
    participant tick should resolve in seconds; anything longer is the
    state machine's job (it stays in phase and re-polls on later ticks)."""
    return RetryPolicy(
        max_attempts=4, base_delay_s=0.05, max_delay_s=2.0, deadline_s=15.0
    )


class ResilientClient(XaynetClient):
    """Retry wrapper around any ``XaynetClient``.

    Transient failures (``ClientTransientError``, connection-ish builtins
    per ``resilience.policy.is_transient``) retry in place on the policy's
    decorrelated-jitter schedule; a server-sent ``Retry-After`` (429/503)
    acts as a FLOOR under the drawn delay, so a shedding admission
    controller is never hammered faster than it asked for. Permanent
    errors propagate on the first attempt.

    Fault-injection sites (chaos, ``resilience.faults``):

    - ``sdk.straggle`` — latency rules delay a send (a straggling radio);
    - ``sdk.drop`` — the send is silently DROPPED: the client believes it
      succeeded, the coordinator never sees the message (a lost packet);
    - ``sdk.send`` — error rules fail a send attempt (retried like any
      transient fault; ``perm=1`` makes it permanent).
    """

    # endpoint -> span name; subclasses with extra endpoints extend this
    SPANS = _ENDPOINT_SPANS

    def __init__(self, inner: XaynetClient, policy: Optional[RetryPolicy] = None):
        self.inner = inner
        self.policy = policy if policy is not None else default_client_policy()
        # the round's trace context: set from the round seed by the SDK
        # state machine (or the edge sync loop), so every tier derives the
        # SAME trace id for one round; None = each call starts a fresh
        # trace (this client GENERATES ids either way)
        self.trace_ctx: Optional[trace.TraceContext] = None

    def set_round_trace(self, round_seed: Optional[bytes]) -> None:
        """Pin this client's calls to the round's deterministic trace."""
        if round_seed is None:
            self.trace_ctx = None
        else:
            self.trace_ctx = trace.TraceContext(trace.round_trace_id(round_seed))

    def close(self) -> None:
        """Release the wrapped transport's pooled connections (if any)."""
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()

    async def _call(self, endpoint: str, fn, *args):
        # the shared policy loop carries the per-site retry/giveup/backoff
        # metrics (xaynet_resilience_*_total{site="sdk.<endpoint>"}); the
        # server-sent Retry-After floors the drawn delay via the hook
        name = self.SPANS.get(endpoint)
        tracer = trace.get_tracer()
        if name is None or tracer.mode == "off":
            return await self.policy.call_async(
                fn,
                *args,
                site=f"sdk.{endpoint}",
                delay_floor=lambda err: getattr(err, "retry_after", None),
            )
        # one logical-call span; every retry attempt is a CHILD span whose
        # context rides the wire (X-Xaynet-Trace carries the attempt id, so
        # the server can tell which attempt it served)
        attempts = 0

        async def one_attempt(*call_args):
            nonlocal attempts
            attempts += 1
            with tracer.span(SPAN_ATTEMPT, attempt=attempts):
                return await fn(*call_args)

        ctx = self.trace_ctx
        if ctx is None and trace.current_ctx() is None:
            ctx = trace.TraceContext(trace.new_id())
        with tracer.span(name, ctx=ctx) as span:
            try:
                return await self.policy.call_async(
                    one_attempt,
                    *args,
                    site=f"sdk.{endpoint}",
                    delay_floor=lambda err: getattr(err, "retry_after", None),
                )
            finally:
                span.set(attempts=attempts)

    async def get_round_params(self) -> RoundParameters:
        return await self._call("params", self.inner.get_round_params)

    async def get_sums(self) -> Optional[dict]:
        return await self._call("sums", self.inner.get_sums)

    async def get_seeds(self, pk: bytes) -> Optional[UpdateSeedDict]:
        return await self._call("seeds", self.inner.get_seeds, pk)

    async def get_model(self) -> Optional[np.ndarray]:
        return await self._call("model", self.inner.get_model)

    async def send_message(self, encrypted: bytes) -> None:
        from ..resilience import faults

        plan = faults.current_plan()
        if plan is not None:
            # participant-side chaos: straggle (delay) then maybe drop this
            # send on the wire — both once per LOGICAL send, not per retry
            await faults.maybe_fail_async("sdk.straggle")
            if plan.decide("sdk.drop") is not None:
                CLIENT_DROPS.inc()
                logger.debug("sdk.drop: send silently dropped by fault plan")
                return
        await self._call("send", self._send_attempt, encrypted)

    async def _send_attempt(self, encrypted: bytes) -> None:
        from ..resilience import faults

        await faults.maybe_fail_async("sdk.send")
        await self.inner.send_message(encrypted)
