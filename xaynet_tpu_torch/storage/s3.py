"""S3-compatible global-model storage (AWS Signature V4, no third-party SDK).

The port's copy of ``xaynet_tpu/storage/s3.py``. Functional port of the
reference's S3/Minio model store (reference:
rust/xaynet-server/src/storage/model_storage/s3.rs:69-200): bucket creation,
refuse-overwrite on the canonical ``{round_id}_{hex(seed)}`` ids, typed
network/HTTP error taxonomy. Works against any S3-compatible endpoint
(Minio, GCS interop, AWS) using path-style addressing.

The HTTP layer is a minimal asyncio HTTP/1.1 client (the coordinator only
needs PUT/GET/HEAD with Content-Length bodies), and request signing is a
from-scratch SigV4 implementation — validated in tests against a fake S3
server that *recomputes and checks* every signature.
"""

from __future__ import annotations

import asyncio
import datetime
import hashlib
import hmac
import ssl as ssl_module
from typing import Optional
from urllib.parse import quote, urlsplit

from .traits import ModelStorage, StorageError, TransientStorageError

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_v4(
    method: str,
    host: str,
    path: str,
    *,
    access_key: str,
    secret_key: str,
    region: str,
    payload_hash: str,
    amz_date: str,
    service: str = "s3",
) -> dict[str, str]:
    """AWS Signature V4 headers for a query-less S3 request.

    Returns the headers to send (including Authorization). Kept separate
    from the client so the test fake can recompute and verify signatures
    with the same code path inverted.
    """
    date_scope = amz_date[:8]
    headers = {
        "host": host,
        "x-amz-content-sha256": payload_hash,
        "x-amz-date": amz_date,
    }
    signed_headers = ";".join(sorted(headers))
    canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
    canonical_request = "\n".join(
        [method, quote(path), "", canonical_headers, signed_headers, payload_hash]
    )
    scope = f"{date_scope}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        ]
    )
    k = _hmac(("AWS4" + secret_key).encode(), date_scope)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    headers["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )
    return headers


class _HttpResponse:
    def __init__(self, status: int, headers: dict[str, str], body: bytes):
        self.status = status
        self.headers = headers
        self.body = body


async def _http_request(
    endpoint: str,
    method: str,
    path: str,
    headers: dict[str, str],
    body: bytes = b"",
    timeout: float = 30.0,
) -> _HttpResponse:
    """One HTTP/1.1 request over asyncio streams (Content-Length bodies)."""
    u = urlsplit(endpoint)
    host = u.hostname or "127.0.0.1"
    use_tls = u.scheme == "https"
    port = u.port or (443 if use_tls else 80)
    ssl_ctx = ssl_module.create_default_context() if use_tls else None

    async def _go() -> _HttpResponse:
        reader, writer = await asyncio.open_connection(host, port, ssl=ssl_ctx)
        try:
            lines = [f"{method} {quote(path)} HTTP/1.1"]
            send_headers = dict(headers)
            send_headers.setdefault("content-length", str(len(body)))
            send_headers.setdefault("connection", "close")
            for k, v in send_headers.items():
                lines.append(f"{k}: {v}")
            writer.write(("\r\n".join(lines) + "\r\n\r\n").encode() + body)
            await writer.drain()

            status_line = await reader.readline()
            parts = status_line.decode().split(" ", 2)
            if len(parts) < 2 or not parts[1].isdigit():
                raise StorageError(f"malformed HTTP status line {status_line!r}")
            status = int(parts[1])
            resp_headers: dict[str, str] = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode().partition(":")
                resp_headers[name.strip().lower()] = value.strip()
            if method == "HEAD":
                # HEAD carries Content-Length of the WOULD-BE body but no
                # body bytes; reading would hit EOF
                data = b""
            elif "chunked" in resp_headers.get("transfer-encoding", "").lower():
                # de-chunk (reverse proxies in front of Minio answer this way)
                parts = []
                while True:
                    size_line = await reader.readline()
                    size = int(size_line.split(b";")[0].strip() or b"0", 16)
                    if size == 0:
                        await reader.readline()  # trailing CRLF
                        break
                    parts.append(await reader.readexactly(size))
                    await reader.readexactly(2)  # chunk CRLF
                data = b"".join(parts)
            else:
                length = resp_headers.get("content-length")
                if length is not None:
                    data = await reader.readexactly(int(length))
                else:
                    data = await reader.read()
            return _HttpResponse(status, resp_headers, data)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # lint: swallow-ok (best-effort socket teardown)
                pass

    try:
        return await asyncio.wait_for(_go(), timeout)
    except StorageError:
        raise
    except asyncio.TimeoutError as e:
        raise TransientStorageError(f"object store timeout after {timeout}s") from e
    except (OSError, asyncio.IncompleteReadError) as e:
        # IncompleteReadError is an EOFError, not an OSError: a connection
        # severed mid-body must still surface as the typed storage failure
        raise TransientStorageError(f"object store unreachable: {e}") from e
    except ValueError as e:  # malformed lengths/framing from a broken proxy
        raise StorageError(f"object store sent a malformed response: {e}") from e


class S3ModelStorage(ModelStorage):
    """Global models in an S3-compatible bucket (path-style addressing)."""

    def __init__(
        self,
        endpoint: str,
        bucket: str = "global-models",
        access_key: str = "",
        secret_key: str = "",
        region: str = "us-east-1",
    ):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        u = urlsplit(self.endpoint)
        default = 443 if u.scheme == "https" else 80
        self._host = f"{u.hostname}:{u.port}" if u.port and u.port != default else str(u.hostname)

    # --- signing ---------------------------------------------------------

    def _request_headers(self, method: str, path: str, body: bytes) -> dict[str, str]:
        amz_date = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
        payload_hash = hashlib.sha256(body).hexdigest() if body else _EMPTY_SHA256
        return sign_v4(
            method,
            self._host,
            path,
            access_key=self.access_key,
            secret_key=self.secret_key,
            region=self.region,
            payload_hash=payload_hash,
            amz_date=amz_date,
        )

    async def _request(
        self, method: str, path: str, body: bytes = b"", extra_headers: dict | None = None
    ) -> _HttpResponse:
        headers = self._request_headers(method, path, body)
        if extra_headers:
            headers.update(extra_headers)
        return await _http_request(self.endpoint, method, path, headers, body)

    # --- operations (reference: s3.rs:69-200) ----------------------------

    async def create_bucket(self) -> None:
        """Create the bucket; already-owned is not an error (s3.rs behavior)."""
        resp = await self._request("PUT", f"/{self.bucket}")
        if resp.status in (200, 204):
            return
        if resp.status == 409:  # BucketAlreadyOwnedByYou / BucketAlreadyExists
            return
        raise StorageError(f"create bucket failed: HTTP {resp.status} {resp.body[:200]!r}")

    async def set_global_model(self, round_id: int, round_seed: bytes, model_data: bytes) -> str:
        model_id = self.create_global_model_id(round_id, round_seed)
        key = f"/{self.bucket}/{model_id}"
        # cheap early refusal without uploading the body ...
        head = await self._request("HEAD", key)
        if head.status == 200:
            raise StorageError(f"global model {model_id} already exists")
        if head.status not in (404,):
            raise StorageError(f"object store HEAD failed: HTTP {head.status}")
        # ... and an ATOMIC conditional PUT closing the HEAD->PUT race
        # between concurrent writers (S3/Minio honor If-None-Match: *)
        resp = await self._request("PUT", key, model_data, {"if-none-match": "*"})
        if resp.status == 412:
            raise StorageError(f"global model {model_id} already exists")
        if resp.status not in (200, 201):
            raise StorageError(f"store model failed: HTTP {resp.status} {resp.body[:200]!r}")
        return model_id

    async def global_model(self, model_id: str) -> Optional[bytes]:
        resp = await self._request("GET", f"/{self.bucket}/{model_id}")
        if resp.status == 404:
            return None
        if resp.status != 200:
            raise StorageError(f"fetch model failed: HTTP {resp.status}")
        return resp.body

    async def is_ready(self) -> None:
        resp = await self._request("HEAD", f"/{self.bucket}")
        if resp.status not in (200, 204):
            raise StorageError(f"bucket {self.bucket} not ready: HTTP {resp.status}")
