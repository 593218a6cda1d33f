"""Request tracing: correlation ids across the service/state-machine boundary.

The reference instruments every request with a tracing span that travels
through the request channel so state-machine-side logs correlate with the
HTTP request that caused them (reference:
rust/xaynet-server/src/state_machine/requests.rs:120,157-165). Here the
span is a contextvar-scoped request id: the message pipeline assigns one
per message, the request envelope carries it across the queue, and the
phase restores it while handling — so a single grep on the id yields the
full path of one message through the system.
"""

from __future__ import annotations

import contextvars
import logging
import time
import uuid
from contextlib import contextmanager

request_id: contextvars.ContextVar[str] = contextvars.ContextVar("xaynet_request_id", default="-")

logger = logging.getLogger("xaynet.trace")


def new_request_id() -> str:
    rid = uuid.uuid4().hex[:12]
    request_id.set(rid)
    return rid


def current_request_id() -> str:
    return request_id.get()


@contextmanager
def use_request_id(rid: str):
    token = request_id.set(rid)
    try:
        yield
    finally:
        request_id.reset(token)


@contextmanager
def span(name: str, **fields):
    """Logs entry/exit with duration at DEBUG, tagged with the request id."""
    rid = request_id.get()
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    t0 = time.perf_counter()
    logger.debug("[%s] >> %s %s", rid, name, extra)
    try:
        yield
    except Exception as e:
        logger.debug(
            "[%s] !! %s failed after %.1fms: %s", rid, name, (time.perf_counter() - t0) * 1e3, e
        )
        raise
    else:
        logger.debug("[%s] << %s %.1fms", rid, name, (time.perf_counter() - t0) * 1e3)


class RequestIdFilter(logging.Filter):
    """Attach ``%(request_id)s`` to log records for formatter use."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.request_id = request_id.get()
        return True
