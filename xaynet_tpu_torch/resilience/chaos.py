"""Deterministic SIGKILL injection for the crash-anywhere chaos harness.

``tools/soak.py --kill-matrix`` boots the coordinator subprocess with
``XAYNET_KILL_POINT=<site>:<n>`` and the phases call :func:`maybe_kill`
at their journal commit points; the *n*-th visit of the named site kills
the process with SIGKILL — no atexit handlers, no flushes, exactly the
power-loss the journal must survive. Sites:

- ``sum`` / ``update`` / ``sum2``: after the n-th accepted (and
  journaled) message of that phase;
- ``unmask:publish``: after the global model is persisted but BEFORE the
  journal entry is deleted — the publish window.

Without the environment variable every call is a no-op (one dict lookup
on the accept path). The counter is per-site and process-local: a
restarted coordinator starts at zero, so the same spec never re-fires
after recovery unless the site is genuinely revisited n more times.
"""

from __future__ import annotations

import logging
import os
import signal

ENV = "XAYNET_KILL_POINT"

logger = logging.getLogger("xaynet.resilience")

_visits: dict[str, int] = {}


def maybe_kill(site: str) -> None:
    """SIGKILL this process on the configured visit of ``site`` (no-op
    unless ``XAYNET_KILL_POINT`` names it)."""
    spec = os.environ.get(ENV)
    if not spec:
        return
    want, _, index = spec.rpartition(":")
    if want != site:
        return
    _visits[site] = _visits.get(site, 0) + 1
    try:
        n = int(index)
    except ValueError:
        logger.warning("ignoring malformed %s=%r", ENV, spec)
        return
    if _visits[site] >= n:
        logger.warning("kill point %s reached (visit %d): SIGKILL", spec, _visits[site])
        logging.shutdown()
        os.kill(os.getpid(), signal.SIGKILL)
