"""Runtime secret redaction: the telemetry layer's last line of defense.

The static taint pass (``tools/analysis/taint.py``, docs/DESIGN.md §18)
proves at lint time that key material never *flows* into logs, spans,
dumps or reports. This module is the runtime complement for what static
analysis cannot see — values that become secret only dynamically (a seed
fetched off the wire, an attr dict built from parsed input): flight
recorder dumps and Chrome-trace exports pass every attribute through a
deny-list filter before it hits disk, and ``redact()`` is the sanctioned
length/type-only projection for code that must mention a secret at all
(the taint pass treats it as a declassifier).

Every redaction is counted on ``xaynet_redactions_total{site}`` so a
sudden spike — someone started putting secret-keyed values into span
attrs — is an alertable signal, not a silent save.
"""

from __future__ import annotations

import hashlib
import os

from .registry import get_registry

# per-process salt: the digest prefix must correlate two mentions of the
# same secret WITHIN one process's artifacts (that is the forensic need —
# flight dumps and trace exports are per-process) without handing anyone
# holding the artifact an offline dictionary-confirmation oracle for
# low-entropy secrets like a human-chosen edge token
_SALT = os.urandom(16)

REDACTIONS = get_registry().counter(
    "xaynet_redactions_total",
    "Values redacted from telemetry surfaces before leaving the process, "
    "by site (redact = explicit redact() call | flight = flight-recorder "
    "dump filter | trace = Chrome-trace export filter | alerts = SLO "
    "alert-payload filter).",
    ("site",),
)

# attr/field names whose VALUES never leave the process raw. Substring
# match on the lowercased key: 'mask_seed', 'round_seed', 'secret_key',
# 'edge_token', 'keystream_bytes' all hit. 'round_seed' is public by
# protocol but carries zero forensic value in a dump (the derived trace id
# is already there), so the filter stays simple instead of clever.
DENY_SUBSTRINGS = ("seed", "secret", "token", "keystream", "private")
DENY_EXACT = ("sk", "key_bytes")


def _denied(key: str) -> bool:
    low = key.lower()
    return low in DENY_EXACT or any(s in low for s in DENY_SUBSTRINGS)


def redact(value, site: str = "redact") -> str:
    """Length/type-only projection of a secret value.

    Returns ``<redacted TYPE:LEN DIGEST8>`` — the digest prefix is
    sha256 over a per-process random salt plus the value, so it
    correlates two mentions of the same secret within one process's
    artifacts without revealing a byte of it or enabling an offline
    dictionary check. This is the declassifier the taint pass sanctions
    for code that must talk about a secret (error detail, forensic
    attrs).
    """
    if isinstance(value, (bytes, bytearray, memoryview)):
        raw = bytes(value)
    else:
        raw = str(value).encode("utf-8", "replace")
    digest = hashlib.sha256(_SALT + raw).hexdigest()[:8]
    REDACTIONS.labels(site=site).inc()
    return f"<redacted {type(value).__name__}:{len(raw)} {digest}>"


def scrub_attrs(attrs: dict, site: str) -> dict:
    """Deny-list filter for attr dicts headed to disk.

    Recursive over nested dicts (and dicts inside lists/tuples): any entry
    whose key matches the deny list is replaced by its ``redact()``
    projection. Non-denied values pass through untouched — the filter must
    never change the shape consumers (Perfetto, the trace validator,
    soak greps) parse.
    """
    out = {}
    for key, value in attrs.items():
        if _denied(str(key)):
            out[key] = redact(value, site=site)
        elif isinstance(value, dict):
            out[key] = scrub_attrs(value, site)
        elif isinstance(value, (list, tuple)):
            out[key] = [
                scrub_attrs(item, site) if isinstance(item, dict) else item
                for item in value
            ]
        else:
            out[key] = value
    return out
