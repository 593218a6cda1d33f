"""Coordinator-side edge-tier API: round handoff + envelope intake.

``EdgeCoordinatorApi`` is what the coordinator's REST server exposes under
``/edge/*`` when ``[edge] enabled = true``:

- ``round_info`` hands a trusted edge everything it needs to act as a
  decrypt/verify tier for the current round — the public round parameters
  PLUS the round's encryption secret key. Edges are coordinator-operated
  infrastructure in the NET-SA sense (in-network aggregation nodes inside
  the operator's trust domain); the optional shared ``token`` gates the
  endpoint on open networks.
- ``submit_envelope`` parses a partial-aggregate envelope and forwards it
  to the state machine as ONE :class:`PartialAggregate` request; the
  update phase folds it atomically (docs/DESIGN.md §11), one K1 launch on
  the port's coordinator.

Port of ``xaynet_tpu/edge/api.py``.
"""

from __future__ import annotations

import hmac
import logging
from typing import Optional

from ..server.requests import PartialAggregate, RequestError, RequestSender
from .envelope import EnvelopeError, PartialAggregateEnvelope
from .upstream import EDGE_TOKEN_HEADER

logger = logging.getLogger("xaynet.edge")


class EdgeCoordinatorApi:
    """The coordinator's half of the edge-tier protocol."""

    def __init__(self, events, request_tx: RequestSender, token: str = ""):
        self.events = events
        self.request_tx = request_tx
        self.token = token

    def authorized(self, headers: dict) -> bool:
        """Shared-token check (no token configured = open network).

        Constant-time: the endpoint behind it hands out the round's secret
        key, so the comparison must not leak matching-prefix timing.
        """
        if not self.token:
            return True
        supplied = headers.get(EDGE_TOKEN_HEADER.lower()) or ""
        return hmac.compare_digest(supplied.encode(), self.token.encode())

    def round_info(self) -> dict:
        """Round handoff for the trusted edge tier: public params, the
        round's encryption keypair, and the coordinator's current phase."""
        params = self.events.params.get_latest().event
        keys = self.events.keys.get_latest().event
        return {
            "round_id": self.events.params.get_latest().round_id,
            "phase": self.events.phase.get_latest().event.value,
            "params": params.to_dict(),
            "secret_key": keys.secret.as_bytes().hex(),
        }

    async def submit_envelope(self, body: bytes) -> tuple[bool, Optional[str]]:
        """Parse + forward one envelope; returns ``(accepted, detail)``.

        ``accepted`` False with a detail means a PROTOCOL rejection (the
        edge must drop the envelope, not retry it); parse failures raise
        :class:`EnvelopeError` and infrastructure failures propagate.
        """
        envelope = PartialAggregateEnvelope.from_bytes(body)
        request = PartialAggregate(
            edge_id=envelope.edge_id,
            window_seq=envelope.window_seq,
            round_seed=envelope.round_seed,
            members=envelope.members,
            seed_dicts=envelope.seed_dicts,
            masked=envelope.masked,
            trace=envelope.trace,
        )
        try:
            await self.request_tx.request(request)
        except RequestError as err:
            if err.kind is RequestError.Kind.INTERNAL:
                raise  # channel closed / infrastructure: 503, edge retries
            logger.info(
                "edge envelope %s/%d rejected: %s",
                envelope.edge_id,
                envelope.window_seq,
                err,
            )
            return False, str(err)
        return True, None


__all__ = ["EdgeCoordinatorApi", "EnvelopeError"]
