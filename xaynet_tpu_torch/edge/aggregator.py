"""EdgeAggregator: the accounting fold path for one edge window.

Every masked update accepted by an edge MUST flow through ``admit`` — it
validates the update against the round's aggregation state, folds it into
the window's partial aggregate, and records the member pk + seed dict that
the envelope will carry. A fold without the matching accounting entry
would ship a partial whose ``nb_models`` undercounts its content and break
the coordinator's nb_models == seed-watermark unmask invariant, so the one
fold site below is the only one under ``edge/`` (annotated ``# lint:
fold-ok`` as in the JAX package, whose ``tools/lint.py`` rejects any
other). Port of ``xaynet_tpu/edge/aggregator.py``.
"""

from __future__ import annotations

from ..core.mask.config import MaskConfigPair
from ..core.mask.masking import Aggregation, AggregationError
from ..server.requests import UpdateRequest
from ..telemetry.registry import get_registry
from .envelope import PartialAggregateEnvelope

_registry = get_registry()
WINDOW_MEMBERS = _registry.gauge(
    "xaynet_edge_window_members",
    "Masked updates folded into the current (unsealed) edge window.",
)
MEMBER_REJECTIONS = _registry.counter(
    "xaynet_edge_member_rejections_total",
    "Updates an edge refused to fold into its window, by reason.",
    ("reason",),
)
ENVELOPES_SEALED = _registry.counter(
    "xaynet_edge_envelopes_sealed_total",
    "Edge windows sealed into partial-aggregate envelopes.",
)


class EdgeAdmitError(Exception):
    """An update was rejected by the edge fold path; ``reason`` is the
    counter label (``duplicate`` | protocol kinds from AggregationError)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}{': ' + detail if detail else ''}")
        self.reason = reason


class EdgeAggregator:
    """Folds verified updates into one partial aggregate per linger window."""

    def __init__(
        self,
        config: MaskConfigPair,
        object_size: int,
        max_members: int = 64,
        start_seq: int = 0,
    ):
        if max_members < 1:
            raise ValueError("max_members must be >= 1")
        self.config = config
        self.object_size = object_size
        self.max_members = max_members
        self._agg = Aggregation(config, object_size)
        self._members: list[bytes] = []
        self._seed_dicts: dict[bytes, dict] = {}
        # pks already shipped upstream THIS round: a participant retrying
        # through the same edge must not be folded twice (the coordinator
        # would reject the whole second envelope for the one duplicate)
        self._shipped_pks: set[bytes] = set()
        # `start_seq`: the coordinator's per-edge watermark only moves
        # forward within a round, so a RESTARTED edge process must start
        # past any sequence its crashed predecessor shipped — the service
        # passes a wall-clock-derived base (sequences need not be dense,
        # only strictly increasing per (edge_id, round))
        self.window_seq = start_seq

    # --- window state -----------------------------------------------------

    @property
    def pending(self) -> int:
        """Members folded into the current, not-yet-sealed window."""
        return len(self._members)

    @property
    def full(self) -> bool:
        return len(self._members) >= self.max_members

    # --- the accounting fold path -----------------------------------------

    def admit(self, req: UpdateRequest) -> None:
        """Validate + fold one verified update into the window.

        Raises :class:`EdgeAdmitError` on rejection; the caller answers the
        participant (who then falls back to uploading upstream directly).
        """
        pk = req.participant_pk
        if pk in self._seed_dicts or pk in self._shipped_pks:
            MEMBER_REJECTIONS.labels(reason="duplicate").inc()
            raise EdgeAdmitError("duplicate", "participant already folded this round")
        if self.full:
            MEMBER_REJECTIONS.labels(reason="window-full").inc()
            raise EdgeAdmitError("window-full", "seal the window first")
        try:
            self._agg.validate_aggregation(req.masked_model)
        except AggregationError as err:
            MEMBER_REJECTIONS.labels(reason=err.kind).inc()
            raise EdgeAdmitError(err.kind) from err
        # THE fold site: accounting (member + seed dict) and the modular
        # add commit together, so a sealed envelope can never ship a model
        # count that disagrees with its content
        self._agg.aggregate(req.masked_model)  # lint: fold-ok
        self._members.append(pk)
        self._seed_dicts[pk] = dict(req.local_seed_dict)
        WINDOW_MEMBERS.set(len(self._members))

    def seal(self, edge_id: str, round_seed: bytes) -> PartialAggregateEnvelope:
        """Close the window into an envelope and start a fresh one.

        The sealed members move to the shipped set — whatever happens to
        the envelope upstream, this edge will not fold them again.
        """
        if not self._members:
            raise ValueError("cannot seal an empty window")
        envelope = PartialAggregateEnvelope(
            edge_id=edge_id,
            window_seq=self.window_seq,
            round_seed=round_seed,
            members=list(self._members),
            seed_dicts=dict(self._seed_dicts),
            masked=self._agg.object,
        )
        self.window_seq += 1
        self._shipped_pks.update(self._members)
        self._agg = Aggregation(self.config, self.object_size)
        self._members = []
        self._seed_dicts = {}
        WINDOW_MEMBERS.set(0)
        ENVELOPES_SEALED.inc()
        return envelope
