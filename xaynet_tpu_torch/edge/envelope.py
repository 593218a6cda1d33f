"""Partial-aggregate envelope: the edge -> coordinator wire format.

Port of ``xaynet_tpu/edge/envelope.py``; the bytes are the JAX package's.
One envelope carries ONE pre-folded window: the modular sum of the
window's verified masked updates, the member pks in fold order, and every
member's local seed dict. The coordinator folds it as a single
fold (one K1 launch on the port's coordinator) and advances ``nb_models`` by the member count —
byte-identical to folding the same updates centrally, because masked
aggregation is modular addition (associative and commutative).

Wire format (same family as the checkpoint blob, docs/DESIGN.md §11):
``XNEDGE1`` magic, u32-le JSON-header length, JSON header, then the raw
``serialize_mask_object`` bytes of the partial. The header carries the
envelope identity (edge id, window sequence, round seed), the member pks,
the per-member seed dicts, and a sha256 digest of the masked payload — a
torn or corrupted transfer fails parsing, never folds.
"""

from __future__ import annotations

import hashlib
import json
import struct
from dataclasses import dataclass

from ..core.common import LocalSeedDict
from ..core.mask.object import MaskObject
from ..core.mask.seed import EncryptedMaskSeed
from ..core.mask.serialization import parse_mask_object, serialize_mask_object

MAGIC = b"XNEDGE1"


class EnvelopeError(ValueError):
    """Corrupt or inconsistent partial-aggregate envelope."""


@dataclass
class PartialAggregateEnvelope:
    """Everything the coordinator needs to fold one edge window atomically."""

    edge_id: str
    window_seq: int
    round_seed: bytes
    members: list[bytes]  # update pks, fold order
    seed_dicts: dict[bytes, LocalSeedDict]  # update pk -> {sum pk -> seed}
    masked: MaskObject  # modular sum of the members' masked models
    # optional trace context ("trace_id-span_id") of the edge's seal span:
    # the coordinator's fold span adopts the trace id, so a two-tier round
    # stitches into ONE trace (docs/DESIGN.md §16). Absent on pre-tracing
    # envelopes — the wire format stays compatible both ways.
    trace: str | None = None

    def __len__(self) -> int:
        return len(self.members)

    def to_bytes(self) -> bytes:
        masked_raw = serialize_mask_object(self.masked)
        fields = {
            "edge_id": self.edge_id,
            "window_seq": self.window_seq,
            "round_seed": self.round_seed.hex(),
            "members": [pk.hex() for pk in self.members],
            "seed_dicts": {
                pk.hex(): {
                    sum_pk.hex(): seed.as_bytes().hex()
                    for sum_pk, seed in local.items()
                }
                for pk, local in self.seed_dicts.items()
            },
            "masked_sha256": hashlib.sha256(masked_raw).hexdigest(),
        }
        if self.trace:
            fields["trace"] = self.trace
        header = json.dumps(fields).encode()
        return MAGIC + struct.pack("<I", len(header)) + header + masked_raw

    @classmethod
    def from_bytes(cls, raw: bytes) -> "PartialAggregateEnvelope":
        if len(raw) < len(MAGIC) + 4 or raw[: len(MAGIC)] != MAGIC:
            raise EnvelopeError("bad magic")
        (header_len,) = struct.unpack_from("<I", raw, len(MAGIC))
        body_at = len(MAGIC) + 4 + header_len
        if body_at > len(raw):
            raise EnvelopeError("truncated header")
        try:
            header = json.loads(raw[len(MAGIC) + 4 : body_at].decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise EnvelopeError(f"bad header: {e}") from e
        masked_raw = raw[body_at:]
        try:
            if hashlib.sha256(masked_raw).hexdigest() != header["masked_sha256"]:
                raise EnvelopeError("masked payload digest mismatch")
            members = [bytes.fromhex(pk) for pk in header["members"]]
            seed_dicts = {
                bytes.fromhex(pk): {
                    bytes.fromhex(sum_pk): EncryptedMaskSeed(bytes.fromhex(seed))
                    for sum_pk, seed in local.items()
                }
                for pk, local in header["seed_dicts"].items()
            }
            envelope = cls(
                edge_id=str(header["edge_id"]),
                window_seq=int(header["window_seq"]),
                round_seed=bytes.fromhex(header["round_seed"]),
                members=members,
                seed_dicts=seed_dicts,
                masked=parse_mask_object(masked_raw)[0],
                trace=str(header["trace"]) if header.get("trace") else None,
            )
        except EnvelopeError:
            raise
        except (KeyError, ValueError, TypeError) as e:
            raise EnvelopeError(f"malformed envelope: {e}") from e
        if not envelope.members:
            raise EnvelopeError("empty envelope")
        if sorted(envelope.seed_dicts) != sorted(envelope.members):
            raise EnvelopeError("seed dicts do not match the member list")
        return envelope
