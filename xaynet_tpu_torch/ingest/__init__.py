"""Admission-controlled batched ingest pipeline.

The port's copy of ``xaynet_tpu/ingest``. It runs no device code of its
own: the coalesced micro-batches it submits reach the Update phase, whose
aggregator validates them on the card (K4 for wire v2, K3 for v1: one
launch per ``batch_size`` chunk) and folds their device rows with K1.

The fan-in between the REST surface and the state machine (NET-SA shows
secure-aggregation throughput is dominated by exactly this path):

    POST /message -> pre-filter -> AdmissionController -> ShardedIntake
        -> DecryptWorker (batched sealed-box open + verify, one thread-pool
           hop per batch) -> UpdateCoalescer (micro-batched UpdateRequests,
           one stacked fold dispatch per batch) -> state machine

Every queue is bounded; saturation sheds load at the door (HTTP 429 +
Retry-After) instead of growing coordinator memory.
"""

from .admission import AdmissionController, Verdict
from .coalescer import UpdateCoalescer
from .intake import IntakeShard, ShardedIntake
from .pipeline import IngestPipeline

__all__ = [
    "AdmissionController",
    "IngestPipeline",
    "IntakeShard",
    "ShardedIntake",
    "UpdateCoalescer",
    "Verdict",
]
