"""Hierarchical edge pre-aggregation tier (docs/DESIGN.md §11).

Port of ``xaynet_tpu/edge``. Edge aggregators admit and decrypt/verify
participant uploads near the participants, fold accepted masked updates
into a partial masked aggregate (modular addition, byte-identical to
folding centrally), and ship ONE ``PartialAggregate`` envelope upstream
per linger window. The coordinator's ingress shrinks by the edge batch
factor (NET-SA in PAPERS.md).

An edge does no device work: it folds on the host through
``core.mask.masking.Aggregation``. The card is reached on the
coordinator, whose Update phase folds each envelope as one row, one K1
launch (``StagedAggregator.fold_partial``).
"""

from .aggregator import EdgeAdmitError as EdgeAdmitError
from .aggregator import EdgeAggregator as EdgeAggregator
from .api import EdgeCoordinatorApi as EdgeCoordinatorApi
from .envelope import EnvelopeError as EnvelopeError
from .envelope import PartialAggregateEnvelope as PartialAggregateEnvelope
from .service import EdgeService as EdgeService
from .upstream import ResilientUpstream as ResilientUpstream
from .upstream import UpstreamClient as UpstreamClient
