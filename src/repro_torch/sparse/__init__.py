"""Row-sparse gossip: ship only the touched rows of each plane bucket
(``repro.sparse``).

See :mod:`repro_torch.sparse.channel` for the channels' semantics (exact and
delta modes, crossover, byte accounting, the wire) and
:mod:`repro_torch.sparse.tracker` for the model-side touched-row derivation.
"""

from .channel import (
    SparseDelayedPpermuteChannel,
    SparseGossipChannel,
    SparsePpermuteChannel,
    SparseStackedChannel,
    build_sparse_channel,
    grad_row_masks,
)
from .tracker import RowSource, RowTracker

__all__ = [
    "SparseStackedChannel",
    "SparsePpermuteChannel",
    "SparseDelayedPpermuteChannel",
    "SparseGossipChannel",
    "build_sparse_channel",
    "grad_row_masks",
    "RowSource",
    "RowTracker",
]
