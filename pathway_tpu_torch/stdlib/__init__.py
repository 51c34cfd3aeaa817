"""Standard library of the PyTorch port (parity: ``pathway_tpu/stdlib``):
graphs, indexing, ml, ordered, stateful, statistical, temporal, utils,
viz."""

from pathway_tpu_torch.stdlib import (
    graphs,
    indexing,
    ml,
    ordered,
    stateful,
    statistical,
    temporal,
    utils,
    viz,
)

__all__ = [
    "graphs",
    "indexing",
    "ml",
    "ordered",
    "stateful",
    "statistical",
    "temporal",
    "utils",
    "viz",
]
