"""Standard library of the PyTorch port (parity: ``pathway_tpu/stdlib``):
indexing, ml, ordered, stateful, statistical, utils.  ``temporal``,
``graphs`` and ``viz`` are stand-ins that raise ``NotImplementedError`` on
use, naming the temporal slice, which brings them."""

from pathway_tpu_torch.io import _LaterSlice
from pathway_tpu_torch.stdlib import (
    indexing,
    ml,
    ordered,
    stateful,
    statistical,
    utils,
)

LATER = "the temporal slice (stdlib/temporal, graphs, viz)"
graphs = _LaterSlice("pw.graphs", LATER)
temporal = _LaterSlice("pw.temporal", LATER)
viz = _LaterSlice("pw.viz", LATER)

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
