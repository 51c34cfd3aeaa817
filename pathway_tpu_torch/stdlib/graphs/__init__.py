"""Graph algorithms over streaming tables (parity: stdlib/graphs/).

pagerank, bellman_ford, louvain — all built on ``pw.iterate`` fixed points,
as in the reference.
"""

from pathway_tpu_torch.stdlib.graphs.common import Edge, Vertex, Graph
from pathway_tpu_torch.stdlib.graphs.pagerank import pagerank
from pathway_tpu_torch.stdlib.graphs.bellman_ford import bellman_ford
from pathway_tpu_torch.stdlib.graphs.louvain_communities import louvain_level

__all__ = [
    "Edge",
    "Vertex",
    "Graph",
    "pagerank",
    "bellman_ford",
    "louvain_level",
]
