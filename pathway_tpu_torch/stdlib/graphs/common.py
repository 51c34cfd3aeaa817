"""Graph schemas (parity: stdlib/graphs/common.py)."""

from __future__ import annotations

import dataclasses

from pathway_tpu_torch.engine.types import Pointer
from pathway_tpu_torch.internals.schema import Schema


class Vertex(Schema):
    pass


class Edge(Schema):
    u: Pointer
    v: Pointer


class Weight(Schema):
    weight: float


@dataclasses.dataclass
class Graph:
    V: object  # Table of vertices
    E: object  # Table of edges
