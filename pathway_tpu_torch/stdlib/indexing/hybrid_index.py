"""Hybrid index — reciprocal-rank fusion (parity: stdlib/indexing/hybrid_index.py:14).

A copy of ``pathway_tpu/stdlib/indexing/hybrid_index.py``.  The fused index
has no ``search_many``: the engine asks it one query at a time."""

from __future__ import annotations

from collections import defaultdict
from typing import Any

from pathway_tpu_torch.stdlib.indexing.data_index import InnerIndex


class _HybridEngineIndex:
    def __init__(self, inner_indexes, k: float = 60.0):
        self.inners = inner_indexes
        self.k = k

    def add(self, key: int, data, filter_data=None) -> None:
        # data is a tuple: one entry per inner index
        for inner, d in zip(self.inners, data):
            inner.add(key, d, filter_data)

    def remove(self, key: int) -> None:
        for inner in self.inners:
            inner.remove(key)

    def search(self, query, k: int | None, filter_query=None):
        if k is None:
            k = 3
        fused: dict[int, float] = defaultdict(float)
        for inner, q in zip(self.inners, query):
            results = inner.search(q, k * 3, filter_query)
            for rank, (key, _score) in enumerate(results):
                fused[key] += 1.0 / (self.k + rank + 1)
        ranked = sorted(fused.items(), key=lambda e: -e[1])
        return [(key, score) for key, score in ranked[:k]]


class HybridIndex(InnerIndex):
    """Fuses several inner indexes by reciprocal rank fusion.

    The engine-side data/query payloads are tuples with one element per
    sub-index (e.g. ``(embedding, text)`` for dense + BM25); ``embed`` and
    ``data_expr`` synthesize those tuples from each child's preparation.
    """

    def __init__(self, inner_indexes: list[InnerIndex], *, k: float = 60.0):
        super().__init__(inner_indexes[0].data_column, inner_indexes[0].metadata_column)
        self.inner_indexes = inner_indexes
        self.k = k

    def factory(self):
        factories = [ix.factory() for ix in self.inner_indexes]
        k = self.k

        class _F:
            @staticmethod
            def build():
                return _HybridEngineIndex([f.build() for f in factories], k)

        return _F()

    def embed(self, column):
        from pathway_tpu_torch.internals.expression import make_tuple

        return make_tuple(*[ix.embed(column) for ix in self.inner_indexes])

    def data_expr(self, index_column):
        from pathway_tpu_torch.internals.expression import make_tuple

        return make_tuple(
            *[ix.data_expr(index_column) for ix in self.inner_indexes]
        )


class HybridDataIndex:
    """Table-level hybrid index fusing several DataIndexes (RRF)."""

    def __new__(cls, data_table, data_indexes, *, k: float = 60.0):
        from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex

        inners = [di.inner_index for di in data_indexes]
        return DataIndex(data_table, HybridIndex(inners, k=k))


HybridIndexFactory = HybridIndex
