"""Retriever factory enums/abstracts (parity: stdlib/indexing/retrievers.py).

A copy of ``pathway_tpu/stdlib/indexing/retrievers.py``;
``BruteForceKnnFactory``'s ``device`` is the port's own.
"""

from __future__ import annotations

import dataclasses
import enum


class USearchMetricKind(enum.Enum):
    # mirrors usearch MetricKind (usearch_integration.rs)
    COS = "cos"
    L2SQ = "l2sq"
    IP = "ip"


class BruteForceKnnMetricKind(enum.Enum):
    # mirrors brute_force_knn_integration.rs metric kinds
    COS = "cos"
    L2SQ = "l2sq"


class AbstractRetrieverFactory:
    def build_index(self, data_column, data_table, metadata_column=None):
        raise NotImplementedError


@dataclasses.dataclass
class BruteForceKnnFactory(AbstractRetrieverFactory):
    """Factory for the dense device-backed index (parity: retrievers.py)."""

    dimensions: int | None = None
    reserved_space: int = 0
    embedder: object | None = None
    metric: "BruteForceKnnMetricKind" = None  # type: ignore[assignment]
    mesh: object | None = None  # DeviceMesh → corpus-sharded device index
    device: object | None = None  # the index's device: cuda:0 unless named

    def build_index(self, data_column, data_table, metadata_column=None):
        from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
        from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
            BruteForceKnn,
            DistanceMetric,
        )

        metric = self.metric or BruteForceKnnMetricKind.COS
        inner = BruteForceKnn(
            data_column,
            metadata_column,
            dimensions=self.dimensions,
            reserved_space=self.reserved_space,
            metric=DistanceMetric(metric.value),
            embedder=self.embedder,
            mesh=self.mesh,
            device=self.device,
        )
        return DataIndex(data_table, inner)


@dataclasses.dataclass
class UsearchKnnFactory(AbstractRetrieverFactory):
    """Factory keeping USearch HNSW API parity (an HNSW graph on the host)."""

    dimensions: int | None = None
    reserved_space: int = 0
    embedder: object | None = None
    metric: "USearchMetricKind" = None  # type: ignore[assignment]
    connectivity: int = 0
    expansion_add: int = 0
    expansion_search: int = 0
    mesh: object | None = None  # unused: the HNSW graph lives on the host

    def build_index(self, data_column, data_table, metadata_column=None):
        from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
        from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
            DistanceMetric,
            USearchKnn,
        )

        metric = self.metric or USearchMetricKind.COS
        inner = USearchKnn(
            data_column,
            metadata_column,
            dimensions=self.dimensions,
            reserved_space=self.reserved_space,
            metric=DistanceMetric(metric.value),
            connectivity=self.connectivity,
            expansion_add=self.expansion_add,
            expansion_search=self.expansion_search,
            embedder=self.embedder,
            mesh=self.mesh,
        )
        return DataIndex(data_table, inner)


@dataclasses.dataclass
class TantivyBM25Factory(AbstractRetrieverFactory):
    """Factory for the BM25 full-text index."""

    ram_budget: int = 50_000_000
    in_memory_index: bool = True

    def build_index(self, data_column, data_table, metadata_column=None):
        from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25
        from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex

        inner = TantivyBM25(
            data_column,
            metadata_column,
            ram_budget=self.ram_budget,
            in_memory_index=self.in_memory_index,
        )
        return DataIndex(data_table, inner)


@dataclasses.dataclass
class HybridIndexFactory(AbstractRetrieverFactory):
    """Reciprocal-rank fusion over several retriever factories."""

    retriever_factories: list = None  # type: ignore[assignment]
    k: float = 60.0

    def build_index(self, data_column, data_table, metadata_column=None):
        from pathway_tpu_torch.stdlib.indexing.hybrid_index import HybridDataIndex

        indexes = [
            f.build_index(data_column, data_table, metadata_column)
            for f in self.retriever_factories
        ]
        return HybridDataIndex(data_table, indexes, k=self.k)


@dataclasses.dataclass
class LshKnnFactory(AbstractRetrieverFactory):
    """Factory for LSH-bucketed approximate KNN (parity:
    nearest_neighbors.py:528)."""

    dimensions: int | None = None
    n_or: int = 20
    n_and: int = 10
    bucket_length: float = 10.0
    distance_type: str = "euclidean"
    embedder: object | None = None

    def build_index(self, data_column, data_table, metadata_column=None):
        from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
        from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import LshKnn

        if not isinstance(self.dimensions, int):
            # fail at configuration time, not mid-run inside rng.normal
            raise ValueError("LshKnnFactory requires dimensions= (int)")

        from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import DistanceMetric

        metric = (
            DistanceMetric.COS
            if self.distance_type == "cosine"
            else DistanceMetric.L2SQ
        )
        inner = LshKnn(
            data_column,
            metadata_column,
            dimensions=self.dimensions,
            n_or=self.n_or,
            n_and=self.n_and,
            bucket_length=self.bucket_length,
            metric=metric,
            embedder=self.embedder,
        )
        return DataIndex(data_table, inner)
