"""KNN inner indexes (parity: stdlib/indexing/nearest_neighbors.py:65-262
and src/external_integration/{brute_force_knn,usearch}_integration.rs).

Counterpart of ``pathway_tpu/stdlib/indexing/nearest_neighbors.py``.
``BruteForceKnnIndex`` is the device index: vectors are packed into a
matrix kept on the device (``ops/topk.py::DeviceIndexCache``) and a batch
of queries is answered by one scored, masked top-k.  ``BruteForceKnn`` is
its Table-API wrapper, whose factory binds the default index mesh late.
``LshKnn`` is the pure-host LSH analog of the reference's
``ml/classifiers/_knn_lsh.py``.  ``USearchKnn`` is approximate: an HNSW
graph on the host (``hnsw.py``) honoring the USearch tuning parameters
(connectivity / expansion_add / expansion_search).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals.expression import ColumnReference
from pathway_tpu_torch.ops import topk as topk_ops
from pathway_tpu_torch.stdlib.indexing.data_index import InnerIndex
from pathway_tpu_torch.stdlib.indexing.filters import metadata_matches
from pathway_tpu_torch.stdlib.indexing.retrievers import (
    BruteForceKnnMetricKind,
    USearchMetricKind,
)


class DistanceMetric(enum.Enum):
    COS = "cos"
    L2SQ = "l2sq"
    IP = "ip"


def _as_vec(v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v.astype(np.float32, copy=False)
    return np.asarray(v, dtype=np.float32)


class BruteForceKnnIndex:
    """Exact top-k by dense similarity scan on the device.

    Runs on ``cuda:0`` unless ``device`` names another device; without a
    card and without ``device`` it raises.  With a ``mesh``
    (``parallel/mesh.py::make_mesh``) the matrix is sharded row-wise over
    the mesh's ranks, each on its own device, and answered by the
    distributed top-k at any size (``ops/topk.py::DeviceIndexCache``).
    ``BruteForceKnn``'s factory binds the default mesh
    (``parallel/mesh.py::set_default_index_mesh``) when the run builds
    the index.
    """

    def __init__(
        self,
        metric: DistanceMetric,
        reserved_space: int = 0,
        dimensions: int | None = None,
        mesh=None,
        device=None,
    ):
        self.metric = metric
        self._vectors: dict[int, np.ndarray] = {}
        self._filters: dict[int, Any] = {}
        self._dirty = True
        self._version = 0  # bumped on every change; keys the device cache
        self._keys: list[int] = []
        self._matrix: np.ndarray | None = None
        self._device_cache = topk_ops.DeviceIndexCache(device=device, mesh=mesh)

    def add(self, key: int, vector, filter_data=None) -> None:
        self._vectors[key] = _as_vec(vector)
        if filter_data is not None:
            self._filters[key] = filter_data
        self._dirty = True
        self._version += 1

    def remove(self, key: int) -> None:
        self._vectors.pop(key, None)
        self._filters.pop(key, None)
        self._dirty = True
        self._version += 1

    def _rebuild(self):
        self._keys = list(self._vectors.keys())
        if self._keys:
            self._matrix = np.stack([self._vectors[k] for k in self._keys])
        else:
            self._matrix = None
        self._dirty = False

    def search(self, query, k: int | None, filter_query=None) -> list[tuple[int, float]]:
        return self.search_many([(query, k, filter_query)])[0]

    def search_many(
        self, requests: list[tuple[Any, int | None, Any]]
    ) -> list[list[tuple[int, float]]]:
        """Answer a batch of ``(query, k, filter)`` requests: the queries
        stack into one matrix per distinct fetch-k and run through one
        bucketed device top-k each.  A filter over-fetches, then filters on
        the host."""
        if not requests:
            return []
        if self._dirty:
            self._rebuild()
        if self._matrix is None:
            return [[] for _ in requests]
        groups: dict[int, list[int]] = {}
        ks: list[int] = []
        for pos, (_q, k, filter_query) in enumerate(requests):
            k = 3 if k is None else k
            ks.append(k)
            fetch_k = (
                k
                if filter_query is None
                else min(len(self._keys), max(4 * k, 64))
            )
            groups.setdefault(fetch_k, []).append(pos)
        out: list[list[tuple[int, float]]] = [[] for _ in requests]
        for fetch_k, positions in groups.items():
            queries = np.stack([_as_vec(requests[p][0]) for p in positions])
            idx, scores = topk_ops.topk_search_cached(
                self._matrix,
                queries,
                fetch_k,
                self.metric.value,
                cache=self._device_cache,
                version=self._version,
            )
            for row, pos in enumerate(positions):
                k = ks[pos]
                filter_query = requests[pos][2]
                hits = []
                for i, score in zip(idx[row], scores[row]):
                    key = self._keys[int(i)]
                    if filter_query is not None and not metadata_matches(
                        filter_query, self._filters.get(key)
                    ):
                        continue
                    s = float(score)
                    # distance for L2, similarity for cos/ip
                    hits.append(
                        (key, -s if self.metric == DistanceMetric.L2SQ else s)
                    )
                    if len(hits) >= k:
                        break
                out[pos] = hits
        return out


@dataclasses.dataclass
class _SimpleFactory:
    make: Callable[[], Any]

    def build(self):
        return self.make()


class BruteForceKnn(InnerIndex):
    """Exact KNN (parity: nearest_neighbors.py:170).  ``device`` is the
    port's own: the index runs on ``cuda:0`` unless it names another
    device (``"cpu"`` runs the plain top-k)."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnReference | None = None,
        *,
        dimensions: int | None = None,
        reserved_space: int = 0,
        metric: BruteForceKnnMetricKind | DistanceMetric = DistanceMetric.COS,
        embedder=None,
        mesh=None,
        device=None,
    ):
        super().__init__(data_column, metadata_column)
        if isinstance(metric, BruteForceKnnMetricKind):
            metric = DistanceMetric(metric.value)
        self.metric = metric
        self.dimensions = dimensions
        self.embedder = embedder
        self.mesh = mesh
        self.device = device

    def factory(self):
        metric = self.metric
        explicit_mesh = self.mesh
        device = self.device

        def make():
            # late-bound so set_default_index_mesh() before pw.run() applies
            from pathway_tpu_torch.parallel.mesh import get_default_index_mesh

            mesh = explicit_mesh if explicit_mesh is not None else get_default_index_mesh()
            return BruteForceKnnIndex(metric, mesh=mesh, device=device)

        return _SimpleFactory(make)

    def embed(self, column):
        if self.embedder is not None:
            return self.embedder(column)
        return column


class USearchKnn(BruteForceKnn):
    """Approximate KNN over an HNSW graph (parity: the reference's USearch
    index, nearest_neighbors.py:65 + usearch_integration.rs:163).

    Backed by the HNSW graph of ``hnsw.py``, on the host; the USearch
    tuning parameters map directly: ``connectivity`` = M,
    ``expansion_add`` = efConstruction, ``expansion_search`` = ef.
    ``device`` is taken for ``BruteForceKnn``'s signature and unused: the
    index allocates nothing on a device."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnReference | None = None,
        *,
        dimensions: int | None = None,
        reserved_space: int = 0,
        metric: USearchMetricKind | DistanceMetric = DistanceMetric.COS,
        connectivity: int = 0,
        expansion_add: int = 0,
        expansion_search: int = 0,
        embedder=None,
        mesh=None,
        device=None,
    ):
        if isinstance(metric, USearchMetricKind):
            metric = DistanceMetric(metric.value)
        super().__init__(
            data_column,
            metadata_column,
            dimensions=dimensions,
            reserved_space=reserved_space,
            metric=metric,
            embedder=embedder,
            mesh=mesh,
            device=device,
        )
        self.connectivity = connectivity
        self.expansion_add = expansion_add
        self.expansion_search = expansion_search

    def factory(self):
        metric = self.metric
        connectivity = self.connectivity
        expansion_add = self.expansion_add
        expansion_search = self.expansion_search

        def make():
            from pathway_tpu_torch.stdlib.indexing.hnsw import HnswIndex

            return HnswIndex(
                metric=metric.value,
                connectivity=connectivity,
                expansion_add=expansion_add,
                expansion_search=expansion_search,
            )

        return _SimpleFactory(make)


class LshKnnIndex:
    """Random-hyperplane LSH (analog of ml/classifiers/_knn_lsh.py)."""

    def __init__(self, dimensions: int, n_or: int = 4, n_and: int = 8, bucket_length: float = 10.0):
        self.dimensions = dimensions
        self.n_or = n_or
        self.n_and = n_and
        rng = np.random.default_rng(42)
        self._planes = [
            rng.normal(size=(n_and, dimensions)).astype(np.float32) for _ in range(n_or)
        ]
        self._buckets: list[dict[bytes, set[int]]] = [dict() for _ in range(n_or)]
        self._vectors: dict[int, np.ndarray] = {}
        self._filters: dict[int, Any] = {}

    def _hashes(self, v: np.ndarray) -> list[bytes]:
        return [
            np.packbits((p @ v) > 0).tobytes() for p in self._planes
        ]

    def add(self, key: int, vector, filter_data=None) -> None:
        v = _as_vec(vector)
        self._vectors[key] = v
        if filter_data is not None:
            self._filters[key] = filter_data
        for table, h in zip(self._buckets, self._hashes(v)):
            table.setdefault(h, set()).add(key)

    def remove(self, key: int) -> None:
        v = self._vectors.pop(key, None)
        self._filters.pop(key, None)
        if v is None:
            return
        for table, h in zip(self._buckets, self._hashes(v)):
            table.get(h, set()).discard(key)

    def search(self, query, k: int | None, filter_query=None) -> list[tuple[int, float]]:
        if k is None:
            k = 3
        q = _as_vec(query)
        candidates: set[int] = set()
        for table, h in zip(self._buckets, self._hashes(q)):
            candidates |= table.get(h, set())
        scored = []
        qn = np.linalg.norm(q) + 1e-12
        for key in candidates:
            if filter_query is not None and not metadata_matches(
                filter_query, self._filters.get(key)
            ):
                continue
            v = self._vectors[key]
            sim = float(q @ v / (qn * (np.linalg.norm(v) + 1e-12)))
            scored.append((key, sim))
        scored.sort(key=lambda e: -e[1])
        return scored[:k]


class LshKnn(InnerIndex):
    """LSH-backed approximate KNN (parity: nearest_neighbors.py:262)."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnReference | None = None,
        *,
        dimensions: int,
        n_or: int = 4,
        n_and: int = 8,
        bucket_length: float = 10.0,
        metric: DistanceMetric = DistanceMetric.COS,
        embedder=None,
    ):
        super().__init__(data_column, metadata_column)
        self.dimensions = dimensions
        self.n_or = n_or
        self.n_and = n_and
        self.bucket_length = bucket_length
        self.embedder = embedder

    def factory(self):
        dims, n_or, n_and, bl = self.dimensions, self.n_or, self.n_and, self.bucket_length
        return _SimpleFactory(lambda: LshKnnIndex(dims, n_or, n_and, bl))

    def embed(self, column):
        if self.embedder is not None:
            return self.embedder(column)
        return column
