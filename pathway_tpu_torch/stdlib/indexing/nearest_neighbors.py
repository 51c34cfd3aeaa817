"""Exact KNN index over a device-resident matrix.

Counterpart of ``pathway_tpu/stdlib/indexing/nearest_neighbors.py``'s
``DistanceMetric`` and ``BruteForceKnnIndex``: vectors are packed into a
matrix kept on the device (``ops/topk.py::DeviceIndexCache``) and a batch
of queries is answered by one scored, masked top-k.  The Table-API index
wrappers (``BruteForceKnn``, ``DataIndex``), LSH and HNSW wait for the
host-engine slice of the port.
"""

from __future__ import annotations

import enum
from typing import Any

import numpy as np

from pathway_tpu_torch.ops import topk as topk_ops
from pathway_tpu_torch.stdlib.indexing.filters import metadata_matches


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
    The factories' late-bound default mesh comes with the host-engine
    slice.
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
