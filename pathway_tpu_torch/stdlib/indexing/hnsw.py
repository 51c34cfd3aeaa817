"""HNSW approximate nearest-neighbor index.

A copy of ``pathway_tpu/stdlib/indexing/hnsw.py``.  The graph lives on the
host, in the port's own native core (``pathway_tpu_torch/native``, whose
``hnsw_*`` functions are the JAX package's C++ unchanged) or in Python.

Parity target: the reference's USearch integration
(``src/external_integration/usearch_integration.rs:163``),
which links the USearch C library.  This build implements the HNSW
algorithm (Malkov & Yashunin 2016) directly, twice:

* ``NativeHnswIndex`` — the production path: graph, vector store and the
  insert/search hot loops live in the C++ native core
  (``native/src/_native.cpp`` ``hnsw_*``), the same division of labor as
  the reference linking the USearch C library.  The Python side keeps
  128-bit-key↔dense-id mapping, metadata filters, and the
  tombstone-compaction policy.
* ``PyHnswIndex`` — the dependency-free fallback (numpy-vectorized per
  candidate frontier), used when the native core is unavailable
  (``PATHWAY_NATIVE=0`` or no compiler).

Both honor the same tuning knobs — ``connectivity`` (M),
``expansion_add`` (efConstruction), ``expansion_search`` (ef) — and the
same scoring conventions.  ``HnswIndex(...)`` picks the best available.
Deletions are tombstoned and compacted when they exceed half the index
(USearch marks-and-skips the same way).
"""

from __future__ import annotations

import heapq
import math
import random
from typing import Any, Callable

import numpy as np


def HnswIndex(
    metric: str = "cos",
    connectivity: int = 16,
    expansion_add: int = 128,
    expansion_search: int = 64,
    seed: int = 0,
):
    """The best available HNSW implementation (native core, else Python)."""
    from pathway_tpu_torch import native as native_mod

    nat = native_mod.get()
    if nat is not None and hasattr(nat, "hnsw_new"):
        return NativeHnswIndex(
            metric=metric,
            connectivity=connectivity,
            expansion_add=expansion_add,
            expansion_search=expansion_search,
            seed=seed,
        )
    return PyHnswIndex(
        metric=metric,
        connectivity=connectivity,
        expansion_add=expansion_add,
        expansion_search=expansion_search,
        seed=seed,
    )


class NativeHnswIndex:
    """C++-cored HNSW with the engine's external-index duck type.

    Keys are the engine's 128-bit row keys (arbitrary Python ints); the
    native graph works on dense u32 node ids.  In-place updates tombstone
    the old node and insert a fresh one; when tombstones outnumber live
    nodes the index is rebuilt from the retained raw vectors (USearch's
    compaction analog).
    """

    def __init__(
        self,
        metric: str = "cos",
        connectivity: int = 16,
        expansion_add: int = 128,
        expansion_search: int = 64,
        seed: int = 0,
    ):
        if metric not in ("cos", "l2sq", "ip"):
            raise ValueError(f"unknown metric {metric!r}")
        from pathway_tpu_torch import native as native_mod

        self._nat = native_mod.get()
        self.metric = metric
        self.m = max(2, int(connectivity) or 16)
        self.ef_construction = max(self.m, int(expansion_add) or 128)
        self.ef_search = max(1, int(expansion_search) or 64)
        self._seed = seed
        self._dim: int | None = None
        self._h = None
        self._node_of_key: dict[int, int] = {}
        self._key_of_node: dict[int, int] = {}
        self._filters: dict[int, Any] = {}
        self._n_dead = 0

    def __len__(self) -> int:
        return len(self._node_of_key)

    def _ensure(self, dim: int):
        if self._h is None:
            self._dim = dim
            self._h = self._nat.hnsw_new(
                dim, self.metric, self.m, self.ef_construction, self._seed
            )
        elif dim != self._dim:
            raise ValueError(f"dimension mismatch: {dim} != {self._dim}")
        return self._h

    def add(self, key: int, vector, filter_data=None) -> None:
        v = np.ascontiguousarray(np.asarray(vector, np.float32).reshape(-1))
        h = self._ensure(v.shape[0])
        old = self._node_of_key.pop(key, None)
        if old is not None:
            # in-place update: tombstone + fresh insert
            self._nat.hnsw_remove(h, old)
            self._key_of_node.pop(old, None)
            self._n_dead += 1
        node = self._nat.hnsw_add(h, v)
        self._node_of_key[key] = node
        self._key_of_node[node] = key
        if filter_data is not None:
            self._filters[key] = filter_data
        else:
            self._filters.pop(key, None)
        self._maybe_compact()

    def remove(self, key: int) -> None:
        node = self._node_of_key.pop(key, None)
        if node is None:
            return
        self._nat.hnsw_remove(self._h, node)
        self._key_of_node.pop(node, None)
        self._filters.pop(key, None)
        self._n_dead += 1
        self._maybe_compact()

    def _maybe_compact(self) -> None:
        """Rebuild once tombstones outnumber live nodes — update-only churn
        counts too, not just removals (every in-place add tombstones)."""
        if self._n_dead > len(self._node_of_key):
            self._compact()

    def _compact(self) -> None:
        # live vectors are read back from the native store (prepped form —
        # re-prepping is idempotent), so Python never mirrors the vectors
        nat, h = self._nat, self._h
        live = [
            (
                k,
                np.frombuffer(nat.hnsw_get_vector(h, node), np.float32),
                self._filters.get(k),
            )
            for k, node in self._node_of_key.items()
        ]
        self._h = None
        self._node_of_key.clear()
        self._key_of_node.clear()
        self._filters.clear()
        self._n_dead = 0
        for k, v, f in live:
            self.add(k, v, f)

    def search(
        self,
        query,
        k: int | None,
        filter_query=None,
        ef: int | None = None,
    ) -> list[tuple[int, float]]:
        from pathway_tpu_torch.stdlib.indexing.filters import metadata_matches

        if k is None:
            k = 3
        if self._h is None or not self._node_of_key:
            return []
        q = np.ascontiguousarray(np.asarray(query, np.float32).reshape(-1))
        if q.shape[0] != self._dim:
            raise ValueError(f"dimension mismatch: {q.shape[0]} != {self._dim}")
        ef = max(ef or self.ef_search, k)
        pairs = self._nat.hnsw_search(self._h, q, k, ef)
        out: list[tuple[int, float]] = []
        for node, dist in pairs:
            key = self._key_of_node.get(node)
            if key is None:
                continue
            if filter_query is not None and not metadata_matches(
                filter_query, self._filters.get(key)
            ):
                continue
            # same conventions as the brute-force index: similarity for
            # cos/ip (dist = -similarity), distance for l2sq
            score = float(dist) if self.metric == "l2sq" else -float(dist)
            out.append((key, score))
            if len(out) >= k:
                break
        return out


class PyHnswIndex:
    """add/remove/search with the engine's external-index duck type."""

    def __init__(
        self,
        metric: str = "cos",
        connectivity: int = 16,
        expansion_add: int = 128,
        expansion_search: int = 64,
        seed: int = 0,
    ):
        if metric not in ("cos", "l2sq", "ip"):
            raise ValueError(f"unknown metric {metric!r}")
        self.metric = metric
        self.m = max(2, int(connectivity) or 16)
        self.m0 = 2 * self.m
        self.ef_construction = max(self.m, int(expansion_add) or 128)
        self.ef_search = max(1, int(expansion_search) or 64)
        self._ml = 1.0 / math.log(self.m)
        self._rng = random.Random(seed)

        self._vectors: dict[int, np.ndarray] = {}  # raw (unnormalized)
        self._prepped: dict[int, np.ndarray] = {}  # metric-prepped
        self._filters: dict[int, Any] = {}
        self._levels: dict[int, int] = {}
        # per-layer adjacency: layer -> key -> [neighbor keys]
        self._links: list[dict[int, list[int]]] = []
        # reverse edges: target -> {(layer, source)} — makes in-place
        # updates O(degree) instead of a full-graph scan
        self._rev: dict[int, set[tuple[int, int]]] = {}
        self._entry: int | None = None
        self._deleted: set[int] = set()

    # -- metric helpers ----------------------------------------------------

    def _prep(self, v: np.ndarray) -> np.ndarray:
        v = np.asarray(v, dtype=np.float32).reshape(-1)
        if self.metric == "cos":
            n = float(np.linalg.norm(v))
            return v / n if n > 0 else v
        return v

    def _dists(self, q: np.ndarray, keys: list[int]) -> np.ndarray:
        """Distances (lower = closer) from prepped q to prepped keys."""
        mat = np.stack([self._prepped[k] for k in keys])
        if self.metric == "l2sq":
            d = mat - q[None, :]
            return np.einsum("ij,ij->i", d, d)
        # cos / ip: similarity -> distance
        return -(mat @ q)

    def _score(self, dist: float) -> float:
        """Report scores with the brute-force index's conventions:
        similarity for cos/ip (higher better), distance for l2sq."""
        if self.metric == "l2sq":
            return float(dist)
        return -float(dist)  # dist = -similarity → score = similarity

    # -- construction ------------------------------------------------------

    def __len__(self) -> int:
        return len(self._vectors) - len(self._deleted)

    def _set_links(self, layer: int, src: int, new_list: list[int]) -> None:
        """Replace src's adjacency on a layer, keeping reverse edges in sync."""
        old = self._links[layer].get(src, ())
        for t in old:
            self._rev.get(t, set()).discard((layer, src))
        self._links[layer][src] = new_list
        for t in new_list:
            self._rev.setdefault(t, set()).add((layer, src))

    def add(self, key: int, vector, filter_data=None) -> None:
        if key in self._vectors:
            # in-place update / re-insert: fully unlink the old node so the
            # fresh insert can't find its own stale edges (self-links)
            self._unlink(key)
        self._deleted.discard(key)
        v = np.asarray(vector, dtype=np.float32).reshape(-1)
        self._vectors[key] = v
        self._prepped[key] = self._prep(v)
        if filter_data is not None:
            self._filters[key] = filter_data
        level = int(-math.log(max(self._rng.random(), 1e-12)) * self._ml)
        self._levels[key] = level
        while len(self._links) <= level:
            self._links.append({})
        for layer in range(level + 1):
            self._links[layer].setdefault(key, [])

        if self._entry is None or not self._live_entry():
            self._entry = key
            return

        q = self._prepped[key]
        ep = [self._entry]
        top = self._levels[self._entry]
        # greedy descent above the insertion level
        for layer in range(top, level, -1):
            ep = [self._greedy(q, ep[0], layer)]
        # beam search + linking from min(level, top) down to 0
        for layer in range(min(level, top), -1, -1):
            cands = self._search_layer(q, ep, layer, self.ef_construction)
            m_max = self.m0 if layer == 0 else self.m
            chosen = [k for (_d, k) in heapq.nsmallest(self.m, cands) if k != key]
            self._set_links(layer, key, list(chosen))
            for nb in chosen:
                lst = self._links[layer].get(nb, []) + [key]
                if len(lst) > m_max:
                    # prune: keep the m_max closest to nb
                    nbv = self._prepped[nb]
                    d = self._dists(nbv, lst)
                    order = np.argsort(d)[:m_max]
                    lst = [lst[i] for i in order]
                self._set_links(layer, nb, lst)
            ep = [k for (_d, k) in cands] or ep
        if level > self._levels.get(self._entry, 0):
            self._entry = key

    def remove(self, key: int) -> None:
        if key not in self._vectors or key in self._deleted:
            return
        self._deleted.add(key)
        self._filters.pop(key, None)
        if len(self._deleted) * 2 > len(self._vectors):
            self._compact()
        elif key == self._entry:
            self._entry = self._pick_entry()

    def _unlink(self, key: int) -> None:
        """Remove a node and every edge referencing it (for re-inserts).

        O(degree) via the reverse-edge index — a full-graph scan here would
        make streaming in-place updates quadratic."""
        for layer_idx, src in list(self._rev.get(key, ())):
            lst = self._links[layer_idx].get(src)
            if lst and key in lst:
                self._links[layer_idx][src] = [x for x in lst if x != key]
        self._rev.pop(key, None)
        for layer_idx, layer in enumerate(self._links):
            out = layer.pop(key, None)
            if out:
                for t in out:
                    self._rev.get(t, set()).discard((layer_idx, key))
        self._vectors.pop(key, None)
        self._prepped.pop(key, None)
        self._filters.pop(key, None)
        self._levels.pop(key, None)
        self._deleted.discard(key)
        if key == self._entry:
            self._entry = self._pick_entry()

    def _live_entry(self) -> bool:
        return self._entry is not None and self._entry not in self._deleted

    def _pick_entry(self) -> int | None:
        best, best_level = None, -1
        for k, lvl in self._levels.items():
            if k not in self._deleted and lvl > best_level:
                best, best_level = k, lvl
        return best

    def _compact(self) -> None:
        """Rebuild without tombstones (USearch's compaction analog)."""
        live = [
            (k, self._vectors[k], self._filters.get(k))
            for k in self._vectors
            if k not in self._deleted
        ]
        self._vectors.clear()
        self._prepped.clear()
        self._filters.clear()
        self._levels.clear()
        self._links = []
        self._rev = {}
        self._entry = None
        self._deleted.clear()
        for k, v, f in live:
            self.add(k, v, f)

    # -- search ------------------------------------------------------------

    def _greedy(self, q: np.ndarray, start: int, layer: int) -> int:
        cur = start
        cur_d = float(self._dists(q, [cur])[0])
        improved = True
        while improved:
            improved = False
            nbs = [n for n in self._links[layer].get(cur, []) if n in self._prepped]
            if not nbs:
                break
            d = self._dists(q, nbs)
            i = int(np.argmin(d))
            if float(d[i]) < cur_d:
                cur, cur_d = nbs[i], float(d[i])
                improved = True
        return cur

    def _search_layer(
        self, q: np.ndarray, entry_points: list[int], layer: int, ef: int
    ) -> list[tuple[float, int]]:
        """Beam search; returns [(dist, key)] of up to ef nearest (live or
        tombstoned — callers filter)."""
        visited = set(entry_points)
        d0 = self._dists(q, entry_points)
        cand: list[tuple[float, int]] = [
            (float(d), k) for d, k in zip(d0, entry_points)
        ]
        heapq.heapify(cand)
        best: list[tuple[float, int]] = [(-c[0], c[1]) for c in cand]
        heapq.heapify(best)  # max-heap via negation
        while cand:
            d, k = heapq.heappop(cand)
            if best and d > -best[0][0] and len(best) >= ef:
                break
            nbs = [
                n
                for n in dict.fromkeys(self._links[layer].get(k, ()))
                if n not in visited and n in self._prepped
            ]
            if not nbs:
                continue
            visited.update(nbs)
            dists = self._dists(q, nbs)
            worst = -best[0][0] if best else float("inf")
            for dist, n in zip(dists, nbs):
                dist = float(dist)
                if len(best) < ef or dist < worst:
                    heapq.heappush(cand, (dist, n))
                    heapq.heappush(best, (-dist, n))
                    if len(best) > ef:
                        heapq.heappop(best)
                    worst = -best[0][0]
        return sorted((-nd, k) for (nd, k) in best)

    def search(
        self,
        query,
        k: int | None,
        filter_query=None,
        ef: int | None = None,
    ) -> list[tuple[int, float]]:
        from pathway_tpu_torch.stdlib.indexing.filters import metadata_matches

        if k is None:
            k = 3
        if not self._live_entry():
            self._entry = self._pick_entry()
        if self._entry is None:
            return []
        q = self._prep(np.asarray(query, dtype=np.float32).reshape(-1))
        ef = max(ef or self.ef_search, k)
        ep = self._entry
        for layer in range(self._levels[self._entry], 0, -1):
            ep = self._greedy(q, ep, layer)
        found = self._search_layer(q, [ep], 0, ef)
        out: list[tuple[int, float]] = []
        for dist, key in found:
            if key in self._deleted:
                continue
            if filter_query is not None and not metadata_matches(
                filter_query, self._filters.get(key)
            ):
                continue
            out.append((key, self._score(dist)))
            if len(out) >= k:
                break
        return out
