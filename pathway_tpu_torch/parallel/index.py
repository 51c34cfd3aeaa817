"""Corpus-sharded device index: distributed exact top-k over the mesh.

Counterpart of ``pathway_tpu/parallel/index.py``.  The document embedding
matrix is sharded row-wise over every rank of the mesh (each rank's slice
is the analog of one worker's key-shard), queries are replicated, and
retrieval is

    local score matmul → local top-k → all_gather of k candidates/rank →
    final top-k

so the payload crossing the interconnect is ``n_ranks × k`` (id, score)
pairs per query; vectors never leave their card.  The JAX package wrote
this as a ``shard_map``; here each rank runs the same body eagerly and the
gather is one ``torch.distributed`` collective over the flattened mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from pathway_tpu_torch.ops.topk import padded_rows, score_block
from pathway_tpu_torch.parallel.mesh import flat_rank, mesh_device


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _flat_group(mesh: DeviceMesh):
    """The process group of every rank of the mesh."""
    if mesh.ndim == 1:
        return mesh.get_group(0)
    if mesh.size() != dist.get_world_size():
        raise ValueError("a mesh of several dims must cover the process group's world")
    return dist.group.WORLD


def _all_gather(t, group, n: int) -> list:
    """Every rank's ``t``, by group rank: one ``all_gather_into_tensor`` on
    NCCL, ``all_gather`` on gloo."""
    t = t.contiguous()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return list(out.unbind(0))
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return parts


def sharded_topk(mesh: DeviceMesh, docs, mask, queries, k: int, metric: str = "ip"):
    """(indices, scores) of the k best doc rows per query, across all ranks.

    ``docs`` ``[rows, d]`` and ``mask`` ``[rows]`` are this rank's slice of
    the padded index (or ``DTensor``\\s sharded so); ``queries`` is the same
    ``[Q, d]`` on every rank.  Each rank keeps ``min(k, rows)`` candidates
    with global ids; every rank returns the same merged answer."""
    docs, mask = _local(docs), _local(mask)
    rows = docs.shape[0]
    queries = torch.as_tensor(queries, dtype=torch.float32, device=docs.device)
    # per-shard candidate count: k capped at the shard's row count; the
    # merge then sees n_ranks * k_local >= k candidates (callers cap k at n)
    k_local = min(k, rows)
    vals, idx = torch.topk(score_block(docs, queries, metric) + mask[None, :], k_local, dim=-1)
    idx = idx + flat_rank(mesh) * rows
    group = _flat_group(mesh)
    n = mesh.size()
    vals_parts = _all_gather(vals, group, n)
    idx_parts = _all_gather(idx, group, n)
    # candidates in flat mesh order, major axis first, as JAX's gather
    order = [dist.get_group_rank(group, r) for r in mesh.mesh.flatten().tolist()]
    vals_g = torch.cat([vals_parts[i] for i in order], dim=1)
    idx_g = torch.cat([idx_parts[i] for i in order], dim=1)
    best, pos = torch.topk(vals_g, k, dim=-1)
    return torch.gather(idx_g, 1, pos), best


def shard_rows(mesh: DeviceMesh, matrix: np.ndarray, capacity: int, *, normalize: bool, dtype: torch.dtype):
    """The index ``matrix`` padded to ``capacity`` rows and its -inf padding
    mask, as ``DTensor``\\s sharded row-wise over the flattened mesh: this
    rank builds only its own slice, on its own device (the padding and
    normalisation of ``ops/topk.py::padded_rows``)."""
    n_ranks = mesh.size()
    rows = capacity // n_ranks
    docs, mask = padded_rows(
        matrix, flat_rank(mesh) * rows, rows, normalize=normalize, dtype=dtype, device=mesh_device(mesh)
    )
    shard = (Shard(0),) * mesh.ndim
    d = matrix.shape[1]
    return (
        DTensor.from_local(docs, mesh, shard, run_check=False, shape=(capacity, d), stride=(d, 1)),
        DTensor.from_local(mask, mesh, shard, run_check=False, shape=(capacity,), stride=(1,)),
    )


class ShardedDeviceIndex:
    """A padded, corpus-sharded embedding index resident across the cards.

    Capacity grows in multiples of ``n_ranks × block`` so every rank holds
    an equal slice.  Padded rows carry a ``-inf`` score mask.  Cosine
    similarity assumes rows are L2-normalized (the encoders guarantee
    this); queries score a plain inner product.  ``dtype`` sets the
    storage (``torch.bfloat16`` halves the bytes a query sweeps);
    ``score_block`` casts to the matmul dtype of the device."""

    def __init__(self, mesh: DeviceMesh, dim: int, block: int = 1024, dtype: torch.dtype | None = None):
        self.mesh = mesh
        self.dim = dim
        self.n_chips = mesh.size()
        self.block = block
        self.dtype = torch.float32 if dtype is None else dtype
        self._n = 0
        self._docs = None
        self._mask = None
        self._host_rows: list[np.ndarray] = []
        self._dirty = False

    def __len__(self) -> int:
        return self._n

    def add(self, vectors: np.ndarray) -> None:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        self._host_rows.append(vectors)
        self._n += vectors.shape[0]
        self._dirty = True

    def _capacity(self, n: int) -> int:
        unit = self.n_chips * self.block
        return max(unit, ((n + unit - 1) // unit) * unit)

    def _sync(self) -> None:
        if not self._dirty:
            return
        full = (
            np.concatenate(self._host_rows, axis=0)
            if self._host_rows
            else np.zeros((0, self.dim), np.float32)
        )
        self._docs = self._mask = None  # let the old slice go before the new one lands
        self._docs, self._mask = shard_rows(
            self.mesh, full, self._capacity(self._n), normalize=False, dtype=self.dtype
        )
        self._dirty = False

    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self._n == 0:
            return np.zeros((q.shape[0], 0), np.int64), np.zeros((q.shape[0], 0), np.float32)
        self._sync()
        with torch.no_grad():
            idx, vals = sharded_topk(self.mesh, self._docs, self._mask, q, min(k, self._n))
        return idx.cpu().numpy(), vals.cpu().numpy()
