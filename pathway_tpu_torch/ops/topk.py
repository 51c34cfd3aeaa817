"""Dense similarity scoring and top-k over a device-resident index.

Counterpart of ``pathway_tpu/ops/topk.py``: the index matrix lives on the
device, padded to a power-of-two capacity with a -inf mask on the padding
rows; the query batch is scored in one matmul and reduced with an exact
top-k.  Below :data:`MIN_DEVICE_ROWS` rows the host numpy path answers, as
in the JAX package, because a device round trip costs more than the scan.

Every op here is a plain PyTorch composition (the JAX module had no Pallas
kernel either).  With a ``mesh`` the index is sharded row-wise over its
ranks and answered by ``parallel/index.py::sharded_topk``.
"""

from __future__ import annotations

import numpy as np
import torch

from pathway_tpu_torch.device import get_default_executor, next_pow2, resolve_device

MIN_DEVICE_ROWS = 256  # below this, host numpy beats a device round trip

_TOPK_CALLABLE = "indexing:masked_topk"


def score_block(matrix, queries, metric: str):
    """Similarity scores ``[n_queries, n_rows]``, larger = closer.

    cos and ip run the matmul in bf16 on the card (tensor-core native) and
    in f32 on the CPU, where bf16 is emulated; l2sq always stays f32
    (catastrophic cancellation in bf16)."""
    mm_dtype = torch.float32 if matrix.device.type == "cpu" else torch.bfloat16
    m = matrix.to(mm_dtype)
    q = queries.to(mm_dtype)
    if metric == "cos":
        mn = m / (torch.linalg.norm(m, dim=1, keepdim=True).to(mm_dtype) + 1e-6)
        qn = q / (torch.linalg.norm(q, dim=1, keepdim=True).to(mm_dtype) + 1e-6)
        return (qn @ mn.T).float()
    if metric == "ip":
        return (q @ m.T).float()
    # l2sq: the negative squared distance, so that larger = closer
    m32 = matrix.float()
    q32 = queries.float()
    sq_m = torch.sum(m32 * m32, dim=1)[None, :]
    sq_q = torch.sum(q32 * q32, dim=1)[:, None]
    return -(sq_q + sq_m - 2.0 * (q32 @ m32.T))


def exact_topk(scores, k: int):
    """Exact top-k along the last axis: ``(values, indices)``, best first.

    ``torch.topk`` is exact at any row length.  The JAX package split long
    rows into a blockwise two-stage top-k only because ``lax.top_k`` over a
    long row was a full sort on the TPU; the port needs no such split."""
    return torch.topk(scores, k, dim=-1)


def masked_topk_block(matrix, mask, queries, *, metric: str, k: int):
    """Masked top-k of one padded query batch against the padded index."""
    scores = score_block(matrix, queries, metric)
    return exact_topk(scores + mask[None, :], k)


def _topk_executor(device):
    """The device's default executor with the masked top-k registered once
    (``metric`` and ``k`` ride as static keyword arguments)."""
    ex = get_default_executor(device)
    if not ex.registered(_TOPK_CALLABLE):
        ex.register(_TOPK_CALLABLE, masked_topk_block)
    return ex


def padded_rows(matrix: np.ndarray, start: int, rows: int, *, normalize: bool, dtype: torch.dtype, device):
    """Rows ``[start, start + rows)`` of the index padded with zero rows past
    its end, on ``device``, and their mask (0, or -inf on padding).  With
    ``normalize`` (cos) the real rows are L2-normalised in f32, once, so a
    query runs a plain inner product; then the rows are cast to ``dtype``."""
    valid = max(0, min(matrix.shape[0] - start, rows))
    padded = torch.zeros((rows, matrix.shape[1]), dtype=torch.float32, device=device)
    padded[:valid] = torch.from_numpy(np.ascontiguousarray(matrix[start : start + valid], np.float32)).to(device)
    if normalize:
        norms = torch.linalg.norm(padded[:valid], dim=1, keepdim=True)
        padded[:valid] /= torch.clamp(norms, min=1e-12)
    mask = torch.full((rows,), -torch.inf, dtype=torch.float32, device=device)
    mask[:valid] = 0.0
    return padded.to(dtype), mask


class DeviceIndexCache:
    """Keeps the padded index matrix (and its padding mask) resident on the
    device across queries.

    Rebuilds (re-pads, re-uploads) only when the index changed; the capacity
    grows in power-of-two steps.  Padded rows carry a -inf mask so they never
    win top-k.  For cos the rows are normalised once here, so a query runs a
    plain inner product; for cos and ip the matrix is stored in bf16 on the
    card, halving the bytes each query sweeps.

    With a ``mesh`` (``parallel/mesh.py::make_mesh``) the capacity is
    rounded up to a multiple of the rank count, each rank keeps its row
    slice on its own device (``DTensor`` shards over the flattened
    mesh), and queries run through ``sharded_topk``, not the executor."""

    def __init__(self, device=None, mesh=None):
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            self.executor = _topk_executor(self.device)
        else:
            from pathway_tpu_torch.parallel.mesh import mesh_device

            self.device = mesh_device(mesh)
            if device is not None and torch.device(device).type != self.device.type:
                raise ValueError(f"device {device} is not the mesh's {self.device}")
            self.executor = None
        self._version = -1
        self._metric = None
        self._padded = None
        self._mask = None
        self._n = 0

    def get(self, matrix: np.ndarray, version: int, metric: str = "raw"):
        n = matrix.shape[0]
        cap = next_pow2(max(n, MIN_DEVICE_ROWS))
        ranks = 1 if self.mesh is None else self.mesh.size()
        if cap % ranks:  # non-power-of-two meshes: equal slices per rank
            cap = ((cap + ranks - 1) // ranks) * ranks
        if (
            self._padded is None
            or version != self._version
            or metric != self._metric
            or self._padded.shape[0] != cap
            or self._padded.shape[1] != matrix.shape[1]
        ):
            self._padded = self._mask = None  # let the old matrix go before the new one lands
            dtype = torch.bfloat16 if metric in ("cos", "ip") and self.device.type != "cpu" else torch.float32
            if self.mesh is None:
                self._padded, self._mask = padded_rows(
                    matrix, 0, cap, normalize=metric == "cos", dtype=dtype, device=self.device
                )
            else:
                from pathway_tpu_torch.parallel.index import shard_rows

                self._padded, self._mask = shard_rows(
                    self.mesh, matrix, cap, normalize=metric == "cos", dtype=dtype
                )
            self._version = version
            self._metric = metric
            self._n = n
        return self._padded, self._mask, self._n


def topk_search_cached(
    matrix: np.ndarray,
    queries: np.ndarray,
    k: int,
    metric: str,
    *,
    cache: DeviceIndexCache,
    version: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k against a device-resident padded index (warm across queries);
    returns ``(indices, scores)`` as numpy."""
    n = matrix.shape[0]
    k_eff = min(k, n)
    if n < MIN_DEVICE_ROWS and cache.mesh is None:
        scores = _score_numpy(
            matrix.astype(np.float32), queries.astype(np.float32), metric
        )
        idx = np.argsort(-scores, kind="stable", axis=1)[:, :k_eff]
        return idx, np.take_along_axis(scores, idx, axis=1)
    device_matrix, mask, _n = cache.get(matrix, version, metric)
    q = queries.astype(np.float32)
    kernel_metric = metric
    if metric == "cos":
        # the cached matrix is pre-normalised; normalise the (small) query
        # batch on the host and score a plain inner product
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        kernel_metric = "ip"
    if cache.mesh is not None:
        # a sharded index answers at any size (the JAX package's routing)
        from pathway_tpu_torch.parallel.index import sharded_topk

        with torch.no_grad():
            idx, vals = sharded_topk(cache.mesh, device_matrix, mask, q, k_eff, kernel_metric)
        return idx.cpu().numpy(), vals.cpu().numpy()
    vals, idx = cache.executor.run_batch(
        _TOPK_CALLABLE,
        (q.astype(np.float32, copy=False),),
        operands=(device_matrix, mask),
        static={"metric": kernel_metric, "k": k_eff},
    )
    return idx, vals


def _score_numpy(matrix: np.ndarray, queries: np.ndarray, metric: str) -> np.ndarray:
    if metric == "cos":
        mn = matrix / (np.linalg.norm(matrix, axis=1, keepdims=True) + 1e-12)
        qn = queries / (np.linalg.norm(queries, axis=1, keepdims=True) + 1e-12)
        return qn @ mn.T
    if metric == "ip":
        return queries @ matrix.T
    sq_m = np.sum(matrix * matrix, axis=1)[None, :]
    sq_q = np.sum(queries * queries, axis=1)[:, None]
    return -(sq_q + sq_m - 2.0 * (queries @ matrix.T))


def score_batch(
    matrix: np.ndarray, queries: np.ndarray, metric: str = "cos", *, device=None
) -> np.ndarray:
    """Scores [n_queries, n_docs]; larger = closer for every metric."""
    device = resolve_device(device)
    if matrix.ndim != 2:
        matrix = np.atleast_2d(matrix)
    if queries.ndim != 2:
        queries = np.atleast_2d(queries)
    if matrix.shape[0] < MIN_DEVICE_ROWS:
        return _score_numpy(
            matrix.astype(np.float32), queries.astype(np.float32), metric
        )
    with torch.inference_mode():
        scores = score_block(_to(matrix, device), _to(queries, device), metric)
        return scores.cpu().numpy()


def topk_search(
    matrix: np.ndarray, queries: np.ndarray, k: int, metric: str = "cos", *, device=None
) -> tuple[np.ndarray, np.ndarray]:
    """(indices, scores) of the k best rows per query."""
    device = resolve_device(device)
    n = matrix.shape[0]
    k_eff = min(k, n)
    if n < MIN_DEVICE_ROWS:
        scores = _score_numpy(
            matrix.astype(np.float32), queries.astype(np.float32), metric
        )
        idx = np.argsort(-scores, axis=1)[:, :k_eff]
        return idx, np.take_along_axis(scores, idx, axis=1)
    with torch.inference_mode():
        scores = score_block(_to(matrix, device), _to(queries, device), metric)
        vals, idx = exact_topk(scores, k_eff)
        return idx.cpu().numpy(), vals.cpu().numpy()


def _to(array: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array, np.float32)).to(device)
