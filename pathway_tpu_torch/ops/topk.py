"""Dense similarity scoring and top-k over a device-resident index.

Counterpart of ``pathway_tpu/ops/topk.py``: the index matrix lives on the
device, padded to a power-of-two capacity with a -inf mask on the padding
rows; the query batch is scored in one matmul and reduced with an exact
top-k.  Below :data:`MIN_DEVICE_ROWS` rows the host numpy path answers, as
in the JAX package, because a device round trip costs more than the scan.

Every op here is a plain PyTorch composition (the JAX module had no Pallas
kernel either).  Sharded top-k over several cards (the JAX ``mesh``
branch) waits for the multi-GPU slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from pathway_tpu_torch.device import DeviceExecutor, next_pow2, resolve_device

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


class DeviceIndexCache:
    """Keeps the padded index matrix (and its padding mask) resident on the
    device across queries.

    Rebuilds (re-pads, re-uploads) only when the index changed; the capacity
    grows in power-of-two steps.  Padded rows carry a -inf mask so they never
    win top-k.  For cos the rows are normalised once here, so a query runs a
    plain inner product; for cos and ip the matrix is stored in bf16 on the
    card, halving the bytes each query sweeps."""

    def __init__(self, device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a sharded multi-card index is a later slice of the port"
            )
        self.device = resolve_device(device)
        self.executor = DeviceExecutor(self.device)
        self.executor.register(_TOPK_CALLABLE, masked_topk_block)
        self._version = -1
        self._metric = None
        self._padded = None
        self._mask = None
        self._n = 0

    def get(self, matrix: np.ndarray, version: int, metric: str = "raw"):
        n = matrix.shape[0]
        cap = next_pow2(max(n, MIN_DEVICE_ROWS))
        if (
            self._padded is None
            or version != self._version
            or metric != self._metric
            or self._padded.shape[0] != cap
            or self._padded.shape[1] != matrix.shape[1]
        ):
            self._padded = None  # let the old matrix go before the new one lands
            padded = torch.zeros((cap, matrix.shape[1]), dtype=torch.float32, device=self.device)
            padded[:n] = torch.from_numpy(np.ascontiguousarray(matrix, np.float32)).to(self.device)
            if metric == "cos":
                norms = torch.linalg.norm(padded[:n], dim=1, keepdim=True)
                padded[:n] /= torch.clamp(norms, min=1e-12)
            mask = torch.full((cap,), -torch.inf, dtype=torch.float32, device=self.device)
            mask[:n] = 0.0
            if metric in ("cos", "ip") and self.device.type != "cpu":
                padded = padded.to(torch.bfloat16)
            self._padded = padded
            self._mask = mask
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
    if n < MIN_DEVICE_ROWS:
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
