"""Bucketing planner: ragged batches → fixed-shape device batches.

Counterpart of ``pathway_tpu/device/bucketing.py`` (copied, not imported:
the port imports nothing of the JAX package).  PyTorch runs eagerly and
compiles nothing per shape, but the bucket set still bounds the shapes
the kernels see, keeps padded rows out of real rows' outputs (all-zero
rows with a zero attention mask), and keeps the port's batching identical
to the JAX package's so the two can be compared row for row.

``plan(cap=...)``, ``next_smaller`` and ``floor_bucket`` serve the
executor's OOM ratchet: a chunk that runs out of device memory drops one
bucket, and later batches plan under the ratcheted cap.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

DEFAULT_MAX_BUCKET = 512


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass(frozen=True)
class BatchChunk:
    """One fixed-shape chunk of a planned ragged batch."""

    start: int  # first row of the chunk in the submitted batch
    count: int  # real rows in the chunk
    bucket: int  # padded batch size, count <= bucket


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Rounds ragged row counts up to declared buckets: powers of two
    between ``min_bucket`` and ``max_bucket``, or an explicit ``sizes``
    set."""

    min_bucket: int = 1
    max_bucket: int = DEFAULT_MAX_BUCKET
    sizes: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.sizes is not None:
            ordered = tuple(sorted(set(int(s) for s in self.sizes)))
            if not ordered or ordered[0] < 1:
                raise ValueError("sizes must be a non-empty set of ints >= 1")
            object.__setattr__(self, "sizes", ordered)
            object.__setattr__(self, "min_bucket", ordered[0])
            object.__setattr__(self, "max_bucket", ordered[-1])
            return
        if self.min_bucket < 1:
            raise ValueError("min_bucket must be >= 1")
        if self.max_bucket < self.min_bucket:
            raise ValueError("max_bucket must be >= min_bucket")

    def bucket_for(self, n: int) -> int:
        """The padded batch size for ``n`` rows (n <= max_bucket)."""
        if n < 1:
            raise ValueError("cannot bucket an empty batch")
        if n > self.max_bucket:
            raise ValueError(
                f"batch of {n} exceeds the largest bucket "
                f"{self.max_bucket}; plan() splits it first"
            )
        if self.sizes is not None:
            return next(b for b in self.sizes if b >= n)
        return min(max(next_pow2(n), self.min_bucket), self.max_bucket)

    def buckets(self) -> tuple[int, ...]:
        """Every bucket this policy can emit, ascending."""
        if self.sizes is not None:
            return self.sizes
        out = []
        b = self.min_bucket
        if b & (b - 1):
            b = next_pow2(b)
        while b < self.max_bucket:
            out.append(b)
            b <<= 1
        out.append(self.max_bucket)
        return tuple(out)

    def next_smaller(self, bucket: int) -> int | None:
        """The declared bucket just below ``bucket``, or ``None`` when it
        is the smallest: the OOM ratchet's step."""
        below = [b for b in self.buckets() if b < bucket]
        return below[-1] if below else None

    def floor_bucket(self, cap: int) -> int:
        """The largest declared bucket <= ``cap`` (the smallest declared
        bucket when none fits), so capped planning emits declared shapes."""
        declared = self.buckets()
        fitting = [b for b in declared if b <= cap]
        return fitting[-1] if fitting else declared[0]

    def plan(self, n: int, *, cap: int | None = None) -> list[BatchChunk]:
        """Split ``n`` rows into fixed-shape chunks: full largest-bucket
        chunks first, then one bucketed remainder.  ``cap`` (the
        callable's OOM ratchet) bounds the largest chunk below
        ``max_bucket``."""
        if n < 1:
            raise ValueError("cannot plan an empty batch")
        largest = self.max_bucket
        if cap is not None:
            largest = self.floor_bucket(min(cap, self.max_bucket))
        chunks: list[BatchChunk] = []
        start = 0
        while n - start > largest:
            chunks.append(BatchChunk(start, largest, largest))
            start += largest
        rest = n - start
        chunks.append(BatchChunk(start, rest, self.bucket_for(rest)))
        return chunks


def pad_batch_dim(
    array: np.ndarray, bucket: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pad ``array``'s leading (batch) axis with zero rows up to
    ``bucket``; returns ``(padded, mask)`` with ``mask[i] = 1.0`` for
    real rows.  A no-copy passthrough when already exactly bucket-sized."""
    n = array.shape[0]
    if n > bucket:
        raise ValueError(f"batch of {n} does not fit bucket {bucket}")
    mask = np.zeros((bucket,), dtype=np.float32)
    mask[:n] = 1.0
    if n == bucket:
        return array, mask
    padded = np.zeros((bucket,) + array.shape[1:], dtype=array.dtype)
    padded[:n] = array
    return padded, mask


def replay_waste(
    size_counts: dict[int, int], buckets: Sequence[int]
) -> tuple[int, int]:
    """Replay an observed batch-size distribution against a bucket set.

    Returns ``(pad_rows, real_rows)``: how many padding rows the set
    would add over how many real rows, using the executor's planning
    semantics — batches above the largest bucket split into full
    largest-bucket chunks (zero waste) plus one bucketed remainder.
    The analysis behind ``device.padding.waste.fraction`` and the
    ``python -m pathway_tpu_torch buckets`` suggestion report."""
    if not buckets:
        raise ValueError("cannot replay against an empty bucket set")
    ordered = sorted(set(int(b) for b in buckets))
    if ordered[0] < 1:
        raise ValueError("buckets must be >= 1")
    largest = ordered[-1]
    pad = 0
    real = 0
    for size, count in size_counts.items():
        size, count = int(size), int(count)
        if size < 1 or count < 1:
            continue
        real += size * count
        rest = size % largest if size > largest else size
        if rest == 0:
            continue  # exact multiples of the largest bucket: no waste
        bucket = next((b for b in ordered if b >= rest), largest)
        pad += (bucket - rest) * count
    return pad, real


def suggest_buckets(
    size_counts: dict[int, int], *, max_buckets: int = 8
) -> tuple[int, ...]:
    """The bucket set of at most ``max_buckets`` sizes minimizing padded
    rows over an observed batch-size distribution.

    Exact dynamic program over the distinct observed sizes (an optimal
    bucket boundary always sits on an observed size): ``cost(i..j)`` is
    the padding added by covering sizes ``i..j`` with one bucket at size
    ``j``.  Distinct sizes are bounded by the accountant's cap
    (``device/telemetry.py``), so the O(S²·K) DP stays trivial.  The
    largest observed size is always a bucket (larger batches split
    against it at zero marginal waste, matching :meth:`BucketPolicy.plan`
    semantics).  Each extra bucket is one more compile per callable —
    the suggestion trades padding against compile count, and the CLI
    reports both sides."""
    sizes = sorted(
        int(s) for s, c in size_counts.items() if int(s) >= 1 and int(c) >= 1
    )
    if not sizes:
        raise ValueError("cannot suggest buckets for an empty distribution")
    counts = [int(size_counts[s]) for s in sizes]
    m = len(sizes)
    k_max = max(1, min(int(max_buckets), m))
    # cost[i][j]: padding rows when sizes[i..j] all round up to sizes[j]
    prefix_rows = [0]
    prefix_count = [0]
    for s, c in zip(sizes, counts):
        prefix_rows.append(prefix_rows[-1] + s * c)
        prefix_count.append(prefix_count[-1] + c)

    def cost(i: int, j: int) -> int:
        n = prefix_count[j + 1] - prefix_count[i]
        rows = prefix_rows[j + 1] - prefix_rows[i]
        return sizes[j] * n - rows

    INF = float("inf")
    # dp[k][j]: min padding covering sizes[0..j] with k buckets, the last
    # at sizes[j]; choice[k][j] remembers the split for reconstruction
    dp = [[INF] * m for _ in range(k_max + 1)]
    choice = [[-1] * m for _ in range(k_max + 1)]
    for j in range(m):
        dp[1][j] = cost(0, j)
    for k in range(2, k_max + 1):
        for j in range(k - 1, m):
            for i in range(k - 2, j):
                c = dp[k - 1][i] + cost(i + 1, j)
                if c < dp[k][j]:
                    dp[k][j] = c
                    choice[k][j] = i
    # fewer buckets can tie; prefer the smallest set that reaches the
    # optimum (every bucket is a compile)
    best_k = min(
        range(1, k_max + 1), key=lambda k: (dp[k][m - 1], k)
    )
    buckets = []
    j, k = m - 1, best_k
    while k >= 1:
        buckets.append(sizes[j])
        j = choice[k][j]
        k -= 1
    return tuple(sorted(buckets))


def stack_rows(rows: Sequence[np.ndarray]) -> tuple[np.ndarray, int]:
    """Stack per-row arrays into one ``[n, ...]`` batch, refusing mixes.

    Returns ``(batch, n_rows)``.  Raises :class:`ValueError` when rows
    disagree on dtype or trailing shape — the dtype-mix refusal the
    bucketing contract promises (a mixed batch would silently upcast or
    corrupt; the caller must split by dtype before submitting)."""
    if not rows:
        raise ValueError("cannot stack an empty row list")
    first = np.asarray(rows[0])
    arrays = [first]
    for i, row in enumerate(rows[1:], start=1):
        arr = np.asarray(row)
        if arr.dtype != first.dtype:
            raise ValueError(
                f"dtype mix in one device batch: row 0 is {first.dtype}, "
                f"row {i} is {arr.dtype} — split the batch by dtype"
            )
        if arr.shape != first.shape:
            raise ValueError(
                f"shape mix in one device batch: row 0 is {first.shape}, "
                f"row {i} is {arr.shape} — pad rows to one shape first"
            )
        arrays.append(arr)
    return np.stack(arrays), len(arrays)
