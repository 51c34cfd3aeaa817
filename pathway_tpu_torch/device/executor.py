"""Slim batch dispatcher: the port's counterpart of
``pathway_tpu/device/executor.py::DeviceExecutor.register/run_batch``.

A callable is registered once under a name with its bucket policy;
``run_batch`` plans a ragged numpy batch into fixed-shape chunks, pads
each chunk's batch axis, runs the callable on the executor's device under
``torch.inference_mode()``, slices the padding off and concatenates the
chunks back into numpy arrays.  Each registered callable counts its
dispatches (one per chunk).  ``warmup`` runs each bucket once before
traffic.

Resilience (retry, breaker, host fallback, OOM ratchet), telemetry and
futures wait for a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from pathway_tpu_torch.device.bucketing import BucketPolicy, pad_batch_dim


@dataclasses.dataclass
class _Entry:
    fn: Callable
    policy: BucketPolicy
    dispatches: int = 0


class DeviceExecutor:
    """Runs registered callables on one device over bucketed batches."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._callables: dict[str, _Entry] = {}

    def register(
        self, name: str, fn: Callable, *, policy: BucketPolicy | None = None
    ) -> str:
        """Register ``fn`` under ``name``; it is called as
        ``fn(*operands, *arrays, **static)`` with the arrays as tensors on
        the executor's device, batch axis padded to a bucket.
        Re-registering a name replaces the callable."""
        self._callables[name] = _Entry(fn, policy or BucketPolicy())
        return name

    def dispatches(self, name: str) -> int:
        """How many fixed-shape chunks ``name`` has run."""
        return self._callables[name].dispatches

    def warmup(
        self,
        name: str,
        row_shapes: Sequence[tuple[int, ...]],
        dtypes: Sequence[Any],
        *,
        buckets: Sequence[int] | None = None,
    ) -> int:
        """Run ``name`` once on all-zero arrays at every bucket of its policy
        (or at ``buckets``), before traffic; ``row_shapes`` and ``dtypes``
        describe one row of each array.  Returns how many buckets ran; they
        are not counted as dispatches."""
        entry = self._callables[name]
        buckets = entry.policy.buckets() if buckets is None else buckets
        for bucket in buckets:
            tensors = [
                torch.from_numpy(np.zeros((bucket, *shape), dtype)).to(self.device)
                for shape, dtype in zip(row_shapes, dtypes)
            ]
            with torch.inference_mode():
                entry.fn(*tensors)
        return len(buckets)

    def run_batch(
        self,
        name: str,
        arrays: Sequence[np.ndarray],
        *,
        operands: Sequence[Any] = (),
        static: dict[str, Any] | None = None,
    ) -> Any:
        """Run a ragged batch (``arrays`` share a leading batch axis)
        through the registered callable; returns its output (an array or a
        tuple of arrays, each leading with the batch axis) as numpy with
        the padding sliced off."""
        entry = self._callables[name]
        arrays = tuple(np.asarray(a) for a in arrays)
        n_rows = arrays[0].shape[0]
        if n_rows == 0:
            raise ValueError("cannot dispatch an empty batch")
        for a in arrays:
            if a.shape[0] != n_rows:
                raise ValueError(
                    f"batch arrays disagree on row count: {a.shape[0]} != {n_rows}"
                )
        static = static or {}
        outs = []
        for chunk in entry.policy.plan(n_rows):
            rows = (
                pad_batch_dim(a[chunk.start : chunk.start + chunk.count], chunk.bucket)[0]
                for a in arrays
            )
            tensors = [torch.from_numpy(np.ascontiguousarray(r)).to(self.device) for r in rows]
            with torch.inference_mode():
                out = entry.fn(*operands, *tensors, **static)
            entry.dispatches += 1
            outs.append(_slice_rows(out, chunk.count))
        if len(outs) == 1:
            return outs[0]
        return _concat_rows(outs)


def _slice_rows(out: Any, count: int) -> Any:
    if isinstance(out, (tuple, list)):
        return tuple(o[:count].cpu().numpy() for o in out)
    return out[:count].cpu().numpy()


def _concat_rows(chunks: list[Any]) -> Any:
    first = chunks[0]
    if isinstance(first, tuple):
        return tuple(
            np.concatenate([c[i] for c in chunks], axis=0)
            for i in range(len(first))
        )
    return np.concatenate(chunks, axis=0)
