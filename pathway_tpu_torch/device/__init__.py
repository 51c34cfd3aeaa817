"""Device selection and dispatch for the PyTorch port.

Every entry point of the port runs on the first CUDA device unless the
caller names another device.  Without a card and without an explicit
device it raises: the port never carries on silently on the CPU, where
its kernels have only their plain versions.

``DeviceExecutor`` (``executor.py``) is the one dispatch path: bucketing,
the cache-key ledger, async ``submit`` with a bounded in-flight budget,
cost accounting (``telemetry.py``) and the typed failure rail
(``resilience.py``).  :func:`get_default_executor` gives the process-wide
executor of a device, which every stock caller shares.  The JAX package
has one default executor; the port has one per ``torch.device``, because
an executor copies its batches onto its own device.
"""

from __future__ import annotations

import threading
from typing import Any

import torch

from pathway_tpu_torch.device.bucketing import (
    BatchChunk,
    BucketPolicy,
    next_pow2,
    pad_batch_dim,
    replay_waste,
    stack_rows,
    suggest_buckets,
)
from pathway_tpu_torch.device.executor import DeviceExecutor, DeviceFuture
from pathway_tpu_torch.device.resilience import (
    CircuitBreaker,
    DeviceCompileError,
    DeviceDispatchHangError,
    DeviceJobError,
    DeviceOOMError,
    DeviceQuarantinedError,
    ExecutorClosedError,
    RetryPolicy,
    TransientDeviceError,
)
from pathway_tpu_torch.device.telemetry import (
    CostAccountant,
    TraceBusy,
    TraceUnavailable,
    capture_trace,
    render_device_snapshot,
)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` gives ``cuda:0`` (or raises when no card is visible);
    anything else is taken as the caller's explicit choice."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the host"
        )
    return torch.device("cuda", 0)


_defaults: dict[torch.device, DeviceExecutor] = {}
_default_lock = threading.Lock()


def _canonical(device: str | torch.device | None) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def get_default_executor(device: str | torch.device | None = None) -> DeviceExecutor:
    """The process-wide executor of ``device`` (resolved as
    :func:`resolve_device` resolves it, so ``None`` raises without a
    card), which every stock caller on that device shares: one queue, one
    budget, one ``backlog.device.*`` story."""
    dev = _canonical(device)
    ex = _defaults.get(dev)
    if ex is None:
        with _default_lock:
            ex = _defaults.get(dev)
            if ex is None:
                ex = DeviceExecutor(dev, collector_name=f"device.executor:{dev}")
                _defaults[dev] = ex
    return ex


def default_executor_snapshot() -> dict[str, Any] | None:
    """``{device: DeviceExecutor.device_snapshot()}`` of every default
    executor made so far, without making one: ``None`` when the process
    never touched the device path."""
    if not _defaults:
        return None
    return {str(dev): ex.device_snapshot() for dev, ex in sorted(_defaults.items(), key=lambda kv: str(kv[0]))}


__all__ = [
    "stack_rows",
    "BatchChunk",
    "BucketPolicy",
    "CircuitBreaker",
    "CostAccountant",
    "DeviceCompileError",
    "DeviceDispatchHangError",
    "DeviceExecutor",
    "DeviceFuture",
    "DeviceJobError",
    "DeviceOOMError",
    "DeviceQuarantinedError",
    "ExecutorClosedError",
    "RetryPolicy",
    "TraceBusy",
    "TraceUnavailable",
    "TransientDeviceError",
    "capture_trace",
    "default_executor_snapshot",
    "get_default_executor",
    "next_pow2",
    "pad_batch_dim",
    "render_device_snapshot",
    "replay_waste",
    "resolve_device",
    "suggest_buckets",
]
