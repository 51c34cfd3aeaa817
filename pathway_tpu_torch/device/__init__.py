"""Device selection and batch dispatch for the PyTorch port.

Every entry point of the port runs on the first CUDA device unless the
caller names another device.  Without a card and without an explicit
device it raises: the port never carries on silently on the CPU, where
its kernels have only their plain versions.
"""

from __future__ import annotations

import torch

from pathway_tpu_torch.device.bucketing import BucketPolicy, next_pow2
from pathway_tpu_torch.device.executor import DeviceExecutor


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


__all__ = ["BucketPolicy", "DeviceExecutor", "next_pow2", "resolve_device"]
