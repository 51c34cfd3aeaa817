"""Host-side helpers of the PyTorch port (the micro-batching front end)."""

from pathway_tpu_torch.utils.batching import AsyncMicroBatcher

__all__ = ["AsyncMicroBatcher"]
