"""Serving paths of the PyTorch port (continuous-batching generation)."""

from pathway_tpu_torch.serving.generation import (
    GenerationScheduler,
    GenRequest,
    reset_shared_schedulers,
    shared_scheduler,
)

__all__ = [
    "GenerationScheduler",
    "GenRequest",
    "reset_shared_schedulers",
    "shared_scheduler",
]
