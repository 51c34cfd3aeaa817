"""Serving paths of the PyTorch port (continuous-batching generation)."""
