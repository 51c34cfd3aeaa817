"""Host-side helpers of the PyTorch port (the micro-batching front end)."""
