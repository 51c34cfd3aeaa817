"""Host engine pieces of the PyTorch port (the serving edge's errors and deadlines)."""
