"""Parallel layers of the PyTorch port (the Mixtral mixture-of-experts FFN)."""
