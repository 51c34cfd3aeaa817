"""Runtime configuration of the PyTorch port."""
