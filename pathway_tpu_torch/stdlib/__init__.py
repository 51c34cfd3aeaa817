"""Standard library of the PyTorch port."""
