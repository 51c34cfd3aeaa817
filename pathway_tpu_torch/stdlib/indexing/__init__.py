"""Indexes of the PyTorch port."""
