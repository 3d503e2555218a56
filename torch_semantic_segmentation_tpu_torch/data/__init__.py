"""Data transforms of the PyTorch port."""
