"""training of the PyTorch port (see the package docstring)."""
