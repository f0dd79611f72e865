"""Prior generators of the PyTorch port (COLMAP sparse depth)."""
