"""qa of the PyTorch port: the 14 metric families, visibility masks and the runner."""
