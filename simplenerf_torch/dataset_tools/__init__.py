"""dataset_tools of the PyTorch port: split creators, render-path pose creators, extractors."""
