"""dataset_tools of the PyTorch port: render-path pose creators."""
