"""Loss operators of the PyTorch port."""
