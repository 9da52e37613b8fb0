"""Configuration and input validation for the PyTorch port."""
