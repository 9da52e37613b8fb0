"""Synthetic data pipeline of the PyTorch port (numpy only)."""
