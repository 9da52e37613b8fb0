"""Runnable examples of the port (the counterparts of the repository's
``examples/``): ``python -m monotonic_rnnt_tpu_torch.examples.<name>``."""
