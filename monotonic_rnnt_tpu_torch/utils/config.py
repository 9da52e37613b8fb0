"""Runtime configuration flags.

PyTorch counterpart of ``monotonic_rnnt_tpu/utils/config.py``. Only the
loss backend has a counterpart so far; the JAX package's ``pipeline`` and
``interpret`` flags wait for the split route's port.
"""

from __future__ import annotations

import dataclasses
import os
from contextlib import contextmanager


@dataclasses.dataclass
class Config:
    """Global runtime options.

    backend: 'auto' | 'cuda' | 'reference'. 'auto' runs the hand-written
      CUDA kernels on CUDA tensors and the plain-torch oracle on CPU
      tensors; 'cuda' insists on the kernels (the JAX package's 'pallas');
      'reference' forces the oracle on any device.
    """

    backend: str = os.environ.get("MRNNT_BACKEND", "auto")


_config = Config()


def get_config() -> Config:
    return _config


def update_config(**kwargs) -> Config:
    for key, value in kwargs.items():
        if not hasattr(_config, key):
            raise AttributeError(f"unknown config field: {key}")
        setattr(_config, key, value)
    return _config


@contextmanager
def config_override(**kwargs):
    """Temporarily override config fields (test / debug scoping)."""
    saved = {k: getattr(_config, k) for k in kwargs}
    update_config(**kwargs)
    try:
        yield _config
    finally:
        update_config(**saved)
