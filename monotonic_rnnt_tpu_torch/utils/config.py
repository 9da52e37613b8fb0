"""Runtime configuration flags.

PyTorch counterpart of ``monotonic_rnnt_tpu/utils/config.py``: the loss
backend and the pipeline. The JAX package's ``interpret`` flag has no
counterpart: the kernels' plain versions serve CPU tensors.
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
    pipeline: 'auto' | 'fused' | 'split', the orchestration of the padded
      loss on the 'cuda' backend. 'auto' takes the DP-fused kernels and the
      deferred-gradient route at every shape (the JAX package's VMEM gate
      has no counterpart); 'fused' is an alias of 'auto', the JAX
      package's name for that route. 'split' forces the split pipeline
      (softmax_stats, the scans, grad_pass), whose forward makes the
      gradient (the eager route); it is slower and serves as the JAX
      package's parity route. Neither route ever becomes the other. A value
      outside the three raises where it is set.
    """

    backend: str = os.environ.get("MRNNT_BACKEND", "auto")
    pipeline: str = os.environ.get("MRNNT_PIPELINE", "auto")

    def __post_init__(self):
        _check_pipeline(self.pipeline)


PIPELINES = ("auto", "fused", "split")


def _check_pipeline(value) -> None:
    if value not in PIPELINES:
        raise ValueError(f"pipeline must be one of {PIPELINES}, got "
                         f"{value!r}")


_config = Config()


def get_config() -> Config:
    return _config


def update_config(**kwargs) -> Config:
    for key, value in kwargs.items():
        if not hasattr(_config, key):
            raise AttributeError(f"unknown config field: {key}")
        if key == "pipeline":
            _check_pipeline(value)
    for key, value in kwargs.items():
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
