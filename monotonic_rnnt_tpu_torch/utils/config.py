"""Runtime configuration flags.

PyTorch counterpart of ``monotonic_rnnt_tpu/utils/config.py``: the loss
backend and the debug flags, each settable by the same environment
variable as in the JAX package or programmatically. The debug flags (the
reference's DEBUG_* printf macros) are read by utils/debug.py. The JAX
package's ``interpret`` flag has no counterpart: the kernels' plain
versions serve CPU tensors. Nor has its ``pipeline`` flag: the padded loss
has one CUDA route, the DP-fused kernels with the deferred gradient, at
every shape (the JAX package's VMEM gate has no counterpart).
"""

from __future__ import annotations

import dataclasses
import os
from contextlib import contextmanager


def _env_bool(name: str, default: bool) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val.lower() not in ("0", "false", "off", "")


@dataclasses.dataclass
class Config:
    """Global runtime options.

    backend: 'auto' | 'cuda' | 'reference'. 'auto' runs the hand-written
      CUDA kernels on CUDA tensors and the plain-torch oracle on CPU
      tensors; 'cuda' insists on the kernels (the JAX package's 'pallas');
      'reference' forces the oracle on any device.
    debug_time: wall-clock each public loss call (reference DEBUG_TIME),
      after the card has finished its work; not inside an exported graph.
    debug_fwdbwd / debug_grads: per-call log-likelihood prints and gradient
      summaries (reference DEBUG_FWDBWD / DEBUG_GRADS).
    debug_space: one line per loss call naming the pipeline and the
      big-tensor traffic it is committed to (reference DEBUG_SPACE
      workspace reports, cpu_workspace_manager.h:110-112).
    check_fwd_bwd: warn when |ll_fwd - ll_bwd| > fwd_bwd_tol, the
      reference's only runtime self-check (cpu_rnnt.h:256-259).
    """

    backend: str = os.environ.get("MRNNT_BACKEND", "auto")
    debug_time: bool = _env_bool("MRNNT_DEBUG_TIME", False)
    debug_space: bool = _env_bool("MRNNT_DEBUG_SPACE", False)
    debug_fwdbwd: bool = _env_bool("MRNNT_DEBUG_FWDBWD", False)
    debug_grads: bool = _env_bool("MRNNT_DEBUG_GRADS", False)
    check_fwd_bwd: bool = _env_bool("MRNNT_CHECK_FWD_BWD", False)
    fwd_bwd_tol: float = float(os.environ.get("MRNNT_FWD_BWD_TOL", "0.1"))


_config = Config()


def get_config() -> Config:
    return _config


def update_config(**kwargs) -> Config:
    for key in kwargs:
        if not hasattr(_config, key):
            raise AttributeError(f"unknown config field: {key}")
    for key, value in kwargs.items():
        setattr(_config, key, value)
    return _config


@contextmanager
def config_override(**kwargs):
    """Temporarily override config fields (test / debug scoping)."""
    saved = {k: getattr(_config, k) for k in kwargs if hasattr(_config, k)}
    update_config(**kwargs)
    try:
        yield _config
    finally:
        update_config(**saved)
