"""PyTorch + CUDA port of the monotonic RNN-T training loss.

Counterpart of the JAX package ``monotonic_rnnt_tpu``, which stays the
reference. The padded loss runs forward, cost-only and backward through
hand-written CUDA kernels (``csrc/``, built for sm_90a at first use) on
CUDA tensors, and through the plain-torch oracle on CPU tensors.
"""

from .ops.bands import Bands, bands_from_alignment, default_bands
from .ops.loss import monotonic_rnnt_alignment_score, monotonic_rnnt_loss
from .ops.reference import rnnt_loss_reference
from .utils.config import config_override, get_config, update_config
from .utils.status import RnntError, Status

__all__ = [
    "Bands",
    "RnntError",
    "Status",
    "bands_from_alignment",
    "config_override",
    "default_bands",
    "get_config",
    "monotonic_rnnt_alignment_score",
    "monotonic_rnnt_loss",
    "rnnt_loss_reference",
    "update_config",
]
