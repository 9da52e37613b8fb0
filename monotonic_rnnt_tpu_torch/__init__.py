"""PyTorch + CUDA port of the monotonic RNN-T training loss.

Counterpart of the JAX package ``monotonic_rnnt_tpu``, which stays the
reference. The padded loss (on the DP-fused or the split pipeline), the
reference's packed [sum T_b(S_b+1), V] layout over it, the banded loss
(packed [B, T, W, V] layout) and the two fused-joint losses, which compute
the loss from encoder and predictor outputs in T-chunks, run forward,
cost-only and backward through hand-written CUDA kernels (``csrc/``, built
for sm_90a at first use) on CUDA tensors, and through the kernels' plain
versions or the plain-torch oracles on CPU tensors; so do Viterbi
alignment and the occupancy posteriors. ``interop`` holds the reference's
PyTorch binding surface, ``native`` the C++ engine it runs on CPU tensors.
``models`` holds the Conformer transducer whose loss step runs on the padded
loss, ``data`` the synthetic batches, ``utils.metrics`` the edit distance.
``serving`` exports the losses and the decoders as ``torch.export``
artifacts; ``interop.tf_binding`` and ``interop.returnn_op`` hold the
TensorFlow surface. ``utils.config`` holds the runtime flags (the debug
flags read by ``utils.debug``), ``utils.provenance`` the stamp for
measurements.
"""

from .ops.alignment import (ViterbiResult, occupancy_posteriors,
                            occupancy_posteriors_banded, viterbi_alignment,
                            viterbi_alignment_banded)
from .ops.banded import monotonic_rnnt_loss_banded
from .ops.chunked import rnnt_loss_fused_joint
from .ops.chunked_banded import rnnt_loss_fused_joint_banded
from .ops.bands import (BandLayout, Bands, band_layout_is_exact,
                        bands_from_alignment, compute_band_layout,
                        default_bands, pack_band, required_band_width,
                        suggested_band_width, unpack_band)
from .ops.loss import monotonic_rnnt_alignment_score, monotonic_rnnt_loss
from .ops.packing import monotonic_rnnt_loss_packed, pack_acts, unpack_acts
from .ops.reference import rnnt_loss_reference
from .utils.config import config_override, get_config, update_config
from .utils.status import RnntError, Status

__version__ = "0.3.0"

__all__ = [
    "BandLayout",
    "Bands",
    "RnntError",
    "Status",
    "ViterbiResult",
    "band_layout_is_exact",
    "bands_from_alignment",
    "compute_band_layout",
    "config_override",
    "default_bands",
    "get_config",
    "monotonic_rnnt_alignment_score",
    "monotonic_rnnt_loss",
    "monotonic_rnnt_loss_banded",
    "monotonic_rnnt_loss_packed",
    "occupancy_posteriors",
    "occupancy_posteriors_banded",
    "pack_acts",
    "pack_band",
    "required_band_width",
    "rnnt_loss_fused_joint",
    "rnnt_loss_fused_joint_banded",
    "rnnt_loss_reference",
    "suggested_band_width",
    "unpack_acts",
    "unpack_band",
    "update_config",
    "viterbi_alignment",
    "viterbi_alignment_banded",
]
