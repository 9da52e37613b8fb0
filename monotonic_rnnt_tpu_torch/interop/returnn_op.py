"""RETURNN integration (counterpart of the reference's returnn_tf_op.py).

PyTorch counterpart of ``monotonic_rnnt_tpu/interop/returnn_op.py``. The
reference ships a self-compiling wrapper that concatenates its CUDA op
source and builds it through RETURNN's `OpCodeCompiler` at import time
(returnn_tf_op.py:35-81), then re-exports `monotonic_rnnt_loss` with the
registered gradient (returnn_tf_op.py:92-170). Here the TF surface is the
native engine behind tf.numpy_function (interop/tf_binding.py), so the
RETURNN entry point is a direct re-export with the exact reference
signature (acts, labels, input_lengths, label_lengths, blank_label).

Usage inside a RETURNN config (same call shape as the reference):

    from monotonic_rnnt_tpu_torch.interop.returnn_op import \\
        monotonic_rnnt_loss
    loss = monotonic_rnnt_loss(acts, labels, input_lengths, label_lengths,
                               blank_label=0)

The reference's compile-time debug macros (returnn_tf_op.py:61-69) map to
this package's runtime flags: monotonic_rnnt_tpu_torch.update_config(
debug_fwdbwd=True, ...); see utils/config.py and utils/debug.py.
"""

from __future__ import annotations

from .tf_binding import monotonic_rnnt_loss as _tf_monotonic_rnnt_loss


def monotonic_rnnt_loss(acts, labels, input_lengths, label_lengths,
                        blank_label: int = 0):
    """Packed-layout monotonic RNN-T loss for RETURNN (reference
    returnn_tf_op.py:92-137 signature: no alignment variant).

    acts: [sum_b T_b*(S_b+1), V] float32 raw logits (softmax internal);
    labels [B, S_max] int32; lengths int32 [B]. Returns costs [B],
    differentiable w.r.t. acts.
    """
    return _tf_monotonic_rnnt_loss(acts, labels, input_lengths,
                                   label_lengths, blank_label=blank_label)
