"""Bindings of the port (reference L3: pytorch_binding/, tensorflow_binding/).

  torch_binding -- the reference's PyTorch binding surface (packed layout,
                   native engine or the port's loss)
  tf_binding    -- the packed TF loss on the native engine, and bridges from
                   TF onto the port's padded and banded losses and greedy
                   decoder
  returnn_op    -- RETURNN re-export of the packed TF loss

tf_binding and returnn_op import TensorFlow only when one of their
functions is called, and this package does not import them.
"""

from .torch_binding import (MonotonicRNNTLoss, monotonic_rnnt_loss,
                            monotonic_rnnt_loss_padded)

__all__ = ["MonotonicRNNTLoss", "monotonic_rnnt_loss",
           "monotonic_rnnt_loss_padded"]
