"""Bindings of the port: the reference's PyTorch binding surface."""

from .torch_binding import (MonotonicRNNTLoss, monotonic_rnnt_loss,
                            monotonic_rnnt_loss_padded)

__all__ = ["MonotonicRNNTLoss", "monotonic_rnnt_loss",
           "monotonic_rnnt_loss_padded"]
