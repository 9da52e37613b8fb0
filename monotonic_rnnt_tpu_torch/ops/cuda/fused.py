"""The padded monotonic RNN-T loss on the CUDA kernels.

Counterpart of ``monotonic_rnnt_tpu/ops/pallas/fused.py``'s DP-fused
pipeline (fused.py:140-285), which makes two passes over the [B, T, S1, V]
logits, the minimum HBM traffic of the algorithm:

  * forward, ``stats_alpha_fused``: one read gives the stats, the alphas
    and the costs; it reads only the live lattice (t < T'_b, s <= S_b);
  * backward, ``beta_grad_fused``: one read and one write give the betas,
    the occupancy coefficients and the gradient, with the per-sample cost
    cotangent folded in (the deferred-gradient route).

The JAX package admits this route only when its tiles fit the TPU's VMEM
(fused.py:210-216) and otherwise runs its split pipeline; the port takes it
at every shape, so the padded loss has this one CUDA route. Its glue is
three small kernels of its own (kernels.py): ``loss_prologue`` before row
1, ``loss_costs`` after it and ``beta_operands`` before row 2, so a loss
step is a few launches the card queues behind row 1. The split kernels
(split_kernels.py) serve alignment, the fused-joint losses and sharding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...utils.debug import emit_loss_debug, report_space
from ...utils.profiling import ROWS
from ..bands import Bands, default_bands
from .kernels import (beta_grad_fused, beta_operands, loss_costs,
                      loss_prologue, stats_alpha_fused)

ROWS.update({"stats_alpha_fused.read": 0, "stats_alpha_fused.padded": 0})


def count_live_rows(host_ilen: torch.Tensor, host_slen: torch.Tensor,
                    t_max: int, s1: int) -> None:
    """Adds one call of row 1 to ``ROWS``: the lattice rows it reads,
    sum_b T'_b * (S_b + 1), and those of the padded lattice, B * T * S1.
    The lengths are validated host copies (1 <= T'_b <= T, 0 <= S_b < S1),
    so nothing here reads the device."""
    ilen = host_ilen.numpy().astype(np.int64)
    slen = host_slen.numpy().astype(np.int64)
    ROWS["stats_alpha_fused.read"] += int(np.dot(ilen, slen + 1))
    ROWS["stats_alpha_fused.padded"] += len(ilen) * t_max * s1


def _lengths(input_lengths, label_lengths):
    return (input_lengths.to(torch.int32).contiguous(),
            label_lengths.to(torch.int32).contiguous())


def _prologue(logits, labels, ilen, slen, bands):
    """loss_prologue on the default bands where none are given: labels_ext,
    the alpha window (a_lo, a_hi) and the beta window (b_lo, b_hi)."""
    _, t_max, s1, _ = logits.shape
    if bands is None:
        bands = default_bands(ilen, slen, t_max)
    labels_ext, a_lo, a_hi, b_lo, b_hi = loss_prologue(
        labels, ilen, slen, bands.min_s, bands.max_s, t_max, s1)
    return labels_ext, (a_lo, a_hi), (b_lo, b_hi)


def _dp_fused_alpha_half(logits, labels_ext, ilen, slen, awin, blank_id):
    """stats_alpha_fused + the ll gather (the one-read forward, of the live
    lattice t < T'_b, s <= S_b only). Returns
    (costs, (denom, lp_blank, lp_label, alphas, ll_fwd))."""
    denom, lp_blank, lp_label, alphas = stats_alpha_fused(
        logits, labels_ext, *awin, ilen, slen, blank_id)
    ll_fwd, costs = loss_costs(alphas, ilen, slen)
    return costs, (denom, lp_blank, lp_label, alphas, ll_fwd)


def _dp_fused_grad_half(logits, labels_ext, ilen, slen, blank_id, stats,
                        bwin, grad_scale=None):
    """beta_grad_fused + its operands (the read+write backward)."""
    denom, lp_blank, lp_label, alphas, ll_fwd = stats
    lpb_bmask, lpl_bmask, aprev_m, llb, beta_virtual = beta_operands(
        lp_blank, lp_label, alphas, ll_fwd, ilen, slen, *bwin)
    grads, betas = beta_grad_fused(logits, denom, lpb_bmask, lpl_bmask,
                                   aprev_m, ilen, llb, beta_virtual,
                                   labels_ext, blank_id,
                                   grad_scale=grad_scale)
    emit_loss_debug(ll_fwd, betas[:, 0, 0], grads)
    return grads


def rnnt_loss_cuda(
    logits: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int = 0,
    bands: Optional[Bands] = None,
    with_grads: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Monotonic RNN-T costs (+ logit grads) through the CUDA kernels.

    Same contract as ops.reference.rnnt_loss_reference, except that the
    gradient comes in the logits' dtype. The forward makes the gradient
    here (row 2 at grad_scale 1): the route serving.export_loss holds. A
    training step goes through the deferred route instead.
    """
    ilen, slen = _lengths(input_lengths, label_lengths)
    report_space("dp-fused", logits.shape, logits.dtype,
                 reads=2 if with_grads else 1, writes=1 if with_grads else 0)
    labels_ext, awin, bwin = _prologue(logits, labels, ilen, slen, bands)
    costs, stats = _dp_fused_alpha_half(logits, labels_ext, ilen, slen, awin,
                                        blank_id)
    if not with_grads:
        return costs, None
    grads = _dp_fused_grad_half(logits, labels_ext, ilen, slen, blank_id,
                                stats, bwin)
    return costs, grads


def rnnt_loss_cuda_deferred_fwd(logits, labels, input_lengths, label_lengths,
                                blank_id: int = 0,
                                bands: Optional[Bands] = None):
    """Cost-only forward keeping small residuals for a deferred gradient.

    One read of the logits now; the beta+gradient pass runs later in
    rnnt_loss_cuda_deferred_bwd with the cotangent folded into the
    occupancy coefficients in-kernel, so a training step makes three passes
    over the big tensor and keeps four [B, T, S1] f32 residuals. The
    residuals also hold what loss_prologue made (labels_ext, the beta
    window), so the backward rebuilds neither.

    Returns (costs [B] f32, residuals tuple to pass to the bwd).
    """
    ilen, slen = _lengths(input_lengths, label_lengths)
    report_space("dp-fused-deferred-fwd", logits.shape, logits.dtype,
                 reads=1, writes=0)
    labels_ext, awin, bwin = _prologue(logits, labels, ilen, slen, bands)
    costs, stats = _dp_fused_alpha_half(logits, labels_ext, ilen, slen, awin,
                                        blank_id)
    return costs, (ilen, slen, labels_ext, *bwin, *stats)


def rnnt_loss_cuda_deferred_bwd(logits, residuals, cost_cotangent,
                                blank_id: int = 0):
    """The deferred beta+gradient pass; returns dlogits in the logits' dtype.

    residuals: rnnt_loss_cuda_deferred_fwd's. cost_cotangent: [B]
    dL/dcosts, folded into the coefficients in-kernel (dlogits ==
    cost_cotangent[:, None, None, None] * grads up to one multiply's
    rounding).
    """
    report_space("dp-fused-deferred-bwd", logits.shape, logits.dtype,
                 reads=1, writes=1)
    ilen, slen, labels_ext, b_lo, b_hi, *stats = residuals
    scale = cost_cotangent.to(torch.float32).contiguous()
    return _dp_fused_grad_half(logits, labels_ext, ilen, slen, blank_id,
                               stats, (b_lo, b_hi), grad_scale=scale)
