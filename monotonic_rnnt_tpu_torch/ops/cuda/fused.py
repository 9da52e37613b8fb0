"""DP-fused monotonic RNN-T loss pipeline on the CUDA kernels.

Counterpart of ``monotonic_rnnt_tpu/ops/pallas/fused.py:140-285``: two
passes over the [B, T, S1, V] logits, the minimum HBM traffic of the
algorithm:

  * forward, ``stats_alpha_fused``: one read gives the stats, the alphas
    and the costs;
  * backward, ``beta_grad_fused``: one read and one write give the betas,
    the occupancy coefficients and the gradient, with the per-sample cost
    cotangent folded in (the deferred-gradient route).

The JAX package admits this route only when its tiles fit the TPU's VMEM
(fused.py:210-216); the port takes it at every shape. Everything between
the kernels is O(B*T*S1) torch glue.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..bands import Bands, _window_bounds, default_bands
from ..helpers import NEG_INF, extend_labels, mask_to_additive
from ..reference import _gather_ll
from .kernels import beta_grad_fused, stats_alpha_fused


def _prepare(logits, labels, input_lengths, label_lengths, bands):
    s1 = logits.shape[2]
    ilen = input_lengths.to(torch.int32).contiguous()
    slen = label_lengths.to(torch.int32)
    if bands is None:
        bands = default_bands(ilen, slen, logits.shape[1])
    return ilen, slen, bands, extend_labels(labels, slen, s1)


def _windows(ilen, slen, bands, t_max, s1):
    """Alpha window, beta window and t < T_b, conjoined as the kernels take them."""
    a_lo, a_hi, b_lo, b_hi = _window_bounds(ilen, slen, bands, t_max, s1)
    t_idx = torch.arange(t_max, dtype=torch.int32, device=ilen.device)[None, :]
    valid_t = t_idx < ilen[:, None]
    # Conjoin t < T_b by emptying the window (hi < lo) on invalid rows.
    a_hi = torch.where(valid_t, a_hi, -1)
    b_hi = torch.where(valid_t, b_hi, -1)
    return a_lo.contiguous(), a_hi.contiguous(), (b_lo, b_hi, valid_t)


def _dp_fused_alpha_half(logits, labels_ext, ilen, slen, bands, blank_id):
    """stats_alpha_fused + windows + ll gather (the one-read forward)."""
    _, t_max, s1, _ = logits.shape
    a_lo, a_hi, bwin = _windows(ilen, slen, bands, t_max, s1)
    denom, lp_blank, lp_label, alphas = stats_alpha_fused(
        logits, labels_ext, a_lo, a_hi, blank_id)
    ll_fwd = _gather_ll(alphas, ilen, slen)
    return denom, lp_blank, lp_label, alphas, ll_fwd, bwin


def beta_grad_operands(lp_blank, lp_label, alphas, ll_fwd, slen, bwin):
    """The small operands of beta_grad_fused (fused.py:166-180).

    Returns (lpb_bmask, lpl_bmask, aprev_masked, ll_bounded, beta_virtual).
    The beta window is folded in by a select, not by adding an additive
    -inf mask as the JAX glue does: the two agree on finite stats, and the
    select keeps a NaN statistic of a padding cell (from +-inf padding
    logits) out of the recurrence.
    """
    batch, _, s1 = alphas.shape
    b_lo, b_hi, valid_t = bwin
    s_idx = torch.arange(s1, dtype=torch.int32, device=alphas.device)
    in_band = ((s_idx >= b_lo[:, :, None]) & (s_idx <= b_hi[:, :, None]))
    alpha_virt = mask_to_additive(s_idx == 0).expand(batch, s1)
    alpha_prev = torch.cat([alpha_virt[:, None, :], alphas[:, :-1, :]], dim=1)
    ll_ok = torch.isfinite(ll_fwd)
    ll_bounded = torch.where(ll_ok, ll_fwd, 0.0)
    valid = valid_t[:, :, None] & ll_ok[:, None, None]
    return (torch.where(in_band, lp_blank, NEG_INF),
            torch.where(in_band, lp_label, NEG_INF),
            torch.where(valid, alpha_prev, NEG_INF),
            ll_bounded,
            mask_to_additive(s_idx[None, :] == slen[:, None]))


def _dp_fused_grad_half(logits, labels_ext, ilen, slen, blank_id, denom,
                        lp_blank, lp_label, alphas, ll_fwd, bwin,
                        grad_scale=None):
    """beta_grad_fused + its small-array glue (the read+write backward)."""
    lpb_bmask, lpl_bmask, aprev_m, llb, beta_virtual = beta_grad_operands(
        lp_blank, lp_label, alphas, ll_fwd, slen, bwin)
    grads, _ = beta_grad_fused(logits, denom, lpb_bmask, lpl_bmask, aprev_m,
                               ilen, llb, beta_virtual, labels_ext, blank_id,
                               grad_scale=grad_scale)
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
    here (grad_scale 1); a training step goes through the deferred route.
    """
    ilen, slen, bands, labels_ext = _prepare(logits, labels, input_lengths,
                                             label_lengths, bands)
    denom, lp_blank, lp_label, alphas, ll_fwd, bwin = _dp_fused_alpha_half(
        logits, labels_ext, ilen, slen, bands, blank_id)
    costs = -ll_fwd
    if not with_grads:
        return costs, None
    grads = _dp_fused_grad_half(logits, labels_ext, ilen, slen, blank_id,
                                denom, lp_blank, lp_label, alphas, ll_fwd,
                                bwin)
    return costs, grads


def rnnt_loss_cuda_deferred_fwd(logits, labels, input_lengths, label_lengths,
                                blank_id: int = 0,
                                bands: Optional[Bands] = None):
    """Cost-only forward keeping small residuals for a deferred gradient.

    One read of the logits now; the beta+gradient pass runs later in
    rnnt_loss_cuda_deferred_bwd with the cotangent folded into the
    occupancy coefficients in-kernel, so a training step makes three passes
    over the big tensor and keeps four [B, T, S1] f32 residuals.

    Returns (costs [B] f32, residuals tuple to pass to the bwd).
    """
    ilen, slen, bands, labels_ext = _prepare(logits, labels, input_lengths,
                                             label_lengths, bands)
    denom, lp_blank, lp_label, alphas, ll_fwd, _ = _dp_fused_alpha_half(
        logits, labels_ext, ilen, slen, bands, blank_id)
    return -ll_fwd, (denom, lp_blank, lp_label, alphas, ll_fwd)


def rnnt_loss_cuda_deferred_bwd(logits, labels, input_lengths, label_lengths,
                                residuals, cost_cotangent, blank_id: int = 0,
                                bands: Optional[Bands] = None):
    """The deferred beta+gradient pass; returns dlogits in the logits' dtype.

    cost_cotangent: [B] dL/dcosts, folded into the coefficients in-kernel
    (dlogits == cost_cotangent[:, None, None, None] * grads up to one
    multiply's rounding).
    """
    ilen, slen, bands, labels_ext = _prepare(logits, labels, input_lengths,
                                             label_lengths, bands)
    denom, lp_blank, lp_label, alphas, ll_fwd = residuals
    _, t_max, s1, _ = logits.shape
    _, _, bwin = _windows(ilen, slen, bands, t_max, s1)
    scale = cost_cotangent.to(torch.float32).contiguous()
    return _dp_fused_grad_half(logits, labels_ext, ilen, slen, blank_id,
                               denom, lp_blank, lp_label, alphas, ll_fwd,
                               bwin, grad_scale=scale)
