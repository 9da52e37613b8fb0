"""Banded monotonic RNN-T loss pipeline on the CUDA kernels.

Counterpart of ``monotonic_rnnt_tpu/ops/pallas/banded.py`` on the packed
[B, T, W, V] band layout (ops/bands.py): the big-tensor traffic of a
training step is two reads and one write of the band tensor, W/(S+1) of the
padded pipeline's.

  * forward, ``softmax_stats_banded`` + ``fwdbwd_scan_banded`` (training) or
    ``alpha_scan_banded`` (cost-only): one read of the band tensor gives the
    mask-folded stats, then the V-free scans give alphas (and betas);
  * backward, the occupancy coefficients (O(B*T*W) torch glue) scaled by
    the cost cotangent, then ``grad_pass``: one read + one write.

The JAX pipeline pads B and T to full DP tiles for its Mosaic blocks
(pallas/banded.py:78-86); the CUDA scans take any B and T, so there is no
padding here. Nothing on this path copies to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utils.debug import emit_loss_debug, report_space
from ..banded import band_labels, band_occupancy_coefficients
from ..bands import (Bands, band_final_slot, band_relative_bounds,
                     band_virtual_next_rows, compute_band_layout)
from .banded_kernels import (alpha_scan_banded, fwdbwd_scan_banded,
                             softmax_stats_banded)
from .kernels import grad_pass


def _layout(logits_band, labels, input_lengths, label_lengths, bands):
    _, t_max, w, _ = logits_band.shape
    s1 = labels.shape[1] + 1
    ilen = input_lengths.to(torch.int32).contiguous()
    slen = label_lengths.to(torch.int32)
    layout = compute_band_layout(ilen, slen, bands, t_max, s1, w)
    lab_band = band_labels(labels, slen, layout, s1).contiguous()
    return ilen, slen, layout, lab_band, s1


def _banded_fwd_parts(logits_band, labels, input_lengths, label_lengths,
                      bands, blank_id, with_betas):
    """Stats + DP scans; returns (costs, (denom, alphas, betas, ll))."""
    ilen, slen, layout, lab_band, s1 = _layout(
        logits_band, labels, input_lengths, label_lengths, bands)
    t_max = logits_band.shape[1]
    rel = tuple(b.contiguous() for b in band_relative_bounds(
        ilen, slen, bands, layout, t_max, s1))
    stats = softmax_stats_banded(logits_band, lab_band, rel, blank_id,
                                 with_beta=with_betas)
    d = layout.d.contiguous()
    if with_betas:
        denom, lpba, lpla, lpbb, lplb = stats
        # One launch advances both serial chains side by side.
        alphas, betas = fwdbwd_scan_banded(
            lpba, lpla, d, lpbb, lplb, layout.d_next.contiguous(), ilen,
            band_virtual_next_rows(layout, slen).contiguous())
    else:
        denom, lpba, lpla = stats
        betas = None
        alphas = alpha_scan_banded(lpba, lpla, d)
    ll = band_final_slot(alphas, layout, ilen, slen)
    return -ll, (denom, alphas, betas, ll)


def _banded_grad_part(logits_band, labels, input_lengths, label_lengths,
                      bands, blank_id, denom, alphas, betas, ll,
                      grad_scale=None):
    """Occupancy coefficients (optionally cotangent-scaled) + grad pass."""
    ilen, slen, layout, lab_band, _ = _layout(
        logits_band, labels, input_lengths, label_lengths, bands)
    occ, cb, cl = band_occupancy_coefficients(alphas, betas, ll, ilen, slen,
                                              layout)
    if grad_scale is not None:
        sc = grad_scale.to(torch.float32)[:, None, None]
        occ, cb, cl = occ * sc, cb * sc, cl * sc
    grads = grad_pass(logits_band, denom, occ.contiguous(), cb.contiguous(),
                      cl.contiguous(), lab_band, blank_id,
                      out_dtype=logits_band.dtype)
    emit_loss_debug(ll, betas[:, 0, 0], grads)
    return grads


def rnnt_loss_banded_cuda(
    logits_band: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    bands: Bands,
    blank_id: int = 0,
    with_grads: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Banded costs (+ packed-layout grads) through the CUDA kernels.

    Same contract as ops.banded.rnnt_loss_banded_reference, except that the
    gradient comes in the logits' dtype. with_grads=False is the cost-only
    route: the stats kernel without the beta streams, then the alpha scan.
    """
    report_space("banded", logits_band.shape, logits_band.dtype,
                 reads=2 if with_grads else 1, writes=1 if with_grads else 0)
    costs, (denom, alphas, betas, ll) = _banded_fwd_parts(
        logits_band, labels, input_lengths, label_lengths, bands, blank_id,
        with_grads)
    if not with_grads:
        return costs, None
    return costs, _banded_grad_part(logits_band, labels, input_lengths,
                                    label_lengths, bands, blank_id, denom,
                                    alphas, betas, ll)


def banded_deferred_fwd(logits_band, labels, input_lengths, label_lengths,
                        bands: Bands, blank_id: int = 0):
    """Banded forward keeping small residuals for a deferred gradient.

    One read of the band tensor and one bidirectional V-free walk; the
    gradient pass (one read + one write) runs in banded_deferred_bwd with
    the cost cotangent folded into the occupancy coefficients. Returns
    (costs [B] f32, (denom, alphas, betas, ll)).
    """
    return _banded_fwd_parts(logits_band, labels, input_lengths,
                             label_lengths, bands, blank_id, True)


def banded_deferred_bwd(logits_band, labels, input_lengths, label_lengths,
                        bands: Bands, residuals, cost_cotangent,
                        blank_id: int = 0) -> torch.Tensor:
    """The deferred banded gradient pass; returns packed-layout dlogits."""
    denom, alphas, betas, ll = residuals
    return _banded_grad_part(logits_band, labels, input_lengths,
                             label_lengths, bands, blank_id, denom, alphas,
                             betas, ll, grad_scale=cost_cotangent)
