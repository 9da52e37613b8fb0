"""The banded loss's CUDA kernels, their wrappers and their plain versions.

Counterpart of ``monotonic_rnnt_tpu/ops/pallas/kernels.py:292-377,
1104-1296`` on the packed [B, T, W(, V)] band layout (ops/bands.py):

* ``softmax_stats_banded`` (TPU kernel at kernels.py:335) launches
  ``mrnnt_stats_banded_kernel``;
* ``fwdbwd_scan_banded`` (kernels.py:1219) launches
  ``mrnnt_fwdbwd_banded_kernel``, the alpha and beta chains side by side;
* ``alpha_scan_banded`` (kernels.py:1271) launches
  ``mrnnt_alpha_banded_kernel``;

all from csrc/banded.cu. Each keeps its Pallas function's contract, except
that d / d_next are [B, T] and input_lengths [B] (the TPU's [B, T, 1] and
[B, 1, 1] block shapes), and that the scans take any B and T: the TPU
padding to full DP tiles has no counterpart.

Each row is an operator, ``torch.ops.mrnnt.<name>`` (kernels.define_op):
the plain PyTorch version for CPU tensors, ``<name>_cuda`` (checks,
allocation, launch, one added to ``kernels.LAUNCHES[<name>]``) for CUDA
tensors, and a fake implementation for tracing, so that torch.export and
torch.compile graphs hold them. The stats operator takes the four window
bounds as four tensors and returns its 3 or 5 outputs stacked (one
allocation); the wrapper keeps the ``Bounds`` tuple and unbinds.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..helpers import (NEG_INF, log_sum_exp, select_label_logits, shift_left_s,
                       shift_right_s)
from .kernels import (LAUNCHES, _call, _check, _check_cuda, _check_device,
                      _check_logits, _ptr, define_op)

Bounds = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# --- softmax_stats_banded --------------------------------------------------------

def softmax_stats_banded_plain(logits_band, lab_band, rel_bounds: Bounds,
                               blank_id: int, with_beta: bool = True):
    """Plain-torch softmax_stats_banded: the same arguments and outputs."""
    x = logits_band.float()
    denom = -torch.logsumexp(x, dim=-1)
    lpb = x[..., blank_id] + denom
    lpl = torch.where(lab_band >= 0, select_label_logits(x, lab_band) + denom,
                      NEG_INF)
    w_idx = torch.arange(x.shape[2], dtype=torch.int32, device=x.device)
    ra_lo, ra_hi, rb_lo, rb_hi = rel_bounds

    def madd(lo, hi, shift=0):
        keep = ((w_idx >= lo[..., None] - shift)
                & (w_idx <= hi[..., None] - shift))
        return torch.where(keep, 0.0, NEG_INF)

    out = (denom, lpb + madd(ra_lo, ra_hi), lpl + madd(ra_lo, ra_hi, 1))
    if with_beta:
        bm = madd(rb_lo, rb_hi)
        out += (lpb + bm, lpl + bm)
    return out


def softmax_stats_banded_cuda(logits_band, lab_band, ra_lo, ra_hi, rb_lo,
                              rb_hi, blank_id: int,
                              with_beta: bool) -> torch.Tensor:
    """The launch of mrnnt_stats_banded_kernel behind the op's CUDA
    implementation; returns the stacked [5 or 3, B, T, W] f32 outputs."""
    batch, t_max, w, v = _check_logits(logits_band, blank_id)
    dev = logits_band.device
    _check(lab_band, "lab_band", torch.int32, (batch, t_max, w), dev)
    rel_bounds = (ra_lo, ra_hi, rb_lo, rb_hi)
    for name, t in zip(("ra_lo", "ra_hi", "rb_lo", "rb_hi"), rel_bounds):
        _check(t, name, torch.int32, (batch, t_max), dev)
    # One allocation for the outputs: the host prelude is part of a call
    # that the kernel makes short.
    out = torch.empty((5 if with_beta else 3, batch, t_max, w),
                      dtype=torch.float32, device=dev)
    betas_out = (out[3], out[4]) if with_beta else (None, None)
    _call("mrnnt_stats_banded", dev, _ptr(logits_band),
          int(logits_band.dtype == torch.bfloat16), _ptr(lab_band),
          *(_ptr(t) for t in rel_bounds), batch, t_max, w, v, blank_id,
          *(_ptr(out[i]) for i in range(3)), *(_ptr(t) for t in betas_out))
    LAUNCHES["softmax_stats_banded"] += 1
    return out


def _stats_banded_cpu(logits_band, lab_band, ra_lo, ra_hi, rb_lo, rb_hi,
                      blank_id: int, with_beta: bool) -> torch.Tensor:
    return torch.stack(softmax_stats_banded_plain(
        logits_band, lab_band, (ra_lo, ra_hi, rb_lo, rb_hi), blank_id,
        with_beta))


define_op("softmax_stats_banded",
          "(Tensor logits_band, Tensor lab_band, Tensor ra_lo, Tensor ra_hi, "
          "Tensor rb_lo, Tensor rb_hi, int blank_id, bool with_beta) "
          "-> Tensor", _stats_banded_cpu, softmax_stats_banded_cuda,
          lambda logits_band, *args: logits_band.new_empty(
              (5 if args[-1] else 3, *logits_band.shape[:3]),
              dtype=torch.float32))


def softmax_stats_banded(logits_band, lab_band, rel_bounds: Bounds,
                         blank_id: int, with_beta: bool = True):
    """Banded stats with the reachability masks folded in, one read of the band.

    logits_band [B, T, W, V] f32 or bf16; lab_band [B, T, W] int32 (-1
    sentinel); rel_bounds (ra_lo, ra_hi, rb_lo, rb_hi), [B, T] int32 slot
    windows (bands.band_relative_bounds). Returns (denom, lpb + amask,
    lpl + amask shifted one slot down[, lpb + bmask, lpl + bmask]), each
    [B, T, W] f32: exactly the operand streams of the banded scans.
    """
    _check_device(logits_band)
    return torch.ops.mrnnt.softmax_stats_banded(
        logits_band, lab_band, *rel_bounds, blank_id,
        bool(with_beta)).unbind(0)


# --- the scans -------------------------------------------------------------------

def alpha_scan_banded_plain(lpb, lpl, d):
    """Plain-torch alpha_scan_banded: the same arguments and outputs."""
    batch, t_max, w = lpb.shape
    w_idx = torch.arange(w, device=lpb.device)
    prev = torch.where(w_idx == 0, 0.0, NEG_INF).expand(batch, w)
    shifted = (d == 1)[:, :, None]
    alphas = torch.empty_like(lpb)
    for t in range(t_max):
        aligned = torch.where(shifted[:, t], shift_left_s(prev), prev)
        prev = log_sum_exp(aligned + lpb[:, t],
                           shift_right_s(aligned + lpl[:, t]))
        alphas[:, t] = prev
    return alphas


def beta_scan_banded_plain(lpb, lpl, d_next, input_lengths, beta_virtual):
    """The beta half of fwdbwd_scan_banded_plain."""
    batch, t_max, w = lpb.shape
    shifted = (d_next == 1)[:, :, None]
    betas = torch.empty_like(lpb)
    carry = torch.full((batch, w), NEG_INF, dtype=torch.float32,
                       device=lpb.device)
    for t in range(t_max - 1, -1, -1):
        nxt = torch.where((t + 1 >= input_lengths)[:, None], beta_virtual[:, t],
                          carry)
        dn = shifted[:, t]
        carry = log_sum_exp(
            torch.where(dn, shift_right_s(nxt), nxt) + lpb[:, t],
            torch.where(dn, nxt, shift_left_s(nxt)) + lpl[:, t])
        betas[:, t] = carry
    return betas


def fwdbwd_scan_banded_plain(lpb_amask, lpl_amask, d, lpb_bmask, lpl_bmask,
                             d_next, input_lengths, beta_virtual):
    """Plain-torch fwdbwd_scan_banded: the same arguments and outputs."""
    return (alpha_scan_banded_plain(lpb_amask, lpl_amask, d),
            beta_scan_banded_plain(lpb_bmask, lpl_bmask, d_next, input_lengths,
                                   beta_virtual))


def _check_streams(streams, shifts, dev):
    batch, t_max, w = streams[0][1].shape
    for name, t in streams:
        _check(t, name, torch.float32, (batch, t_max, w), dev)
    for name, t in shifts:
        _check(t, name, torch.int32, (batch, t_max), dev)
    return batch, t_max, w


def alpha_scan_banded_cuda(lpb_masked, lpl_masked, d) -> torch.Tensor:
    """The launch of mrnnt_alpha_banded_kernel behind the op's CUDA
    implementation."""
    _check_cuda(lpb_masked)
    dev = lpb_masked.device
    batch, t_max, w = _check_streams(
        (("lpb_masked", lpb_masked), ("lpl_masked", lpl_masked)),
        (("d", d),), dev)
    alphas = torch.empty_like(lpb_masked)
    _call("mrnnt_alpha_banded", dev, _ptr(lpb_masked), _ptr(lpl_masked),
          _ptr(d), batch, t_max, w, _ptr(alphas))
    LAUNCHES["alpha_scan_banded"] += 1
    return alphas


def fwdbwd_scan_banded_cuda(lpb_amask, lpl_amask, d, lpb_bmask, lpl_bmask,
                            d_next, input_lengths, beta_virtual):
    """The launch of mrnnt_fwdbwd_banded_kernel behind the op's CUDA
    implementation."""
    _check_cuda(lpb_amask)
    dev = lpb_amask.device
    batch, t_max, w = _check_streams(
        (("lpb_amask", lpb_amask), ("lpl_amask", lpl_amask),
         ("lpb_bmask", lpb_bmask), ("lpl_bmask", lpl_bmask),
         ("beta_virtual", beta_virtual)),
        (("d", d), ("d_next", d_next)), dev)
    _check(input_lengths, "input_lengths", torch.int32, (batch,), dev)
    alphas = torch.empty_like(lpb_amask)
    betas = torch.empty_like(lpb_amask)
    _call("mrnnt_fwdbwd_banded", dev, _ptr(lpb_amask), _ptr(lpl_amask),
          _ptr(d), _ptr(lpb_bmask), _ptr(lpl_bmask), _ptr(d_next),
          _ptr(input_lengths), _ptr(beta_virtual), batch, t_max, w,
          _ptr(alphas), _ptr(betas))
    LAUNCHES["fwdbwd_scan_banded"] += 1
    return alphas, betas


define_op("alpha_scan_banded", "(Tensor lpb_masked, Tensor lpl_masked, "
          "Tensor d) -> Tensor", alpha_scan_banded_plain,
          alpha_scan_banded_cuda, lambda lpb, *_: torch.empty_like(lpb))
define_op("fwdbwd_scan_banded", "(Tensor lpb_amask, Tensor lpl_amask, "
          "Tensor d, Tensor lpb_bmask, Tensor lpl_bmask, Tensor d_next, "
          "Tensor input_lengths, Tensor beta_virtual) -> (Tensor, Tensor)",
          fwdbwd_scan_banded_plain, fwdbwd_scan_banded_cuda,
          lambda lpb, *_: (torch.empty_like(lpb), torch.empty_like(lpb)))


def alpha_scan_banded(lpb_masked, lpl_masked, d):
    """Banded cost-only alpha DP; returns alphas [B, T, W] f32.

    lpb_masked / lpl_masked: [B, T, W] f32 with the alpha mask folded in
    (lpl's pre-shifted onto the source slot); d: [B, T] int32 window shifts.
    Walks t serially:
      aligned[w] = d[t] ? prev[w+1] : prev[w],
      alpha(t, w) = LSE(aligned[w] + lpb[t, w], aligned[w-1] + lpl[t, w-1]),
    reads outside [0, W) give -inf; the row before t = 0 is [w == 0].
    """
    _check_device(lpb_masked)
    return torch.ops.mrnnt.alpha_scan_banded(lpb_masked, lpl_masked, d)


def fwdbwd_scan_banded(lpb_amask, lpl_amask, d, lpb_bmask, lpl_bmask, d_next,
                       input_lengths, beta_virtual):
    """Banded alpha and beta DPs in one launch; returns (alphas, betas) [B, T, W].

    The alpha operands are alpha_scan_banded's. The beta chain walks t from
    T-1 down to 0 with lpb_bmask / lpl_bmask [B, T, W] f32 (beta mask folded
    in), d_next [B, T] int32, input_lengths [B] int32 and beta_virtual
    [B, T, W] f32 (bands.band_virtual_next_rows):
      nxt = t+1 >= T_b ? beta_virtual[t] : beta(t+1)   (-inf past T_max),
      beta(t, w) = LSE((d_next[t] ? nxt[w-1] : nxt[w]) + lpb[t, w],
                       (d_next[t] ? nxt[w] : nxt[w+1]) + lpl[t, w]).
    """
    _check_device(lpb_amask)
    return torch.ops.mrnnt.fwdbwd_scan_banded(lpb_amask, lpl_amask, d,
                                              lpb_bmask, lpl_bmask, d_next,
                                              input_lengths, beta_virtual)
