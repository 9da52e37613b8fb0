"""Band-pruned monotonic RNN-T loss on the packed [B, T, W, V] layout.

PyTorch counterpart of ``monotonic_rnnt_tpu/ops/banded.py``: the oracle of
the alignment-restricted fast path and its public API. The lattice's s axis
is re-indexed into a static-width window (ops/bands.py BandLayout), so every
tensor the loss touches is [B, T, W(, V)] (reference: band-pruned storage,
cpu_workspace_manager.h:286-297; band-clamped GPU work,
gpu_rnnt_kernel.h:58-72).

Band-coordinate recurrences, with s = offset[t] + w and the per-step window
shift d[t] = offset[t] - offset[t-1] in {0, 1}:

  alpha(t, w) = LSE( alpha(t-1, w + d[t])     + log p(blank | t, w),
                     alpha(t-1, w + d[t] - 1) + log p(label | t, w) )
  beta(t, w)  = LSE( beta(t+1, w - d[t+1])     + log p(blank | t, w),
                     beta(t+1, w - d[t+1] + 1) + log p(label | t, w) )

Values shifted in from outside the window are exactly -inf. Both the
oracle and the CUDA route (ops/cuda/banded.py) compute the loss of
``clip_bands_to_width(bands)``, which equals the requested band whenever
band_layout_is_exact holds.

As in ops/reference.py, the oracle applies the reachability masks with a
select where the JAX oracle adds a -inf mask, and zeroes the gradient where
its coefficient is zero, except on the lattice cells of a sample whose cost
is not finite, which take p * 0 as the JAX oracle's do; on finite inputs
the two agree.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import spanned
from ..utils.status import RnntError, Status, validate_loss_inputs
from .bands import (BandLayout, Bands, LatticeMasks, band_final_slot,
                    band_lattice_masks, band_virtual_next_rows,
                    compute_band_layout)
from .helpers import (NEG_INF, extend_labels, log_sum_exp, mask_to_additive,
                      select_label_logits, shift_left_s, shift_right_s)
from .loss import _resolve_backend, debug_timer
from .reference import nonfinite_cost_cells


class BandStats(NamedTuple):
    """Per-cell softmax statistics in band coordinates ([B, T, W] f32 each)."""

    denom: torch.Tensor
    lp_blank: torch.Tensor
    lp_label: torch.Tensor


def band_labels(labels: torch.Tensor, label_lengths: torch.Tensor,
                layout: BandLayout, s1: int) -> torch.Tensor:
    """[B, T, W] int32 label id per packed slot (-1 sentinel where invalid).

    One gather of extend_labels at offset + w; slots outside [0, s1) get the
    sentinel. (The JAX package writes this as a one-hot matmul because
    multi-dim gathers serialize on the TPU.)
    """
    lab_ext = extend_labels(labels, label_lengths, s1)
    w_idx = torch.arange(layout.width, dtype=torch.int64,
                         device=layout.offset.device)
    idx = layout.offset.to(torch.int64)[:, :, None] + w_idx
    valid = (idx >= 0) & (idx < s1)
    picked = torch.gather(lab_ext[:, None, :].expand(-1, idx.shape[1], -1), 2,
                          idx.clamp(0, s1 - 1))
    return torch.where(valid, picked, -1).to(torch.int32)


def band_stats(logits_band: torch.Tensor, lab_band: torch.Tensor,
               blank_id: int) -> BandStats:
    """Log-softmax statistics over V on the packed layout."""
    x = logits_band.float()
    denom = -torch.logsumexp(x, dim=-1)
    lp_blank = x[..., blank_id] + denom
    lp_label = torch.where(lab_band >= 0,
                           select_label_logits(x, lab_band) + denom, NEG_INF)
    return BandStats(denom=denom, lp_blank=lp_blank, lp_label=lp_label)


def band_forward_backward(stats: BandStats, masks: LatticeMasks,
                          layout: BandLayout, input_lengths: torch.Tensor,
                          label_lengths: torch.Tensor,
                          compute_betas: bool = True):
    """Banded alpha (and optionally beta) scans; returns (alphas, betas, ll)."""
    ilen = input_lengths.to(torch.int32)
    slen = label_lengths.to(torch.int32)
    batch, t_max, w = stats.lp_blank.shape
    dev = stats.lp_blank.device
    w_idx = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    shifted = layout.d[:, :, None] == 1

    # alpha(-1, .) = [s == 0] lives at offset 0, so band slot w == 0.
    carry = mask_to_additive(w_idx == 0).expand(batch, w)
    alphas = torch.empty((batch, t_max, w), dtype=torch.float32, device=dev)
    for t in range(t_max):
        # Realign alpha(t-1) into t's coordinates (its rows sit at w + d[t]),
        # then the usual recurrence: emit enters w from w-1 and consumes
        # lp_label(t, w-1).
        aligned = torch.where(shifted[:, t], shift_left_s(carry), carry)
        new = log_sum_exp(aligned + stats.lp_blank[:, t],
                          shift_right_s(aligned + stats.lp_label[:, t]))
        carry = torch.where(masks.alpha[:, t], new, NEG_INF)
        alphas[:, t] = carry
    ll = band_final_slot(alphas, layout, ilen, slen)

    if not compute_betas:
        return alphas, None, ll

    d_next = layout.d_next[:, :, None] == 1
    bvirt = band_virtual_next_rows(layout, slen)
    betas = torch.empty_like(alphas)
    carry = torch.full((batch, w), NEG_INF, dtype=torch.float32, device=dev)
    for t in range(t_max - 1, -1, -1):
        nxt = torch.where((t + 1 >= ilen)[:, None], bvirt[:, t], carry)
        # beta(t+1) rows sit at w - d_next: read row[w-1] / row[w] when
        # d_next == 1, row[w] / row[w+1] otherwise.
        dn = d_next[:, t]
        no_emit = torch.where(dn, shift_right_s(nxt), nxt)
        emit = torch.where(dn, nxt, shift_left_s(nxt))
        new = log_sum_exp(no_emit + stats.lp_blank[:, t],
                          emit + stats.lp_label[:, t])
        carry = torch.where(masks.beta[:, t], new, NEG_INF)
        betas[:, t] = carry
    return alphas, betas, ll


def band_occupancy_coefficients(alphas, betas, ll, input_lengths,
                                label_lengths, layout: BandLayout):
    """Per-cell gradient coefficients (occ, cb, cl) in band coordinates.

    ops/reference.py:occupancy_coefficients re-indexed to the packed window:
    the neighbours at t-1 / t+1 are realigned into t's coordinates by the
    d / d_next shifts.
    """
    batch, t_max, w = alphas.shape
    dev = alphas.device
    ilen = input_lengths.to(torch.int32)[:, None, None]
    slen = label_lengths.to(torch.int32)[:, None, None]
    w_idx = torch.arange(w, dtype=torch.int32, device=dev)[None, None, :]
    t_idx = torch.arange(t_max, dtype=torch.int32, device=dev)[None, :, None]

    # alpha(t-1, s) in t's coordinates: rows shift left when d[t] == 1.
    virt = mask_to_additive(w_idx == 0).expand(batch, 1, w)
    ap = torch.cat([virt, alphas[:, :-1, :]], dim=1)
    alpha_prev = torch.where(layout.d[:, :, None] == 1, shift_left_s(ap), ap)

    # beta(t+1, s) in t's coordinates: rows shift right when d_next == 1; at
    # t == T_b-1 the next row is the virtual [s == S_b] boundary.
    bn = torch.cat([betas[:, 1:, :],
                    torch.full((batch, 1, w), NEG_INF, dtype=torch.float32,
                               device=dev)], dim=1)
    beta_next = torch.where(layout.d_next[:, :, None] == 1, shift_right_s(bn),
                            bn)
    bvirt = mask_to_additive(layout.offset[:, :, None] + w_idx == slen)
    beta_next = torch.where(t_idx == ilen - 1, bvirt, beta_next)

    ll_ok = torch.isfinite(ll)
    llb = torch.where(ll_ok, ll, 0.0)[:, None, None]
    valid_t = (t_idx < ilen) & ll_ok[:, None, None]

    def _coef(b):
        return torch.where(valid_t, torch.exp(alpha_prev + b - llb), 0.0)

    return (_coef(betas), _coef(beta_next), _coef(shift_left_s(beta_next)))


def band_gradients(logits_band, denom, lab_band, occ, cb, cl,
                   blank_id: int, v_offset: int = 0,
                   open_cells: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dL/dz on the packed layout, f32; exactly 0 where the coefficient is 0,
    except on open_cells ([B, T, W] bool), which take p * coef.

    v_offset shifts local vocab indices to global ids (the vocab-sharded
    path; cf. reference.gradients_from_coefficients).
    """
    v = logits_band.shape[-1]
    p = torch.exp(logits_band.float() + denom[..., None])
    v_idx = torch.arange(v, dtype=torch.int32,
                         device=logits_band.device) + v_offset
    coef = (occ[..., None]
            - torch.where(v_idx == blank_id, cb[..., None], 0.0)
            - torch.where(v_idx == lab_band[..., None], cl[..., None], 0.0))
    zero = coef == 0.0
    if open_cells is not None:
        zero &= ~open_cells[..., None]
    return torch.where(zero, 0.0, p * coef)


def rnnt_loss_banded_reference(
    logits_band: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    bands: Bands,
    blank_id: int = 0,
    with_grads: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Banded monotonic RNN-T loss on the packed layout (plain torch).

    Args:
      logits_band: [B, T_max, W, V], slot (t, w) holding lattice cell
        (t, offset[t] + w); see bands.compute_band_layout / pack_band.
      bands: the band being scored (clipped to width W; exact when
        band_layout_is_exact holds).
    Returns (costs [B] f32, grads [B, T_max, W, V] f32 or None), the
    gradients in the packed layout (bands.unpack_band scatters them back).
    """
    _, t_max, w, _ = logits_band.shape
    s1 = labels.shape[1] + 1
    layout = compute_band_layout(input_lengths, label_lengths, bands, t_max,
                                 s1, w)
    masks = band_lattice_masks(input_lengths, label_lengths, bands, layout,
                               t_max, s1)
    lab_band = band_labels(labels, label_lengths, layout, s1)
    stats = band_stats(logits_band, lab_band, blank_id)
    alphas, betas, ll = band_forward_backward(
        stats, masks, layout, input_lengths, label_lengths,
        compute_betas=with_grads)
    if not with_grads:
        return -ll, None
    occ, cb, cl = band_occupancy_coefficients(
        alphas, betas, ll, input_lengths, label_lengths, layout)
    w_idx = torch.arange(w, dtype=torch.int32, device=logits_band.device)
    open_cells = nonfinite_cost_cells(ll, input_lengths, label_lengths,
                                      layout.offset[:, :, None] + w_idx,
                                      t_max)
    return -ll, band_gradients(logits_band, stats.denom, lab_band, occ, cb,
                               cl, blank_id, open_cells=open_cells)


# ---------------------------------------------------------------------------
# Public API (autograd, backend dispatch)
# ---------------------------------------------------------------------------


class _BandedCore(torch.autograd.Function):
    """costs = banded loss(logits_band); d costs / d logits_band by the backend's route."""

    @staticmethod
    @spanned("mrnnt.loss.forward")
    def forward(ctx, logits_band, labels, input_lengths, label_lengths,
                band_min, band_max, blank_id, backend):
        bands = Bands(band_min, band_max)
        need_grad = ctx.needs_input_grad[0]
        ctx.backend = backend
        ctx.blank_id = blank_id
        if backend == "cuda":
            from .cuda.banded import banded_deferred_fwd, rnnt_loss_banded_cuda
            logits_band = logits_band.contiguous()  # kernels take contiguous rows
            if not need_grad:
                costs, _ = rnnt_loss_banded_cuda(
                    logits_band, labels, input_lengths, label_lengths, bands,
                    blank_id, with_grads=False)
                return costs
            # Deferred-gradient route: stats + the bidirectional walk now
            # (one read of the band tensor); the gradient pass (one read +
            # one write) runs in backward with the cotangent folded in.
            costs, res = banded_deferred_fwd(logits_band, labels,
                                             input_lengths, label_lengths,
                                             bands, blank_id)
            ctx.save_for_backward(logits_band, labels, input_lengths,
                                  label_lengths, band_min, band_max, *res)
            return costs
        costs, grads = rnnt_loss_banded_reference(
            logits_band, labels, input_lengths, label_lengths, bands,
            blank_id=blank_id, with_grads=need_grad)
        if need_grad:
            ctx.logits_dtype = logits_band.dtype
            ctx.save_for_backward(grads)
        return costs

    @staticmethod
    @spanned("mrnnt.loss.backward")
    @once_differentiable
    def backward(ctx, cost_cotangent):
        if ctx.backend == "cuda":
            from .cuda.banded import banded_deferred_bwd
            (logits_band, labels, input_lengths, label_lengths, band_min,
             band_max, *res) = ctx.saved_tensors
            dlogits = banded_deferred_bwd(
                logits_band, labels, input_lengths, label_lengths,
                Bands(band_min, band_max), tuple(res), cost_cotangent,
                ctx.blank_id)
        else:
            (grads,) = ctx.saved_tensors
            dlogits = (grads * cost_cotangent[:, None, None, None]).to(
                ctx.logits_dtype)
        return dlogits, None, None, None, None, None, None, None


@spanned("mrnnt.loss")
def monotonic_rnnt_loss_banded(
    logits_band: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    *,
    bands: Bands,
    blank_id: int = 0,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Alignment-restricted monotonic RNN-T loss on the packed band layout.

    The long-utterance fast path: with a width-W band around a known
    alignment (bands_from_alignment), the loss's compute and memory scale
    with W instead of S_max+1.

    Args:
      logits_band: [B, T_max, W, V] packed joint activations, f32 or bf16
        (see bands.compute_band_layout / pack_band for the slot <-> lattice
        map).
      labels / input_lengths / label_lengths: as monotonic_rnnt_loss.
      bands: the restriction being scored. Must satisfy the packed-layout
        contract (offset increments in {0, 1}; check with
        bands.band_layout_is_exact, size W with bands.suggested_band_width).
        Wider spans are clipped to W.
      backend: 'auto' (default; the CUDA kernels for CUDA tensors, the
        oracle for CPU tensors), 'cuda', or 'reference'.

    The labels, lengths and bands are moved to the logits' device.

    Returns [B] f32 costs, differentiable w.r.t. logits_band; the gradient
    comes in the packed layout and the logits' dtype.
    """
    if logits_band.dim() != 4:
        raise RnntError(Status.INVALID_VALUE,
                        "logits_band must be [B, T, W, V], got shape "
                        f"{tuple(logits_band.shape)}")
    s1 = labels.shape[1] + 1
    if logits_band.shape[2] > s1:
        raise RnntError(Status.INVALID_VALUE,
                        f"band width {logits_band.shape[2]} exceeds S_max+1="
                        f"{s1}; use monotonic_rnnt_loss for unbanded lattices")
    batch, t_max, _, v = logits_band.shape
    validate_loss_inputs(torch.empty((batch, t_max, s1, v), device="meta"),
                         labels, input_lengths, label_lengths)
    return banded_loss_on_route(logits_band, labels, input_lengths,
                                label_lengths, bands, blank_id,
                                _resolve_backend(backend, logits_band))


def banded_loss_on_route(logits_band, labels, input_lengths, label_lengths,
                         bands: Bands, blank_id: int,
                         route: str) -> torch.Tensor:
    """monotonic_rnnt_loss_banded on a resolved route after its checks; as
    loss.loss_on_route, it also takes the 'cuda' route on CPU tensors."""
    dev = logits_band.device
    if not torch.is_grad_enabled():
        # Under no_grad, ctx.needs_input_grad still follows requires_grad;
        # a detached input keeps the call on the cost-only route.
        logits_band = logits_band.detach()
    with debug_timer(f"monotonic_rnnt_loss_banded[{route}]"):
        return _BandedCore.apply(
            logits_band, labels.to(dev),
            input_lengths.to(device=dev, dtype=torch.int32),
            label_lengths.to(device=dev, dtype=torch.int32),
            bands.min_s.to(device=dev, dtype=torch.int32),
            bands.max_s.to(device=dev, dtype=torch.int32), int(blank_id),
            route)
