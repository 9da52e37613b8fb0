"""Viterbi forced alignment and occupancy posteriors for the monotonic RNN-T lattice.

PyTorch counterpart of ``monotonic_rnnt_tpu/ops/alignment.py``. The Viterbi
recursion is the loss's forward DP with max in place of log-sum-exp:

  vit(t, s) = max( vit(t-1, s)   + log p(blank      | t, s),
                   vit(t-1, s-1) + log p(label[s-1] | t, s-1) )

with the same virtual start (vit(-1, s) = [s == 0] in log space), band
clamping and -inf boundary semantics; ties go to no-emit. Backpointers are
one bit per cell (emit or not), and the backtrace walks t back from T_max-1
carrying the current s. The recursion and the backtrace are ``lax.scan``
loops in the JAX package, not Pallas kernels; here they are torch loops
over t on the tensor's device, a few small ops a step.

The V-dependent statistics and the forward-backward of the occupancies come
from the CUDA kernels on CUDA tensors (unless the config backend is
'reference'): ``softmax_stats`` then
``fwdbwd_scan`` on the full lattice, ``softmax_stats_banded`` (whose
mask-folded streams are exactly the banded recursion's operands) then
``fwdbwd_scan_banded`` on the band. Otherwise they come from the
plain-torch oracles (ops/reference.py, ops/banded.py), as in the JAX
package. The alignments feed ``bands_from_alignment`` and the
alignment-restricted losses.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .banded import (band_forward_backward, band_labels,
                     band_occupancy_coefficients, band_stats)
from .bands import (Bands, band_final_slot, band_lattice_masks,
                    band_relative_bounds, compute_band_layout, default_bands,
                    lattice_masks)
from .cuda.banded import banded_deferred_fwd
from .cuda.banded_kernels import softmax_stats_banded
from .cuda.kernels import use_kernels
from .cuda.split_kernels import fwdbwd_scan, softmax_stats
from .helpers import (NEG_INF, extend_labels, mask_to_additive, shift_left_s,
                      shift_right_s)
from .reference import (_gather_ll, compute_stats, forward_backward,
                        occupancy_coefficients)


class ViterbiResult(NamedTuple):
    """alignment: [B, T_max] int32, the emitted symbol per frame (blank_id
    where no label is emitted, and on frames t >= T_b). score: [B] f32, the
    path's negative log-probability (the loss's scale; >= the loss, equal
    iff one path carries all the mass).
    """

    alignment: torch.Tensor
    score: torch.Tensor


def _use_kernels(x: torch.Tensor) -> bool:
    """The CUDA kernels where use_kernels(x) (a CUDA tensor, a backend
    other than 'reference'), else the oracles."""
    return use_kernels(x)


def _lengths(logits, labels, input_lengths, label_lengths):
    dev = logits.device
    return (labels.to(dev), input_lengths.to(device=dev, dtype=torch.int32),
            label_lengths.to(device=dev, dtype=torch.int32))


def _lattice_stats(logits, labels, slen, blank_id):
    """(lp_blank, lp_label) [B, T, S1] f32; lp_label -inf where s >= S_b."""
    if _use_kernels(logits):
        lab = extend_labels(labels, slen, logits.shape[2]).contiguous()
        _, lpb, lpl_raw = softmax_stats(logits.contiguous(), lab, blank_id)
        return lpb, torch.where(lab[:, None, :] >= 0, lpl_raw, NEG_INF)
    stats = compute_stats(logits, labels, slen, blank_id)
    return stats.lp_blank, stats.lp_label


def _t_major(x: torch.Tensor) -> torch.Tensor:
    """[B, T, ...] -> contiguous [T, B, ...]: each step reads one block."""
    return x.transpose(0, 1).contiguous()


def _backtrace(bptr, first_slot, width, active, slen, labels, blank_id):
    """Alignment from the backpointers ([T, B, width] bool, t-major).

    first_slot: [T, B] lattice index of slot 0 (zeros on the full lattice),
    active: [T, B] t < T_b. Frames t >= T_b keep s at S_b and emit blank;
    an emit at (t, s) moves s to s-1 and emits labels[s-1]. A lattice cell
    outside [first_slot, first_slot + width) has no backpointer and emits
    nothing, as the JAX backtrace.
    """
    t_max, batch, _ = bptr.shape
    s_cur = slen.to(torch.int64)[:, None]
    s_after = torch.empty((t_max, batch, 1), dtype=torch.int64,
                          device=bptr.device)
    off = first_slot.to(torch.int64)[:, :, None]
    act = active.to(torch.int64)[:, :, None]
    for t in range(t_max - 1, -1, -1):
        slot = s_cur - off[t]
        clamped = slot.clamp(0, width - 1)
        # The emit bit at slot 0 (s = 0 on the full lattice) is never set:
        # emit reads -inf there, and a tie goes to no-emit.
        took = torch.gather(bptr[t], 1, clamped) & (slot == clamped)
        s_cur = s_cur - took * act[t]
        s_after[t] = s_cur
    s_after = s_after[:, :, 0].transpose(0, 1)               # [B, T]
    s_before = torch.cat([s_after[:, 1:], slen.to(torch.int64)[:, None]], 1)
    s1 = labels.shape[1] + 1
    lab_pad = torch.cat(
        [labels.to(torch.int32),
         torch.zeros((batch, s1 - labels.shape[1]), dtype=torch.int32,
                     device=labels.device)], dim=1)
    emitted = torch.gather(lab_pad, 1, s_after.clamp(0, s1 - 1))
    return torch.where(s_after < s_before, emitted,
                       blank_id).to(torch.int32)


def viterbi_alignment(
    logits: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    *,
    blank_id: int = 0,
    bands: Optional[Bands] = None,
) -> ViterbiResult:
    """Best monotonic alignment path and its score.

    Args match monotonic_rnnt_loss (padded layout, raw logits). When `bands`
    is given, the search is clamped to the band (restricted re-alignment).
    """
    labels, ilen, slen = _lengths(logits, labels, input_lengths,
                                  label_lengths)
    batch, t_max, s1, _ = logits.shape
    if bands is None:
        bands = default_bands(ilen, slen, t_max)
    masks = lattice_masks(ilen, slen, bands, t_max, s1)
    lpb, lpl = _lattice_stats(logits, labels, slen, blank_id)
    lpb, lpl_sh = _t_major(lpb), _t_major(shift_right_s(lpl))
    drop = _t_major(~masks.alpha)
    dev = logits.device

    # buf[:, 1:] holds vit(t-1, .); buf[:, :-1] is it shifted one slot up,
    # with the -inf of buf[:, 0] at s = 0.
    buf = torch.full((batch, s1 + 1), NEG_INF, dtype=torch.float32,
                     device=dev)
    buf[:, 1] = 0.0
    carry, shifted = buf[:, 1:], buf[:, :-1]
    vit = torch.empty((t_max, batch, s1), dtype=torch.float32, device=dev)
    bptr = torch.empty((t_max, batch, s1), dtype=torch.bool, device=dev)
    for t in range(t_max):
        no_emit = carry + lpb[t]
        emit = shifted + lpl_sh[t]
        torch.gt(emit, no_emit, out=bptr[t])      # ties go to no-emit
        torch.maximum(no_emit, emit, out=carry)
        carry.masked_fill_(drop[t], NEG_INF)
        vit[t] = carry

    b_idx = torch.arange(batch, device=dev)
    score = -vit[(ilen.to(torch.int64) - 1).clamp(min=0), b_idx,
                 slen.to(torch.int64)]
    t_idx = torch.arange(t_max, dtype=torch.int32, device=dev)[:, None]
    alignment = _backtrace(bptr, torch.zeros((t_max, batch), dtype=torch.int32,
                                             device=dev),
                           s1, t_idx < ilen[None, :], slen, labels, blank_id)
    return ViterbiResult(alignment=alignment, score=score)


def _band_operands(logits_band, labels, ilen, slen, bands, blank_id):
    """(layout, lpb + amask, lpl + amask shifted one slot), [B, T, W] f32."""
    _, t_max, w, _ = logits_band.shape
    s1 = labels.shape[1] + 1
    layout = compute_band_layout(ilen, slen, bands, t_max, s1, w)
    lab_band = band_labels(labels, slen, layout, s1)
    if _use_kernels(logits_band):
        rel = tuple(r.contiguous() for r in band_relative_bounds(
            ilen, slen, bands, layout, t_max, s1))
        _, lpbm, lplm = softmax_stats_banded(logits_band.contiguous(),
                                             lab_band.contiguous(), rel,
                                             blank_id, with_beta=False)
        return layout, lpbm, lplm
    masks = band_lattice_masks(ilen, slen, bands, layout, t_max, s1)
    stats = band_stats(logits_band, lab_band, blank_id)
    amask = mask_to_additive(masks.alpha)
    return (layout, stats.lp_blank + amask,
            stats.lp_label + shift_left_s(amask))


def viterbi_alignment_banded(
    logits_band: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    *,
    bands: Bands,
    blank_id: int = 0,
) -> ViterbiResult:
    """Best path on the packed band layout: O(W) restricted re-alignment.

    The realignment loop of alignment-restricted training (align -> train
    restricted -> re-align in a band around the previous alignment) never
    needs the full lattice: this searches [B, T, W, V] band logits (see
    bands.compute_band_layout / monotonic_rnnt_loss_banded for the layout
    contract) with viterbi_alignment's recursion in band coordinates
    (alpha(t-1) realigned by the window shift d[t]) and a backtrace in
    lattice coordinates. Same result as viterbi_alignment with
    clip_bands_to_width(bands) on the full lattice.
    """
    labels, ilen, slen = _lengths(logits_band, labels, input_lengths,
                                  label_lengths)
    batch, t_max, w, _ = logits_band.shape
    layout, lpbm, lplm = _band_operands(logits_band, labels, ilen, slen,
                                        bands, blank_id)
    lpbm, lplm_sh = _t_major(lpbm), _t_major(shift_right_s(lplm))
    shifted = _t_major(layout.d[:, :, None] == 1)
    dev = logits_band.device

    # buf[:, 1:-1] holds vit(t-1, .) with a -inf slot at each end;
    # aligned = vit(t-1) in t's coordinates, in abuf[:, 1:] behind a -inf.
    buf = torch.full((batch, w + 2), NEG_INF, dtype=torch.float32,
                     device=dev)
    buf[:, 1] = 0.0
    carry = buf[:, 1:-1]
    abuf = torch.full((batch, w + 1), NEG_INF, dtype=torch.float32,
                      device=dev)
    aligned, aligned_up = abuf[:, 1:], abuf[:, :-1]
    vit = torch.empty((t_max, batch, w), dtype=torch.float32, device=dev)
    bptr = torch.empty((t_max, batch, w), dtype=torch.bool, device=dev)
    for t in range(t_max):
        torch.where(shifted[t], buf[:, 2:], carry, out=aligned)
        no_emit = aligned + lpbm[t]
        emit = aligned_up + lplm_sh[t]
        torch.gt(emit, no_emit, out=bptr[t])      # ties go to no-emit
        torch.maximum(no_emit, emit, out=carry)
        vit[t] = carry

    score = -band_final_slot(vit.transpose(0, 1), layout, ilen, slen)
    t_idx = torch.arange(t_max, dtype=torch.int32, device=dev)[:, None]
    alignment = _backtrace(bptr, layout.offset.transpose(0, 1), w,
                           t_idx < ilen[None, :], slen, labels, blank_id)
    return ViterbiResult(alignment=alignment, score=score)


def occupancy_posteriors(
    logits: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    *,
    blank_id: int = 0,
    bands: Optional[Bands] = None,
) -> torch.Tensor:
    """Per-cell occupancy posteriors gamma[b, t, s] = p(path visits (t, s)).

    gamma(t, s) = exp(alpha(t-1, s) + beta(t, s) - ll): the probability mass
    of all monotonic paths that occupy lattice cell (t, s), the quantity the
    gradient formula is built from (reference README.md "Gradients"), for
    confidence estimation, soft-alignment distillation and diagnostics.
    Rows sum to 1 over s for every valid frame t < T_b (and to 0 beyond).
    Returns [B, T_max, S_max+1] f32.
    """
    labels, ilen, slen = _lengths(logits, labels, input_lengths,
                                  label_lengths)
    _, t_max, s1, _ = logits.shape
    if bands is None:
        bands = default_bands(ilen, slen, t_max)
    masks = lattice_masks(ilen, slen, bands, t_max, s1)
    if _use_kernels(logits):
        lpb, lpl = _lattice_stats(logits, labels, slen, blank_id)
        s_idx = torch.arange(s1, dtype=torch.int32, device=logits.device)
        alphas, betas = fwdbwd_scan(
            lpb, lpl, mask_to_additive(masks.alpha),
            mask_to_additive(masks.beta), ilen.contiguous(),
            mask_to_additive(s_idx[None, :] == slen[:, None]))
        ll = _gather_ll(alphas, ilen, slen)
    else:
        stats = compute_stats(logits, labels, slen, blank_id)
        alphas, betas, ll, _ = forward_backward(stats, masks, ilen, slen)
    occ, _, _ = occupancy_coefficients(alphas, betas, ll, ilen, slen)
    return occ


def occupancy_posteriors_banded(
    logits_band: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    *,
    bands: Bands,
    blank_id: int = 0,
) -> torch.Tensor:
    """Packed-layout gamma[b, t, w] = p(path visits (t, offset[t] + w)).

    Banded counterpart of occupancy_posteriors, [B, T_max, W] f32
    (bands.unpack_band scatters it back to the lattice if needed).
    """
    labels, ilen, slen = _lengths(logits_band, labels, input_lengths,
                                  label_lengths)
    _, t_max, w, _ = logits_band.shape
    s1 = labels.shape[1] + 1
    layout = compute_band_layout(ilen, slen, bands, t_max, s1, w)
    if _use_kernels(logits_band):
        _, (_, alphas, betas, ll) = banded_deferred_fwd(
            logits_band.contiguous(), labels, ilen, slen, bands, blank_id)
    else:
        masks = band_lattice_masks(ilen, slen, bands, layout, t_max, s1)
        stats = band_stats(logits_band, band_labels(labels, slen, layout, s1),
                           blank_id)
        alphas, betas, ll = band_forward_backward(stats, masks, layout, ilen,
                                                  slen)
    occ, _, _ = band_occupancy_coefficients(alphas, betas, ll, ilen, slen,
                                            layout)
    return occ
