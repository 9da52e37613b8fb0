"""Lattice reachability bands for the monotonic RNN-T alignment lattice.

PyTorch counterpart of ``monotonic_rnnt_tpu/ops/bands.py``: per-(b, t)
label-count windows and the boolean masks they imply over the padded
[B, T, S+1] lattice (reference cpu_workspace_manager.h:67-86, 161-224), and
the packed band layout that re-indexes the s axis into a static-width
window (bands.py:132-389).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import to_host
from .helpers import take_index


class Bands(NamedTuple):
    """Per-(b, t) allowed label-count window [min_s, max_s], both inclusive.

    Shapes: [B, T_max] int32. Defaults are [0, S_b] (unrestricted).
    """

    min_s: torch.Tensor
    max_s: torch.Tensor


def default_bands(input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                  t_max: int) -> Bands:
    """Unrestricted bands: min=0, max=S_b for every t (cpu_workspace_manager.h:53-56)."""
    batch = input_lengths.shape[0]
    min_s = torch.zeros((batch, t_max), dtype=torch.int32,
                        device=input_lengths.device)
    max_s = label_lengths.to(torch.int32)[:, None].expand(batch, t_max)
    return Bands(min_s, max_s.contiguous())


def bands_from_alignment(alignment: torch.Tensor, input_lengths: torch.Tensor,
                         label_lengths: torch.Tensor, max_shift: int,
                         blank_id: int) -> Bands:
    """Viterbi band around a reference alignment.

    Matches reference restrict_to_alignment (cpu_workspace_manager.h:207-224):
      s_index_mapping[t+1] = number of non-blank symbols in alignment[0..t];
      min_allowed_s[t] = mapping[max(0, t+1-max_shift)]
      max_allowed_s[t] = mapping[min(T_b, t+1+max_shift)]

    Args:
      alignment: [B, T_max] int label ids (blank_id marks blank frames).
      input_lengths: [B] frames per sample.
      label_lengths: [B] labels per sample.
      max_shift: window half-width in frames; 0 pins the lattice to the
        alignment path exactly.
      blank_id: index of the blank symbol.
    """
    batch, t_max = alignment.shape
    dev = alignment.device
    ilen = input_lengths.to(torch.int32)[:, None]
    t_idx = torch.arange(t_max, dtype=torch.int32, device=dev)[None, :]
    nonblank = (alignment != blank_id) & (t_idx < ilen)
    # mapping[b, k] = #nonblank in alignment[b, :k]; shape [B, T_max+1].
    mapping = torch.cat(
        [torch.zeros((batch, 1), dtype=torch.int32, device=dev),
         torch.cumsum(nonblank.to(torch.int32), dim=1, dtype=torch.int32)],
        dim=1)
    lo_idx = torch.minimum((t_idx + 1 - max_shift).clamp(min=0), ilen)
    hi_idx = torch.minimum((t_idx + 1 + max_shift).clamp(min=0), ilen)
    min_s = torch.gather(mapping, 1, lo_idx.to(torch.int64))
    max_s = torch.gather(mapping, 1, hi_idx.to(torch.int64))
    # Guard against alignments containing more labels than label_lengths.
    slen = label_lengths.to(torch.int32)[:, None]
    return Bands(torch.minimum(min_s, slen), torch.minimum(max_s, slen))


class LatticeMasks(NamedTuple):
    """Boolean reachability masks over the padded [B, T_max, S_max+1] lattice.

    alpha[b, t, s]: alpha(t, s) is computed/stored (else exactly -inf).
    beta[b, t, s]: beta(t, s) likewise (its band is the allowed window at
      t-1, cpu_workspace_manager.h:73-86, 196).
    """

    alpha: torch.Tensor
    beta: torch.Tensor


def _window_bounds(input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                   bands: Bands, t_max: int, s1: int):
    """Per-(b, t) inclusive alpha/beta window bounds (a_lo, a_hi, b_lo, b_hi).

    alpha window at t (cpu_workspace_manager.h:67-71):
        max(min_s[t], t - (T-1-S)) <= s <= min(max_s[t], t+1, S)
    beta window at t (cpu_workspace_manager.h:73-86):
        t == 0: s == 0
        else:   max(min_s[t-1], t - (T-S)) <= s <= min(max_s[t-1], t, S)
    All four are [B, T] int32 (hi < lo means an empty window).
    """
    ilen = input_lengths.to(torch.int32)[:, None]
    slen = label_lengths.to(torch.int32)[:, None]
    t_idx = torch.arange(t_max, dtype=torch.int32,
                         device=input_lengths.device)[None, :]
    min_s = bands.min_s.to(torch.int32)
    max_s = bands.max_s.to(torch.int32)

    a_lo = torch.maximum(min_s, t_idx - (ilen - 1 - slen))
    a_hi = torch.minimum(torch.minimum(max_s, t_idx + 1), slen)

    prev_min = torch.cat([torch.zeros_like(min_s[:, :1]), min_s[:, :-1]], dim=1)
    prev_max = torch.cat([torch.full_like(max_s[:, :1], s1), max_s[:, :-1]],
                         dim=1)
    b_lo = torch.maximum(prev_min, t_idx - (ilen - slen))
    b_hi = torch.minimum(torch.minimum(prev_max, t_idx), slen)
    return a_lo, a_hi, b_lo, b_hi


def lattice_masks(input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                  bands: Bands, t_max: int, s1: int) -> LatticeMasks:
    """Build alpha/beta reachability masks (see _window_bounds), plus t < T_b."""
    dev = input_lengths.device
    ilen = input_lengths.to(torch.int32)[:, None, None]
    s_idx = torch.arange(s1, dtype=torch.int32, device=dev)[None, None, :]
    t_idx = torch.arange(t_max, dtype=torch.int32, device=dev)[None, :, None]
    a_lo, a_hi, b_lo, b_hi = _window_bounds(
        input_lengths, label_lengths, bands, t_max, s1)
    valid_t = t_idx < ilen
    alpha = (s_idx >= a_lo[:, :, None]) & (s_idx <= a_hi[:, :, None]) & valid_t
    beta = (s_idx >= b_lo[:, :, None]) & (s_idx <= b_hi[:, :, None]) & valid_t
    return LatticeMasks(alpha=alpha, beta=beta)


# ---------------------------------------------------------------------------
# Packed band layout
# ---------------------------------------------------------------------------
#
# The lattice's s axis is re-indexed into a packed window of static width W:
# packed[b, t, w] <-> lattice[b, t, offset[b, t] + w], so all loss traffic
# scales with W instead of S+1 (the reference prunes storage and compute to
# the band: cpu_workspace_manager.h:286-297, gpu_rnnt_kernel.h:58-72).
#
# The layout is valid when offset increments are in {0, 1} per time step,
# as bands_from_alignment and the structural band guarantee. Faster-growing
# min_s is clamped, which tightens such bands; band_layout_is_exact says so.


class BandLayout(NamedTuple):
    """Static-width packed view of a banded [B, T, S+1] lattice.

    offset:  [B, T] int32, lattice s-index of packed slot w=0 at time t;
             nondecreasing with per-step increments in {0, 1}.
    d:       [B, T] int32, offset[t] - offset[t-1] (offset[-1] := 0), the
             per-step window shift the banded DP kernels consume.
    d_next:  [B, T] int32, d[t+1] (0 at t = T-1), consumed by the backward
             scan and the occupancy shifts.
    width:   int W; packed tensors have shape [B, T, W(, V)].
    """

    offset: torch.Tensor
    d: torch.Tensor
    d_next: torch.Tensor
    width: int


def _lag(x: torch.Tensor, first) -> torch.Tensor:
    """x shifted one step later along t: out[:, 0] = first, out[:, t] = x[:, t-1]."""
    return torch.cat([torch.full_like(x[:, :1], first), x[:, :-1]], dim=1)


def _raw_offsets(input_lengths, label_lengths, bands: Bands, t_max: int,
                 s1: int) -> torch.Tensor:
    """Unclipped packed-window offsets: the beta window's lower bound.

    The beta lower bound is pointwise <= the alpha one, so it anchors both
    DP windows. Increments outside {0, 1} are clamped.
    """
    _, _, b_lo, _ = _window_bounds(input_lengths, label_lengths, bands,
                                   t_max, s1)
    slen = label_lengths.to(torch.int32)[:, None]
    o = torch.minimum(b_lo.clamp(min=0), slen)
    return torch.cumsum((o - _lag(o, 0)).clamp(0, 1), dim=1, dtype=torch.int32)


def compute_band_layout(input_lengths: torch.Tensor,
                        label_lengths: torch.Tensor, bands: Bands,
                        t_max: int, s1: int, width: int) -> BandLayout:
    """The packed window layout for `bands` at width `width` (capped at s1).

    offset[t] is the beta window's lower bound at t-1 (offset[0] = 0), one
    step behind the band, so that the window at t also covers the alpha
    band of t-1: the emit transition into alpha(t, s) reads lp_label at
    (t, s-1), and the gradient at (t, s) is nonzero wherever alpha(t-1, s)
    is finite. Offsets are clipped so [offset, offset + W) stays inside
    [0, s1); clipping by a constant keeps the {0, 1} increments.
    """
    width = int(min(width, s1))
    o_raw = _raw_offsets(input_lengths, label_lengths, bands, t_max, s1)
    offset = _lag(o_raw, 0).clamp(max=s1 - width)
    d = offset - _lag(offset, 0)
    d_next = torch.cat([d[:, 1:], torch.zeros_like(d[:, :1])], dim=1)
    return BandLayout(offset=offset, d=d, d_next=d_next, width=width)


def _t_valid(input_lengths: torch.Tensor, t_max: int) -> torch.Tensor:
    t_idx = torch.arange(t_max, dtype=torch.int32, device=input_lengths.device)
    return t_idx[None, :] < input_lengths.to(torch.int32)[:, None]


def band_layout_is_exact(input_lengths, label_lengths, bands: Bands,
                         t_max: int, s1: int, width: int) -> torch.Tensor:
    """[B] bool: the packed (layout, width) covers both DP windows exactly.

    False means the packed path computes the loss of a tighter band than
    requested (offset increments were clamped, or the window span exceeds
    width).
    """
    layout = compute_band_layout(input_lengths, label_lengths, bands, t_max,
                                 s1, width)
    a_lo, a_hi, b_lo, b_hi = _window_bounds(input_lengths, label_lengths,
                                            bands, t_max, s1)
    # The window at t must also hold the alpha band of t-1; at t = 0 that is
    # the virtual cell s = 0.
    pa_lo, pa_hi = _lag(a_lo, 0), _lag(a_hi, 0)
    top = layout.offset + layout.width - 1

    def covered(lo, hi):
        return (hi < lo) | ((lo >= layout.offset) & (hi <= top))

    ok = covered(a_lo, a_hi) & covered(b_lo, b_hi) & covered(pa_lo, pa_hi)
    return (ok | ~_t_valid(input_lengths, t_max)).all(dim=1)


def required_band_width(input_lengths, label_lengths, bands: Bands,
                        t_max: int, s1: int) -> torch.Tensor:
    """Smallest W for which band_layout_is_exact holds (0-d int32 tensor).

    A sizing helper for concrete bands, called once by the user; clipping
    the width-W layout's offsets to s1 - W only lowers them, so the span
    measured here stays covered.
    """
    offset = _lag(_raw_offsets(input_lengths, label_lengths, bands, t_max,
                               s1), 0)
    a_lo, a_hi, b_lo, b_hi = _window_bounds(input_lengths, label_lengths,
                                            bands, t_max, s1)
    span = torch.maximum(torch.maximum(a_hi, b_hi), _lag(a_hi, 0)) - offset + 1
    return torch.where(_t_valid(input_lengths, t_max), span, 1).max()


def suggested_band_width(input_lengths, label_lengths, bands: Bands,
                         t_max: int, s1: int) -> int:
    """required_band_width rounded up to a multiple of 8, capped at s1.

    The rounding is part of the answer: the JAX package rounds to its
    sublane tiling, and the port picks the same W.
    """
    req = int(to_host(required_band_width(input_lengths, label_lengths,
                                          bands, t_max, s1), "bands.width"))
    return int(min(s1, -(-req // 8) * 8))


def clip_bands_to_width(bands: Bands, layout: BandLayout) -> Bands:
    """The bands the packed path actually computes: max_s clipped to the window."""
    return Bands(bands.min_s, torch.minimum(bands.max_s.to(torch.int32),
                                            layout.offset + layout.width - 1))


def band_relative_bounds(input_lengths, label_lengths, bands: Bands,
                         layout: BandLayout, t_max: int, s1: int):
    """Per-(b, t) inclusive DP windows in packed slot coordinates.

    Returns (ra_lo, ra_hi, rb_lo, rb_hi), each [B, T] int32: the alpha/beta
    window at t relative to layout.offset[t], width clipping applied.
    Frames t >= T_b get an empty window (lo=1, hi=0). The oracle's masks and
    the banded stats kernel both come from these bounds.
    """
    clipped = clip_bands_to_width(bands, layout)
    a_lo, a_hi, b_lo, b_hi = _window_bounds(input_lengths, label_lengths,
                                            clipped, t_max, s1)
    valid_t = _t_valid(input_lengths, t_max)

    def rel(lo, hi):
        return (torch.where(valid_t, lo - layout.offset, 1).to(torch.int32),
                torch.where(valid_t, hi - layout.offset, 0).to(torch.int32))

    return (*rel(a_lo, a_hi), *rel(b_lo, b_hi))


def band_lattice_masks(input_lengths, label_lengths, bands: Bands,
                       layout: BandLayout, t_max: int,
                       s1: int) -> LatticeMasks:
    """Alpha/beta reachability masks in packed band coordinates [B, T, W]."""
    ra_lo, ra_hi, rb_lo, rb_hi = band_relative_bounds(
        input_lengths, label_lengths, bands, layout, t_max, s1)
    w_idx = torch.arange(layout.width, dtype=torch.int32,
                         device=ra_lo.device)[None, None, :]
    alpha = (w_idx >= ra_lo[:, :, None]) & (w_idx <= ra_hi[:, :, None])
    beta = (w_idx >= rb_lo[:, :, None]) & (w_idx <= rb_hi[:, :, None])
    return LatticeMasks(alpha=alpha, beta=beta)


def band_final_slot(values_band: torch.Tensor, layout: BandLayout,
                    input_lengths: torch.Tensor,
                    label_lengths: torch.Tensor) -> torch.Tensor:
    """values_band[b, T_b-1, slot of s = S_b], -inf when out of the window.

    With width clipping the final cell can fall outside the packed window;
    the lattice is then infeasible under the clipped band. So is a T_b past
    T_max, which only an exported artifact (no length checks) can see:
    JAX's gather fills the offset with INT_MIN there, which puts S_b out
    of the window.
    """
    w = values_band.shape[-1]
    last_t, in_bounds = take_index(
        (input_lengths.to(torch.int64) - 1).clamp(min=0), values_band.shape[1])
    b_idx = torch.arange(values_band.shape[0], device=values_band.device)
    w_ll = label_lengths.to(torch.int64) - layout.offset[b_idx, last_t]
    out = values_band[b_idx, last_t, w_ll.clamp(0, w - 1)]
    return torch.where(in_bounds & (w_ll >= 0) & (w_ll < w), out,
                       float("-inf"))


def band_virtual_next_rows(layout: BandLayout,
                           label_lengths: torch.Tensor) -> torch.Tensor:
    """[B, T, W] f32 additive rows: beta(t+1, s) = [s == S_b] in t+1's coords.

    The virtual terminal boundary the banded backward scans consume at
    t = T_b - 1, at offset[t] + d_next[t] (= offset[t+1]).
    """
    slen = label_lengths.to(torch.int32)[:, None, None]
    w_idx = torch.arange(layout.width, dtype=torch.int32,
                         device=layout.offset.device)[None, None, :]
    o_next = (layout.offset + layout.d_next)[:, :, None]
    return torch.where(o_next + w_idx == slen, 0.0,
                       float("-inf")).to(torch.float32)


def _band_index(x: torch.Tensor, layout: BandLayout) -> torch.Tensor:
    """Lattice s-index of every packed slot, shaped to gather x's s axis."""
    w_idx = torch.arange(layout.width, dtype=torch.int64,
                         device=layout.offset.device)
    idx = layout.offset.to(torch.int64)[:, :, None] + w_idx
    if x.dim() == 4:
        return idx[..., None].expand(*idx.shape, x.shape[3])
    return idx


def pack_band(x: torch.Tensor, layout: BandLayout) -> torch.Tensor:
    """Gather lattice rows into the packed window.

    x: [B, T, S1] or [B, T, S1, V] -> [B, T, W(, V)]; reads only the
    gathered rows.
    """
    return torch.gather(x, 2, _band_index(x, layout))


def unpack_band(x_band: torch.Tensor, layout: BandLayout, s1: int,
                fill=0.0) -> torch.Tensor:
    """Scatter a packed [B, T, W(, V)] tensor back to the [B, T, S1(, V)] lattice.

    Out-of-band cells get `fill`. Costs a full-lattice write: for the
    boundary to full-layout consumers (tests, interop) only.
    """
    shape = x_band.shape[:2] + (s1,) + x_band.shape[3:]
    out = torch.full(shape, fill, dtype=x_band.dtype, device=x_band.device)
    return out.scatter_(2, _band_index(x_band, layout), x_band)
