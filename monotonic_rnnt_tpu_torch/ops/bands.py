"""Lattice reachability bands for the monotonic RNN-T alignment lattice.

PyTorch counterpart of ``monotonic_rnnt_tpu/ops/bands.py:24-129``:
per-(b, t) label-count windows and the boolean masks they imply over the
padded [B, T, S+1] lattice (reference cpu_workspace_manager.h:67-86,
161-224). The packed band layout (bands.py:130 onwards) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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
