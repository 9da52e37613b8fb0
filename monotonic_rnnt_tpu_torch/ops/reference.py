"""Plain-PyTorch reference implementation of the monotonic RNN-T loss.

PyTorch counterpart of ``monotonic_rnnt_tpu/ops/reference.py``, the port's
oracle: a direct transcription of the forward-backward recurrences on a
padded [B, T_max, S_max+1, V] lattice, with a Python loop over t. It is the
CPU path and the ``backend="reference"`` path on any device.

Math contract (reference README.md "Forward-backward"/"Gradients",
include/cpu_rnnt.h:155-236):

  log p(v | t, s)  = logits[t, s, v] + denom[t, s],
      denom = -logsumexp_v logits[t, s, :]
  alpha(t, s) = LSE( alpha(t-1, s)   + log p(blank   | t, s),
                     alpha(t-1, s-1) + log p(label[s-1] | t, s-1) )
      alpha(-1, s) = [s == 0] in log space
  beta(t, s)  = LSE( beta(t+1, s)   + log p(blank    | t, s),
                     beta(t+1, s+1) + log p(label[s] | t, s) )
      beta(T, s) = [s == S] in log space
  loss = -alpha(T-1, S) = -beta(0, 0)

  dL/dz[t, s, v] = p(v|t,s) * ( exp(alpha(t-1,s) + beta(t,s)   - ll)
        - [v == blank]    * exp(alpha(t-1,s) + beta(t+1,s)   - ll)
        - [v == label[s]] * exp(alpha(t-1,s) + beta(t+1,s+1) - ll) )

All recurrences run in float32 log space regardless of input dtype.

Two choices differ from the JAX oracle only where it would produce NaN:
the reachability masks are applied with ``where`` instead of adding an
additive -inf mask, and the gradient is zero wherever its coefficient is
zero (the guard the Pallas kernels apply), except on the lattice cells of a
sample whose cost is not finite. With +-inf logits in padding cells the
JAX oracle returns NaN; this one returns the padding-independent cost and
a zero gradient there. A sample whose cost is NaN (a non-finite logit in a
lattice cell) has all-zero coefficients in both oracles, and its lattice
cells take p * 0 as the JAX oracle's do: NaN where p is not finite. On
finite inputs the two agree.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.debug import emit_loss_debug
from .bands import Bands, LatticeMasks, default_bands, lattice_masks
from .helpers import (NEG_INF, extend_labels, log_sum_exp, mask_to_additive,
                      select_label_logits, shift_left_s, shift_right_s,
                      take_index)


class LatticeStats(NamedTuple):
    """Per-cell softmax statistics, the only V-dependent inputs to the DP.

    denom:    [B, T, S1] f32, -logsumexp_v(logits)
    lp_blank: [B, T, S1] f32, log p(blank | t, s)
    lp_label: [B, T, S1] f32, log p(label[s] | t, s); -inf where s >= S_b.
    """

    denom: torch.Tensor
    lp_blank: torch.Tensor
    lp_label: torch.Tensor


def compute_stats(logits: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor, blank_id: int) -> LatticeStats:
    """Log-softmax statistics over the vocab axis."""
    x = logits.float()
    denom = -torch.logsumexp(x, dim=-1)
    lp_blank = x[..., blank_id] + denom

    s1 = x.shape[2]
    lab_ext = extend_labels(labels, label_lengths, s1)
    gathered = select_label_logits(x, lab_ext[:, None, :])
    lp_label = torch.where((lab_ext >= 0)[:, None, :], gathered + denom,
                           NEG_INF)
    return LatticeStats(denom=denom, lp_blank=lp_blank, lp_label=lp_label)


def _gather_ll(alphas: torch.Tensor, input_lengths: torch.Tensor,
               label_lengths: torch.Tensor) -> torch.Tensor:
    """alphas[b, T_b - 1, S_b] for every b.

    The gather follows JAX's take_along_axis: NaN where T_b > T_max or S_b
    is out of bounds. A live call has validated the lengths; an exported
    artifact checks no length values, and there this costs such a sample
    NaN with a zero gradient, as JAX's artifact does."""
    b_idx = torch.arange(alphas.shape[0], device=alphas.device)
    t_last, t_ok = take_index((input_lengths.to(torch.int64) - 1).clamp(min=0),
                              alphas.shape[1])
    s_last, s_ok = take_index(label_lengths.to(torch.int64), alphas.shape[2])
    return torch.where(t_ok & s_ok, alphas[b_idx, t_last, s_last],
                       float("nan"))


def forward_backward(stats: LatticeStats, masks: LatticeMasks,
                     input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                     compute_betas: bool = True):
    """Run the alpha (and optionally beta) scans.

    Returns (alphas, betas, ll_fwd, ll_bwd); alphas/betas are [B, T, S1] with
    exact -inf outside the reachable band, betas/ll_bwd are None when
    compute_betas is False (the cost-only fast path, reference gpu_rnnt.h:139).
    """
    batch, t_max, s1 = stats.lp_blank.shape
    dev = stats.lp_blank.device
    ilen = input_lengths.to(torch.int32)
    slen = label_lengths.to(torch.int32)
    s_idx = torch.arange(s1, dtype=torch.int32, device=dev)[None, :]

    # Virtual starts: alpha(-1, s) = [s == 0]; beta(T_b, s) = [s == S_b].
    carry = mask_to_additive(s_idx == 0).expand(batch, s1)
    beta_virtual = mask_to_additive(s_idx == slen[:, None])

    alphas = torch.empty((batch, t_max, s1), dtype=torch.float32, device=dev)
    for t in range(t_max):
        no_emit = carry + stats.lp_blank[:, t]
        emit = shift_right_s(carry + stats.lp_label[:, t])
        carry = torch.where(masks.alpha[:, t], log_sum_exp(no_emit, emit),
                            NEG_INF)
        alphas[:, t] = carry
    ll_fwd = _gather_ll(alphas, ilen, slen)

    if not compute_betas:
        return alphas, None, ll_fwd, None

    betas = torch.empty_like(alphas)
    carry = torch.full((batch, s1), NEG_INF, dtype=torch.float32, device=dev)
    for t in range(t_max - 1, -1, -1):
        # Until t+1 < T_b, the "next" row is the virtual boundary row.
        use_virtual = (t + 1 >= ilen)[:, None]
        nxt = torch.where(use_virtual, beta_virtual, carry)
        no_emit = nxt + stats.lp_blank[:, t]
        emit = shift_left_s(nxt) + stats.lp_label[:, t]
        carry = torch.where(masks.beta[:, t], log_sum_exp(no_emit, emit),
                            NEG_INF)
        betas[:, t] = carry

    ll_bwd = betas[:, 0, 0]
    return alphas, betas, ll_fwd, ll_bwd


def occupancy_coefficients(alphas: torch.Tensor, betas: torch.Tensor,
                           ll: torch.Tensor, input_lengths: torch.Tensor,
                           label_lengths: torch.Tensor):
    """Per-cell gradient coefficients (V-independent part of dL/dz).

      occ[t,s] = exp(alpha(t-1,s) + beta(t,s)   - ll)
      cb[t,s]  = exp(alpha(t-1,s) + beta(t+1,s)   - ll)  (blank transition)
      cl[t,s]  = exp(alpha(t-1,s) + beta(t+1,s+1) - ll)  (label transition)

    Rows with t >= T_b are zero; infeasible lattices (ll == -inf) yield zero
    coefficients so gradients stay finite while the cost is +inf.
    """
    batch, t_max, s1 = alphas.shape
    dev = alphas.device
    ilen = input_lengths.to(torch.int32)
    slen = label_lengths.to(torch.int32)
    s_idx = torch.arange(s1, dtype=torch.int32, device=dev)[None, :]
    t_idx = torch.arange(t_max, dtype=torch.int32, device=dev)[None, :, None]

    alpha_virt = mask_to_additive(s_idx == 0).expand(batch, s1)
    alpha_prev = torch.cat([alpha_virt[:, None, :], alphas[:, :-1, :]], dim=1)

    beta_virt = mask_to_additive(s_idx == slen[:, None])
    beta_next = torch.cat(
        [betas[:, 1:, :],
         torch.full((batch, 1, s1), NEG_INF, dtype=torch.float32, device=dev)],
        dim=1)
    beta_next = torch.where(t_idx == (ilen[:, None, None] - 1),
                            beta_virt[:, None, :], beta_next)
    beta_next_up = shift_left_s(beta_next)

    ll_ok = torch.isfinite(ll)
    llb = torch.where(ll_ok, ll, 0.0)[:, None, None]
    valid_t = (t_idx < ilen[:, None, None]) & ll_ok[:, None, None]

    def _coef(b):
        return torch.where(valid_t, torch.exp(alpha_prev + b - llb), 0.0)

    return _coef(betas), _coef(beta_next), _coef(beta_next_up)


def nonfinite_cost_cells(ll: torch.Tensor, input_lengths: torch.Tensor,
                         label_lengths: torch.Tensor, cell_s: torch.Tensor,
                         t_max: int) -> torch.Tensor:
    """[B, T, S1] bool: the lattice cells (t < T_b, s <= S_b) of the samples
    whose ll is not finite. cell_s is each cell's lattice s, broadcastable
    to [B, T, S1]: the s index on the padded lattice, offset[t] + w on the
    band layout."""
    t_idx = torch.arange(t_max, dtype=torch.int32, device=ll.device)
    return ((~torch.isfinite(ll))[:, None, None]
            & (t_idx[None, :, None] < input_lengths[:, None, None])
            & (cell_s <= label_lengths[:, None, None]))


def gradients_from_coefficients(logits: torch.Tensor, denom: torch.Tensor,
                                labels: torch.Tensor,
                                label_lengths: torch.Tensor,
                                occ: torch.Tensor, cb: torch.Tensor,
                                cl: torch.Tensor, blank_id: int,
                                v_offset: int = 0,
                                open_cells: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Assemble dL/dz from per-cell coefficients.

      dL/dz[t,s,v] = p(v|t,s) * (occ - [v==blank]*cb - [v==label[s]]*cl)

    and exactly 0 where the coefficient is 0, so +-inf padding logits
    (p = NaN or inf there) cannot leak NaN into the gradient; open_cells
    ([B, T, S1] bool, nonfinite_cost_cells) lifts that guard, so those
    cells take p * coef as the JAX oracle's do. v_offset shifts local
    vocab indices to global ids (the vocab-sharded path, where this shard
    holds columns [v_offset, v_offset + V_local)).
    """
    s1, v = logits.shape[2], logits.shape[3]
    p = torch.exp(logits.float() + denom[..., None])

    lab_ext = extend_labels(labels, label_lengths, s1)

    v_idx = torch.arange(v, dtype=torch.int32, device=logits.device) + v_offset
    blank_mask = (v_idx == blank_id)[None, None, None, :]
    label_mask = v_idx[None, None, None, :] == lab_ext[:, None, :, None]

    coef = (occ[..., None]
            - torch.where(blank_mask, cb[..., None], 0.0)
            - torch.where(label_mask, cl[..., None], 0.0))
    zero = coef == 0.0
    if open_cells is not None:
        zero &= ~open_cells[..., None]
    return torch.where(zero, 0.0, p * coef)


def rnnt_loss_reference(
    logits: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int = 0,
    bands: Optional[Bands] = None,
    with_grads: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Monotonic RNN-T loss (and logit gradients) on a padded lattice.

    Args:
      logits: [B, T_max, S_max+1, V] raw (pre-softmax) activations.
      labels: [B, S_max] int.
      input_lengths / label_lengths: [B] int, with T_b >= S_b >= 0, T_b >= 1.
      blank_id: blank symbol index.
      bands: optional alignment-restriction bands (see bands.py).
      with_grads: when False, runs the alpha-only cost path.

    Returns (costs [B] f32, grads [B, T_max, S_max+1, V] f32 or None).
    """
    _, t_max, s1, _ = logits.shape
    if bands is None:
        bands = default_bands(input_lengths, label_lengths, t_max)
    masks = lattice_masks(input_lengths, label_lengths, bands, t_max, s1)
    stats = compute_stats(logits, labels, label_lengths, blank_id)

    alphas, betas, ll_fwd, ll_bwd = forward_backward(
        stats, masks, input_lengths, label_lengths, compute_betas=with_grads)
    costs = -ll_fwd
    if not with_grads:
        return costs, None

    occ, cb, cl = occupancy_coefficients(
        alphas, betas, ll_fwd, input_lengths, label_lengths)
    s_idx = torch.arange(s1, dtype=torch.int32, device=logits.device)
    grads = gradients_from_coefficients(
        logits, stats.denom, labels, label_lengths, occ, cb, cl, blank_id,
        open_cells=nonfinite_cost_cells(ll_fwd, input_lengths, label_lengths,
                                        s_idx, t_max))
    emit_loss_debug(ll_fwd, ll_bwd, grads)
    return costs, grads
