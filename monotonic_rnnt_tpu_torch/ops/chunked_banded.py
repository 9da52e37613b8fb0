"""Banded memory-efficient fused-joint loss: the O(W) training path.

PyTorch counterpart of ``monotonic_rnnt_tpu/ops/chunked_banded.py``.
ops/chunked.py streams T-chunks so the [B, T, S+1, V] activation never
exists; this module also evaluates the joint only on the packed band window
(ops/bands.py BandLayout), so the joint's matmuls and the loss kernels
scale with the band width W instead of S+1: O(B*Tc*W*V) peak memory.

The structure is ops/chunked.py's (a chunk loop forward, then one alpha
scan; one reverse chunk scan computing betas, dlogits and the joint's VJP),
with the band recurrences of ops/banded.py (per-step window shifts d /
d_next in {0, 1}). The chunk statistics run ``softmax_stats`` with the
per-t band labels [B, Tc, W], and the chunk gradient runs ``grad_pass``.
The recurrences run the banded loss's scan kernels: the forward folds the
alpha mask into full-T [B, T, W] streams and runs one ``alpha_scan_banded``
over them; each backward chunk's beta recurrence is one
``fwdbwd_scan_banded`` launch, with the next chunk's carry as its virtual
row. Only that launch's beta half is used: its alpha half runs in its own
blocks beside it, on the same streams, and is dropped.

The joint function contract differs from the full-lattice one: the
predictor rows arrive gathered per band cell,

    logits_band_chunk = joint_fn(params, enc_chunk [B, Tc, De],
                                 pred_band [B, Tc, W, Dp]) -> [B, Tc, W, V]

(for an additive joint, project enc once per (b, t) and broadcast over W).
``group`` shards the vocab axis over a process group, as in ops/chunked.py.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.autograd.function import once_differentiable

from ..utils.status import RnntError, Status
from .banded import BandStats, band_labels
from .bands import (Bands, band_final_slot, band_lattice_masks,
                    band_virtual_next_rows, compute_band_layout)
from .chunked import (_chunks, carry_operands, coefficients,
                      gradient_targets, graph_leaves, push_through_joint,
                      validate_fused_inputs)
from .cuda.banded_kernels import (alpha_scan_banded, alpha_scan_banded_plain,
                                  fwdbwd_scan_banded,
                                  fwdbwd_scan_banded_plain)
from .collective import sharded_band_stats
from .cuda.kernels import grad_pass, grad_pass_plain, kernel_or_plain
from .cuda.split_kernels import softmax_stats, softmax_stats_plain
from .helpers import NEG_INF, mask_to_additive, shift_left_s, shift_right_s
from .reference import nonfinite_cost_cells


def _band_chunk_stats(logits_c, lab_k, blank_id: int, group=None):
    """(BandStats, v_offset) of one chunk: softmax_stats on per-t labels,
    -inf on invalid slots; with a group, the collective stats of this V
    slice."""
    if group is not None:
        return sharded_band_stats(logits_c, lab_k, blank_id, group)
    denom, lp_blank, lpl_raw = kernel_or_plain(
        softmax_stats, softmax_stats_plain, logits_c)(logits_c, lab_k,
                                                      blank_id)
    return BandStats(denom=denom, lp_blank=lp_blank,
                     lp_label=torch.where(lab_k >= 0, lpl_raw, NEG_INF)), 0


def _gather_pred(pred, idx_c):
    """pred [B, S1, Dp], idx_c [B, Tc, W] -> [B, Tc, W, Dp].

    An index gather; autograd's scatter-add is its VJP. (The JAX package
    writes a one-hot matmul, because such gathers serialise on the TPU.)
    """
    b_idx = torch.arange(pred.shape[0], device=pred.device)[:, None, None]
    return pred[b_idx, idx_c]


def alpha_streams(stats: BandStats, mask_alpha):
    """The alpha operands of alpha_scan_banded: the mask folded in by a
    select, lp_label's mask shifted onto the source slot (it feeds w+1)."""
    return (torch.where(mask_alpha, stats.lp_blank, NEG_INF),
            torch.where(shift_left_s(mask_alpha, False), stats.lp_label,
                        NEG_INF))


def chunk_band_betas(row, stats: BandStats, d_next, bvirt, mask_beta, ilen,
                     t0: int):
    """The band beta recurrence over one chunk, t descending, in one
    fwdbwd_scan_banded launch (chunked_banded.py:232-241). Returns (betas,
    bnext) [B, Tc, W].

    row: [B, W] beta(t1, .), the carry from the chunk after this one;
    d_next [B, Tc] int32; bvirt and mask_beta the chunk's [B, Tc, W] rows.
    bnext is beta(t+1) (the virtual row where t+1 >= T_b) realigned into
    t's coordinates: exactly the beta_next the coefficients need.
    """
    t1 = t0 + stats.lp_blank.shape[1]
    local_len, virt = carry_operands(row, bvirt, ilen, t0, t1)
    lpb = torch.where(mask_beta, stats.lp_blank, NEG_INF)
    lpl = torch.where(mask_beta, stats.lp_label, NEG_INF)
    _, betas = kernel_or_plain(fwdbwd_scan_banded, fwdbwd_scan_banded_plain,
                               row)(lpb, lpl, d_next, lpb, lpl, d_next,
                                    local_len, virt)
    t_idx = torch.arange(t0 + 1, t1 + 1, device=row.device)
    nxt = torch.where(t_idx[None, :, None] >= ilen[:, None, None], bvirt,
                      torch.cat([betas[:, 1:], row[:, None]], dim=1))
    return betas, torch.where((d_next == 1)[:, :, None], shift_right_s(nxt),
                              nxt)


class _Layout:
    """The band layout and every [B, T, W] array the two scans read."""

    def __init__(self, labels, ilen, slen, bands, t_max, s1, width):
        self.layout = compute_band_layout(ilen, slen, bands, t_max, s1, width)
        self.masks = band_lattice_masks(ilen, slen, bands, self.layout, t_max,
                                        s1)
        w_idx = torch.arange(self.layout.width, dtype=torch.int64,
                             device=ilen.device)
        self.idx = self.layout.offset.to(torch.int64)[:, :, None] + w_idx
        self.lab = band_labels(labels, slen, self.layout, s1)


class _FusedBandedCore(torch.autograd.Function):
    """Banded costs from (enc, pred, params); gradients by a reverse chunk scan."""

    @staticmethod
    def forward(ctx, enc, pred, labels, ilen, slen, band_min, band_max,
                joint_fn, blank_id, chunk_t, width, group, keys, *values):
        batch, t_max, _ = enc.shape
        s1 = pred.shape[1]
        params = dict(zip(keys, values))
        L = _Layout(labels, ilen, slen, Bands(band_min, band_max), t_max, s1,
                    width)
        lpb, lpl = (torch.empty((batch, t_max, L.layout.width),
                                dtype=torch.float32, device=enc.device)
                    for _ in range(2))
        for t0, t1 in _chunks(t_max, chunk_t):
            logits_c = joint_fn(params, enc[:, t0:t1],
                                _gather_pred(pred, L.idx[:, t0:t1]))
            stats, _ = _band_chunk_stats(logits_c.contiguous(),
                                         L.lab[:, t0:t1].contiguous(),
                                         blank_id, group)
            lpb[:, t0:t1], lpl[:, t0:t1] = alpha_streams(
                stats, L.masks.alpha[:, t0:t1])
            del logits_c, stats
        alphas = kernel_or_plain(alpha_scan_banded, alpha_scan_banded_plain,
                                 lpb)(lpb, lpl, L.layout.d.contiguous())
        del lpb, lpl
        ll = band_final_slot(alphas, L.layout, ilen, slen)
        (ctx.joint_fn, ctx.blank_id, ctx.chunk_t, ctx.width, ctx.group,
         ctx.keys) = (joint_fn, blank_id, chunk_t, width, group, keys)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(enc, pred, labels, ilen, slen, band_min,
                                  band_max, alphas, ll, *values)
        return -ll

    @staticmethod
    @once_differentiable
    def backward(ctx, cost_cotangent):
        (enc, pred, labels, ilen, slen, band_min, band_max, alphas, ll,
         *values) = ctx.saved_tensors
        batch, t_max, _ = enc.shape
        s1 = pred.shape[1]
        dev = enc.device
        L = _Layout(labels, ilen, slen, Bands(band_min, band_max), t_max, s1,
                    ctx.width)
        layout, w = L.layout, L.layout.width
        bvirt = band_virtual_next_rows(layout, slen)
        d_next = layout.d_next
        # alpha(t-1, .) realigned into t's coordinates (chunked_banded.py:206-210).
        w_idx = torch.arange(w, dtype=torch.int32, device=dev)
        virt = mask_to_additive(w_idx == 0).expand(batch, 1, w)
        ap = torch.cat([virt, alphas[:, :-1]], dim=1)
        aprev = torch.where(layout.d[:, :, None] == 1, shift_left_s(ap), ap)
        ll_ok = torch.isfinite(ll)
        llb = torch.where(ll_ok, ll, 0.0)[:, None, None]
        open_cells = nonfinite_cost_cells(
            ll, ilen, slen, layout.offset[:, :, None] + w_idx, t_max)
        weight = cost_cotangent.to(torch.float32)[:, None, None]
        needs, acc = gradient_targets(ctx, enc, pred, values, 13)

        beta_row = torch.full((batch, w), NEG_INF, dtype=torch.float32,
                              device=dev)
        for t0, t1 in reversed(_chunks(t_max, ctx.chunk_t)):
            leaves = graph_leaves(enc[:, t0:t1], pred, values, needs)
            lab_k = L.lab[:, t0:t1].contiguous()
            with torch.enable_grad():
                logits_c = ctx.joint_fn(
                    dict(zip(ctx.keys, leaves[2:])), leaves[0],
                    _gather_pred(leaves[1], L.idx[:, t0:t1]))
            x = logits_c.detach().contiguous()
            stats, v_off = _band_chunk_stats(x, lab_k, ctx.blank_id,
                                             ctx.group)
            betas, bnext = chunk_band_betas(
                beta_row, stats, d_next[:, t0:t1].contiguous(),
                bvirt[:, t0:t1], L.masks.beta[:, t0:t1], ilen, t0)
            beta_row = betas[:, 0]
            t_idx = torch.arange(t0, t1, dtype=torch.int32, device=dev)
            valid = ((t_idx[None, :, None] < ilen[:, None, None])
                     & ll_ok[:, None, None])
            occ, cb, cl = coefficients(
                aprev[:, t0:t1], betas, bnext, valid, llb, weight,
                open_cells[:, t0:t1] & ~torch.isfinite(stats.denom))
            dlogits = kernel_or_plain(grad_pass, grad_pass_plain, x)(
                x, stats.denom, occ, cb, cl, lab_k - v_off,
                ctx.blank_id - v_off, out_dtype=x.dtype)
            targets = [acc[0][:, t0:t1] if needs[0] else None, *acc[1:]]
            push_through_joint(logits_c, leaves, dlogits, targets)
            del logits_c, x, dlogits
        return (acc[0], acc[1]) + (None,) * 11 + tuple(acc[2:])


def rnnt_loss_fused_joint_banded(
    enc: torch.Tensor,
    pred: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    joint_fn: Callable,
    joint_params: Dict[str, torch.Tensor],
    *,
    bands: Bands,
    band_width: int,
    blank_id: int = 0,
    chunk_t: int = 32,
    group=None,
) -> torch.Tensor:
    """Alignment-restricted costs from encoder/predictor outputs, O(W) compute.

    Args:
      enc: [B, T, De] encoder outputs; pred: [B, S+1, Dp] predictor rows.
      labels / input_lengths / label_lengths / blank_id: as usual; they and
        the bands are moved to enc's device.
      joint_fn: (params, enc_chunk [B, Tc, De], pred_band [B, Tc, W, Dp]) ->
        [B, Tc, W, V] raw logits; pred rows arrive gathered per band cell.
      joint_params: dict of the joint's parameter tensors.
      bands: the restriction (the packed-layout contract of
        monotonic_rnnt_loss_banded; wider spans are clipped to band_width).
      band_width: the packed window width W (size it with
        bands.suggested_band_width).
      chunk_t: frames per streamed chunk; the last chunk may be shorter.
      group: if set, the process group over which the vocab axis is sharded
        (see rnnt_loss_fused_joint).

    Returns [B] f32 costs, differentiable w.r.t. enc, pred and every tensor
    of joint_params.
    """
    validate_fused_inputs(enc, pred, labels, input_lengths, label_lengths)
    s1 = pred.shape[1]
    if not 0 < band_width <= s1:
        raise RnntError(Status.INVALID_VALUE,
                        f"band_width must be in (0, S+1]; got {band_width} "
                        f"with S+1 = {s1}")
    dev = enc.device
    keys = tuple(joint_params)
    values = [joint_params[k] for k in keys]
    if not torch.is_grad_enabled():
        # Under no_grad, ctx.needs_input_grad still follows requires_grad;
        # detached inputs keep the call from saving residuals.
        enc, pred = enc.detach(), pred.detach()
        values = [v.detach() for v in values]
    return _FusedBandedCore.apply(
        enc, pred, labels.to(dev),
        input_lengths.to(device=dev, dtype=torch.int32),
        label_lengths.to(device=dev, dtype=torch.int32),
        bands.min_s.to(device=dev, dtype=torch.int32),
        bands.max_s.to(device=dev, dtype=torch.int32), joint_fn,
        int(blank_id), int(chunk_t), int(band_width), group, keys,
        *values)
