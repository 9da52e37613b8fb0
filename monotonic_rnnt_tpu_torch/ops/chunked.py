"""Memory-efficient fused-joint monotonic RNN-T loss.

PyTorch counterpart of ``monotonic_rnnt_tpu/ops/chunked.py``. The loss is
computed from the encoder and predictor outputs, streaming the lattice in
T-chunks: each chunk's [B, Tc, S+1, V] logits are made by the caller's
joint function, consumed and dropped, so the full [B, T, S+1, V] tensor and
its gradient never exist. Peak memory is O(B*Tc*S1*V) + O(B*T*S1):

  forward:  the alpha row is carried across chunks; the residuals are the
     alphas and the log-likelihoods only;
  backward: one reverse chunk scan. Each chunk's logits are recomputed once
     (with autograd's graph) and serve both the beta recurrence and the
     gradient: the occupancy coefficients, with the cost cotangent folded
     in so that per-sample weights are exact, go through ``grad_pass`` to
     dlogits, which ``torch.autograd.grad`` pushes through the joint,
     accumulating d_enc, d_pred and d_params.

The chunk statistics run the ``softmax_stats`` kernel (a plain version on
CPU tensors). The recurrences, ``jax.lax.scan`` loops in the JAX package,
run the split pipeline's scan kernels: the forward keeps each chunk's
lp_blank and lp_label in full-T [B, T, S1] streams (the order of the alphas
residual) and runs one ``alpha_scan`` over them after the chunk loop; the
beta recurrence of a chunk is one ``beta_scan`` launch, since that kernel
takes the carry from the next chunk as its virtual row. The gradient of a
chunk goes through ``grad_pass``: one read of the chunk's logits and one
write, where the plain formula would hold several [B, Tc, S1, V] f32
temporaries. The masks are applied by a select, as everywhere in the port.

With ``group`` (the counterpart of JAX's ``axis_name``) the vocab axis is
sharded over a torch.distributed process group: the joint makes only this
rank's [B, Tc, S+1, V_local] slice, the chunk statistics come from
``ops/collective.py`` (``softmax_stats_partial`` and two all-reduces), in
the forward and again in the backward's recompute, and each chunk's
``grad_pass`` takes label and blank ids relative to the shard. Every rank
runs every chunk, so all of them issue the same collectives in the same
order. The gradients are this rank's contribution: summing those of the
inputs every shard holds whole (enc, pred, a replicated weight) over the
group is the caller's, as parallel/sharding.make_dp_tp_fused_loss does.

The joint function contract:

    logits_chunk = joint_fn(params, enc_chunk [B, Tc, De], pred [B, S+1, Dp])
                   -> [B, Tc, S+1, V] raw logits, f32 or bf16

with ``params`` a dict of tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.autograd.function import once_differentiable

from ..utils.status import RnntError, Status, _is_integer
from .bands import Bands, default_bands, lattice_masks
from .collective import sharded_lattice_stats
from .cuda.kernels import grad_pass, grad_pass_plain, kernel_or_plain
from .cuda.split_kernels import (alpha_scan, alpha_scan_plain, beta_scan,
                                 beta_scan_plain, softmax_stats,
                                 softmax_stats_plain)
from .helpers import NEG_INF, extend_labels, mask_to_additive, shift_left_s
from .reference import LatticeStats, _gather_ll, nonfinite_cost_cells


def _chunk_stats(logits_c, labels_ext, blank_id: int, group=None):
    """(LatticeStats, v_offset) of one chunk: softmax_stats, then -inf on
    invalid slots; with a group, the collective stats of this V slice."""
    if group is not None:
        return sharded_lattice_stats(logits_c, labels_ext, blank_id, group)
    denom, lp_blank, lpl_raw = kernel_or_plain(
        softmax_stats, softmax_stats_plain, logits_c)(logits_c, labels_ext,
                                                      blank_id)
    lp_label = torch.where((labels_ext >= 0)[:, None, :], lpl_raw, NEG_INF)
    return LatticeStats(denom=denom, lp_blank=lp_blank,
                        lp_label=lp_label), 0


def _chunks(t_max: int, chunk_t: int):
    """(t0, t1) of every T-chunk; the last one may be short."""
    return [(t0, min(t0 + chunk_t, t_max)) for t0 in range(0, t_max, chunk_t)]


def carry_operands(row, virt_rows, ilen, t0: int, t1: int):
    """(local lengths [B] int32, virtual rows) that make a backward scan of
    the chunk [t0, t1) start from ``row``, beta(t1, .).

    The scan kernels read their virtual row where t+1 >= T_b. On the chunk
    that length becomes min(T_b - t0, Tc), and the virtual row is the
    sample's own where it ends inside the chunk (T_b <= t1) and the carry
    elsewhere, so the chunk's last step reads the carry. virt_rows is
    [B, S1] (full lattice) or the chunk's [B, Tc, W] (band layout).
    """
    ends = (ilen <= t1).view(-1, *([1] * (virt_rows.dim() - 1)))
    carry = row if virt_rows.dim() == 2 else row[:, None]
    virt = torch.where(ends, virt_rows, carry).contiguous()
    return torch.clamp(ilen - t0, 0, t1 - t0).to(torch.int32), virt


def chunk_betas(row, stats: LatticeStats, beta_maskadd, beta_virt, ilen,
                t0: int):
    """The beta recurrence over one chunk, t descending, in one beta_scan
    launch (chunked.py:271-279). Returns (betas, bnext) [B, Tc, S1].

    row: [B, S1] beta(t1, .), the carry from the chunk after this one;
    beta_maskadd: the chunk's additive beta mask. bnext is beta(t+1, .)
    with the virtual row where t+1 >= T_b: exactly the beta_next the
    gradient coefficients need.
    """
    tc = stats.lp_blank.shape[1]
    t1 = t0 + tc
    local_len, virt = carry_operands(row, beta_virt, ilen, t0, t1)
    betas = kernel_or_plain(beta_scan, beta_scan_plain, row)(
        stats.lp_blank, stats.lp_label, beta_maskadd, local_len, virt)
    t_idx = torch.arange(t0 + 1, t1 + 1, device=row.device)
    bnext = torch.where(t_idx[None, :, None] >= ilen[:, None, None],
                        beta_virt[:, None],
                        torch.cat([betas[:, 1:], row[:, None]], dim=1))
    return betas, bnext


def validate_fused_inputs(enc, pred, labels, input_lengths,
                          label_lengths) -> None:
    """The JAX package's checks of the fused-joint inputs (chunked.py:129-145)."""
    if enc.dim() != 3 or pred.dim() != 3 or enc.shape[0] != pred.shape[0]:
        raise RnntError(Status.INVALID_VALUE,
                        f"enc must be [B,T,De] and pred [B,S+1,Dp] with the "
                        f"same B; got {tuple(enc.shape)} and "
                        f"{tuple(pred.shape)}")
    if labels.dim() != 2 or labels.shape[0] != enc.shape[0] or (
            labels.shape[1] < pred.shape[1] - 1) or (
            labels.shape[1] > pred.shape[1]):
        raise RnntError(Status.INVALID_VALUE,
                        f"labels must be [B, S] or [B, S+1]; got "
                        f"{tuple(labels.shape)} with pred S+1 = "
                        f"{pred.shape[1]}")
    for name, arr in (("input_lengths", input_lengths),
                      ("label_lengths", label_lengths)):
        if tuple(arr.shape) != (enc.shape[0],) or not _is_integer(arr.dtype):
            raise RnntError(Status.INVALID_VALUE,
                            f"{name} must be int [B]; got "
                            f"{tuple(arr.shape)} {arr.dtype}")


def graph_leaves(enc_c, pred, values, needs):
    """Detached copies of one chunk's joint inputs, requiring grad as needed."""
    return [x.detach().requires_grad_(bool(n))
            for x, n in zip([enc_c, pred, *values], needs)]


def push_through_joint(logits_c, leaves, dlogits, targets) -> None:
    """targets[i] += the VJP of dlogits through the joint, per leaf needing it."""
    idx = [i for i, x in enumerate(leaves) if x.requires_grad]
    if not idx:
        return
    grads = torch.autograd.grad(logits_c, [leaves[i] for i in idx], dlogits,
                                allow_unused=True)
    for i, g in zip(idx, grads):
        if g is not None:
            targets[i].add_(g)


def coefficients(aprev, betas, bnext, valid, llb, weight, nan_cells):
    """(occ, cb, cl) of one chunk, the cotangent folded in (chunked.py:294-299).

    occ is NaN on nan_cells: the lattice cells with a non-finite denom of a
    sample whose cost is not finite. Its coefficients are all 0, and there
    the JAX oracle's p * 0 is NaN where grad_pass would write a zero.
    """
    def coef(b):
        return torch.where(valid, torch.exp(aprev + b - llb), 0.0) * weight

    occ = torch.where(nan_cells, float("nan"), coef(betas))
    return occ, coef(bnext), coef(shift_left_s(bnext))


def gradient_targets(ctx, enc, pred, values, n_lead: int):
    """Zeroed accumulators of the inputs that need a gradient (None else)."""
    needs = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
             *ctx.needs_input_grad[n_lead:]]
    return needs, [torch.zeros_like(x) if n else None
                   for x, n in zip([enc, pred, *values], needs)]


class _FusedJointCore(torch.autograd.Function):
    """costs from (enc, pred, params); their gradients by a reverse chunk scan."""

    @staticmethod
    def forward(ctx, enc, pred, labels_ext, ilen, slen, band_min, band_max,
                joint_fn, blank_id, chunk_t, group, keys, *values):
        batch, t_max, _ = enc.shape
        s1 = pred.shape[1]
        params = dict(zip(keys, values))
        masks = lattice_masks(ilen, slen, Bands(band_min, band_max), t_max, s1)
        lp_blank, lp_label = (torch.empty((batch, t_max, s1),
                                          dtype=torch.float32,
                                          device=enc.device)
                              for _ in range(2))
        for t0, t1 in _chunks(t_max, chunk_t):
            stats, _ = _chunk_stats(
                joint_fn(params, enc[:, t0:t1], pred).contiguous(),
                labels_ext, blank_id, group)
            lp_blank[:, t0:t1] = stats.lp_blank
            lp_label[:, t0:t1] = stats.lp_label
            del stats
        alphas = kernel_or_plain(alpha_scan, alpha_scan_plain, enc)(
            lp_blank, lp_label, mask_to_additive(masks.alpha))
        del lp_blank, lp_label
        ll = _gather_ll(alphas, ilen, slen)
        ctx.joint_fn, ctx.blank_id, ctx.chunk_t, ctx.group, ctx.keys = (
            joint_fn, blank_id, chunk_t, group, keys)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(enc, pred, labels_ext, ilen, slen, band_min,
                                  band_max, alphas, ll, *values)
        return -ll

    @staticmethod
    @once_differentiable
    def backward(ctx, cost_cotangent):
        (enc, pred, labels_ext, ilen, slen, band_min, band_max, alphas, ll,
         *values) = ctx.saved_tensors
        batch, t_max, _ = enc.shape
        s1 = pred.shape[1]
        dev = enc.device
        masks = lattice_masks(ilen, slen, Bands(band_min, band_max), t_max, s1)
        s_idx = torch.arange(s1, dtype=torch.int32, device=dev)
        beta_virt = mask_to_additive(s_idx[None, :] == slen[:, None])
        alpha_virt = mask_to_additive(s_idx == 0).expand(batch, 1, s1)
        aprev = torch.cat([alpha_virt, alphas[:, :-1]], dim=1)
        ll_ok = torch.isfinite(ll)
        llb = torch.where(ll_ok, ll, 0.0)[:, None, None]
        open_cells = nonfinite_cost_cells(ll, ilen, slen, s_idx, t_max)
        weight = cost_cotangent.to(torch.float32)[:, None, None]
        needs, acc = gradient_targets(ctx, enc, pred, values, 12)

        beta_row = torch.full((batch, s1), NEG_INF, dtype=torch.float32,
                              device=dev)
        for t0, t1 in reversed(_chunks(t_max, ctx.chunk_t)):
            leaves = graph_leaves(enc[:, t0:t1], pred, values, needs)
            with torch.enable_grad():
                logits_c = ctx.joint_fn(dict(zip(ctx.keys, leaves[2:])),
                                        leaves[0], leaves[1])
            x = logits_c.detach().contiguous()
            stats, v_off = _chunk_stats(x, labels_ext, ctx.blank_id,
                                        ctx.group)
            betas, bnext = chunk_betas(
                beta_row, stats, mask_to_additive(masks.beta[:, t0:t1]),
                beta_virt, ilen, t0)
            beta_row = betas[:, 0]
            t_idx = torch.arange(t0, t1, dtype=torch.int32, device=dev)
            valid = ((t_idx[None, :, None] < ilen[:, None, None])
                     & ll_ok[:, None, None])
            occ, cb, cl = coefficients(
                aprev[:, t0:t1], betas, bnext, valid, llb, weight,
                open_cells[:, t0:t1] & ~torch.isfinite(stats.denom))
            dlogits = kernel_or_plain(grad_pass, grad_pass_plain, x)(
                x, stats.denom, occ, cb, cl, labels_ext - v_off,
                ctx.blank_id - v_off, out_dtype=x.dtype)
            targets = [acc[0][:, t0:t1] if needs[0] else None, *acc[1:]]
            push_through_joint(logits_c, leaves, dlogits, targets)
            del logits_c, x, dlogits
        return (acc[0], acc[1]) + (None,) * 10 + tuple(acc[2:])


def rnnt_loss_fused_joint(
    enc: torch.Tensor,
    pred: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    joint_fn: Callable,
    joint_params: Dict[str, torch.Tensor],
    *,
    blank_id: int = 0,
    chunk_t: int = 32,
    bands: Optional[Bands] = None,
    group=None,
) -> torch.Tensor:
    """Monotonic RNN-T costs from encoder/predictor outputs, O(B*Tc*S1*V) memory.

    Args:
      enc: [B, T, De] encoder outputs (T = frames after subsampling).
      pred: [B, S+1, Dp] predictor context vectors.
      labels / input_lengths / label_lengths / blank_id / bands: as in
        monotonic_rnnt_loss (lengths refer to enc frames / labels); they are
        moved to enc's device.
      joint_fn: (params, enc_chunk, pred) -> [B, Tc, S+1, V] raw logits.
      joint_params: dict of the joint's parameter tensors.
      chunk_t: frames per chunk; the last chunk may be shorter.
      group: if set, a torch.distributed process group over which the vocab
        axis is sharded: joint_fn and joint_params make only this rank's V
        slice (rank r holds columns [r * V_local, (r + 1) * V_local)), and
        the statistics are combined by all-reduces (ops/collective.py).
        Gradients stay this rank's contribution (module docstring).

    Returns [B] f32 costs, differentiable w.r.t. enc, pred and every tensor
    of joint_params. On CUDA tensors the chunk statistics and gradients run
    the softmax_stats (with a group, softmax_stats_partial) and grad_pass
    kernels.
    """
    validate_fused_inputs(enc, pred, labels, input_lengths, label_lengths)
    dev = enc.device
    ilen = input_lengths.to(device=dev, dtype=torch.int32)
    slen = label_lengths.to(device=dev, dtype=torch.int32)
    if bands is None:
        bands = default_bands(ilen, slen, enc.shape[1])
    keys = tuple(joint_params)
    values = [joint_params[k] for k in keys]
    if not torch.is_grad_enabled():
        # Under no_grad, ctx.needs_input_grad still follows requires_grad;
        # detached inputs keep the call from saving residuals.
        enc, pred = enc.detach(), pred.detach()
        values = [v.detach() for v in values]
    labels_ext = extend_labels(labels.to(dev), slen, pred.shape[1])
    return _FusedJointCore.apply(
        enc, pred, labels_ext, ilen, slen,
        bands.min_s.to(device=dev, dtype=torch.int32),
        bands.max_s.to(device=dev, dtype=torch.int32), joint_fn,
        int(blank_id), int(chunk_t), group, keys, *values)
