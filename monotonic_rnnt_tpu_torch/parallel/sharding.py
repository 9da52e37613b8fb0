"""Vocab-sharded (tensor-parallel) monotonic RNN-T losses.

PyTorch counterpart of ``monotonic_rnnt_tpu/parallel/sharding.py``. When
V * T * S exceeds one card's memory (e.g. 10k-BPE joint outputs on long
utterances), the logits' vocab axis is sharded over the 'model' axis of a
process mesh. Each rank computes its shard's softmax statistics in one pass
(``softmax_stats_partial``); all-reduces over the model group combine them
into the global denominator (ops/collective.py); the small V-free
recursions run on every rank of the group alike (``fwdbwd_scan`` /
``alpha_scan``, ``fwdbwd_scan_banded`` / ``alpha_scan_banded``); and the
backward runs ``grad_pass`` on the local slice only, with ids relative to
the shard and the cost cotangent folded in -- the big tensor is never
gathered. A sample whose cost is not finite gets NaN on its lattice rows
with a non-finite denominator, where JAX's backward (XLA's p * coef, not a
kernel) has NaN, as the fused-joint losses do (ops/chunked.py).

Each returned loss function takes this rank's shard (logits
[B/data, T, S1 or W, V/model], the rest [B/data]) and returns the global
scalar on every rank, as JAX's ``out_specs=P()``. In the fused-joint losses
the gradient of an input that several ranks hold whole is summed by hand
over those ranks (an identity forward whose backward all-reduces): enc and
pred and every weight replicated over 'model' over the model group, every
weight over the data group -- what JAX's transpose of ``shard_map``'s
``in_specs`` does.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from ..ops.banded import band_labels, band_occupancy_coefficients
from ..ops.bands import (BandLayout, Bands, band_final_slot,
                         band_lattice_masks, band_virtual_next_rows,
                         compute_band_layout, default_bands, lattice_masks)
from ..ops.chunked import rnnt_loss_fused_joint
from ..ops.chunked_banded import alpha_streams, rnnt_loss_fused_joint_banded
from ..ops.collective import sharded_band_stats, sharded_lattice_stats
from ..ops.cuda.banded_kernels import (alpha_scan_banded,
                                       alpha_scan_banded_plain,
                                       fwdbwd_scan_banded,
                                       fwdbwd_scan_banded_plain)
from ..ops.cuda.kernels import grad_pass, grad_pass_plain, kernel_or_plain
from ..ops.cuda.split_kernels import (alpha_scan, alpha_scan_plain,
                                      fwdbwd_scan, fwdbwd_scan_plain)
from ..ops.helpers import NEG_INF, extend_labels, mask_to_additive
from ..ops.reference import (_gather_ll, nonfinite_cost_cells,
                             occupancy_coefficients)
from .data_parallel import batch_total
from .mesh import MODEL_AXIS, Mesh, Spec


def _local_grad(x, denom, coefs, labels, blank_id: int, v_offset: int,
                cost_cotangent, open_cells):
    """grad_pass on the local slice, the cotangent folded into the
    coefficients (occ, cb, cl), ids relative to the shard.

    occ is NaN on open_cells (nonfinite_cost_cells) where the denominator
    is not finite: a NaN-cost sample's coefficients are all 0, and there
    JAX's p * 0 is NaN where grad_pass would write a zero.
    """
    sc = cost_cotangent.to(torch.float32)[:, None, None]
    occ, cb, cl = ((c * sc).contiguous() for c in coefs)
    occ = torch.where(open_cells & ~torch.isfinite(denom), float("nan"), occ)
    return kernel_or_plain(grad_pass, grad_pass_plain, x)(
        x, denom, occ, cb, cl, (labels - v_offset).contiguous(),
        blank_id - v_offset, out_dtype=x.dtype)


class _VocabShardedCore(torch.autograd.Function):
    """costs from a local vocab slice; its slice of d costs / d logits."""

    @staticmethod
    def forward(ctx, x, labels, ilen, slen, band_min, band_max, blank_id,
                group):
        _, t_max, s1, _ = x.shape
        labels_ext = extend_labels(labels, slen, s1).contiguous()
        stats, v_offset = sharded_lattice_stats(x, labels_ext, blank_id, group)
        masks = lattice_masks(ilen, slen, Bands(band_min, band_max), t_max, s1)
        amask = mask_to_additive(masks.alpha)
        if ctx.needs_input_grad[0]:
            # Deferred gradients (sharding.py:64-92): the forward stops after
            # the V-free recursions, one launch for both chains.
            s_idx = torch.arange(s1, dtype=torch.int32, device=x.device)
            alphas, betas = kernel_or_plain(fwdbwd_scan, fwdbwd_scan_plain, x)(
                stats.lp_blank, stats.lp_label, amask,
                mask_to_additive(masks.beta), ilen,
                mask_to_additive(s_idx[None, :] == slen[:, None]))
        else:
            alphas, betas = kernel_or_plain(alpha_scan, alpha_scan_plain, x)(
                stats.lp_blank, stats.lp_label, amask), None
        ll = _gather_ll(alphas, ilen, slen)
        if betas is not None:
            ctx.blank_id, ctx.v_offset = blank_id, v_offset
            ctx.save_for_backward(x, labels_ext, ilen, slen, stats.denom,
                                  alphas, betas, ll)
        return -ll

    @staticmethod
    @once_differentiable
    def backward(ctx, cost_cotangent):
        x, labels_ext, ilen, slen, denom, alphas, betas, ll = ctx.saved_tensors
        coefs = occupancy_coefficients(alphas, betas, ll, ilen, slen)
        s_idx = torch.arange(x.shape[2], dtype=torch.int32, device=x.device)
        dx = _local_grad(x, denom, coefs, labels_ext, ctx.blank_id,
                         ctx.v_offset, cost_cotangent,
                         nonfinite_cost_cells(ll, ilen, slen, s_idx,
                                              x.shape[1]))
        return dx, None, None, None, None, None, None, None


def _int32(t: torch.Tensor, dev) -> torch.Tensor:
    return t.to(device=dev, dtype=torch.int32).contiguous()


def rnnt_loss_vocab_sharded(logits_local, labels, input_lengths,
                            label_lengths, band_min, band_max,
                            blank_id: int, group) -> torch.Tensor:
    """Per-sample costs [B] from this rank's vocab slice [B, T, S1, V_local].

    Every rank of `group` (the model axis) calls it with its columns
    [rank * V_local, (rank + 1) * V_local) and gets the same costs;
    differentiable w.r.t. logits_local (the local slice of the gradient, in
    its dtype). band_min / band_max: [B, T] (bands.default_bands for the
    unrestricted lattice).
    """
    dev = logits_local.device
    if not torch.is_grad_enabled():
        logits_local = logits_local.detach()   # the cost-only route
    return _VocabShardedCore.apply(
        logits_local.contiguous(), labels.to(dev), _int32(input_lengths, dev),
        _int32(label_lengths, dev), _int32(band_min, dev),
        _int32(band_max, dev), int(blank_id), group)


class _BandedVocabShardedCore(torch.autograd.Function):
    """Banded costs from a local vocab slice of the packed band layout."""

    @staticmethod
    def forward(ctx, x, labels, ilen, slen, band_min, band_max, blank_id,
                group):
        _, t_max, w, _ = x.shape
        s1 = labels.shape[1] + 1
        bands = Bands(band_min, band_max)
        layout = compute_band_layout(ilen, slen, bands, t_max, s1, w)
        masks = band_lattice_masks(ilen, slen, bands, layout, t_max, s1)
        lab_band = band_labels(labels, slen, layout, s1)
        stats, v_offset = sharded_band_stats(x, lab_band, blank_id, group)
        # The operand streams softmax_stats_banded folds its masks into on
        # the unsharded route, here from the combined statistics.
        lpba, lpla = (s.contiguous()
                      for s in alpha_streams(stats, masks.alpha))
        d = layout.d.contiguous()
        if ctx.needs_input_grad[0]:
            lpbb, lplb = (torch.where(masks.beta, s, NEG_INF).contiguous()
                          for s in (stats.lp_blank, stats.lp_label))
            alphas, betas = kernel_or_plain(
                fwdbwd_scan_banded, fwdbwd_scan_banded_plain, x)(
                lpba, lpla, d, lpbb, lplb, layout.d_next.contiguous(), ilen,
                band_virtual_next_rows(layout, slen).contiguous())
        else:
            alphas, betas = kernel_or_plain(
                alpha_scan_banded, alpha_scan_banded_plain, x)(lpba, lpla,
                                                               d), None
        ll = band_final_slot(alphas, layout, ilen, slen)
        if betas is not None:
            ctx.blank_id, ctx.v_offset, ctx.width = blank_id, v_offset, w
            ctx.save_for_backward(x, lab_band, ilen, slen, layout.offset,
                                  layout.d, layout.d_next, stats.denom,
                                  alphas, betas, ll)
        return -ll

    @staticmethod
    @once_differentiable
    def backward(ctx, cost_cotangent):
        (x, lab_band, ilen, slen, offset, d, d_next, denom, alphas, betas,
         ll) = ctx.saved_tensors
        coefs = band_occupancy_coefficients(
            alphas, betas, ll, ilen, slen,
            BandLayout(offset, d, d_next, ctx.width))
        w_idx = torch.arange(ctx.width, dtype=torch.int32, device=x.device)
        dx = _local_grad(x, denom, coefs, lab_band, ctx.blank_id,
                         ctx.v_offset, cost_cotangent,
                         nonfinite_cost_cells(ll, ilen, slen,
                                              offset[:, :, None] + w_idx,
                                              x.shape[1]))
        return dx, None, None, None, None, None, None, None


def rnnt_loss_banded_vocab_sharded(logits_band_local, labels, input_lengths,
                                   label_lengths, band_min, band_max,
                                   blank_id: int, group) -> torch.Tensor:
    """Banded per-sample costs [B] from this rank's vocab slice of the
    packed [B, T, W, V] layout.

    The long-utterance fast path (ops/banded.py) composed with vocab tensor
    parallelism: the big-tensor traffic scales with W * V_local. Gradients
    are the local slice, in the packed layout.
    """
    dev = logits_band_local.device
    if not torch.is_grad_enabled():
        logits_band_local = logits_band_local.detach()
    return _BandedVocabShardedCore.apply(
        logits_band_local.contiguous(), labels.to(dev),
        _int32(input_lengths, dev), _int32(label_lengths, dev),
        _int32(band_min, dev), _int32(band_max, dev), int(blank_id), group)


def make_dp_tp_loss(mesh: Mesh, *, blank_id: int = 0,
                    mean_over_batch: bool = True):
    """Loss with the batch sharded over 'data' and the vocabulary over 'model'.

    fn(logits [B/data, T, S1, V/model], labels, input_lengths,
    label_lengths [B/data]) -> the global scalar.
    """

    def fn(logits, labels, input_lengths, label_lengths):
        bands = default_bands(input_lengths, label_lengths, logits.shape[1])
        costs = rnnt_loss_vocab_sharded(
            logits, labels, input_lengths, label_lengths, bands.min_s,
            bands.max_s, blank_id, mesh.model_group)
        return batch_total(costs, mesh, mean_over_batch)

    return fn


def make_dp_tp_banded_loss(mesh: Mesh, *, blank_id: int = 0,
                           mean_over_batch: bool = True):
    """Banded loss: batch on 'data', vocabulary on 'model', compute O(W).

    fn(logits_band [B/data, T, W, V/model], labels, input_lengths,
    label_lengths, band_min [B/data, T], band_max [B/data, T]) -> scalar.
    """

    def fn(logits_band, labels, input_lengths, label_lengths, band_min,
           band_max):
        costs = rnnt_loss_banded_vocab_sharded(
            logits_band, labels, input_lengths, label_lengths, band_min,
            band_max, blank_id, mesh.model_group)
        return batch_total(costs, mesh, mean_over_batch)

    return fn


class _SumGradOver(torch.autograd.Function):
    """Identity forward; the backward all-reduces (SUM) each cotangent over
    the group, in the order of the inputs."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        out = []
        for g in grads:
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


def _sum_grads_over(group, xs):
    """The list xs as it is, the gradients of those of its tensors that need
    one summed over `group` in the backward (the same on every rank)."""
    xs = list(xs)
    idx = [i for i, x in enumerate(xs) if x.requires_grad]
    if idx:
        for i, y in zip(idx, _SumGradOver.apply(group,
                                                *(xs[i] for i in idx))):
            xs[i] = y
    return xs


def _replicated_inputs(mesh: Mesh, enc, pred, params, params_specs):
    """enc, pred and params with their gradients summed over the ranks that
    hold each whole (module docstring)."""
    keys = list(params)
    over_model = [k for k in keys if MODEL_AXIS not in params_specs[k]]
    params = dict(zip(keys, _sum_grads_over(mesh.data_group,
                                            params.values())))
    enc, pred, *rest = _sum_grads_over(
        mesh.model_group, [enc, pred] + [params[k] for k in over_model])
    params.update(zip(over_model, rest))
    return enc, pred, params


def make_dp_tp_fused_loss(mesh: Mesh, joint_fn: Callable,
                          params_specs: Dict[str, Spec], *,
                          blank_id: int = 0, chunk_t: int = 32,
                          mean_over_batch: bool = True,
                          with_bands: bool = False):
    """Memory-efficient fused-joint loss: batch on 'data', V on 'model'.

    The production configuration for large vocabularies: the joint's output
    projection is sharded over the model axis, each rank computes only its
    [B/data, Tc, S1, V/model] logits slice chunk by chunk, and the loss
    combines softmax statistics by all-reduces -- the [B, T, S1, V] tensor
    never exists on any rank.

    Args:
      joint_fn: (params_local, enc_chunk, pred) -> local V-slice logits.
      params_specs: a spec per joint parameter (mesh.Spec): the leaves that
        make the vocab axis are sharded on MODEL_AXIS (e.g. (None,
        MODEL_AXIS) for an output projection [H, V], (MODEL_AXIS,) for its
        bias), the rest replicated (()).
      with_bands: if True the returned fn takes trailing (band_min,
        band_max) [B/data, T] tensors restricting the lattice.

    Returns fn(enc [B/data, T, De], pred [B/data, S1, Dp], labels,
    input_lengths, label_lengths, joint_params[, band_min, band_max]) ->
    scalar, with this rank's shards in (mesh.shard_params cuts the
    parameters); differentiable w.r.t. enc, pred and joint_params, each
    gradient the rank's slice of the global one.
    """

    def fn(enc, pred, labels, input_lengths, label_lengths, joint_params,
           *band_args):
        if len(band_args) != (2 if with_bands else 0):
            raise TypeError("band_min and band_max go with with_bands=True "
                            "only")
        enc, pred, params = _replicated_inputs(mesh, enc, pred, joint_params,
                                               params_specs)
        bands = Bands(*band_args) if with_bands else None
        costs = rnnt_loss_fused_joint(
            enc, pred, labels, input_lengths, label_lengths, joint_fn,
            params, blank_id=blank_id, chunk_t=chunk_t, bands=bands,
            group=mesh.model_group)
        return batch_total(costs, mesh, mean_over_batch)

    return fn


def make_dp_tp_fused_banded_loss(mesh: Mesh, joint_fn: Callable,
                                 params_specs: Dict[str, Spec], *,
                                 band_width: int, blank_id: int = 0,
                                 chunk_t: int = 32,
                                 mean_over_batch: bool = True):
    """O(W) fused-joint loss: batch on 'data', vocabulary on 'model'.

    Alignment-restricted long utterances with large vocabularies: the joint
    runs on band cells only (ops/chunked_banded.py), streamed in T-chunks,
    its output projection sharded over the model axis. joint_fn follows the
    banded contract: (params_local, enc_chunk [B,Tc,De], pred_band
    [B,Tc,W,Dp]) -> [B, Tc, W, V_local].

    Returns fn(enc, pred, labels, input_lengths, label_lengths,
    joint_params, band_min [B/data, T], band_max [B/data, T]) -> scalar.
    """

    def fn(enc, pred, labels, input_lengths, label_lengths, joint_params,
           band_min, band_max):
        enc, pred, params = _replicated_inputs(mesh, enc, pred, joint_params,
                                               params_specs)
        costs = rnnt_loss_fused_joint_banded(
            enc, pred, labels, input_lengths, label_lengths, joint_fn,
            params, bands=Bands(band_min, band_max), band_width=band_width,
            blank_id=blank_id, chunk_t=chunk_t, group=mesh.model_group)
        return batch_total(costs, mesh, mean_over_batch)

    return fn
