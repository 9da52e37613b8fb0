"""The reference's PyTorch binding surface, on the port's own engines.

PyTorch counterpart of ``monotonic_rnnt_tpu/interop/torch_binding.py``,
API-compatible with the reference's pytorch_binding
(monotonic_rnnt_op.py:121-217): ``monotonic_rnnt_loss(acts, labels,
input_lengths, label_lengths, alignment=None, max_distance_from_alignment=0,
blank_label=0)`` over the packed activation layout, ``MonotonicRNNTLoss``
with a reduction, and ``monotonic_rnnt_loss_padded`` over the padded one.
Two engines for the packed layout:

  * ``"native"``: the native C++ engine (native_src/mrnnt.cpp) on CPU
    tensors, the reference's CPU binding role. Its forward makes the
    gradients and the backward is the per-sample chain rule
        dacts = grad_costs.repeat_interleave(T_b * (S_b + 1))[:, None] * grads
    as in the reference (monotonic_rnnt_op.py:96-118);
  * ``"torch"``: the port's packed loss (ops/packing.py), the reference's
    GPU binding role (pytorch_binding/monotonic_rnnt.cu:81-114). On CUDA
    tensors it runs the CUDA kernels on the deferred route: the forward
    computes the costs and the backward the gradient with the cotangent
    folded in. Nothing but the [B] lengths crosses to the host.

engine=None picks "native" for CPU tensors and "torch" otherwise. Where the
JAX binding bridges to JAX, the port has nothing to bridge to: "jax" is not
an engine here.

As in the JAX binding, ``MonotonicRNNTLoss`` keeps its blank in
``self.blank_label`` (the reference module reads ``self.blank``, a latent
AttributeError at monotonic_rnnt_op.py:176/214).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..native import rnnt_loss_native
from ..ops.loss import monotonic_rnnt_loss as _padded_loss
from ..ops.packing import monotonic_rnnt_loss_packed

ENGINES = ("native", "torch")


class _NativePackedFunction(torch.autograd.Function):
    """The native engine's costs; its gradient scaled per sample in backward."""

    @staticmethod
    def forward(ctx, acts, labels, input_lengths, label_lengths, alignment,
                max_distance_from_alignment, blank_label):
        # grad mode is off inside forward; needs_input_grad folds it in (the
        # public function detaches under no_grad).
        needs_grad = ctx.needs_input_grad[0]
        costs, grads = rnnt_loss_native(
            acts.detach().numpy(), labels.detach().numpy(),
            input_lengths.detach().numpy(), label_lengths.detach().numpy(),
            blank_id=blank_label,
            alignment=(None if alignment is None
                       else alignment.detach().numpy()),
            max_distance_from_alignment=max_distance_from_alignment,
            with_grads=needs_grad)
        if needs_grad:
            ctx.acts_dtype = acts.dtype
            ctx.save_for_backward(torch.from_numpy(grads), input_lengths,
                                  label_lengths)
        return torch.from_numpy(costs)

    @staticmethod
    def backward(ctx, grad_costs):
        grads, input_lengths, label_lengths = ctx.saved_tensors
        repeats = (input_lengths.to(torch.long)
                   * (label_lengths.to(torch.long) + 1))
        scale = grad_costs.to(grads.dtype).repeat_interleave(repeats)
        return ((scale[:, None] * grads).to(ctx.acts_dtype), None, None,
                None, None, None, None)


def monotonic_rnnt_loss(acts, labels, input_lengths, label_lengths,
                        alignment=None, max_distance_from_alignment: int = 0,
                        blank_label: int = 0,
                        engine: Optional[str] = None) -> torch.Tensor:
    """Reference-compatible packed-layout torch loss.

    acts: [sum_b T_b*(S_b+1), V] float tensor; labels [B, >= S_max] int;
    lengths int [B]; alignment optional [B, >= T_max] int. Labels wider
    than S_max and alignments wider than T_max (bucket-padded metadata) are
    sliced to the widths the lengths imply. Returns per-sample costs [B]
    f32 on acts' device, differentiable w.r.t. acts.

    engine: None (the native engine for CPU tensors, the torch engine
    otherwise), "native" (CPU tensors only) or "torch".
    """
    if engine is None:
        engine = "native" if acts.device.type == "cpu" else "torch"
    if engine not in ENGINES:
        raise ValueError(f"engine must be None or one of the port's engines "
                         f"{ENGINES}; got {engine!r}")
    if engine == "native" and acts.device.type != "cpu":
        raise ValueError("engine='native' needs CPU tensors; CUDA tensors "
                         "route through engine='torch'")
    if engine == "torch":
        return monotonic_rnnt_loss_packed(
            acts, labels, input_lengths, label_lengths, blank_id=blank_label,
            alignment=alignment,
            max_distance_from_alignment=max_distance_from_alignment)
    if not torch.is_grad_enabled():
        # Under no_grad, ctx.needs_input_grad still follows requires_grad;
        # a detached input keeps the call on the cost-only path.
        acts = acts.detach()
    return _NativePackedFunction.apply(
        acts, labels, input_lengths, label_lengths, alignment,
        max_distance_from_alignment, blank_label)


def monotonic_rnnt_loss_padded(logits, labels, input_lengths, label_lengths,
                               alignment=None,
                               max_distance_from_alignment: int = 0,
                               blank_label: int = 0, backend=None):
    """Padded-layout torch loss: the port's ``monotonic_rnnt_loss``.

    logits: [B, T_max, S_max+1, V] float tensor on any device; labels
    [B, S_max] int; lengths int [B]. Returns per-sample costs [B] on
    logits' device, differentiable w.r.t. logits. backend as in
    ``monotonic_rnnt_loss`` ('auto' default: the CUDA kernels for CUDA
    tensors, the oracle for CPU tensors).
    """
    return _padded_loss(
        logits, labels, input_lengths, label_lengths, blank_id=blank_label,
        alignment=alignment,
        max_distance_from_alignment=max_distance_from_alignment,
        backend=backend)


class MonotonicRNNTLoss(torch.nn.Module):
    """Module wrapper with optional reduction (reference API parity)."""

    def __init__(self, blank_label: int = 0, reduction: str = "mean"):
        super().__init__()
        if reduction not in ("none", "mean", "sum"):
            raise ValueError(f"bad reduction {reduction!r}")
        self.blank_label = blank_label
        self.reduction = reduction

    def forward(self, acts, labels, input_lengths, label_lengths,
                alignment=None, max_distance_from_alignment: int = 0):
        costs = monotonic_rnnt_loss(
            acts, labels, input_lengths, label_lengths, alignment,
            max_distance_from_alignment, self.blank_label)
        if self.reduction == "mean":
            return costs.mean()
        if self.reduction == "sum":
            return costs.sum()
        return costs
