"""Public monotonic RNN-T loss API (padded layout, autograd).

PyTorch counterpart of ``monotonic_rnnt_tpu/ops/loss.py``:

  * on the ``cuda`` backend the forward runs only the stats+alpha kernel
    (with the glue kernels loss_prologue before it and loss_costs after);
    when the logits need a gradient it keeps four [B, T, S1] residuals,
    labels_ext and the beta window, and the backward runs beta_operands
    and the beta+grad kernel with the incoming cotangent folded in (the
    deferred-gradient route). A cost-only call never launches the
    beta+grad kernel;
  * on the ``reference`` backend the forward makes the gradient with the
    plain-torch oracle and the backward scales it by the cotangent;
  * the alignment-restricted variant is the same lattice with band masks
    (reference restrict_to_alignment, cpu_workspace_manager.h:207-224).

A call on the ``cuda`` backend whose lengths are on the card queues its
forward before it waits for the lengths' values (``loss_ahead``): one copy
of both lengths to pinned host memory goes first, the forward's launches
queue behind it, and only then does the host wait for that copy and check
the values. So the host prepares the step while the card still runs the
previous one.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..utils.config import get_config
from ..utils.profiling import AHEAD, phase_timer, span, spanned
from ..utils.status import (check_loss_shapes, checked_lengths, copy_lengths,
                            tracing, validate_loss_inputs)
from .bands import Bands, bands_from_alignment, default_bands
from .cuda.fused import (count_live_rows, rnnt_loss_cuda_deferred_bwd,
                         rnnt_loss_cuda_deferred_fwd)
from .reference import rnnt_loss_reference

_BACKENDS = ("auto", "reference", "cuda")


def _resolve_backend(backend: Optional[str], logits: torch.Tensor) -> str:
    backend = backend or get_config().backend
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
    if backend == "auto":
        backend = "cuda" if logits.is_cuda else "reference"
    if backend == "cuda" and not logits.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors, got logits on "
                         f"{logits.device}")
    return backend


class _LossCore(torch.autograd.Function):
    """costs = loss(logits); d costs / d logits by the backend's route."""

    @staticmethod
    @spanned("mrnnt.loss.forward")
    def forward(ctx, logits, labels, input_lengths, label_lengths, band_min,
                band_max, blank_id, backend):
        bands = Bands(band_min, band_max)
        need_grad = ctx.needs_input_grad[0]
        ctx.deferred = backend == "cuda"
        ctx.blank_id = blank_id
        if ctx.deferred:
            logits = logits.contiguous()  # the kernels take contiguous rows
            costs, res = rnnt_loss_cuda_deferred_fwd(
                logits, labels, input_lengths, label_lengths,
                blank_id=blank_id, bands=bands)
            if need_grad:
                ctx.save_for_backward(logits, *res)
            return costs
        costs, grads = rnnt_loss_reference(
            logits, labels, input_lengths, label_lengths, blank_id=blank_id,
            bands=bands, with_grads=need_grad)
        if need_grad:
            ctx.logits_dtype = logits.dtype
            ctx.save_for_backward(grads)
        return costs

    @staticmethod
    @spanned("mrnnt.loss.backward")
    @once_differentiable
    def backward(ctx, cost_cotangent):
        if ctx.deferred:
            logits, *res = ctx.saved_tensors
            dlogits = rnnt_loss_cuda_deferred_bwd(
                logits, res, cost_cotangent, blank_id=ctx.blank_id)
        else:
            (grads,) = ctx.saved_tensors
            dlogits = (grads * cost_cotangent[:, None, None, None]).to(
                ctx.logits_dtype)
        return dlogits, None, None, None, None, None, None, None


@spanned("mrnnt.loss")
def monotonic_rnnt_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    *,
    blank_id: int = 0,
    alignment: Optional[torch.Tensor] = None,
    max_distance_from_alignment: int = 0,
    bands: Optional[Bands] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Monotonic RNN-T negative log-likelihood per sample.

    Args:
      logits: [B, T_max, S_max+1, V] raw (pre-softmax) joint-network outputs.
        Padding cells may hold arbitrary values. f32 or bf16 (the
        forward-backward recursion always accumulates in f32).
      labels: [B, S_max] int target labels (no blanks).
      input_lengths: [B] int frames per sample, 1 <= T_b <= T_max.
      label_lengths: [B] int labels per sample, 0 <= S_b <= min(S_max, T_b).
      blank_id: vocabulary index of the blank symbol.
      alignment: optional [B, T_max] int reference alignment for the
        alignment-restricted variant (reference MonotonicRNNTAlignRestrict op).
      max_distance_from_alignment: half-width of the allowed band around
        `alignment` in frames; 0 scores exactly the given path.
      bands: pre-computed Bands, mutually exclusive with `alignment`.
      backend: 'auto' (default; the CUDA kernels for CUDA tensors, the
        oracle for CPU tensors), 'cuda', or 'reference'.

    The labels, lengths and bands are moved to the logits' device.

    Returns:
      [B] float32 costs (negative log-likelihoods), differentiable w.r.t.
      logits; the gradient comes in the logits' dtype.
    """
    ahead = _queues_ahead(logits, input_lengths, label_lengths, alignment,
                          backend)
    if ahead:
        with span("mrnnt.validate"):
            check_loss_shapes(logits, labels, input_lengths, label_lengths)
            lengths = copy_lengths(input_lengths, label_lengths)
    else:
        host_lengths = validate_loss_inputs(logits, labels, input_lengths,
                                            label_lengths)
    dev = logits.device
    labels = labels.to(dev)
    input_lengths = input_lengths.to(device=dev, dtype=torch.int32)
    label_lengths = label_lengths.to(device=dev, dtype=torch.int32)
    t_max = logits.shape[1]
    if alignment is not None and bands is not None:
        raise ValueError("pass either alignment or bands, not both")
    if bands is None:
        with span("mrnnt.bands"):
            if alignment is not None:
                bands = bands_from_alignment(
                    alignment.to(dev), input_lengths, label_lengths,
                    max_distance_from_alignment, blank_id)
            else:
                bands = default_bands(input_lengths, label_lengths, t_max)
    route = _resolve_backend(backend, logits)
    if ahead:
        return loss_ahead(logits, labels, input_lengths, label_lengths, bands,
                          blank_id, lengths)
    if host_lengths is not None and route == "cuda":
        # This call runs row 1 once.
        count_live_rows(*host_lengths, t_max, logits.shape[2])
    return loss_on_route(logits, labels, input_lengths, label_lengths, bands,
                         blank_id, route)


def _queues_ahead(logits, input_lengths, label_lengths, alignment,
                  backend) -> bool:
    """Whether a call queues its forward before it waits for its lengths:
    on the 'cuda' route, with both lengths on the card, and not while a
    graph is traced (no value checks then). The alignment form checks
    first, as bands_from_alignment gathers at indices the lengths bound;
    the reference route indexes by them too."""
    return (alignment is None and logits.is_cuda and input_lengths.is_cuda
            and label_lengths.is_cuda
            and (backend or get_config().backend) in ("auto", "cuda")
            and not tracing())


def loss_ahead(logits, labels, input_lengths, label_lengths, bands: Bands,
               blank_id: int, lengths) -> torch.Tensor:
    """loss_on_route's 'cuda' route, then the lengths' value checks:
    `lengths` is copy_lengths' copy of the caller's lengths, started before
    this call, and the host waits for it only once the forward's launches
    (loss_prologue, row 1, loss_costs) are queued behind it. The kernels
    keep inside their tensors whatever the lengths hold, so an invalid
    batch raises RnntError here, before its costs reach the caller; they go
    with their autograd node, and no backward runs on them. Then row 1's
    rows are counted from the checked host lengths."""
    _, t_max, s1, _ = logits.shape
    try:
        costs = loss_on_route(logits, labels, input_lengths, label_lengths,
                              bands, blank_id, "cuda")
    except ValueError:
        # Invalid lengths raise first, as where the checks come first.
        with span("mrnnt.validate"):
            checked_lengths(lengths, t_max, s1)
        raise
    AHEAD["validate"] += 1
    with span("mrnnt.validate"):
        ilen, slen = checked_lengths(lengths, t_max, s1)
    count_live_rows(ilen, slen, t_max, s1)
    return costs


def loss_on_route(logits, labels, input_lengths, label_lengths, bands: Bands,
                  blank_id: int, route: str) -> torch.Tensor:
    """monotonic_rnnt_loss on a resolved route ('cuda' or 'reference'),
    its lengths int32 on the logits' device: what the public function runs
    after its checks. It also takes the 'cuda' route on CPU tensors, which
    the public function refuses: each kernel wrapper then runs its plain
    version (how the harness and the tests drive that route's code off the
    card)."""
    dev = logits.device
    if not torch.is_grad_enabled():
        # Under no_grad, ctx.needs_input_grad still follows requires_grad;
        # a detached input keeps the call on the cost-only route.
        logits = logits.detach()
    with debug_timer(f"monotonic_rnnt_loss[{route}]"):
        return _LossCore.apply(logits, labels, input_lengths, label_lengths,
                               bands.min_s.to(dev), bands.max_s.to(dev),
                               int(blank_id), route)


def debug_timer(name: str):
    """The debug_time flag's timer around a public loss call (the JAX
    package's loss.py:175-186): phase_timer waits for the card before and
    after the call, so the time covers its device work. Not while
    torch.export or torch.compile traces a graph, as JAX skips it on
    traced values."""
    if get_config().debug_time and not tracing():
        return phase_timer(name)
    return contextlib.nullcontext()


def monotonic_rnnt_alignment_score(logits, labels, input_lengths,
                                   label_lengths, alignment, *,
                                   blank_id: int = 0, backend=None):
    """Negative log-probability of exactly the given alignment path.

    Convenience wrapper for max_distance_from_alignment=0 (reference
    pytorch_binding/test.py:110-128 semantics).
    """
    return monotonic_rnnt_loss(
        logits, labels, input_lengths, label_lengths, blank_id=blank_id,
        alignment=alignment, max_distance_from_alignment=0, backend=backend)
