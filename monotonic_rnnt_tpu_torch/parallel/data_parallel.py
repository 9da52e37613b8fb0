"""Data-parallel loss over a process mesh.

PyTorch counterpart of ``monotonic_rnnt_tpu/parallel/data_parallel.py``:
every rank runs the whole loss pipeline on its batch shard; the only
communication is the all-reduce of the scalar.

The scalar's all-reduce is an autograd Function that sums in the forward and
passes the cotangent through unchanged in the backward, which is how the
JAX ``psum`` under ``shard_map`` transposes: each rank's gradient is its
slice of the global gradient. ``torch.distributed.nn.functional.all_reduce``
would all-reduce the cotangent too and scale every gradient by the group's
size.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.loss import monotonic_rnnt_loss
from .mesh import Mesh


class _SumOver(torch.autograd.Function):
    """All-reduce SUM forward; the cotangent passes through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def batch_total(costs: torch.Tensor, mesh: Mesh,
                mean_over_batch: bool) -> torch.Tensor:
    """The global sum of the per-sample costs over the data axis, or their
    mean over the global batch (the count all-reduced too)."""
    total = _SumOver.apply(costs.sum().reshape(1), mesh.data_group)[0]
    if not mean_over_batch:
        return total
    n = torch.tensor([float(costs.shape[0])], device=costs.device)
    dist.all_reduce(n, group=mesh.data_group)
    return total / n[0]


def make_data_parallel_loss(mesh: Mesh, *, blank_id: int = 0,
                            backend: Optional[str] = None,
                            mean_over_batch: bool = True):
    """Data-parallel loss over `mesh`'s 'data' axis.

    Returns fn(logits, labels, input_lengths, label_lengths) -> scalar: this
    rank's batch shard in (logits [B/data, T, S1, V], the rest [B/data]),
    the mean (or sum) over the global batch out, the same on every rank.
    Differentiable; each rank's logit gradient is its slice of the global
    one (no gradient communication: the loss is batch-separable).
    """

    def fn(logits, labels, input_lengths, label_lengths):
        costs = monotonic_rnnt_loss(logits, labels, input_lengths,
                                    label_lengths, blank_id=blank_id,
                                    backend=backend)
        return batch_total(costs, mesh, mean_over_batch)

    return fn


def make_per_sample_loss(mesh: Mesh, *, blank_id: int = 0,
                         backend: Optional[str] = None):
    """Data-parallel loss returning this rank's per-sample costs [B/data].

    The global [B] costs (JAX's batch-sharded output) are the ranks' slices
    in data-index order; this rank's shard needs no communication.
    """

    def fn(logits, labels, input_lengths, label_lengths):
        return monotonic_rnnt_loss(logits, labels, input_lengths,
                                   label_lengths, blank_id=blank_id,
                                   backend=backend)

    return fn
