"""Collective (vocab-sharded) softmax statistics for tensor parallelism.

PyTorch counterpart of ``monotonic_rnnt_tpu/ops/collective.py``. When the
logits' vocab axis is sharded over a process group (one process per shard),
each shard computes its per-cell (max, sum-exp) in one pass
(``softmax_stats_partial``); an all-reduce MAX and an all-reduce SUM combine
them into the global log-softmax denominator, and an all-reduce SUM of each
shard's picks recovers the blank and label columns. These are the V-dependent
core of every vocab-sharded loss: the padded lattice and the packed band
layout (parallel/sharding.py) and the fused-joint losses (ops/chunked.py,
ops/chunked_banded.py with ``group=...``).

Where JAX names a mesh axis (``axis_name``), the port takes a
``torch.distributed`` process group: ``pmax`` becomes ``all_reduce(MAX)``,
``psum`` ``all_reduce(SUM)`` and ``axis_index`` the rank in the group. A
shard holds the columns [rank * V_local, (rank + 1) * V_local). Every rank
of the group must call these functions in the same order with the same
shapes: each call issues two all-reduces.

Two choices differ from the JAX package without changing a finite result:
the three SUMs travel as one stacked all-reduce, and whether any shard owns
a label id is read from the id itself (0 <= id < V_local * group size)
instead of from a fourth all-reduce. A shard whose row is all -inf gives
m = -inf and se = 0 and adds nothing, where the Pallas kernel's se = NaN
would poison the sum.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .banded import BandStats
from .cuda.kernels import kernel_or_plain
from .cuda.split_kernels import (softmax_stats_partial,
                                 softmax_stats_partial_plain)
from .helpers import NEG_INF, select_label_logits
from .reference import LatticeStats


def local_max_sumexp(x_local: torch.Tensor) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Pre-reduction (m, sum-exp) per lattice cell over the local V slice:
    the kernel on CUDA tensors (its plain version under the 'reference'
    backend), the plain version on CPU tensors."""
    return kernel_or_plain(softmax_stats_partial, softmax_stats_partial_plain,
                           x_local)(x_local.contiguous())


def _shard(x_local: torch.Tensor, group) -> Tuple[int, int]:
    """(v_offset, V_global) of this rank's slice."""
    v_local = x_local.shape[-1]
    return (dist.get_rank(group) * v_local,
            dist.get_world_size(group) * v_local)


def _combine(x_local, group, blank_id: int, v_offset: int,
             lab_rel: torch.Tensor):
    """(denom, x[blank], x[label]) of every cell, over all shards.

    lab_rel: this shard's label ids relative to v_offset, broadcastable to
    x_local's leading axes; ids outside [0, V_local) pick nothing here.
    """
    m_loc, se_loc = local_max_sumexp(x_local)
    m = m_loc.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    # A shard with nothing finite in a row (se 0) adds exactly 0, even where
    # every shard's row is -inf (m_loc - m would be NaN there).
    scaled = torch.where(se_loc == 0, 0.0, se_loc * torch.exp(m_loc - m))
    v_local = x_local.shape[-1]
    rel_b = blank_id - v_offset
    if 0 <= rel_b < v_local:
        xb = x_local[..., rel_b].float()
    else:
        xb = torch.zeros_like(scaled)
    xl = select_label_logits(x_local, lab_rel).float()
    sums = torch.stack([scaled, xb, xl])
    dist.all_reduce(sums, group=group)
    return -(m + torch.log(sums[0])), sums[1], sums[2]


def sharded_lattice_stats(x_local: torch.Tensor, labels_ext: torch.Tensor,
                          blank_id: int, group: Optional[dist.ProcessGroup]):
    """Global LatticeStats from a local vocab slice; returns (stats, v_offset).

    x_local: [B, T, S1, V_local] f32 or bf16, this shard's columns
      [v_offset, v_offset + V_local) of the joint logits.
    labels_ext: [B, S1] int32 global label ids (the -1 sentinel, and any id
      past the last shard, is owned by no shard and gives lp_label -inf).
    """
    v_offset, v_global = _shard(x_local, group)
    rel = (labels_ext - v_offset)[:, None, :]
    denom, xb, xl = _combine(x_local, group, blank_id, v_offset, rel)
    owned = ((labels_ext >= 0) & (labels_ext < v_global))[:, None, :]
    return LatticeStats(denom=denom, lp_blank=xb + denom,
                        lp_label=torch.where(owned, xl + denom,
                                             NEG_INF)), v_offset


def sharded_band_stats(x_local: torch.Tensor, lab_band: torch.Tensor,
                       blank_id: int, group: Optional[dist.ProcessGroup]):
    """Global BandStats from a local vocab slice of the packed band layout.

    The recipe of sharded_lattice_stats on [B, T, W] cells, with the per-slot
    label ids lab_band [B, T, W] (-1 sentinel). Returns (stats, v_offset).
    """
    v_offset, v_global = _shard(x_local, group)
    denom, xb, xl = _combine(x_local, group, blank_id, v_offset,
                             lab_band - v_offset)
    owned = (lab_band >= 0) & (lab_band < v_global)
    return BandStats(denom=denom, lp_blank=xb + denom,
                     lp_label=torch.where(owned, xl + denom,
                                          NEG_INF)), v_offset
