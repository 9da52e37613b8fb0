"""Numeric helpers for monotonic RNN-T computations.

PyTorch counterpart of ``monotonic_rnnt_tpu/ops/helpers.py``: stable
log-space arithmetic with explicit -inf semantics (reference
include/rnnt_helper.h:16-83), as elementwise torch ops.
"""

from __future__ import annotations

import torch

# The boundary semantics are exact -inf (rnnt_helper.h:17-19), and
# exp(-inf) == 0 is relied upon by the gradient formula; the NaN-producing
# paths are guarded instead of using a large finite value.
NEG_INF = float("-inf")


def take_index(idx: torch.Tensor, n: int):
    """JAX's take_along_axis rule for an index into an axis of n: a negative
    index counts from the end, and one outside [-n, n) is out of bounds.
    Returns (the index clamped into [0, n), whether it was in bounds)."""
    idx = torch.where(idx < 0, idx + n, idx)
    return idx.clamp(0, n - 1), (idx >= 0) & (idx < n)


def log_sum_exp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise stable log(exp(a) + exp(b)) with -inf short-circuits.

    max + log1p(exp(min - max)), returning -inf (not NaN) when both inputs
    are -inf (rnnt_helper.h:22-30).
    """
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    both_neg_inf = mx == NEG_INF
    diff = torch.where(both_neg_inf, 0.0, mn - mx)
    out = mx + torch.log1p(torch.exp(diff))
    return torch.where(both_neg_inf, NEG_INF, out)


def log_diff_exp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise stable log(exp(a) - exp(b)); requires a >= b.

    Reference parity: include/rnnt_helper.h:33-38.
    """
    eq = a == b
    b_inf = b == NEG_INF
    diff = torch.where(a == NEG_INF, 0.0, b - a)
    out = a + torch.log1p(-torch.exp(diff))
    out = torch.where(b_inf, a, out)
    return torch.where(eq, NEG_INF, out)


def extend_labels(labels: torch.Tensor, label_lengths: torch.Tensor,
                  s1: int, sentinel: int = -1) -> torch.Tensor:
    """[B, S_max] labels -> [B, S1] int32 per-s-slot ids, `sentinel` where s >= S_b.

    The sentinel (-1) never matches a vocabulary index, so equality masks
    against it are exact.
    """
    batch = labels.shape[0]
    lab = labels.to(torch.int32)[:, :s1]
    pad = torch.full((batch, s1 - lab.shape[1]), sentinel, dtype=torch.int32,
                     device=lab.device)
    lab = torch.cat([lab, pad], dim=1)
    s_idx = torch.arange(s1, dtype=torch.int32, device=lab.device)[None, :]
    valid = s_idx < label_lengths.to(torch.int32)[:, None]
    return torch.where(valid, lab, sentinel)


def mask_to_additive(mask: torch.Tensor) -> torch.Tensor:
    """Boolean keep-mask -> additive f32 mask (0 where kept, -inf where not)."""
    return torch.where(mask, 0.0, NEG_INF).to(torch.float32)


def select_label_logits(x: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """x[..., lab[...]] as a gather; out-of-range ids yield 0.0.

    `lab` must broadcast against x's leading axes (e.g. [B, 1, S1] against
    [B, T, S1, V]). Ids outside [0, V) -- the -1 extend_labels sentinel --
    select nothing and yield 0.0, as the JAX package's compare-select form
    does; callers mask those slots. (That form is a TPU workaround for a
    crashing V-axis gather; a gather on a clamped index is exact here.)
    """
    v = x.shape[-1]
    lab = lab.expand(x.shape[:-1])
    idx = lab.clamp(0, v - 1).to(torch.int64)[..., None]
    picked = torch.gather(x, -1, idx)[..., 0]
    return torch.where((lab >= 0) & (lab < v), picked, 0.0)


def shift_right_s(x: torch.Tensor, fill: float = NEG_INF) -> torch.Tensor:
    """Shift along the last (s) axis so out[..., s] = x[..., s-1]; out[..., 0] = fill."""
    pad = torch.full(x.shape[:-1] + (1,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-1]], dim=-1)


def shift_left_s(x: torch.Tensor, fill: float = NEG_INF) -> torch.Tensor:
    """Shift along the last (s) axis so out[..., s] = x[..., s+1]; out[..., -1] = fill."""
    pad = torch.full(x.shape[:-1] + (1,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., 1:], pad], dim=-1)
