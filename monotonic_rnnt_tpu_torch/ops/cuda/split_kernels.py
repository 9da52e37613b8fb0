"""The split pipeline's CUDA kernels, their wrappers and their plain versions.

Counterpart of ``monotonic_rnnt_tpu/ops/pallas/kernels.py:187-289, 846-1101``
on the padded [B, T, S1(, V)] lattice:

* ``softmax_stats`` (TPU kernel at kernels.py:244) launches
  ``mrnnt_softmax_stats_kernel``;
* ``fwdbwd_scan`` (kernels.py:1053) launches ``mrnnt_fwdbwd_warps_kernel``,
  the alpha and beta chains side by side, each a warp for every 32 slots,
  at S1 <= 256 and ``mrnnt_fwdbwd_scan_kernel`` above;
* ``alpha_scan`` (kernels.py:921) launches ``mrnnt_alpha_warps_kernel`` at
  S1 <= 256 and ``mrnnt_alpha_scan_kernel`` above;
* ``beta_scan`` (kernels.py:947) launches ``mrnnt_beta_warps_kernel`` at
  S1 <= 256 and ``mrnnt_beta_scan_kernel`` above; its betas equal
  ``fwdbwd_scan``'s, and ``alpha_scan``'s alphas its alphas, bit for bit;
* ``softmax_stats_partial`` (kernels.py:816), the vocab-sharded losses'
  per-shard (max, sum-exp), launches ``mrnnt_softmax_stats_partial_kernel``;

all from csrc/split.cu. Each keeps its Pallas function's operands and
outputs, except that input_lengths is [B] (the TPU's [B, 1, 1] block shape),
that ``tiles`` and ``interpret`` are gone, and that the scans take any B and
T: the TPU padding to full DP tiles has no counterpart. The scans apply
their additive masks as the port does everywhere: exactly -inf where the
mask is -inf (a select), the mask added elsewhere.

Each row is an operator, ``torch.ops.mrnnt.<name>`` (kernels.define_op):
the plain PyTorch version for CPU tensors, ``<name>_cuda`` (checks,
allocation, launch, one added to ``kernels.LAUNCHES[<name>]``) for CUDA
tensors, and a fake implementation for tracing, so that torch.export and
torch.compile graphs hold them. The stats kernels write their outputs into
one allocation; their operators return it stacked, and the wrappers unbind
it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..helpers import (NEG_INF, log_sum_exp, mask_to_additive,
                       select_label_logits, shift_left_s, shift_right_s)
from .kernels import (LAUNCHES, _call, _check, _check_cuda, _check_device,
                      _check_logits, _ptr, _stacked, define_op)

Pair = Tuple[torch.Tensor, torch.Tensor]


# --- softmax_stats ---------------------------------------------------------------

def softmax_stats_plain(logits, labels_ext, blank_id: int):
    """Plain-torch softmax_stats: the same arguments and outputs."""
    x = logits.float()
    lab = labels_ext[:, None, :] if labels_ext.dim() == 2 else labels_ext
    denom = -torch.logsumexp(x, dim=-1)
    return (denom, x[..., blank_id] + denom,
            select_label_logits(x, lab) + denom)


def softmax_stats_cuda(logits, labels_ext, blank_id: int) -> torch.Tensor:
    """The launch of mrnnt_softmax_stats_kernel behind the op's CUDA
    implementation; returns the stacked [3, B, T, S1] f32 outputs."""
    batch, t_max, s1, v = _check_logits(logits, blank_id)
    dev = logits.device
    per_t = labels_ext.dim() == 3
    _check(labels_ext, "labels_ext", torch.int32,
           (batch, t_max, s1) if per_t else (batch, s1), dev)
    # One allocation for the three outputs: the host prelude is part of a
    # call that the kernel makes short.
    out = torch.empty((3, batch, t_max, s1), dtype=torch.float32, device=dev)
    _call("mrnnt_softmax_stats", dev, _ptr(logits),
          int(logits.dtype == torch.bfloat16), _ptr(labels_ext), int(per_t),
          batch, t_max, s1, v, blank_id, *(_ptr(t) for t in out))
    LAUNCHES["softmax_stats"] += 1
    return out


define_op("softmax_stats", "(Tensor logits, Tensor labels_ext, int blank_id)"
          " -> Tensor", _stacked(softmax_stats_plain), softmax_stats_cuda,
          lambda logits, *_: logits.new_empty((3, *logits.shape[:3]),
                                              dtype=torch.float32))


def softmax_stats(logits, labels_ext, blank_id: int):
    """Log-softmax statistics and the raw label log-prob, one read of the logits.

    logits [B, T, S1, V] f32 or bf16; labels_ext [B, S1] int32, or [B, T, S1]
    when the id of a slot varies with t (the packed band layout). Returns
    (denom, lp_blank, lp_label_raw), each [B, T, S1] f32. An id outside
    [0, V), such as the -1 sentinel, selects nothing: lp_label_raw is then
    denom, and the caller masks the slot.
    """
    _check_device(logits)
    return torch.ops.mrnnt.softmax_stats(logits, labels_ext,
                                         blank_id).unbind(0)


# --- softmax_stats_partial -------------------------------------------------------

def softmax_stats_partial_plain(logits) -> Pair:
    """Plain-torch softmax_stats_partial: the same argument and outputs."""
    x = logits.float()
    m = torch.amax(x, dim=-1)
    # An all -inf row: m = -inf and se = 0 (exp(-inf - 0)), not NaN.
    se = torch.exp(x - torch.where(m == NEG_INF, 0.0, m)[..., None]).sum(-1)
    return m, se


def softmax_stats_partial_cuda(logits) -> torch.Tensor:
    """The launch of mrnnt_softmax_stats_partial_kernel behind the op's
    CUDA implementation; returns the stacked [2, B, T, S1] f32 (m, se)."""
    batch, t_max, s1, v = _check_logits(logits, None)
    dev = logits.device
    out = torch.empty((2, batch, t_max, s1), dtype=torch.float32, device=dev)
    _call("mrnnt_softmax_stats_partial", dev, _ptr(logits),
          int(logits.dtype == torch.bfloat16), batch, t_max, s1, v,
          _ptr(out[0]), _ptr(out[1]))
    LAUNCHES["softmax_stats_partial"] += 1
    return out


define_op("softmax_stats_partial", "(Tensor logits) -> Tensor",
          _stacked(softmax_stats_partial_plain), softmax_stats_partial_cuda,
          lambda logits: logits.new_empty((2, *logits.shape[:3]),
                                          dtype=torch.float32))


def softmax_stats_partial(logits) -> Pair:
    """Per-cell (max, sum-exp) over this shard's vocab slice, one read.

    logits [B, T, S1, V_local] f32 or bf16 (S1 = W on the band layout).
    Returns (m, se), each [B, T, S1] f32: m = max_v x, se = sum_v exp(x - m),
    so that the shards combine exactly: m_g = max m, se_g = sum se *
    exp(m - m_g), denom = -(m_g + log se_g). An all -inf row gives m = -inf,
    se = 0 (the Pallas kernel gives se = NaN there).
    """
    _check_device(logits)
    return torch.ops.mrnnt.softmax_stats_partial(logits).unbind(0)


# --- the scans -------------------------------------------------------------------

def _masked(x, mask_add):
    """-inf where the additive mask is -inf, x + mask elsewhere."""
    return torch.where(mask_add == NEG_INF, NEG_INF, x + mask_add)


def alpha_scan_plain(lp_blank, lp_label, alpha_maskadd):
    """Plain-torch alpha_scan: the same arguments and outputs."""
    batch, t_max, s1 = lp_blank.shape
    s_idx = torch.arange(s1, device=lp_blank.device)
    prev = mask_to_additive(s_idx == 0).expand(batch, s1)
    alphas = torch.empty_like(lp_blank)
    for t in range(t_max):
        new = log_sum_exp(prev + lp_blank[:, t],
                          shift_right_s(prev + lp_label[:, t]))
        prev = _masked(new, alpha_maskadd[:, t])
        alphas[:, t] = prev
    return alphas


def beta_scan_plain(lp_blank, lp_label, beta_maskadd, input_lengths,
                    beta_virtual):
    """Plain-torch beta_scan: the same arguments and outputs."""
    batch, t_max, s1 = lp_blank.shape
    betas = torch.empty_like(lp_blank)
    carry = torch.full((batch, s1), NEG_INF, dtype=torch.float32,
                       device=lp_blank.device)
    for t in range(t_max - 1, -1, -1):
        nxt = torch.where((t + 1 >= input_lengths)[:, None], beta_virtual,
                          carry)
        new = log_sum_exp(nxt + lp_blank[:, t],
                          shift_left_s(nxt) + lp_label[:, t])
        carry = _masked(new, beta_maskadd[:, t])
        betas[:, t] = carry
    return betas


def fwdbwd_scan_plain(lp_blank, lp_label, alpha_maskadd, beta_maskadd,
                      input_lengths, beta_virtual) -> Pair:
    """Plain-torch fwdbwd_scan: the same arguments and outputs."""
    return (alpha_scan_plain(lp_blank, lp_label, alpha_maskadd),
            beta_scan_plain(lp_blank, lp_label, beta_maskadd, input_lengths,
                            beta_virtual))


def _check_streams(named, dev):
    _check_cuda(named[0][1])
    batch, t_max, s1 = named[0][1].shape
    for name, t in named:
        _check(t, name, torch.float32, (batch, t_max, s1), dev)
    return batch, t_max, s1


def _check_beta_extras(input_lengths, beta_virtual, batch, s1, dev):
    _check(input_lengths, "input_lengths", torch.int32, (batch,), dev)
    _check(beta_virtual, "beta_virtual", torch.float32, (batch, s1), dev)


def alpha_scan_cuda(lp_blank, lp_label, alpha_maskadd) -> torch.Tensor:
    """The launch of alpha_scan's kernel behind the op's CUDA
    implementation."""
    dev = lp_blank.device
    batch, t_max, s1 = _check_streams(
        (("lp_blank", lp_blank), ("lp_label", lp_label),
         ("alpha_maskadd", alpha_maskadd)), dev)
    alphas = torch.empty_like(lp_blank)
    _call("mrnnt_alpha_scan", dev, _ptr(lp_blank), _ptr(lp_label),
          _ptr(alpha_maskadd), batch, t_max, s1, _ptr(alphas))
    LAUNCHES["alpha_scan"] += 1
    return alphas


def beta_scan_cuda(lp_blank, lp_label, beta_maskadd, input_lengths,
                   beta_virtual) -> torch.Tensor:
    """The launch of beta_scan's kernel behind the op's CUDA
    implementation."""
    dev = lp_blank.device
    batch, t_max, s1 = _check_streams(
        (("lp_blank", lp_blank), ("lp_label", lp_label),
         ("beta_maskadd", beta_maskadd)), dev)
    _check_beta_extras(input_lengths, beta_virtual, batch, s1, dev)
    betas = torch.empty_like(lp_blank)
    _call("mrnnt_beta_scan", dev, _ptr(lp_blank), _ptr(lp_label),
          _ptr(beta_maskadd), _ptr(input_lengths), _ptr(beta_virtual), batch,
          t_max, s1, _ptr(betas))
    LAUNCHES["beta_scan"] += 1
    return betas


def fwdbwd_scan_cuda(lp_blank, lp_label, alpha_maskadd, beta_maskadd,
                     input_lengths, beta_virtual) -> Pair:
    """The launch of fwdbwd_scan's kernel behind the op's CUDA
    implementation."""
    dev = lp_blank.device
    batch, t_max, s1 = _check_streams(
        (("lp_blank", lp_blank), ("lp_label", lp_label),
         ("alpha_maskadd", alpha_maskadd), ("beta_maskadd", beta_maskadd)),
        dev)
    _check_beta_extras(input_lengths, beta_virtual, batch, s1, dev)
    alphas = torch.empty_like(lp_blank)
    betas = torch.empty_like(lp_blank)
    _call("mrnnt_fwdbwd_scan", dev, _ptr(lp_blank), _ptr(lp_label),
          _ptr(alpha_maskadd), _ptr(beta_maskadd), _ptr(input_lengths),
          _ptr(beta_virtual), batch, t_max, s1, _ptr(alphas), _ptr(betas))
    LAUNCHES["fwdbwd_scan"] += 1
    return alphas, betas


def _like_first(*args):
    return torch.empty_like(args[0])


define_op("alpha_scan", "(Tensor lp_blank, Tensor lp_label, "
          "Tensor alpha_maskadd) -> Tensor", alpha_scan_plain,
          alpha_scan_cuda, _like_first)
define_op("beta_scan", "(Tensor lp_blank, Tensor lp_label, "
          "Tensor beta_maskadd, Tensor input_lengths, Tensor beta_virtual) "
          "-> Tensor", beta_scan_plain, beta_scan_cuda, _like_first)
define_op("fwdbwd_scan", "(Tensor lp_blank, Tensor lp_label, "
          "Tensor alpha_maskadd, Tensor beta_maskadd, Tensor input_lengths, "
          "Tensor beta_virtual) -> (Tensor, Tensor)", fwdbwd_scan_plain,
          fwdbwd_scan_cuda, lambda *args: (_like_first(*args),
                                           _like_first(*args)))


def alpha_scan(lp_blank, lp_label, alpha_maskadd):
    """Cost-only forward DP; returns alphas [B, T, S1] f32.

    lp_blank, lp_label, alpha_maskadd: [B, T, S1] f32 (lp_label -inf on
    invalid label slots, the mask 0 / -inf). Walks t serially:
      alpha(t, s) = LSE(alpha(t-1, s) + lp_blank[t, s],
                        alpha(t-1, s-1) + lp_label[t, s-1]) + mask[t, s],
    exactly -inf where the mask is; alpha(-1, s) = [s == 0].
    """
    _check_device(lp_blank)
    return torch.ops.mrnnt.alpha_scan(lp_blank, lp_label, alpha_maskadd)


def beta_scan(lp_blank, lp_label, beta_maskadd, input_lengths, beta_virtual):
    """Backward DP; returns betas [B, T, S1] f32 (code convention beta(t, s)).

    input_lengths [B] int32; beta_virtual [B, S1] f32, [s == S_b] in log
    space. Walks t from T-1 down to 0:
      nxt = t+1 >= T_b ? beta_virtual : beta(t+1)   (-inf past T_max),
      beta(t, s) = LSE(nxt[s] + lp_blank[t, s],
                       nxt[s+1] + lp_label[t, s]) + mask[t, s],
    exactly -inf where the mask is.
    """
    _check_device(lp_blank)
    return torch.ops.mrnnt.beta_scan(lp_blank, lp_label, beta_maskadd,
                                     input_lengths, beta_virtual)


def fwdbwd_scan(lp_blank, lp_label, alpha_maskadd, beta_maskadd,
                input_lengths, beta_virtual) -> Pair:
    """alpha_scan's and beta_scan's outputs in one launch: (alphas, betas)."""
    _check_device(lp_blank)
    return torch.ops.mrnnt.fwdbwd_scan(lp_blank, lp_label, alpha_maskadd,
                                       beta_maskadd, input_lengths,
                                       beta_virtual)
