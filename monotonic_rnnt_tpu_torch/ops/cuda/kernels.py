"""The DP-fused loss's CUDA kernels, their wrappers and their plain versions.

Counterpart of ``monotonic_rnnt_tpu/ops/pallas/kernels.py:505-776``:

* ``stats_alpha_fused`` (TPU kernel at kernels.py:586) launches
  ``mrnnt_stats_kernel`` then ``mrnnt_alpha_kernel`` (csrc/stats_alpha.cu);
* ``beta_grad_fused`` (TPU kernel at kernels.py:712) launches
  ``mrnnt_beta_kernel`` then ``mrnnt_grad_kernel`` (csrc/beta_grad.cu).

Each wrapper takes its plain PyTorch version (same arguments, same outputs)
for tensors on the CPU, and for CUDA tensors launches its kernels or
raises. Each adds one to ``LAUNCHES[<name>]`` when it has launched. The
TPU tiling helpers (pick_tv_tiles, fused_dp_tiles, the VMEM caps) have no
counterpart: the CUDA kernels pick their own launch shapes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..helpers import (NEG_INF, log_sum_exp, select_label_logits, shift_left_s,
                       shift_right_s)
from . import _build

LAUNCHES = {"stats_alpha_fused": 0, "beta_grad_fused": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> (library, argtypes); see csrc/*.cu for the parameters.
_ENTRIES = {
    "mrnnt_stats": ("stats_alpha", [_P, _I, _P] + [_I] * 5 + [_P] * 4),
    "mrnnt_alpha": ("stats_alpha", [_P] * 4 + [_I] * 3 + [_P] * 2),
    "mrnnt_beta": ("beta_grad", [_P] * 7 + [_I] * 3 + [_P] * 5),
    "mrnnt_grad": ("beta_grad", [_P, _I] + [_P] * 5 + [_I] * 5 + [_P] * 2),
}


def _call(entry: str, device: torch.device, *args) -> None:
    lib_name, argtypes = _ENTRIES[entry]
    lib = _build.load(lib_name)
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = lib.mrnnt_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} ({msg})")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_logits(logits: torch.Tensor, blank_id: int):
    if logits.device.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors (CPU tensors take"
                         f" the plain version), got {logits.device}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if logits.dim() != 4 or not logits.is_contiguous():
        raise ValueError("logits must be a contiguous [B, T, S1, V] tensor, "
                         f"got shape {tuple(logits.shape)}")
    v = logits.shape[3]
    if not 0 <= blank_id < v:
        raise ValueError(f"blank_id must be in [0, {v}), got {blank_id}")
    return tuple(logits.shape)


def _small(shape, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device)


# --- single-kernel launchers (no checks: the wrappers check) -----------------

def launch_stats(logits, labels_ext, blank_id, denom, lp_blank, lp_label):
    """(a) mrnnt_stats_kernel: denom, lp_blank, lp_label from one read."""
    batch, t_max, s1, v = logits.shape
    _call("mrnnt_stats", logits.device, _ptr(logits),
          int(logits.dtype == torch.bfloat16), _ptr(labels_ext), batch, t_max,
          s1, v, blank_id, _ptr(denom), _ptr(lp_blank), _ptr(lp_label))


def launch_alpha(lp_blank, lp_label, a_lo, a_hi, alphas):
    """(b) mrnnt_alpha_kernel: the windowed alpha recurrence."""
    batch, t_max, s1 = lp_blank.shape
    _call("mrnnt_alpha", lp_blank.device, _ptr(lp_blank), _ptr(lp_label),
          _ptr(a_lo), _ptr(a_hi), batch, t_max, s1, _ptr(alphas))


def launch_beta(lpb_bmask, lpl_bmask, aprev_masked, input_lengths, ll_bounded,
                grad_scale, beta_virtual, betas, occ, cb, cl):
    """(c) mrnnt_beta_kernel: betas and the occupancy coefficients."""
    batch, t_max, s1 = lpb_bmask.shape
    _call("mrnnt_beta", lpb_bmask.device, _ptr(lpb_bmask), _ptr(lpl_bmask),
          _ptr(aprev_masked), _ptr(input_lengths), _ptr(ll_bounded),
          _ptr(grad_scale), _ptr(beta_virtual), batch, t_max, s1, _ptr(betas),
          _ptr(occ), _ptr(cb), _ptr(cl))


def launch_grad(logits, denom, occ, cb, cl, labels_ext, blank_id, grads):
    """(d) mrnnt_grad_kernel: the gradient from the coefficients."""
    batch, t_max, s1, v = logits.shape
    _call("mrnnt_grad", logits.device, _ptr(logits),
          int(logits.dtype == torch.bfloat16), _ptr(denom), _ptr(occ), _ptr(cb),
          _ptr(cl), _ptr(labels_ext), batch, t_max, s1, v, blank_id,
          _ptr(grads))


# --- stats + alpha -------------------------------------------------------------

def stats_alpha_fused_plain(logits, labels_ext, a_lo, a_hi, blank_id: int):
    """Plain-torch stats_alpha_fused: the same arguments and outputs."""
    x = logits.float()
    batch, t_max, s1, _ = x.shape
    denom = -torch.logsumexp(x, dim=-1)
    lp_blank = x[..., blank_id] + denom
    picked = select_label_logits(x, labels_ext[:, None, :])
    lp_label = torch.where(labels_ext[:, None, :] >= 0, picked + denom, NEG_INF)

    s_idx = torch.arange(s1, dtype=torch.int32, device=x.device)
    win = (s_idx >= a_lo[..., None]) & (s_idx <= a_hi[..., None])
    prev = torch.where(s_idx == 0, 0.0, NEG_INF).expand(batch, s1)
    alphas = torch.empty_like(denom)
    for t in range(t_max):
        emit = shift_right_s(prev + lp_label[:, t])
        prev = torch.where(win[:, t], log_sum_exp(prev + lp_blank[:, t], emit),
                           NEG_INF)
        alphas[:, t] = prev
    return denom, lp_blank, lp_label, alphas


def stats_alpha_fused(logits, labels_ext, a_lo, a_hi, blank_id: int):
    """One read of the logits: log-softmax stats and the alpha recurrence.

    logits [B, T, S1, V] f32 or bf16; labels_ext [B, S1] int32 (-1 on
    invalid slots); a_lo / a_hi [B, T] int32 inclusive alpha windows,
    already conjoined with t < T_b (hi < lo on invalid rows).
    Returns (denom, lp_blank, lp_label, alphas), each [B, T, S1] f32;
    lp_label is -inf where the label slot is invalid.
    """
    if logits.device.type == "cpu":
        return stats_alpha_fused_plain(logits, labels_ext, a_lo, a_hi,
                                       blank_id)
    batch, t_max, s1, _ = _check_logits(logits, blank_id)
    dev = logits.device
    _check(labels_ext, "labels_ext", torch.int32, (batch, s1), dev)
    _check(a_lo, "a_lo", torch.int32, (batch, t_max), dev)
    _check(a_hi, "a_hi", torch.int32, (batch, t_max), dev)
    denom, lp_blank, lp_label, alphas = (_small((batch, t_max, s1), dev)
                                         for _ in range(4))
    launch_stats(logits, labels_ext, blank_id, denom, lp_blank, lp_label)
    launch_alpha(lp_blank, lp_label, a_lo, a_hi, alphas)
    LAUNCHES["stats_alpha_fused"] += 1
    return denom, lp_blank, lp_label, alphas


# --- beta + grad ---------------------------------------------------------------

def beta_coefficients_plain(lpb_bmask, lpl_bmask, aprev_masked, input_lengths,
                            ll_bounded, beta_virtual, grad_scale):
    """Plain version of (c): (betas, occ, cb, cl), each [B, T, S1] f32."""
    batch, t_max, s1 = lpb_bmask.shape
    ilen = input_lengths
    sc = grad_scale[:, None]
    llb = ll_bounded[:, None]
    betas, occ, cb, cl = (torch.empty_like(lpb_bmask) for _ in range(4))
    carry = torch.full((batch, s1), NEG_INF, dtype=torch.float32,
                       device=lpb_bmask.device)
    for t in range(t_max - 1, -1, -1):
        use_virtual = (t + 1 >= ilen)[:, None]
        nxt = torch.where(use_virtual, beta_virtual, carry)
        nxt_up = shift_left_s(nxt)
        carry = log_sum_exp(nxt + lpb_bmask[:, t], nxt_up + lpl_bmask[:, t])
        betas[:, t] = carry
        # Op order of kernels.py:688-691: sc * exp(aprev + beta - ll).
        ap = aprev_masked[:, t]
        occ[:, t] = sc * torch.exp(ap + carry - llb)
        cb[:, t] = sc * torch.exp(ap + nxt - llb)
        cl[:, t] = sc * torch.exp(ap + nxt_up - llb)
    return betas, occ, cb, cl


def grad_plain(logits, denom, occ, cb, cl, labels_ext, blank_id: int):
    """Plain version of (d): dz in the logits' dtype, 0 where coef == 0."""
    v = logits.shape[3]
    p = torch.exp(logits.float() + denom[..., None])
    v_idx = torch.arange(v, dtype=torch.int32, device=logits.device)
    coef = (occ[..., None]
            - torch.where(v_idx == blank_id, cb[..., None], 0.0)
            - torch.where(v_idx == labels_ext[:, None, :, None],
                          cl[..., None], 0.0))
    return torch.where(coef == 0.0, 0.0, p * coef).to(logits.dtype)


def _ones_scale(grad_scale, batch, device):
    if grad_scale is None:
        return torch.ones((batch,), dtype=torch.float32, device=device)
    return grad_scale


def beta_grad_fused_plain(logits, denom, lpb_bmask, lpl_bmask, aprev_masked,
                          input_lengths, ll_bounded, beta_virtual, labels_ext,
                          blank_id: int,
                          grad_scale: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch beta_grad_fused: the same arguments and outputs."""
    scale = _ones_scale(grad_scale, logits.shape[0], logits.device)
    betas, occ, cb, cl = beta_coefficients_plain(
        lpb_bmask, lpl_bmask, aprev_masked, input_lengths, ll_bounded,
        beta_virtual, scale)
    return grad_plain(logits, denom, occ, cb, cl, labels_ext, blank_id), betas


def beta_grad_fused(logits, denom, lpb_bmask, lpl_bmask, aprev_masked,
                    input_lengths, ll_bounded, beta_virtual, labels_ext,
                    blank_id: int, grad_scale: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One read and one write of the big tensor: betas, occupancy, gradient.

    lpb_bmask / lpl_bmask: stats with the beta window folded in (-inf
    outside it). aprev_masked: [B, T, S1] f32 alpha(t-1, s) where the cell is
    valid (t < T_b and ll finite), exactly -inf elsewhere. input_lengths [B]
    int32; ll_bounded [B] f32 (ll, 0 where infeasible); beta_virtual [B, S1]
    f32; labels_ext [B, S1] int32. grad_scale: optional [B] f32 per-sample
    scale (the cost cotangent); None = 1.
    Returns (grads [B, T, S1, V] in the logits' dtype, betas [B, T, S1] f32).
    """
    if logits.device.type == "cpu":
        return beta_grad_fused_plain(logits, denom, lpb_bmask, lpl_bmask,
                                     aprev_masked, input_lengths, ll_bounded,
                                     beta_virtual, labels_ext, blank_id,
                                     grad_scale)
    batch, t_max, s1, _ = _check_logits(logits, blank_id)
    dev = logits.device
    scale = _ones_scale(grad_scale, batch, dev)
    for name, t in (("denom", denom), ("lpb_bmask", lpb_bmask),
                    ("lpl_bmask", lpl_bmask), ("aprev_masked", aprev_masked)):
        _check(t, name, torch.float32, (batch, t_max, s1), dev)
    _check(input_lengths, "input_lengths", torch.int32, (batch,), dev)
    _check(ll_bounded, "ll_bounded", torch.float32, (batch,), dev)
    _check(scale, "grad_scale", torch.float32, (batch,), dev)
    _check(beta_virtual, "beta_virtual", torch.float32, (batch, s1), dev)
    _check(labels_ext, "labels_ext", torch.int32, (batch, s1), dev)
    betas, occ, cb, cl = (_small((batch, t_max, s1), dev) for _ in range(4))
    grads = torch.empty_like(logits)
    launch_beta(lpb_bmask, lpl_bmask, aprev_masked, input_lengths, ll_bounded,
                scale, beta_virtual, betas, occ, cb, cl)
    launch_grad(logits, denom, occ, cb, cl, labels_ext, blank_id, grads)
    LAUNCHES["beta_grad_fused"] += 1
    return grads, betas
