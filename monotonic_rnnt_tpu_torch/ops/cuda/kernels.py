"""The CUDA kernels' common launch machinery, and the padded loss's kernels.

Counterpart of ``monotonic_rnnt_tpu/ops/pallas/kernels.py:505-776, 1304-1360``:

* ``stats_alpha_fused`` (TPU kernel at kernels.py:586) launches
  ``mrnnt_stats_alpha_kernel`` (csrc/stats_alpha.cu), one persistent launch
  whose alpha chains trail its stats tiles, over the live lattice only;
* ``beta_grad_fused`` (TPU kernel at kernels.py:712) launches
  ``mrnnt_beta_grad_kernel`` (csrc/beta_grad.cu), one persistent launch
  whose beta chains run ahead of its gradient tiles;
* ``grad_pass`` (TPU kernel at kernels.py:1322) launches
  ``mrnnt_grad_kernel`` (csrc/grad_pass.cu), for the banded and the split
  routes, the fused-joint losses' chunks and the vocab-sharded losses'
  local slices. It and ``beta_grad_fused`` write every gradient row with
  the same device code (csrc/common.cuh's ``grad_row``);
* ``loss_prologue``, ``loss_costs`` and ``beta_operands`` (no TPU kernel:
  XLA fuses this glue of ops/pallas/fused.py) launch the kernels of
  csrc/loss_glue.cu, the padded loss's small-array glue around rows 1-2:
  labels_ext and the windows before row 1, the costs after it, and row
  2's masked operands.

Rows 1-11 of the kernel table (every kernel a loss route runs) and the
glue kernels are operators in the ``mrnnt`` namespace (``torch.ops.mrnnt.<row>``), each
registered by ``define_op``: its plain PyTorch version is the CPU
implementation, a module-level ``<row>_cuda`` function (checks,
allocation, launch, count; looked up by name at each call, so a shim on it
sees live, exported and compiled calls alike) the CUDA one, and a fake
implementation gives the outputs' shapes and dtypes without reading data
or building anything. So ``torch.export`` and ``torch.compile`` trace
every kernel route into a graph that holds the operators (serving.py), as
``jax.export`` and ``jax.jit`` trace the JAX package's. Outputs that one
allocation holds (rows 1, 3, 7, 10) come stacked, and the wrapper unbinds
them: an operator's outputs may not alias each other. The copy kernels of
rows 12-14 (ops/cuda/stream.py) are on no loss route and stay ctypes calls.
The operators are registered through ``torch.library.Library``'s
``define`` and ``impl``, which add less host time to a call than
``torch.library.custom_op``: 7.75 µs against 23.08 µs for an operator
around ``Tensor.clone`` on an NVIDIA H100 (700 W), measured once when the
rows became operators (CHANGES.md).

Each wrapper keeps its name and arguments and calls its operator on every
device: tensors on the CPU take the plain version through it, CUDA tensors
launch the kernel or raise, and a tensor on another device is refused.
The CUDA implementation adds one to ``LAUNCHES[<name>]`` (the port's
launch counters, ``utils/profiling.py``) when it has launched. The TPU
tiling helpers (pick_tv_tiles, fused_dp_tiles, the VMEM caps) have no
counterpart: the CUDA kernels pick their own launch shapes.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Callable, Optional, Tuple

import torch

from ...utils.config import get_config
from ...utils.profiling import LAUNCHES, span
from ..bands import Bands, _window_bounds
from ..helpers import (NEG_INF, extend_labels, log_sum_exp, mask_to_additive,
                       select_label_logits, shift_left_s, shift_right_s)
from ..reference import _gather_ll
from . import _build

LAUNCHES.update({"stats_alpha_fused": 0, "beta_grad_fused": 0,
                 "grad_pass": 0, "softmax_stats_banded": 0,
                 "fwdbwd_scan_banded": 0, "alpha_scan_banded": 0,
                 "softmax_stats": 0, "fwdbwd_scan": 0, "alpha_scan": 0,
                 "beta_scan": 0, "softmax_stats_partial": 0,
                 "stream_copy": 0, "stream_copy_blocked": 0,
                 "stream_copy_blocked_tbsv": 0, "loss_prologue": 0,
                 "loss_costs": 0, "beta_operands": 0})


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_kernels(x: torch.Tensor) -> bool:
    """Whether a path calls the CUDA kernels on x, or their plain versions.

    True for a CUDA tensor under any config backend but 'reference', which
    forces the plain versions on the card too: the counterpart of the JAX
    package's use_pallas_kernels (monotonic_rnnt_tpu/ops/loss.py:46-58).
    The paths that choose their backend themselves (ops/loss.py,
    ops/banded.py) do not need it.
    """
    return x.is_cuda and get_config().backend != "reference"


def kernel_or_plain(kernel, plain, x: torch.Tensor):
    """`kernel` where use_kernels(x) or x lies on the CPU (a wrapper takes
    its plain version there by itself), `plain` for a CUDA tensor under the
    'reference' backend."""
    return kernel if use_kernels(x) or not x.is_cuda else plain


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> (library, argtypes); see csrc/*.cu for the parameters.
_ENTRIES = {
    "mrnnt_stats_alpha": ("stats_alpha", [_P, _I] + [_P] * 5 + [_I] * 5
                          + [_P] * 6),
    "mrnnt_beta_grad": ("beta_grad", [_P, _I] + [_P] * 9 + [_I] * 5
                        + [_P] * 5),
    "mrnnt_grad": ("grad_pass", [_P, _I] + [_P] * 5 + [_I] * 6 + [_P, _I,
                                                                 _P]),
    "mrnnt_stats_banded": ("banded", [_P, _I] + [_P] * 5 + [_I] * 5
                           + [_P] * 7),
    "mrnnt_stats_banded_shape": ("banded", [_P] + [_I] * 6 + [_P]),
    "mrnnt_alpha_banded": ("banded", [_P] * 3 + [_I] * 3 + [_P] * 2),
    "mrnnt_fwdbwd_banded": ("banded", [_P] * 8 + [_I] * 3 + [_P] * 3),
    "mrnnt_softmax_stats": ("split", [_P, _I, _P] + [_I] * 6 + [_P] * 4),
    "mrnnt_softmax_stats_partial": ("split", [_P] + [_I] * 5 + [_P] * 3),
    "mrnnt_alpha_scan": ("split", [_P] * 3 + [_I] * 3 + [_P] * 2),
    "mrnnt_beta_scan": ("split", [_P] * 5 + [_I] * 3 + [_P] * 2),
    "mrnnt_fwdbwd_scan": ("split", [_P] * 6 + [_I] * 3 + [_P] * 3),
    "mrnnt_stream_copy_vmem": ("stream", [_P, _P, _I, _L, _P]),
    "mrnnt_stream_copy_dma": ("stream", [_P, _P, _P, _I, _L, _P]),
    "mrnnt_stream_copy_blocked": ("stream", [_P] * 3 + [_I] * 6 + [_P]),
    "mrnnt_stream_copy_blocked_tbsv": ("stream", [_P, _P] + [_I] * 6 + [_P]),
    "mrnnt_loss_prologue": ("loss_glue", [_P, _I, _I] + [_P] * 4 + [_I] * 3
                            + [_P] * 3),
    "mrnnt_loss_costs": ("loss_glue", [_P] * 3 + [_I] * 3 + [_P] * 3),
    "mrnnt_beta_operands": ("loss_glue", [_P] * 8 + [_I] * 3 + [_P] * 4),
}


_BOUND = {}   # entry -> (function with argtypes set, its library)


def _bound(entry: str):
    """The C entry point, its argtypes and restype set once, at first use."""
    hit = _BOUND.get(entry)
    if hit is None:
        lib_name, argtypes = _ENTRIES[entry]
        lib = _build.load(lib_name)
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        hit = _BOUND[entry] = (fn, lib)
    return hit


def _call(entry: str, device: torch.device, *args) -> None:
    """Launches `entry` on `device`'s current stream, in the span
    ``mrnnt.launch.<entry>``. The stream is read as
    its raw handle: ``torch.cuda.current_stream()`` builds a Stream object
    (a second device lookup) only to give that handle, several µs of a
    call's host prelude."""
    fn, lib = _bound(entry)
    raw_stream = torch._C._cuda_getCurrentRawStream
    current = torch.cuda.current_device()
    with span("mrnnt.launch." + entry):
        if device.index is None or device.index == current:
            err = fn(*args, raw_stream(current))
        else:
            with torch.cuda.device(device):
                err = fn(*args, raw_stream(device.index))
    if err != 0:
        msg = lib.mrnnt_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} ({msg})")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


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


def _check_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors (CPU tensors take"
                         f" the plain version), got {t.device}")


def _check_device(x: torch.Tensor) -> None:
    """A wrapper's one check: the CPU (the plain version) or CUDA."""
    if x.device.type != "cpu":
        _check_cuda(x)


_FLOATS = (torch.float32, torch.bfloat16)

_LIB = torch.library.Library("mrnnt", "FRAGMENT")
# Operator name -> (CPU implementation, module of the CUDA implementation,
# its name there).
OPS = {}


def define_op(name: str, schema: str, cpu: Callable, cuda: Callable,
              fake: Callable) -> None:
    """Registers ``torch.ops.mrnnt.<name>`` with the argument list and
    results `schema`: `cpu` (the plain version) for CPU tensors; for CUDA
    tensors the module-level function `cuda`, looked up by its name at each
    call; `fake` for tracing (shapes and dtypes only)."""
    module, attr = sys.modules[cuda.__module__], cuda.__name__
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, lambda *args: getattr(module, attr)(*args), "CUDA")
    torch.library.register_fake(f"mrnnt::{name}", fake, lib=_LIB)
    OPS[name] = (cpu, module, attr)


def _stacked(plain: Callable) -> Callable:
    """The CPU implementation of an operator whose outputs one allocation
    holds: the plain version's outputs, stacked."""
    return lambda *args: torch.stack(plain(*args))


def _check_logits(logits: torch.Tensor, blank_id: Optional[int]):
    """Checks the big tensor, and that blank_id is in [0, V) unless it is
    None (grad_pass takes any int, as its Pallas function does)."""
    _check_cuda(logits)
    if logits.dtype not in _FLOATS:
        raise ValueError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if logits.dim() != 4 or not logits.is_contiguous():
        raise ValueError("logits must be a contiguous [B, T, S1 or W, V] "
                         f"tensor, got shape {tuple(logits.shape)}")
    v = logits.shape[3]
    if blank_id is not None and not 0 <= blank_id < v:
        raise ValueError(f"blank_id must be in [0, {v}), got {blank_id}")
    return tuple(logits.shape)


def _small(shape, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device)


# --- single-kernel launchers (no checks: the wrappers check) -----------------

def launch_stats_alpha(logits, labels_ext, a_lo, a_hi, input_lengths,
                       label_lengths, blank_id, out, sync):
    """mrnnt_stats_alpha_kernel: out [4, B, T, S1] f32 gets denom, lp_blank,
    lp_label and alphas; sync: B*T + 2 int32 zeros (ready flags, tickets)."""
    batch, t_max, s1, v = logits.shape
    _call("mrnnt_stats_alpha", logits.device, _ptr(logits),
          int(logits.dtype == torch.bfloat16), _ptr(labels_ext), _ptr(a_lo),
          _ptr(a_hi), _ptr(input_lengths), _ptr(label_lengths), batch, t_max,
          s1, v, blank_id, _ptr(out[0]), _ptr(out[1]), _ptr(out[2]),
          _ptr(out[3]), _ptr(sync))


def launch_beta_grad(logits, denom, lpb_bmask, lpl_bmask, aprev_masked,
                     input_lengths, ll_bounded, grad_scale, beta_virtual,
                     labels_ext, blank_id, grads, betas, coef, sync):
    """mrnnt_beta_grad_kernel: grads and betas; coef [3, B, T, S1] f32
    scratch; sync: B + 2 int32 zeros (progress words, tickets);
    grad_scale None = 1."""
    batch, t_max, s1, v = logits.shape
    _call("mrnnt_beta_grad", logits.device, _ptr(logits),
          int(logits.dtype == torch.bfloat16), _ptr(denom), _ptr(lpb_bmask),
          _ptr(lpl_bmask), _ptr(aprev_masked), _ptr(input_lengths),
          _ptr(ll_bounded), _ptr(grad_scale), _ptr(beta_virtual),
          _ptr(labels_ext), batch, t_max, s1, v, blank_id, _ptr(grads),
          _ptr(betas), _ptr(coef), _ptr(sync))


def launch_grad(logits, denom, occ, cb, cl, labels_ext, blank_id, grads):
    """mrnnt_grad_kernel: the gradient from the coefficients.

    labels_ext is [B, S1] or [B, T, S1]; grads f32 or bf16.
    """
    batch, t_max, s1, v = logits.shape
    _call("mrnnt_grad", logits.device, _ptr(logits),
          int(logits.dtype == torch.bfloat16), _ptr(denom), _ptr(occ), _ptr(cb),
          _ptr(cl), _ptr(labels_ext), int(labels_ext.dim() == 3), batch,
          t_max, s1, v, blank_id, _ptr(grads),
          int(grads.dtype == torch.bfloat16))


# --- stats + alpha -------------------------------------------------------------

def live_cells(input_lengths, label_lengths, t_max: int, s1: int):
    """[B, T, S1] bool: the live lattice cells t < T'_b, s <= S_b, the only
    ones whose logits row 1 reads."""
    dev = input_lengths.device
    t_idx = torch.arange(t_max, dtype=torch.int32, device=dev)
    s_idx = torch.arange(s1, dtype=torch.int32, device=dev)
    return ((t_idx[None, :, None] < input_lengths[:, None, None])
            & (s_idx[None, None, :] <= label_lengths[:, None, None]))


def stats_alpha_fused_plain(logits, labels_ext, a_lo, a_hi, input_lengths,
                            label_lengths, blank_id: int):
    """Plain-torch stats_alpha_fused: the same arguments and outputs, the
    fill on the same cells."""
    x = logits.float()
    batch, t_max, s1, _ = x.shape
    live = live_cells(input_lengths, label_lengths, t_max, s1)
    denom = -torch.logsumexp(x, dim=-1)
    lp_blank = torch.where(live, x[..., blank_id] + denom, NEG_INF)
    picked = select_label_logits(x, labels_ext[:, None, :])
    lp_label = torch.where(live & (labels_ext[:, None, :] >= 0),
                           picked + denom, NEG_INF)
    denom = torch.where(live, denom, 0.0)

    s_idx = torch.arange(s1, dtype=torch.int32, device=x.device)
    win = (s_idx >= a_lo[..., None]) & (s_idx <= a_hi[..., None]) & live
    prev = torch.where(s_idx == 0, 0.0, NEG_INF).expand(batch, s1)
    alphas = torch.empty_like(denom)
    for t in range(t_max):
        emit = shift_right_s(prev + lp_label[:, t])
        prev = torch.where(win[:, t], log_sum_exp(prev + lp_blank[:, t], emit),
                           NEG_INF)
        alphas[:, t] = prev
    return denom, lp_blank, lp_label, alphas


def stats_alpha_cuda(logits, labels_ext, a_lo, a_hi, input_lengths,
                     label_lengths, blank_id: int):
    """The launch of mrnnt_stats_alpha_kernel behind the op's CUDA
    implementation: checks, allocation, launch, count. Returns the stacked
    [4, B, T, S1] f32 outputs."""
    batch, t_max, s1, _ = _check_logits(logits, blank_id)
    dev = logits.device
    _check(labels_ext, "labels_ext", torch.int32, (batch, s1), dev)
    _check(a_lo, "a_lo", torch.int32, (batch, t_max), dev)
    _check(a_hi, "a_hi", torch.int32, (batch, t_max), dev)
    _check(input_lengths, "input_lengths", torch.int32, (batch,), dev)
    _check(label_lengths, "label_lengths", torch.int32, (batch,), dev)
    out = _small((4, batch, t_max, s1), dev)
    sync = torch.zeros(batch * t_max + 2, dtype=torch.int32, device=dev)
    launch_stats_alpha(logits, labels_ext, a_lo, a_hi, input_lengths,
                       label_lengths, blank_id, out, sync)
    LAUNCHES["stats_alpha_fused"] += 1
    return out


define_op("stats_alpha_fused",
          "(Tensor logits, Tensor labels_ext, Tensor a_lo, Tensor a_hi, "
          "Tensor input_lengths, Tensor label_lengths, SymInt blank_id) -> "
          "Tensor",
          _stacked(stats_alpha_fused_plain), stats_alpha_cuda,
          lambda logits, *_: logits.new_empty((4, *logits.shape[:3]),
                                              dtype=torch.float32))


def stats_alpha_fused(logits, labels_ext, a_lo, a_hi, input_lengths,
                      label_lengths, blank_id: int):
    """One read of the live logits: log-softmax stats and the alpha
    recurrence.

    logits [B, T, S1, V] f32 or bf16; labels_ext [B, S1] int32 (-1 on
    invalid slots); a_lo / a_hi [B, T] int32 inclusive alpha windows,
    already conjoined with t < T_b (hi < lo on invalid rows);
    input_lengths T'_b and label_lengths S_b [B] int32.
    Returns (denom, lp_blank, lp_label, alphas), each [B, T, S1] f32;
    lp_label is -inf where the label slot is invalid. Only the live cells
    (t < T'_b, s <= S_b, ``live_cells``) are read; every other cell holds
    the fill of a row of probability zero: denom 0, lp_blank, lp_label
    and alphas -inf. The Pallas kernel computes the stats of those cells
    too; no caller reads them, and costs and gradients are the same.

    Goes through the operator ``torch.ops.mrnnt.stats_alpha_fused``, which
    returns one stacked tensor; the four views are taken here.
    """
    _check_device(logits)
    return tuple(torch.ops.mrnnt.stats_alpha_fused(
        logits, labels_ext, a_lo, a_hi, input_lengths, label_lengths,
        blank_id).unbind(0))


# --- beta + grad ---------------------------------------------------------------

def beta_coefficients_plain(lpb_bmask, lpl_bmask, aprev_masked, input_lengths,
                            ll_bounded, beta_virtual, grad_scale):
    """The beta chain's plain version: (betas, occ, cb, cl), each [B, T, S1]
    f32."""
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


def grad_pass_plain(logits, denom, occ, cb, cl, labels_ext, blank_id: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain-torch grad_pass: the same arguments and outputs."""
    v = logits.shape[3]
    lab = labels_ext[:, None, :] if labels_ext.dim() == 2 else labels_ext
    p = torch.exp(logits.float() + denom[..., None])
    v_idx = torch.arange(v, dtype=torch.int32, device=logits.device)
    coef = (occ[..., None]
            - torch.where(v_idx == blank_id, cb[..., None], 0.0)
            - torch.where(v_idx == lab[..., None], cl[..., None], 0.0))
    return torch.where(coef == 0.0, 0.0, p * coef).to(out_dtype)


def grad_pass_cuda(logits, denom, occ, cb, cl, labels_ext, blank_id: int,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """The launch of mrnnt_grad_kernel behind the op's CUDA implementation:
    checks, allocation, launch, count."""
    batch, t_max, s1, _ = _check_logits(logits, None)
    dev = logits.device
    if out_dtype not in _FLOATS:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    for name, t in (("denom", denom), ("occ", occ), ("cb", cb), ("cl", cl)):
        _check(t, name, torch.float32, (batch, t_max, s1), dev)
    _check(labels_ext, "labels_ext", torch.int32,
           (batch, s1) if labels_ext.dim() == 2 else (batch, t_max, s1), dev)
    grads = torch.empty(logits.shape, dtype=out_dtype, device=dev)
    launch_grad(logits, denom, occ, cb, cl, labels_ext, blank_id, grads)
    LAUNCHES["grad_pass"] += 1
    return grads


define_op("grad_pass",
          "(Tensor logits, Tensor denom, Tensor occ, Tensor cb, Tensor cl, "
          "Tensor labels_ext, int blank_id, ScalarType out_dtype) -> Tensor",
          grad_pass_plain, grad_pass_cuda,
          lambda logits, *args: logits.new_empty(logits.shape,
                                                 dtype=args[-1]))


def grad_pass(logits, denom, occ, cb, cl, labels_ext, blank_id: int,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dL/dz from per-cell coefficients: one read of logits, one write of grads.

    logits [B, T, S1, V] f32 or bf16 (S1 = W on the band layout); denom,
    occ, cb, cl [B, T, S1] f32; labels_ext [B, S1] or [B, T, S1] int32 (-1
    sentinel). Returns grads [B, T, S1, V] in out_dtype (f32 or bf16):
    p * (occ - [v == blank] cb - [v == label] cl), 0 where that is 0.
    blank_id and the label ids may be any int: on a vocab shard the caller
    passes ids relative to its first column, and an id outside [0, V)
    matches no column. Goes through ``torch.ops.mrnnt.grad_pass``.
    """
    _check_device(logits)
    return torch.ops.mrnnt.grad_pass(logits, denom, occ, cb, cl, labels_ext,
                                     blank_id, out_dtype)


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
    return grad_pass_plain(logits, denom, occ, cb, cl, labels_ext, blank_id,
                           logits.dtype), betas


def beta_grad_cuda(logits, denom, lpb_bmask, lpl_bmask, aprev_masked,
                   input_lengths, ll_bounded, beta_virtual, labels_ext,
                   blank_id: int, grad_scale: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch of mrnnt_beta_grad_kernel behind the op's CUDA
    implementation: checks, allocation, launch, count."""
    batch, t_max, s1, _ = _check_logits(logits, blank_id)
    dev = logits.device
    for name, t in (("denom", denom), ("lpb_bmask", lpb_bmask),
                    ("lpl_bmask", lpl_bmask), ("aprev_masked", aprev_masked)):
        _check(t, name, torch.float32, (batch, t_max, s1), dev)
    _check(input_lengths, "input_lengths", torch.int32, (batch,), dev)
    _check(ll_bounded, "ll_bounded", torch.float32, (batch,), dev)
    if grad_scale is not None:
        _check(grad_scale, "grad_scale", torch.float32, (batch,), dev)
    _check(beta_virtual, "beta_virtual", torch.float32, (batch, s1), dev)
    _check(labels_ext, "labels_ext", torch.int32, (batch, s1), dev)
    betas = _small((batch, t_max, s1), dev)
    coef = _small((3, batch, t_max, s1), dev)
    sync = torch.zeros(batch + 2, dtype=torch.int32, device=dev)
    grads = torch.empty_like(logits)
    launch_beta_grad(logits, denom, lpb_bmask, lpl_bmask, aprev_masked,
                     input_lengths, ll_bounded, grad_scale, beta_virtual,
                     labels_ext, blank_id, grads, betas, coef, sync)
    LAUNCHES["beta_grad_fused"] += 1
    return grads, betas


define_op("beta_grad_fused",
          "(Tensor logits, Tensor denom, Tensor lpb_bmask, Tensor lpl_bmask, "
          "Tensor aprev_masked, Tensor input_lengths, Tensor ll_bounded, "
          "Tensor beta_virtual, Tensor labels_ext, SymInt blank_id, "
          "Tensor? grad_scale) -> (Tensor, Tensor)",
          beta_grad_fused_plain, beta_grad_cuda,
          lambda logits, denom, *_: (torch.empty_like(logits),
                                     torch.empty_like(denom)))


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
    Returns (grads [B, T, S1, V] in the logits' dtype, betas [B, T, S1] f32),
    through the operator ``torch.ops.mrnnt.beta_grad_fused``.
    """
    _check_device(logits)
    return torch.ops.mrnnt.beta_grad_fused(
        logits, denom, lpb_bmask, lpl_bmask, aprev_masked, input_lengths,
        ll_bounded, beta_virtual, labels_ext, blank_id, grad_scale)


# --- the padded loss's glue around rows 1-2 -----------------------------------

def loss_prologue_plain(labels, input_lengths, label_lengths, band_min,
                        band_max, t_max: int, s1: int):
    """Plain-torch loss_prologue: (labels_ext, a_lo, a_hi, b_lo, b_hi)."""
    labels_ext = extend_labels(labels, label_lengths, s1)
    a_lo, a_hi, b_lo, b_hi = _window_bounds(
        input_lengths, label_lengths, Bands(band_min, band_max), t_max, s1)
    t_idx = torch.arange(t_max, dtype=torch.int32,
                         device=input_lengths.device)[None, :]
    valid_t = t_idx < input_lengths.to(torch.int32)[:, None]
    # Conjoin t < T_b by emptying the window (hi < lo) on invalid rows.
    a_hi = torch.where(valid_t, a_hi, -1)
    b_hi = torch.where(valid_t, b_hi, -1)
    return labels_ext, a_lo.contiguous(), a_hi, b_lo, b_hi


def loss_prologue_cuda(labels, input_lengths, label_lengths, band_min,
                       band_max, t_max: int, s1: int):
    """The launch of mrnnt_loss_prologue_kernel behind the op's CUDA
    implementation: checks, allocation, launch, count. Returns labels_ext
    [B, S1] and the stacked windows [4, B, T] int32."""
    _check_cuda(labels)
    dev = labels.device
    if labels.dim() != 2 or labels.dtype not in (torch.int32, torch.int64) \
            or not labels.is_contiguous():
        raise ValueError("labels must be a contiguous [B, S_max] int32 or "
                         f"int64 tensor, got {labels.dtype} "
                         f"{tuple(labels.shape)}")
    batch = labels.shape[0]
    for name, t in (("input_lengths", input_lengths),
                    ("label_lengths", label_lengths)):
        _check(t, name, torch.int32, (batch,), dev)
    for name, t in (("band_min", band_min), ("band_max", band_max)):
        _check(t, name, torch.int32, (batch, t_max), dev)
    labels_ext = torch.empty((batch, s1), dtype=torch.int32, device=dev)
    windows = torch.empty((4, batch, t_max), dtype=torch.int32, device=dev)
    _call("mrnnt_loss_prologue", dev, _ptr(labels),
          int(labels.dtype == torch.int64), labels.shape[1],
          _ptr(input_lengths), _ptr(label_lengths), _ptr(band_min),
          _ptr(band_max), batch, t_max, s1, _ptr(labels_ext), _ptr(windows))
    LAUNCHES["loss_prologue"] += 1
    return labels_ext, windows


def _prologue_cpu(*args):
    """loss_prologue's CPU implementation: labels_ext, the windows stacked."""
    labels_ext, *windows = loss_prologue_plain(*args)
    return labels_ext, torch.stack(windows)


define_op("loss_prologue",
          "(Tensor labels, Tensor input_lengths, Tensor label_lengths, "
          "Tensor band_min, Tensor band_max, SymInt t_max, SymInt s1) -> "
          "(Tensor, Tensor)",
          _prologue_cpu, loss_prologue_cuda,
          lambda labels, *args: (
              labels.new_empty((labels.shape[0], args[-1]),
                               dtype=torch.int32),
              labels.new_empty((4, labels.shape[0], args[-2]),
                               dtype=torch.int32)))


def loss_prologue(labels, input_lengths, label_lengths, band_min, band_max,
                  t_max: int, s1: int):
    """What rows 1-2 take besides the logits and the stats, in one launch.

    labels [B, S_max] int; input_lengths, label_lengths [B] int32;
    band_min, band_max [B, T] int (the bands, reference
    cpu_workspace_manager.h:53-56, 207-224). Returns labels_ext [B, S1]
    int32 (-1 where s >= S_b, helpers.extend_labels) and the inclusive
    alpha and beta windows a_lo, a_hi, b_lo, b_hi [B, T] int32
    (bands._window_bounds), t < T_b conjoined into both hi bounds (-1 on
    invalid rows), through ``torch.ops.mrnnt.loss_prologue``.
    """
    _check_device(input_lengths)
    if labels.dtype not in (torch.int32, torch.int64):
        labels = labels.to(torch.int32)
    labels_ext, windows = torch.ops.mrnnt.loss_prologue(
        labels.contiguous(), input_lengths, label_lengths,
        band_min.to(torch.int32).contiguous(),
        band_max.to(torch.int32).contiguous(), t_max, s1)
    return (labels_ext, *windows.unbind(0))


def loss_costs_plain(alphas, input_lengths, label_lengths):
    """Plain-torch loss_costs: (ll_fwd, costs)."""
    ll_fwd = _gather_ll(alphas, input_lengths, label_lengths)
    return ll_fwd, -ll_fwd


def loss_costs_cuda(alphas, input_lengths, label_lengths):
    """The launch of mrnnt_loss_costs_kernel behind the op's CUDA
    implementation: checks, allocation, launch, count."""
    _check_cuda(alphas)
    dev = alphas.device
    if alphas.dim() != 3:
        raise ValueError("alphas must be [B, T, S1], got shape "
                         f"{tuple(alphas.shape)}")
    batch, t_max, s1 = alphas.shape
    _check(alphas, "alphas", torch.float32, (batch, t_max, s1), dev)
    for name, t in (("input_lengths", input_lengths),
                    ("label_lengths", label_lengths)):
        _check(t, name, torch.int32, (batch,), dev)
    ll_fwd, costs = _small((batch,), dev), _small((batch,), dev)
    _call("mrnnt_loss_costs", dev, _ptr(alphas), _ptr(input_lengths),
          _ptr(label_lengths), batch, t_max, s1, _ptr(ll_fwd), _ptr(costs))
    LAUNCHES["loss_costs"] += 1
    return ll_fwd, costs


define_op("loss_costs",
          "(Tensor alphas, Tensor input_lengths, Tensor label_lengths) -> "
          "(Tensor, Tensor)",
          loss_costs_plain, loss_costs_cuda,
          lambda alphas, *_: (alphas.new_empty(alphas.shape[:1]),
                              alphas.new_empty(alphas.shape[:1])))


def loss_costs(alphas, input_lengths, label_lengths):
    """(ll_fwd, costs), each [B] f32: ll = alphas[b, T_b - 1, S_b] and
    costs = -ll, NaN where an index is out of range (the exported
    artifact's contract, reference._gather_ll). alphas [B, T, S1] f32;
    the lengths [B] int32. Goes through ``torch.ops.mrnnt.loss_costs``."""
    _check_device(alphas)
    return torch.ops.mrnnt.loss_costs(alphas, input_lengths, label_lengths)


def beta_operands_plain(lp_blank, lp_label, alphas, ll_fwd, input_lengths,
                        label_lengths, b_lo, b_hi):
    """Plain-torch beta_operands: (lpb_bmask, lpl_bmask, aprev_masked,
    ll_bounded, beta_virtual)."""
    batch, t_max, s1 = alphas.shape
    s_idx = torch.arange(s1, dtype=torch.int32, device=alphas.device)
    t_idx = torch.arange(t_max, dtype=torch.int32, device=alphas.device)
    in_band = ((s_idx >= b_lo[:, :, None]) & (s_idx <= b_hi[:, :, None]))
    alpha_virt = mask_to_additive(s_idx == 0).expand(batch, s1)
    alpha_prev = torch.cat([alpha_virt[:, None, :], alphas[:, :-1, :]], dim=1)
    ll_ok = torch.isfinite(ll_fwd)
    ll_bounded = torch.where(ll_ok, ll_fwd, 0.0)
    valid_t = t_idx[None, :] < input_lengths[:, None]
    valid = valid_t[:, :, None] & ll_ok[:, None, None]
    return (torch.where(in_band, lp_blank, NEG_INF),
            torch.where(in_band, lp_label, NEG_INF),
            torch.where(valid, alpha_prev, NEG_INF),
            ll_bounded,
            mask_to_additive(s_idx[None, :] == label_lengths[:, None]))


def beta_operands_cuda(lp_blank, lp_label, alphas, ll_fwd, input_lengths,
                       label_lengths, b_lo, b_hi):
    """The launch of mrnnt_beta_operands_kernel behind the op's CUDA
    implementation: checks, allocation, launch, count. Returns the stacked
    [3, B, T, S1] (lpb_bmask, lpl_bmask, aprev_masked), ll_bounded [B] and
    beta_virtual [B, S1], f32."""
    _check_cuda(alphas)
    dev = alphas.device
    if alphas.dim() != 3:
        raise ValueError("alphas must be [B, T, S1], got shape "
                         f"{tuple(alphas.shape)}")
    batch, t_max, s1 = alphas.shape
    for name, t in (("lp_blank", lp_blank), ("lp_label", lp_label),
                    ("alphas", alphas)):
        _check(t, name, torch.float32, (batch, t_max, s1), dev)
    _check(ll_fwd, "ll_fwd", torch.float32, (batch,), dev)
    for name, t in (("input_lengths", input_lengths),
                    ("label_lengths", label_lengths)):
        _check(t, name, torch.int32, (batch,), dev)
    for name, t in (("b_lo", b_lo), ("b_hi", b_hi)):
        _check(t, name, torch.int32, (batch, t_max), dev)
    masked = _small((3, batch, t_max, s1), dev)
    ll_bounded, beta_virtual = _small((batch,), dev), _small((batch, s1), dev)
    _call("mrnnt_beta_operands", dev, _ptr(lp_blank), _ptr(lp_label),
          _ptr(alphas), _ptr(ll_fwd), _ptr(input_lengths),
          _ptr(label_lengths), _ptr(b_lo), _ptr(b_hi), batch, t_max, s1,
          _ptr(masked), _ptr(ll_bounded), _ptr(beta_virtual))
    LAUNCHES["beta_operands"] += 1
    return masked, ll_bounded, beta_virtual


def _operands_cpu(*args):
    """beta_operands' CPU implementation: the three [B, T, S1] operands
    stacked, ll_bounded, beta_virtual."""
    *masked, ll_bounded, beta_virtual = beta_operands_plain(*args)
    return torch.stack(masked), ll_bounded, beta_virtual


define_op("beta_operands",
          "(Tensor lp_blank, Tensor lp_label, Tensor alphas, Tensor ll_fwd, "
          "Tensor input_lengths, Tensor label_lengths, Tensor b_lo, "
          "Tensor b_hi) -> (Tensor, Tensor, Tensor)",
          _operands_cpu, beta_operands_cuda,
          lambda lp_blank, *_: (lp_blank.new_empty((3, *lp_blank.shape)),
                                lp_blank.new_empty(lp_blank.shape[:1]),
                                lp_blank.new_empty((lp_blank.shape[0],
                                                    lp_blank.shape[2]))))


def beta_operands(lp_blank, lp_label, alphas, ll_fwd, input_lengths,
                  label_lengths, b_lo, b_hi):
    """The small operands of beta_grad_fused (fused.py:166-180).

    lp_blank, lp_label, alphas [B, T, S1] f32 (row 1's); ll_fwd [B] f32;
    the lengths [B] int32; b_lo, b_hi [B, T] int32, the beta window with
    t < T_b conjoined (loss_prologue's). Returns (lpb_bmask, lpl_bmask,
    aprev_masked, ll_bounded, beta_virtual). The beta window is folded in
    by a select, not by adding an additive -inf mask as the JAX glue does:
    the two agree on finite stats, and the select keeps a NaN statistic of
    a padding cell (from +-inf padding logits) out of the recurrence.
    aprev_masked is alpha(t-1, s) where t < T_b and ll is finite, else -inf;
    ll_bounded is ll, 0 where it is not finite. Goes through
    ``torch.ops.mrnnt.beta_operands``.
    """
    _check_device(alphas)
    masked, ll_bounded, beta_virtual = torch.ops.mrnnt.beta_operands(
        lp_blank, lp_label, alphas, ll_fwd, input_lengths, label_lengths,
        b_lo, b_hi)
    return (*masked.unbind(0), ll_bounded, beta_virtual)
