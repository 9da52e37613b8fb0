"""Debug instrumentation.

PyTorch counterpart of ``monotonic_rnnt_tpu/utils/debug.py``: runtime-flag
equivalents of the reference's compile-time printf macros (DEBUG_TIME /
DEBUG_SPACE / DEBUG_FWDBWD / DEBUG_GRADS, returnn_tf_op.py:61-69), with the
JAX package's printed lines:

  * emit_loss_debug(): per-call log-likelihoods, the fwd/bwd self-check and
    gradient statistics, read by every loss route;
  * report_space(): the pipeline a loss call takes and its big-tensor
    traffic;
  * dump_lattice(): print alpha/beta tables for a sample the way the
    reference's DEBUG_FWDBWD blocks do (cpu_rnnt.h:169-178);
  * check_lattice(): fwd/bwd likelihood self-check (cpu_rnnt.h:256-259).

The JAX package's ``interpret_mode`` and its host-callback probe have no
counterpart: the kernels' plain versions serve CPU tensors, and ``print``
needs no callback.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import get_config
from .status import tracing


def _host(x) -> np.ndarray:
    """x as a numpy array on the host (a copy from the card for a CUDA
    tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def emit_loss_debug(ll_fwd, ll_bwd=None, grads=None) -> None:
    """Runtime debug hooks read by every loss route.

    Driven by the config flags (the reference's DEBUG_FWDBWD / DEBUG_GRADS
    macros and its fwd/bwd consistency check, cpu_rnnt.h:256-259):
      debug_fwdbwd  -- print per-sample forward/backward log-likelihoods;
      check_fwd_bwd -- warn (only) when |ll_fwd - ll_bwd| > fwd_bwd_tol;
      debug_grads   -- print gradient summary statistics (in f32).

    With every flag off it reads no tensor; with a flag on it copies what
    it prints to the host, which waits for the card. It prints nothing
    while torch.export traces a graph: an artifact holds no print.
    """
    cfg = get_config()
    wants_debug = ((ll_bwd is not None
                    and (cfg.debug_fwdbwd or cfg.check_fwd_bwd))
                   or (grads is not None and cfg.debug_grads))
    if not wants_debug or tracing():
        return
    if ll_bwd is not None and cfg.debug_fwdbwd:
        print(f"mrnnt fwdbwd: ll_fwd={_host(ll_fwd)} ll_bwd={_host(ll_bwd)}")
    if ll_bwd is not None and cfg.check_fwd_bwd:
        diff = (ll_fwd.float() - ll_bwd.float()).abs()
        bad = diff > cfg.fwd_bwd_tol
        if bool(bad.any()):
            print(f"monotonic_rnnt: fwd/bwd mismatch on {_host(bad.sum())} "
                  f"samples (max |diff| = {_host(diff.max())})")
    if grads is not None and cfg.debug_grads:
        g = grads.float()
        print(f"mrnnt grads: min={_host(g.min())} max={_host(g.max())} "
              f"l2={_host(torch.sqrt(torch.sum(g * g)))}")


def report_space(pipeline: str, logits_shape, dtype, *, reads: int,
                 writes: int, file=None) -> None:
    """DEBUG_SPACE equivalent: one line per loss call.

    The reference prints its workspace allocation in MB behind DEBUG_SPACE
    (reference: cpu_workspace_manager.h:110-112,
    gpu_workspace_manager.h:249-251). Here the analogous decision is which
    route a shape takes (dp-fused / split / banded, and the deferred
    halves) and the big-tensor HBM traffic it is committed to (reads +
    writes of the [B, T, S1, V] tensor). All of it follows from the shape,
    so the line needs no copy from the card; under torch.export it prints
    once, while the graph is traced. The JAX line's ``tiles=`` and
    ``kernel_vmem=`` fields model the TPU's VMEM and have no counterpart.
    """
    if not get_config().debug_space:
        return
    itemsize = torch.empty((), dtype=dtype).element_size()
    big_mb = math.prod(int(d) for d in logits_shape) * itemsize / 2**20
    parts = [
        f"mrnnt space: pipeline={pipeline}",
        f"shape={tuple(int(d) for d in logits_shape)}",
        f"dtype={str(dtype).removeprefix('torch.')}",
        f"big_tensor={big_mb:.1f}MiB",
        f"hbm_traffic={(reads + writes) * big_mb:.1f}MiB"
        f" ({reads}r+{writes}w)",
    ]
    print(" ".join(parts), file=file)


def _fmt_table(arr: np.ndarray) -> str:
    rows = []
    for s in range(arr.shape[1] - 1, -1, -1):
        rows.append("  ".join(f"{v:8.3f}" for v in arr[:, s]))
    return "\n".join(rows)


def dump_lattice(logits, labels, input_lengths, label_lengths,
                 sample: int = 0, blank_id: int = 0, file=None,
                 device="cuda") -> str:
    """Compute and pretty-print alphas/betas/costs for one sample.

    Runs the plain-torch oracle on `device` (tensors or arrays are moved
    there). Returns the formatted dump (and prints it unless file=False).
    """
    from ..ops.bands import default_bands, lattice_masks
    from ..ops.reference import compute_stats, forward_backward

    as_t = lambda x: torch.as_tensor(_host(x), device=device)
    logits, labels = as_t(logits), as_t(labels)
    ilen = as_t(input_lengths).to(torch.int32)
    slen = as_t(label_lengths).to(torch.int32)
    t_max, s1 = logits.shape[1], logits.shape[2]
    with torch.no_grad():
        stats = compute_stats(logits, labels, slen, blank_id)
        masks = lattice_masks(ilen, slen, default_bands(ilen, slen, t_max),
                              t_max, s1)
        alphas, betas, ll_fwd, ll_bwd = forward_backward(stats, masks, ilen,
                                                         slen)
    b = sample
    t_b, s_b = int(ilen[b]), int(slen[b])
    out = [
        f"sample {b}: T={t_b} S={s_b} "
        f"ll_fwd={float(ll_fwd[b]):.4f} ll_bwd={float(ll_bwd[b]):.4f}",
        "alphas (s rows top-down, t columns):",
        _fmt_table(_host(alphas)[b, :t_b, :s_b + 1]),
        "betas:",
        _fmt_table(_host(betas)[b, :t_b, :s_b + 1]),
    ]
    text = "\n".join(out)
    if file is not False:
        print(text, file=file)
    return text


def check_lattice(ll_fwd, ll_bwd, tol: float = 0.1) -> np.ndarray:
    """Return boolean mask of samples whose fwd/bwd likelihoods disagree."""
    return np.abs(_host(ll_fwd) - _host(ll_bwd)) > tol
