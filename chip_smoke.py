#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the monotonic RNN-T loss on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``monotonic_rnnt_tpu_torch/csrc``,
holds each kernel wrapper against its plain PyTorch version, drives the
loss's main path (forward, cost-only and backward at the benchmark lattice
B=32, T=200, S=50, V=1000, in float32 and bfloat16) against the plain-torch
oracle, checks the golden values of the reference's worked example, takes
five SGD steps, and times the kernels with CUDA events. Any failed check
raises, and the script exits non-zero. The last three lines of its output
are the kernels JSON line, the card's name and power limit, and
``{"ok": true, "device": {...}}``.

Tolerances, each with its reason:
  * kernel vs plain version, same inputs: stats |d| <= 1e-5 + 1e-6|ref|
    (the kernel's warp reduction sums V in another order than
    torch.logsumexp); alphas and betas |d| <= 1e-4 + 1e-5|ref| (that
    rounding carried through T log-space steps of magnitude up to ~1e3);
    f32 grads |d| <= 1e-6 + 1e-4|ref|; bf16 grads |d| <= 1e-6 + 8e-3|ref|
    (one bf16 ulp: both sides round an f32 value whose last bits may differ);
  * loss vs oracle: costs |d| <= 1e-4 + 1e-5|ref|; f32 grads
    |d| <= 1e-6 + 1e-3|ref| (the oracle's alphas come from other stats
    roundings, and at T=200 a log-space sum of ~1e3 carries that into the
    exponent of every occupancy coefficient); bf16 grads
    |d| <= 1e-6 + 1.6e-2|ref| (two bf16 ulps: the oracle scales an f32
    gradient by the cotangent and rounds, the kernel rounds once);
  * goldens: cost 1e-4, gradient table 1e-2, as the JAX package's tests.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
B, T, S, V = 32, 200, 50, 1000
ALIGN_SHIFT = 8
TIMING_REPS = 20
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, and f32 outside the
# tensor cores (the kernels do elementwise f32 work only).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def assert_close(got, ref, atol: float, rtol: float, what: str) -> float:
    got, ref = got.detach().float(), ref.detach().float()
    diff = torch.where(got == ref, 0.0, (got - ref).abs())
    bad = ~(diff <= atol + rtol * ref.abs())  # NaN counts as bad
    err = float(diff.max())
    if bool(bad.any()):
        idx = tuple(int(i) for i in torch.nonzero(bad)[0])
        raise CheckFailed(f"{what}: max |d| {err:.3g}; first bad index {idx}: "
                          f"got {float(got[idx])!r} ref {float(ref[idx])!r}")
    return err


def cuda_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- inputs ---------------------------------------------------------------------

def make_inputs(mt, b, t, s, v, *, blank=0, dtype=torch.float32, seed=SEED,
                t_range=None, s_range=None, device="cuda"):
    """Seeded inputs on `device`: logits ~ 2*N(0,1), non-blank labels with a
    planted repeat, lengths drawn from the given ranges (default: full)."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    logits = (torch.randn((b, t, s + 1, v), generator=gen, device=device)
              * 2).to(dtype)
    labels = rng.randint(0, v - 1, size=(b, s))
    labels = np.where(labels >= blank, labels + 1, labels)
    if s >= 3:
        labels[:, s // 2] = labels[:, s // 2 - 1]
    ilen = (rng.randint(t_range[0], t_range[1] + 1, size=b) if t_range
            else np.full(b, t))
    slen = (rng.randint(s_range[0], s_range[1] + 1, size=b) if s_range
            else np.full(b, s))
    slen = np.minimum(slen, ilen)
    as_int = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    return logits, as_int(labels), as_int(ilen), as_int(slen)


def kernel_operands(mt, logits, labels, ilen, slen, blank, bands=None):
    """Operands of both wrappers, from the plain stats+alpha on the card."""
    F, K = mt.fused, mt.K
    ilen, slen, bands, lab = F._prepare(logits, labels, ilen, slen, bands)
    _, t_max, s1, _ = logits.shape
    a_lo, a_hi, bwin = F._windows(ilen, slen, bands, t_max, s1)
    sa_args = (logits, lab, a_lo, a_hi, blank)
    denom, lpb, lpl, alphas = K.stats_alpha_fused_plain(*sa_args)
    ll = F._gather_ll(alphas, ilen, slen)
    lpbb, lplb, aprev, llb, bvirt = F.beta_grad_operands(lpb, lpl, alphas, ll,
                                                         slen, bwin)
    scale = torch.linspace(-0.5, 2.0, logits.shape[0], device=logits.device)
    bg_args = (logits, denom, lpbb, lplb, aprev, ilen, llb, bvirt, lab, blank)
    return sa_args, bg_args, scale


def compare_kernels(mt, sa_args, bg_args, scale, what):
    """Each wrapper against its plain version on the same inputs."""
    K = mt.K
    bf16 = sa_args[0].dtype == torch.bfloat16
    got = K.stats_alpha_fused(*sa_args)
    ref = K.stats_alpha_fused_plain(*sa_args)
    errs_sa = [assert_close(g, r, 1e-5, 1e-6, f"{what} stats {n}")
               for n, g, r in zip(("denom", "lp_blank", "lp_label"), got, ref)]
    errs_sa.append(assert_close(got[3], ref[3], 1e-4, 1e-5, f"{what} alphas"))
    g_k, b_k = K.beta_grad_fused(*bg_args, grad_scale=scale)
    g_p, b_p = K.beta_grad_fused_plain(*bg_args, grad_scale=scale)
    check(g_k.dtype == sa_args[0].dtype, f"{what}: grads dtype {g_k.dtype}")
    errs_bg = [assert_close(g_k, g_p, 1e-6, 8e-3 if bf16 else 1e-4,
                            f"{what} grads"),
               assert_close(b_k, b_p, 1e-4, 1e-5, f"{what} betas")]
    torch.cuda.synchronize()
    log(f"kernel-vs-plain {what}: stats_alpha_fused max|d| "
        f"{[f'{e:.3g}' for e in errs_sa]} beta_grad_fused max|d| "
        f"{[f'{e:.3g}' for e in errs_bg]}")
    return max(errs_sa), max(errs_bg)


# --- phases ---------------------------------------------------------------------

def phase_build(mt):
    t0 = time.perf_counter()
    mt.build.build()
    for name in mt.build.SOURCES:
        mt.build.load(name)
    log(f"build: {len(mt.build.SOURCES)} libraries in "
        f"{time.perf_counter() - t0:.2f} s")


def phase_kernels(mt, main_inputs):
    """Kernel wrappers vs plain versions; returns the benchmark-shape errors."""
    for (b, t, s, v, blank) in ((3, 17, 6, 79, 5), (2, 391, 300, 79, 0),
                                (1, 1200, 1100, 16, 3)):
        for dtype in (torch.float32, torch.bfloat16):
            lg, lab, il, sl = make_inputs(mt, b, t, s, v, blank=blank,
                                          dtype=dtype, seed=1, t_range=(s, t),
                                          s_range=(0, s))
            compare_kernels(mt, *kernel_operands(mt, lg, lab, il, sl, blank),
                            f"({b},{t},{s},{v}) blank={blank} {dtype}")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        lg, lab, il, sl = main_inputs
        ops = kernel_operands(mt, lg.to(dtype), lab, il, sl, 0)
        errs[dtype] = compare_kernels(mt, *ops, f"benchmark {dtype}")
    return errs


def phase_main(mt, main_inputs, weights, dtype):
    K = mt.K
    logits, labels, ilen, slen = main_inputs
    logits = logits.to(dtype)
    # The main path: the loss, a weighted sum, backward -- nothing else
    # between resetting the launch counts and reading them.
    K.reset_launch_counts()
    x = logits.detach().clone().requires_grad_(True)
    costs = mt.monotonic_rnnt_loss(x, labels, ilen, slen)
    (costs * weights).sum().backward()
    costs, grads = costs.detach(), x.grad
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check(launches == {"stats_alpha_fused": 1, "beta_grad_fused": 1},
          f"main path {dtype} launches {launches}")
    check(grads.dtype == dtype, f"grad dtype {grads.dtype} != {dtype}")
    check(tuple(costs.shape) == (B,) and bool(torch.isfinite(costs).all()),
          "costs must be [B] and finite")
    check(bool(torch.isfinite(grads.float()).all()), "grads must be finite")

    x = logits.detach().clone().requires_grad_(True)
    ref_costs = mt.monotonic_rnnt_loss(x, labels, ilen, slen,
                                       backend="reference")
    (ref_costs * weights).sum().backward()
    bf16 = dtype == torch.bfloat16
    e_c = assert_close(costs, ref_costs, 1e-4, 1e-5, f"main {dtype} costs")
    e_g = assert_close(grads, x.grad, 1e-6, 1.6e-2 if bf16 else 1e-3,
                       f"main {dtype} grads")
    log(f"main path {dtype}: launches {launches}; vs oracle costs max|d| "
        f"{e_c:.3g}, grads max|d| {e_g:.3g}; mean cost "
        f"{float(costs.mean()):.4f}")
    return launches, costs


def phase_cost_only(mt, main_inputs, costs_f32):
    K = mt.K
    logits, labels, ilen, slen = main_inputs
    K.reset_launch_counts()
    with torch.no_grad():
        costs = mt.monotonic_rnnt_loss(logits, labels, ilen, slen)
    torch.cuda.synchronize()
    check(dict(K.LAUNCHES) == {"stats_alpha_fused": 1, "beta_grad_fused": 0},
          f"cost-only launches {K.LAUNCHES}")
    check(torch.equal(costs, costs_f32), "cost-only costs differ from fwd+bwd")
    log(f"cost-only: launches {dict(K.LAUNCHES)}; costs equal to fwd+bwd")


def phase_goldens(mt, golden):
    conv = mt.convert

    def run(lg, lb, il, sl, **kw):
        lg, lb, il, sl = conv.loss_inputs_from_numpy(lg, lb, il, sl)
        x = lg.clone().requires_grad_(True)
        costs = mt.monotonic_rnnt_loss(x, lb, il, sl, backend="cuda", **kw)
        costs.sum().backward()
        return costs.detach().cpu().numpy(), x.grad.cpu().numpy()

    costs, grads = run(*golden.readme_batch())
    check(abs(costs[0] - golden.README_LOSS) < 1e-4, f"README loss {costs}")
    check(np.abs(grads[0] - golden.README_GRADS).max() < 1e-2, "README grads")
    for t_pad, s_pad in ((None, None), (7, 5)):
        lg, lb, il, sl, exp_l, exp_g = golden.multibatch(t_pad, s_pad)
        costs, grads = run(lg, lb, il, sl)
        check(np.abs(costs - exp_l).max() < 1e-4, f"multibatch loss {costs}")
        check(np.abs(grads - exp_g).max() < 1e-2, "multibatch grads")
    for align, losses in ((golden.ALIGN_A, golden.ALIGN_A_LOSSES),
                          (golden.ALIGN_B, golden.ALIGN_B_LOSSES)):
        for shift, expected in losses.items():
            costs, grads = run(*golden.readme_batch(),
                               alignment=torch.from_numpy(align[None]).cuda(),
                               max_distance_from_alignment=shift)
            check(abs(costs[0] - expected) < 1e-4,
                  f"restricted loss shift={shift}: {costs} vs {expected}")
            check(np.isfinite(grads).all(), "restricted grads finite")
    log("goldens: README -log 0.363 + gradient table, multibatch 0.39/0.363, "
        "restricted 0.2958/0.072/0.192/0.0672 ok")


def random_alignment(rng, ilen, slen, labels, t_max, blank=0):
    """Frames of each sample's S_b labels, drawn at random among its T_b."""
    align = np.full((len(ilen), t_max), blank, np.int32)
    for b, (tb, sb) in enumerate(zip(ilen, slen)):
        frames = np.sort(rng.choice(tb, size=sb, replace=False))
        align[b, frames] = labels[b, :sb]
    return align


def phase_restricted(mt, main_inputs, weights):
    logits, labels, ilen, slen = main_inputs
    rng = np.random.RandomState(SEED + 7)
    align = torch.from_numpy(random_alignment(
        rng, ilen.cpu().numpy(), slen.cpu().numpy(), labels.cpu().numpy(),
        T)).cuda()
    out = {}
    for backend in ("cuda", "reference"):
        x = logits.detach().clone().requires_grad_(True)
        costs = mt.monotonic_rnnt_loss(x, labels, ilen, slen, alignment=align,
                                       max_distance_from_alignment=ALIGN_SHIFT,
                                       backend=backend)
        (costs * weights).sum().backward()
        out[backend] = (costs.detach(), x.grad)
    check(bool(torch.isfinite(out["cuda"][0]).all()), "restricted costs finite")
    e_c = assert_close(out["cuda"][0], out["reference"][0], 1e-4, 1e-5,
                       "restricted costs")
    e_g = assert_close(out["cuda"][1], out["reference"][1], 1e-6, 1e-3,
                       "restricted grads")
    log(f"alignment-restricted +-{ALIGN_SHIFT} at the benchmark shape: costs "
        f"max|d| {e_c:.3g}, grads max|d| {e_g:.3g}; mean cost "
        f"{float(out['cuda'][0].mean()):.4f}")

    # Infeasible sample: no aligned label, S_b = 3, exact path (shift 0).
    lg, lab, il, sl = make_inputs(mt, 3, 12, 4, 20, seed=3)
    sl[2] = 3
    align = torch.zeros((3, 12), dtype=torch.int32, device="cuda")
    align[0, :4] = lab[0]
    align[1, 2:6] = lab[1]
    x = lg.clone().requires_grad_(True)
    costs = mt.monotonic_rnnt_loss(x, lab, il, sl, alignment=align)
    costs.sum().backward()
    costs = costs.detach()
    check(bool(torch.isinf(costs[2])) and float(costs[2]) > 0,
          f"infeasible cost {costs}")
    check(bool((x.grad[2] == 0).all()) and bool(torch.isfinite(x.grad).all()),
          "infeasible sample: gradient exactly zero, all finite")

    # +-inf padding logits: same costs as finite padding, zero gradient there.
    lg, lab, il, sl = make_inputs(mt, 3, 12, 4, 20, seed=4, t_range=(5, 12),
                                  s_range=(1, 4))
    padded = lg.clone()
    for b in range(3):
        padded[b, int(il[b]):, :, ::2] = float("inf")
        padded[b, int(il[b]):, :, 1::2] = float("-inf")
        padded[b, :, int(sl[b]) + 1:, 3] = float("inf")
    c_fin = mt.monotonic_rnnt_loss(lg, lab, il, sl)
    x = padded.clone().requires_grad_(True)
    c_inf = mt.monotonic_rnnt_loss(x, lab, il, sl)
    c_inf.sum().backward()
    check(torch.equal(c_fin, c_inf), f"inf padding costs {c_inf} vs {c_fin}")
    t_idx = torch.arange(12, device="cuda")[None, :, None]
    s_idx = torch.arange(5, device="cuda")[None, None, :]
    pad = (t_idx >= il[:, None, None]) | (s_idx > sl[:, None, None])
    check(bool((x.grad[pad] == 0).all()) and bool(torch.isfinite(x.grad).all()),
          "inf padding: gradient exactly zero in padding, finite everywhere")
    log("infeasible sample: cost +inf, gradient zero; +-inf padding: costs "
        "unchanged, padding gradient zero")


def phase_train(mt, main_inputs):
    K = mt.K
    logits, labels, ilen, slen = main_inputs
    x = logits.detach().clone().requires_grad_(True)
    opt = torch.optim.SGD([x], lr=0.5)
    losses = []
    for step in range(5):
        K.reset_launch_counts()
        opt.zero_grad(set_to_none=True)
        loss = mt.monotonic_rnnt_loss(x, labels, ilen, slen).sum()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        check(dict(K.LAUNCHES) == {"stats_alpha_fused": 1,
                                   "beta_grad_fused": 1},
              f"train step {step} launches {K.LAUNCHES}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"loss must fall at every step: {losses}")
    log(f"5 SGD steps (lr 0.5) on a logits leaf: summed loss {losses}")


def phase_timing(mt, main_inputs, weights, errs, main_launches):
    K = mt.K
    logits, labels, ilen, slen = main_inputs
    n_cells = logits.shape[0] * logits.shape[1] * logits.shape[2]
    small = n_cells * 4
    n_b, n_t, n_s1 = logits.shape[0], logits.shape[1], logits.shape[2]
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        lg = logits.to(dtype)
        isz = lg.element_size()
        big = lg.numel() * isz
        sa_args, bg_args, _ = kernel_operands(mt, lg, labels, ilen, slen, 0)
        scale = weights
        lab = sa_args[1]
        out = [torch.empty((n_b, n_t, n_s1), device="cuda") for _ in range(8)]
        denom, lpb, lpl, alphas, betas, occ, cb, cl = out
        grads = torch.empty_like(lg)
        _, lpbb, lplb, aprev, il32, llb, bvirt, _, _ = bg_args[1:]

        t_stats = cuda_ms(lambda: K.launch_stats(lg, lab, 0, denom, lpb, lpl))
        t_alpha = cuda_ms(lambda: K.launch_alpha(lpb, lpl, sa_args[2],
                                                 sa_args[3], alphas))
        t_beta = cuda_ms(lambda: K.launch_beta(lpbb, lplb, aprev, il32, llb,
                                               scale, bvirt, betas, occ, cb,
                                               cl))
        # The grad kernel reads only rows whose coefficients are not all 0.
        live = int(((occ != 0) | (cb != 0) | (cl != 0)).sum())
        read_live = live * lg.shape[3] * isz
        t_grad = cuda_ms(lambda: K.launch_grad(lg, denom, occ, cb, cl, lab, 0,
                                               grads))
        sa = {
            "ms": cuda_ms(lambda: K.stats_alpha_fused(*sa_args)),
            "plain_ms": cuda_ms(lambda: K.stats_alpha_fused_plain(*sa_args)),
            "library_ms": cuda_ms(lambda: torch.logsumexp(lg, dim=-1)),
            "bound": bound_ms(big + n_b * n_s1 * 4 + 2 * n_b * n_t * 4
                              + 4 * small, 4 * lg.numel()),
            "parts": [
                {"name": "mrnnt_stats_kernel", "ms": t_stats, "bound_ms":
                 bound_ms(big + n_b * n_s1 * 4 + 3 * small, 4 * lg.numel())[0]},
                {"name": "mrnnt_alpha_kernel", "ms": t_alpha, "bound_ms":
                 bound_ms(3 * small + 2 * n_b * n_t * 4, 8 * n_cells)[0]},
            ],
        }
        bg = {
            "ms": cuda_ms(lambda: K.beta_grad_fused(*bg_args,
                                                    grad_scale=scale)),
            "plain_ms": cuda_ms(lambda: K.beta_grad_fused_plain(
                *bg_args, grad_scale=scale)),
            "library_ms": cuda_ms(lambda: torch.softmax(lg, dim=-1)),
            "bound": bound_ms(read_live + big + 5 * small + 2 * n_b * n_s1 * 4
                              + 3 * n_b * 4, 6 * live * lg.shape[3]),
            "live_rows": live, "rows": n_cells,
            "parts": [
                {"name": "mrnnt_beta_kernel", "ms": t_beta, "bound_ms":
                 bound_ms(7 * small + n_b * n_s1 * 4, 12 * n_cells)[0]},
                {"name": "mrnnt_grad_kernel", "ms": t_grad, "bound_ms":
                 bound_ms(read_live + big + 4 * small,
                          6 * live * lg.shape[3])[0]},
            ],
        }
        lg_leaf = lg.detach().clone().requires_grad_(True)

        def fwd_bwd():
            costs = mt.monotonic_rnnt_loss(lg_leaf, labels, ilen, slen)
            (costs * weights).sum().backward()
            lg_leaf.grad = None

        def cost_only():
            with torch.no_grad():
                mt.monotonic_rnnt_loss(lg, labels, ilen, slen)

        e2e = {"fwd_bwd_ms": cuda_ms(fwd_bwd), "cost_only_ms": cuda_ms(cost_only)}
        rows[dtype] = (sa, bg, e2e)
        log(f"timing {dtype}: stats_alpha_fused {sa['ms']:.4f} ms (bound "
            f"{sa['bound'][0]:.4f}, plain {sa['plain_ms']:.4f}, logsumexp "
            f"{sa['library_ms']:.4f}); beta_grad_fused {bg['ms']:.4f} ms (bound "
            f"{bg['bound'][0]:.4f}, plain {bg['plain_ms']:.4f}, softmax "
            f"{bg['library_ms']:.4f}); parts "
            + ", ".join(f"{p['name']} {p['ms']:.4f} ms (bound "
                        f"{p['bound_ms']:.4f})"
                        for p in sa["parts"] + bg["parts"])
            + f"; live rows {live}/{n_cells}; loss fwd+bwd "
            f"{e2e['fwd_bwd_ms']:.4f} ms, cost-only {e2e['cost_only_ms']:.4f} ms")
        del grads, out, sa_args, bg_args, lg_leaf
        torch.cuda.empty_cache()

    kernels = []
    spec = (("stats_alpha_fused", "stats_alpha.cu", 586, 0),
            ("beta_grad_fused", "beta_grad.cu", 712, 1))
    for name, src, line, i in spec:
        f32, b16 = rows[torch.float32][i], rows[torch.bfloat16][i]
        entry = {
            "name": name, "route": "cuda",
            "source": f"monotonic_rnnt_tpu_torch/csrc/{src}",
            "replaces": f"monotonic_rnnt_tpu/ops/pallas/kernels.py:{line}",
            "launches": main_launches[name],
            "max_abs_err": errs[torch.float32][i],
            "ms": f32["ms"], "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound"][0], "bound_by": f32["bound"][1],
            "library_ms": f32["library_ms"],
            "status": "ported", "dtype": "float32", "parts": f32["parts"],
            "bf16": {"max_abs_err": errs[torch.bfloat16][i], "ms": b16["ms"],
                     "plain_ms": b16["plain_ms"], "bound_ms": b16["bound"][0],
                     "library_ms": b16["library_ms"], "parts": b16["parts"]},
        }
        if "live_rows" in f32:
            entry["live_rows"] = f32["live_rows"]
            entry["rows"] = f32["rows"]
        kernels.append(entry)
    e2e = {str(d).removeprefix("torch."): rows[d][2] for d in rows}
    return kernels, e2e


class _Port:
    """The port's modules that the phases use."""

    def __init__(self):
        import monotonic_rnnt_tpu_torch as pkg
        from monotonic_rnnt_tpu_torch import convert
        from monotonic_rnnt_tpu_torch.ops.cuda import _build, fused, kernels

        pkg_dir = Path(pkg.__file__).resolve().parent
        if pkg_dir.parent != ROOT:
            raise RuntimeError(f"imported the port from {pkg_dir}, not from "
                               f"this checkout ({ROOT})")
        self.monotonic_rnnt_loss = pkg.monotonic_rnnt_loss
        self.convert, self.build, self.fused, self.K = (convert, _build, fused,
                                                        kernels)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    mt = _Port()
    import golden  # the reference's worked example (tests/golden.py)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} ({gpu}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    phase_build(mt)

    main_inputs = make_inputs(mt, B, T, S, V, seed=SEED,
                              t_range=(3 * T // 4, T), s_range=(3 * S // 5, S))
    weights = torch.linspace(-0.5, 2.0, B, device="cuda")  # one negative
    errs = phase_kernels(mt, main_inputs)
    main_launches, costs_f32 = phase_main(mt, main_inputs, weights,
                                          torch.float32)
    phase_main(mt, main_inputs, weights, torch.bfloat16)
    phase_cost_only(mt, main_inputs, costs_f32)
    phase_goldens(mt, golden)
    phase_restricted(mt, main_inputs, weights)
    phase_train(mt, main_inputs)
    kernels, e2e = phase_timing(mt, main_inputs, weights, errs, main_launches)
    log(f"end-to-end loss at B={B},T={T},S={S},V={V}: {json.dumps(e2e)}")
    log(f"total {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
