#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the monotonic RNN-T loss on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``monotonic_rnnt_tpu_torch/csrc``,
holds each kernel wrapper against its plain PyTorch version, drives the
padded loss's main path (forward, cost-only and backward at the benchmark
lattice B=32, T=200, S=50, V=1000, in float32 and bfloat16) against the
plain-torch oracle, checks the golden values of the reference's worked
example, takes five SGD steps, and times the kernels with CUDA events.

The banded phase then builds the banded acceptance case (B=2, T=1600,
S=200, V=1024, alignment band +-20; benchmarks/banded_bench.py) with the
port's own functions and, in float32 and bfloat16: holds the four banded
kernels against their plain versions on the case's operands; drives
``monotonic_rnnt_loss_banded`` (a training step with per-sample weights, then
a cost-only call, launch counts read after each part) against the banded
oracle, and against the padded loss on the full [2, 1600, 201, 1024]
lattice through ``unpack_band``; checks the banded goldens, five SGD steps,
and the banded loss at the benchmark lattice (+-8 band, variable T_b and
S_b) against the padded restricted result; and times each kernel beside its
byte bound, its plain version and a PyTorch yardstick.

Any failed check raises, and the script exits non-zero. The last three lines
of its output are the kernels JSON line, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.

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
  * goldens: cost 1e-4, gradient table 1e-2, as the JAX package's tests;
  * banded kernels vs plain versions: as the padded kernels above (the same
    online-LSE code for the stats; the scans' alphas and betas reach ~1.1e4
    at T=1600, so 1e-5 relative is a few ulps); grad_pass f32 1e-4, bf16
    8e-3 relative (one ulp);
  * banded loss vs the banded oracle: costs as above; grads f32
    |d| <= 1e-6 + 1e-3|ref|, bf16 1.6e-2 (the padded main path's bounds: the
    oracle's stats come from torch.logsumexp, whose rounding the T=1600
    log-space sums carry into every occupancy exponent);
  * banded vs padded on the same band: costs as above, unpacked grads f32
    1e-4, bf16 8e-3 relative. Both routes share the stats code and the DP
    operation order, so they differ at most by the exp of the occupancy
    coefficients (in-kernel expf against torch.exp), a few ulps.
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
# The banded acceptance case (benchmarks/banded_bench.py:10) and its band.
BANDED_CASE = (2, 1600, 200, 1024)
BAND_SHIFT = 20
TIMING_REPS = 20
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, and f32 outside the
# tensor cores (the kernels do elementwise f32 work only).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(AssertionError):
    pass


def launched(K) -> dict:
    """The wrappers that launched since the last reset, with their counts."""
    return {name: n for name, n in K.LAUNCHES.items() if n}


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
    check(launched(K) == {"stats_alpha_fused": 1, "beta_grad_fused": 1},
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
    check(launched(K) == {"stats_alpha_fused": 1},
          f"cost-only launches {K.LAUNCHES}")
    check(torch.equal(costs, costs_f32), "cost-only costs differ from fwd+bwd")
    log(f"cost-only: launches {launched(K)}; costs equal to fwd+bwd")


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
    """Returns the alignment and the CUDA route's (costs, grads) at +-8."""
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
    align_inf = torch.zeros((3, 12), dtype=torch.int32, device="cuda")
    align_inf[0, :4] = lab[0]
    align_inf[1, 2:6] = lab[1]
    x = lg.clone().requires_grad_(True)
    costs = mt.monotonic_rnnt_loss(x, lab, il, sl, alignment=align_inf)
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
    return align, out["cuda"]


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
        check(launched(K) == {"stats_alpha_fused": 1, "beta_grad_fused": 1},
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


# --- the banded path ------------------------------------------------------------

def leaf(x, dtype):
    """A fresh leaf copy in `dtype` (x.to(x.dtype) would be x itself)."""
    return x.detach().to(dtype).clone().requires_grad_(True)


def banded_case(mt, b, t, s, v, shift, seed=SEED):
    """The banded acceptance case, built as benchmarks/banded_bench.py:30-54
    builds it, with the port's own functions: logits N(0,1) and labels from
    RandomState(seed), full-length utterances, a random monotonic alignment,
    then bands_from_alignment, suggested_band_width, compute_band_layout and
    pack_band."""
    bd = mt.bands
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(
        rng.randn(b, t, s + 1, v).astype(np.float32)).to(DEVICE)
    labels = rng.randint(1, v, size=(b, s)).astype(np.int32)
    align = np.zeros((b, t), np.int32)
    for i in range(b):
        pos = np.sort(rng.choice(t, size=s, replace=False))
        align[i, pos] = labels[i]
    as_int = lambda a: torch.as_tensor(a, dtype=torch.int32, device=DEVICE)
    ilen, slen = as_int(np.full(b, t)), as_int(np.full(b, s))
    bands = bd.bands_from_alignment(as_int(align), ilen, slen, shift, 0)
    w_req = int(bd.required_band_width(ilen, slen, bands, t, s + 1))
    w = bd.suggested_band_width(ilen, slen, bands, t, s + 1)
    layout = bd.compute_band_layout(ilen, slen, bands, t, s + 1, w)
    return {"logits": logits, "logits_band": bd.pack_band(logits, layout),
            "labels": as_int(labels), "ilen": ilen, "slen": slen,
            "bands": bands, "layout": layout, "w": w, "w_req": w_req}


def banded_operands(mt, case, weights, dtype):
    """Every banded kernel's operands on the case, from the plain versions."""
    bd, BK = mt.bands, mt.BK
    x = case["logits_band"].to(dtype)
    labels, ilen, slen = case["labels"], case["ilen"], case["slen"]
    layout, bands = case["layout"], case["bands"]
    t_max, s1 = x.shape[1], labels.shape[1] + 1
    lab = mt.banded.band_labels(labels, slen, layout, s1).contiguous()
    rel = tuple(r.contiguous() for r in bd.band_relative_bounds(
        ilen, slen, bands, layout, t_max, s1))
    stats_args = (x, lab, rel, 0)
    denom, lpba, lpla, lpbb, lplb = BK.softmax_stats_banded_plain(*stats_args)
    scan_args = (lpba, lpla, layout.d.contiguous(), lpbb, lplb,
                 layout.d_next.contiguous(), ilen,
                 bd.band_virtual_next_rows(layout, slen).contiguous())
    alphas, betas = BK.fwdbwd_scan_banded_plain(*scan_args)
    ll = bd.band_final_slot(alphas, layout, ilen, slen)
    sc = weights[:, None, None]
    occ, cb, cl = (c * sc for c in mt.banded.band_occupancy_coefficients(
        alphas, betas, ll, ilen, slen, layout))
    grad_args = (x, denom, occ.contiguous(), cb.contiguous(), cl.contiguous(),
                 lab, 0)
    return {"stats": stats_args, "scan": scan_args, "grad": grad_args}


def compare_banded_kernels(mt, ops, what):
    """The four banded wrappers against their plain versions, same inputs.

    Returns each kernel's max |d|."""
    BK, K = mt.BK, mt.K
    errs = {}
    for with_beta in (True, False):
        got = BK.softmax_stats_banded(*ops["stats"], with_beta=with_beta)
        ref = BK.softmax_stats_banded_plain(*ops["stats"], with_beta=with_beta)
        check(len(got) == len(ref), f"{what} stats outputs")
        errs["softmax_stats_banded"] = max(
            [errs.get("softmax_stats_banded", 0.0)]
            + [assert_close(g, r, 1e-5, 1e-6, f"{what} stats {i} beta="
                            f"{with_beta}") for i, (g, r) in
               enumerate(zip(got, ref))])
    got = BK.fwdbwd_scan_banded(*ops["scan"])
    ref = BK.fwdbwd_scan_banded_plain(*ops["scan"])
    errs["fwdbwd_scan_banded"] = max(
        assert_close(g, r, 1e-4, 1e-5, f"{what} {n}")
        for n, g, r in zip(("alphas", "betas"), got, ref))
    got_a = BK.alpha_scan_banded(*ops["scan"][:3])
    errs["alpha_scan_banded"] = assert_close(got_a, ref[0], 1e-4, 1e-5,
                                             f"{what} alpha_scan")
    check(torch.equal(got_a, got[0]), f"{what}: the two alpha scans differ")
    x = ops["grad"][0]
    bf16 = x.dtype == torch.bfloat16
    got = K.grad_pass(*ops["grad"], out_dtype=x.dtype)
    ref = K.grad_pass_plain(*ops["grad"], out_dtype=x.dtype)
    check(got.dtype == x.dtype, f"{what}: grad_pass dtype {got.dtype}")
    errs["grad_pass"] = assert_close(got, ref, 1e-6, 8e-3 if bf16 else 1e-4,
                                     f"{what} grad_pass")
    # The split path's [B, S1] labels: one id per slot for every t.
    lab2 = ops["grad"][5][:, 0, :].contiguous()
    args2 = ops["grad"][:5] + (lab2, 0)
    assert_close(K.grad_pass(*args2, out_dtype=torch.float32),
                 K.grad_pass_plain(*args2, out_dtype=torch.float32), 1e-6,
                 1e-4, f"{what} grad_pass [B,S1] labels")
    torch.cuda.synchronize()
    log(f"banded kernel-vs-plain {what}: max|d| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return errs


def phase_banded_main(mt, case, weights, dtype):
    """The banded main path: a training step (loss, weighted sum, backward),
    then a cost-only call; counts reset once before, read after each part.
    Costs and gradients against the banded oracle on the card."""
    K = mt.K
    args = (case["labels"], case["ilen"], case["slen"])
    x = leaf(case["logits_band"], dtype)
    K.reset_launch_counts()
    costs = mt.monotonic_rnnt_loss_banded(x, *args, bands=case["bands"])
    torch.cuda.synchronize()
    after_fwd = launched(K)
    (costs * weights).sum().backward()
    torch.cuda.synchronize()
    after_bwd = launched(K)
    with torch.no_grad():
        costs_only = mt.monotonic_rnnt_loss_banded(x, *args,
                                                   bands=case["bands"])
    torch.cuda.synchronize()
    launches = launched(K)
    costs, grads = costs.detach(), x.grad
    check(after_fwd == {"softmax_stats_banded": 1, "fwdbwd_scan_banded": 1},
          f"banded forward {dtype} launches {after_fwd}")
    check(after_bwd == {"softmax_stats_banded": 1, "fwdbwd_scan_banded": 1,
                        "grad_pass": 1},
          f"banded backward {dtype} launches {after_bwd}")
    check(launches == {"softmax_stats_banded": 2, "fwdbwd_scan_banded": 1,
                       "grad_pass": 1, "alpha_scan_banded": 1},
          f"banded cost-only {dtype} launches {launches}")
    check(torch.equal(costs_only, costs), "banded cost-only costs differ")
    check(grads.dtype == dtype, f"banded grad dtype {grads.dtype}")
    check(tuple(costs.shape) == (x.shape[0],)
          and bool(torch.isfinite(costs).all()), "banded costs finite, [B]")
    check(bool(torch.isfinite(grads.float()).all()), "banded grads finite")

    xr = leaf(case["logits_band"], dtype)
    ref = mt.monotonic_rnnt_loss_banded(xr, *args, bands=case["bands"],
                                        backend="reference")
    (ref * weights).sum().backward()
    bf16 = dtype == torch.bfloat16
    e_c = assert_close(costs, ref, 1e-4, 1e-5, f"banded {dtype} costs")
    e_g = assert_close(grads, xr.grad, 1e-6, 1.6e-2 if bf16 else 1e-3,
                       f"banded {dtype} grads vs oracle")
    log(f"banded main path {dtype}: launches fwd {after_fwd}, +bwd "
        f"{after_bwd}, +cost-only {launches}; vs banded oracle costs max|d| "
        f"{e_c:.3g}, grads max|d| {e_g:.3g}; costs {costs.tolist()}")
    return launches, costs, grads


def phase_banded_vs_padded(mt, case, weights, dtype, costs, grads):
    """Check 3: the padded path's restricted loss on the full lattice."""
    bd = mt.bands
    args = (case["labels"], case["ilen"], case["slen"])
    s1 = case["labels"].shape[1] + 1
    check(bool(bd.band_layout_is_exact(*args[1:], case["bands"],
                                       case["logits"].shape[1], s1,
                                       case["w"]).all()),
          "band_layout_is_exact must hold at the acceptance case")
    x = leaf(case["logits"], dtype)
    full = mt.monotonic_rnnt_loss(x, *args, bands=case["bands"])
    (full * weights).sum().backward()
    bf16 = dtype == torch.bfloat16
    e_c = assert_close(costs, full, 1e-4, 1e-5, f"banded vs padded {dtype}")
    e_g = assert_close(bd.unpack_band(grads, case["layout"], s1), x.grad,
                       1e-6, 8e-3 if bf16 else 1e-4,
                       f"unpacked banded grads vs padded {dtype}")
    log(f"banded vs padded restricted [{x.shape[0]},{x.shape[1]},{s1},"
        f"{x.shape[3]}] {dtype}: costs max|d| {e_c:.3g}, unpacked grads "
        f"max|d| {e_g:.3g}")


def phase_banded_goldens(mt, golden):
    conv, bd = mt.convert, mt.bands
    lg, lb, il, sl = conv.loss_inputs_from_numpy(*golden.readme_batch(),
                                                 device=DEVICE)
    for align, losses in ((golden.ALIGN_A, golden.ALIGN_A_LOSSES),
                          (golden.ALIGN_B, golden.ALIGN_B_LOSSES)):
        for shift, expected in losses.items():
            bands = bd.bands_from_alignment(
                torch.from_numpy(align[None]).to(DEVICE), il, sl, shift, 0)
            w = bd.suggested_band_width(il, sl, bands, 4, 3)
            layout = bd.compute_band_layout(il, sl, bands, 4, 3, w)
            x = bd.pack_band(lg, layout).requires_grad_(True)
            costs = mt.monotonic_rnnt_loss_banded(x, lb, il, sl, bands=bands,
                                                  backend="cuda")
            costs.sum().backward()
            costs = costs.detach()
            check(abs(float(costs[0]) - expected) < 1e-4,
                  f"banded golden shift={shift}: {costs} vs {expected}")
            check(bool(torch.isfinite(x.grad).all()), "banded golden grads")
    log("banded goldens: restricted 0.363/0.2958/0.072/0.192/0.0672 ok")


def phase_banded_train(mt, case):
    K = mt.K
    args = (case["labels"], case["ilen"], case["slen"])
    x = leaf(case["logits_band"], torch.float32)
    opt = torch.optim.SGD([x], lr=0.5)
    losses = []
    for step in range(5):
        K.reset_launch_counts()
        opt.zero_grad(set_to_none=True)
        loss = mt.monotonic_rnnt_loss_banded(x, *args,
                                             bands=case["bands"]).sum()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        check(launched(K) == {"softmax_stats_banded": 1,
                              "fwdbwd_scan_banded": 1, "grad_pass": 1},
              f"banded train step {step} launches {K.LAUNCHES}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"banded loss must fall at every step: {losses}")
    log(f"5 SGD steps (lr 0.5) on logits_band: summed loss {losses}")


def phase_banded_restricted(mt, main_inputs, weights, align, padded):
    """Check 7: the banded loss at the padded benchmark lattice, +-8 band,
    variable T_b and S_b, against phase_restricted's padded result."""
    bd = mt.bands
    logits, labels, ilen, slen = main_inputs
    t_max, s1 = logits.shape[1], logits.shape[2]
    bands = bd.bands_from_alignment(align, ilen, slen, ALIGN_SHIFT, 0)
    w = bd.suggested_band_width(ilen, slen, bands, t_max, s1)
    check(bool(bd.band_layout_is_exact(ilen, slen, bands, t_max, s1,
                                       w).all()), "restricted layout exact")
    layout = bd.compute_band_layout(ilen, slen, bands, t_max, s1, w)
    x = leaf(bd.pack_band(logits, layout), torch.float32)
    costs = mt.monotonic_rnnt_loss_banded(x, labels, ilen, slen, bands=bands)
    (costs * weights).sum().backward()
    e_c = assert_close(costs.detach(), padded[0], 1e-4, 1e-5,
                       "banded restricted costs")
    e_g = assert_close(bd.unpack_band(x.grad, layout, s1), padded[1], 1e-6,
                       1e-4, "banded restricted unpacked grads")
    log(f"banded at the benchmark lattice, +-{ALIGN_SHIFT} (W={w} of "
        f"S1={s1}, T_b {int(ilen.min())}-{int(ilen.max())}): vs padded costs "
        f"max|d| {e_c:.3g}, unpacked grads max|d| {e_g:.3g}")


def phase_banded_timing(mt, case, weights, errs, launches):
    """Each banded kernel against its bound, plain version and yardstick,
    and the banded loss beside the padded loss on the same lattice."""
    K, BK = mt.K, mt.BK
    args = (case["labels"], case["ilen"], case["slen"])
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        ops = banded_operands(mt, case, weights, dtype)
        x = ops["stats"][0]
        n_b, n_t, n_w, n_v = x.shape
        isz = x.element_size()
        big = x.numel() * isz
        small = n_b * n_t * n_w * 4          # one [B, T, W] f32 or int32
        bt = n_b * n_t * 4                   # one [B, T] int32
        occ, cb, cl = ops["grad"][2:5]
        live = int(((occ != 0) | (cb != 0) | (cl != 0)).sum())
        scan = ops["scan"]
        timed = {
            "softmax_stats_banded": (
                lambda: BK.softmax_stats_banded(*ops["stats"]),
                lambda: BK.softmax_stats_banded_plain(*ops["stats"]),
                lambda: torch.logsumexp(x, dim=-1),
                bound_ms(big + small + 4 * bt + 5 * small, 4 * x.numel())),
            "fwdbwd_scan_banded": (
                lambda: BK.fwdbwd_scan_banded(*scan),
                lambda: BK.fwdbwd_scan_banded_plain(*scan), None,
                bound_ms(5 * small + 2 * bt + n_b * 4 + 2 * small,
                         2 * 8 * n_b * n_t * n_w)),
            "alpha_scan_banded": (
                lambda: BK.alpha_scan_banded(*scan[:3]),
                lambda: BK.alpha_scan_banded_plain(*scan[:3]), None,
                bound_ms(3 * small + bt, 8 * n_b * n_t * n_w)),
            "grad_pass": (
                lambda: K.grad_pass(*ops["grad"], out_dtype=x.dtype),
                lambda: K.grad_pass_plain(*ops["grad"], out_dtype=x.dtype),
                lambda: torch.softmax(x, dim=-1),
                bound_ms(live * n_v * isz + big + 5 * small,
                         6 * live * n_v)),
        }
        out = {}
        for name, (kern, plain, lib, bound) in timed.items():
            out[name] = {
                "ms": cuda_ms(kern),
                # The scans' plain versions loop over T in Python: once.
                "plain_ms": cuda_ms(plain, reps=1, warmup=0),
                "library_ms": cuda_ms(lib) if lib else None,
                "bound": bound}
        out["grad_pass"].update(live_rows=live, rows=n_b * n_t * n_w)
        lg_leaf = leaf(x, dtype)
        full = case["logits"].to(dtype)
        full_leaf = leaf(full, dtype)

        def fwd_bwd(leaf, fn):
            costs = fn(leaf, *args, bands=case["bands"])
            (costs * weights).sum().backward()
            leaf.grad = None

        def cost_only(inp, fn):
            with torch.no_grad():
                fn(inp, *args, bands=case["bands"])

        band_fn, pad_fn = mt.monotonic_rnnt_loss_banded, mt.monotonic_rnnt_loss
        e2e = {"banded_fwd_bwd_ms": cuda_ms(lambda: fwd_bwd(lg_leaf,
                                                            band_fn)),
               "banded_cost_only_ms": cuda_ms(lambda: cost_only(x, band_fn)),
               "padded_fwd_bwd_ms": cuda_ms(lambda: fwd_bwd(full_leaf,
                                                            pad_fn), reps=5),
               "padded_cost_only_ms": cuda_ms(lambda: cost_only(full, pad_fn),
                                              reps=5)}
        rows[dtype] = (out, e2e)
        log(f"banded timing {dtype}: " + "; ".join(
            f"{n} {r['ms']:.4f} ms (bound {r['bound'][0]:.4f}, plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']})"
            for n, r in out.items())
            + f"; live rows {live}/{n_b * n_t * n_w}; " + json.dumps(e2e))
        del ops, lg_leaf, full, full_leaf
        torch.cuda.empty_cache()

    spec = (("softmax_stats_banded", 335), ("fwdbwd_scan_banded", 1219),
            ("alpha_scan_banded", 1271), ("grad_pass", 1322))
    kernels = []
    for name, line in spec:
        f32, b16 = rows[torch.float32][0][name], rows[torch.bfloat16][0][name]
        entry = {
            "name": name, "route": "cuda",
            "source": ("monotonic_rnnt_tpu_torch/csrc/grad_pass.cu"
                       if name == "grad_pass" else
                       "monotonic_rnnt_tpu_torch/csrc/banded.cu"),
            "replaces": f"monotonic_rnnt_tpu/ops/pallas/kernels.py:{line}",
            "launches": launches.get(name, 0),
            "max_abs_err": errs[torch.float32][name],
            "ms": f32["ms"], "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound"][0], "bound_by": f32["bound"][1],
            "library_ms": f32["library_ms"],
            "status": "ported", "dtype": "float32",
            "shape": "B=%d,T=%d,W=%d,V=%d" % tuple(case["logits_band"].shape),
            "bf16": {"max_abs_err": errs[torch.bfloat16][name],
                     "ms": b16["ms"], "plain_ms": b16["plain_ms"],
                     "bound_ms": b16["bound"][0],
                     "library_ms": b16["library_ms"]},
        }
        if f32["library_ms"] is None:
            entry["library_note"] = "no single PyTorch call computes a scan"
        if "live_rows" in f32:
            entry.update(live_rows=f32["live_rows"], rows=f32["rows"])
        kernels.append(entry)
    e2e = {str(d).removeprefix("torch."): rows[d][1] for d in rows}
    return kernels, e2e


def run_banded(mt, golden, main_inputs, weights, restricted):
    """Every banded phase; returns the kernels' JSON entries and the e2e times."""
    b, t, s, v = BANDED_CASE
    t0 = time.perf_counter()
    case = banded_case(mt, b, t, s, v, BAND_SHIFT)
    log(f"banded case B={b},T={t},S={s},V={v}, shift {BAND_SHIFT}: band width "
        f"W={case['w']} (required {case['w_req']}) of S+1={s + 1}; built in "
        f"{time.perf_counter() - t0:.1f} s")
    band_w = torch.tensor([-0.5, 2.0], device=DEVICE)   # one negative
    errs, launches = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype] = compare_banded_kernels(
            mt, banded_operands(mt, case, band_w, dtype), f"banded {dtype}")
        launched_d, costs, grads = phase_banded_main(mt, case, band_w, dtype)
        if dtype == torch.float32:
            launches = launched_d
        phase_banded_vs_padded(mt, case, band_w, dtype, costs, grads)
        del grads
        torch.cuda.empty_cache()
    phase_banded_goldens(mt, golden)
    phase_banded_train(mt, case)
    phase_banded_restricted(mt, main_inputs, weights, *restricted)
    return phase_banded_timing(mt, case, band_w, errs, launches)


class _Port:
    """The port's modules that the phases use."""

    def __init__(self):
        import monotonic_rnnt_tpu_torch as pkg
        from monotonic_rnnt_tpu_torch import convert
        from monotonic_rnnt_tpu_torch.ops import banded, bands
        from monotonic_rnnt_tpu_torch.ops.cuda import (_build, banded_kernels,
                                                       fused, kernels)

        pkg_dir = Path(pkg.__file__).resolve().parent
        if pkg_dir.parent != ROOT:
            raise RuntimeError(f"imported the port from {pkg_dir}, not from "
                               f"this checkout ({ROOT})")
        self.monotonic_rnnt_loss = pkg.monotonic_rnnt_loss
        self.monotonic_rnnt_loss_banded = pkg.monotonic_rnnt_loss_banded
        self.convert, self.build, self.fused, self.K = (convert, _build, fused,
                                                        kernels)
        self.bands, self.banded, self.BK = bands, banded, banded_kernels


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
    restricted = phase_restricted(mt, main_inputs, weights)
    phase_train(mt, main_inputs)
    kernels, e2e = phase_timing(mt, main_inputs, weights, errs, main_launches)
    log(f"end-to-end loss at B={B},T={T},S={S},V={V}: {json.dumps(e2e)}")
    band_kernels, band_e2e = run_banded(mt, golden, main_inputs, weights,
                                        restricted)
    kernels += band_kernels
    log(f"end-to-end banded loss at B,T,S,V={BANDED_CASE}, shift "
        f"{BAND_SHIFT}: {json.dumps(band_e2e)}")
    log(f"total {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
