"""The port's banded (packed [B, T, W, V]) loss against the JAX package.

The same numpy-seeded inputs go through the JAX function and its port: the
band layout (exact integers), the banded oracle, each banded kernel's plain
version against its Pallas function run in interpret mode, and the public
loss under autograd on its deferred (kernel) route and its reference route.
On the CPU the kernel wrappers take their plain versions, so the deferred
route runs here through ``_BandedCore.apply(..., "cuda")``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
import monotonic_rnnt_tpu_torch as mt
from monotonic_rnnt_tpu.ops import banded as jbanded
from monotonic_rnnt_tpu.ops import bands as jbands
from monotonic_rnnt_tpu.ops.pallas import kernels as jk
from monotonic_rnnt_tpu.utils.debug import interpret_mode
from monotonic_rnnt_tpu_torch import convert
from monotonic_rnnt_tpu_torch.ops import banded as tbanded
from monotonic_rnnt_tpu_torch.ops import bands as tbands
from monotonic_rnnt_tpu_torch.ops import helpers as thelpers
from monotonic_rnnt_tpu_torch.ops import reference as tref
from monotonic_rnnt_tpu_torch.ops.cuda import banded as tcbanded
from monotonic_rnnt_tpu_torch.ops.cuda import banded_kernels as tbk
from monotonic_rnnt_tpu_torch.ops.cuda import kernels as tk
from monotonic_rnnt_tpu_torch.utils.status import RnntError
from test_torch_reference import assert_nan_cost_contract, nan_cost_case

# (seed, B, T, S, V, shift, blank): the case shapes of tests/test_banded.py
# (shift 0 is the exact-path restriction; V=130 spans more than one lane
# tile), and a wide band (shift None: the unrestricted band at W = S+1 > 32).
CASES = [(0, 3, 24, 8, 21, 2, 0), (1, 2, 40, 12, 33, 0, 0),
         (2, 5, 17, 5, 130, 3, 2), (4, 2, 40, 36, 9, None, 1)]
IDS = ["3x24x8x21s2", "2x40x12x33s0", "5x17x5x130s3b2", "wide2x40x36x9"]
WEIGHTS = [1.5, -0.25, 2.0, 0.5, -1.0]   # one negative cotangent


def _case(seed, batch, t, s, v, shift, blank):
    """numpy inputs: logits 2*N(0,1), T_b >= S_b, a random alignment."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(batch, t, s + 1, v) * 2).astype(np.float32)
    labels = rng.randint(0, v - 1, size=(batch, s))
    labels = np.where(labels >= blank, labels + 1, labels).astype(np.int32)
    ilen = rng.randint(max(s, 1), t + 1, size=batch).astype(np.int32)
    ilen[0] = t
    slen = rng.randint(0, np.minimum(s, ilen) + 1).astype(np.int32)
    slen[0] = s
    align = np.full((batch, t), blank, np.int32)
    for b in range(batch):
        pos = np.sort(rng.choice(ilen[b], size=slen[b], replace=False))
        align[b, pos] = labels[b, :slen[b]]
    return logits, labels, ilen, slen, align


class Both:
    """One case in both packages: JAX arrays (j_*) and CPU tensors (t_*)."""

    def __init__(self, case, width=None):
        seed, batch, t, s, v, shift, blank = case
        logits, labels, ilen, slen, align = _case(*case)
        self.blank, self.t_max, self.s1, self.batch = blank, t, s + 1, batch
        self.j = [jnp.asarray(a) for a in (logits, labels, ilen, slen)]
        self.t = list(convert.loss_inputs_from_numpy(logits, labels, ilen,
                                                     slen, device="cpu"))
        if shift is None:
            self.jb = jbands.default_bands(self.j[2], self.j[3], t)
            self.tb = tbands.default_bands(self.t[2], self.t[3], t)
        else:
            self.jb = jbands.bands_from_alignment(jnp.asarray(align),
                                                  self.j[2], self.j[3],
                                                  shift, blank)
            self.tb = tbands.bands_from_alignment(torch.from_numpy(align),
                                                  self.t[2], self.t[3],
                                                  shift, blank)
        req = int(jbands.required_band_width(self.j[2], self.j[3], self.jb, t,
                                             self.s1))
        self.w = self.s1 if shift is None else (width or req)
        self.jl = jbands.compute_band_layout(self.j[2], self.j[3], self.jb, t,
                                             self.s1, self.w)
        self.tl = tbands.compute_band_layout(self.t[2], self.t[3], self.tb, t,
                                             self.s1, self.w)
        self.j_band = jbands.pack_band(self.j[0], self.jl)
        self.t_band = tbands.pack_band(self.t[0], self.tl)

    def jargs(self):
        return (self.j[2], self.j[3], self.jb)

    def targs(self):
        return (self.t[2], self.t[3], self.tb)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


# --- module 1: the packed band layout, exact integers --------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_band_layout_and_widths_match_jax(case):
    c = Both(case)
    for width in sorted({c.w, max(1, c.w - 2), c.s1}):
        jl = jbands.compute_band_layout(*c.jargs(), c.t_max, c.s1, width)
        tl = tbands.compute_band_layout(*c.targs(), c.t_max, c.s1, width)
        assert tl.width == jl.width
        for name in ("offset", "d", "d_next"):
            assert getattr(tl, name).dtype == torch.int32
            _eq(getattr(tl, name), getattr(jl, name))
        _eq(tbands.band_layout_is_exact(*c.targs(), c.t_max, c.s1, width),
            jbands.band_layout_is_exact(*c.jargs(), c.t_max, c.s1, width))
        _eq(tbands.clip_bands_to_width(c.tb, tl).max_s,
            jbands.clip_bands_to_width(c.jb, jl).max_s)
    _eq(tbands._raw_offsets(*c.targs(), c.t_max, c.s1),
        jbands._raw_offsets(*c.jargs(), c.t_max, c.s1))
    assert int(tbands.required_band_width(*c.targs(), c.t_max, c.s1)) == int(
        jbands.required_band_width(*c.jargs(), c.t_max, c.s1))
    assert tbands.suggested_band_width(*c.targs(), c.t_max, c.s1) == \
        jbands.suggested_band_width(*c.jargs(), c.t_max, c.s1)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_band_bounds_masks_and_rows_match_jax(case):
    c = Both(case, width=None)
    for width in (c.w, max(1, c.w - 2)):   # exact, then clipped
        jl = jbands.compute_band_layout(*c.jargs(), c.t_max, c.s1, width)
        tl = tbands.compute_band_layout(*c.targs(), c.t_max, c.s1, width)
        for got, want in zip(
                tbands.band_relative_bounds(*c.targs(), tl, c.t_max, c.s1),
                jbands.band_relative_bounds(*c.jargs(), jl, c.t_max, c.s1)):
            assert got.dtype == torch.int32
            _eq(got, want)
        for got, want in zip(
                tbands.band_lattice_masks(*c.targs(), tl, c.t_max, c.s1),
                jbands.band_lattice_masks(*c.jargs(), jl, c.t_max, c.s1)):
            _eq(got, want)
        _eq(tbands.band_virtual_next_rows(tl, c.t[3]),
            jbands.band_virtual_next_rows(jl, c.j[3]))
        values = np.random.RandomState(5).randn(c.batch, c.t_max,
                                                width).astype(np.float32)
        _eq(tbands.band_final_slot(torch.from_numpy(values), tl, c.t[2],
                                   c.t[3]),
            jbands.band_final_slot(jnp.asarray(values), jl, c.j[2], c.j[3]))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_pack_unpack_and_band_labels_match_jax(case):
    c = Both(case)
    _eq(c.t_band, c.j_band)
    x3 = c.t[0][..., 0].contiguous()
    _eq(tbands.pack_band(x3, c.tl), jbands.pack_band(c.j[0][..., 0], c.jl))
    for x, jx in ((c.t_band, c.j_band), (tbands.pack_band(x3, c.tl),
                                         jbands.pack_band(c.j[0][..., 0],
                                                          c.jl))):
        back = tbands.unpack_band(x, c.tl, c.s1, fill=-1.0)
        _eq(back, jbands.unpack_band(jx, c.jl, c.s1, fill=-1.0))
        _eq(tbands.pack_band(back, c.tl), x)   # round trip
    # band_labels: a gather here, a one-hot matmul in the JAX package.
    got = tbanded.band_labels(c.t[1], c.t[3], c.tl, c.s1)
    assert got.dtype == torch.int32
    _eq(got, jbanded.band_labels(c.j[1], c.j[3], c.jl, c.s1))


def test_band_labels_large_ids_and_convert():
    """Ids above 256 (a bf16 matmul would round them) and a layout handed
    across from the JAX package by convert.band_layout_from_numpy."""
    c = Both((21, 3, 30, 9, 1024, 2, 0))
    got = tbanded.band_labels(c.t[1], c.t[3], c.tl, c.s1)
    _eq(got, jbanded.band_labels(c.j[1], c.j[3], c.jl, c.s1))
    assert int(got.max()) > 256
    moved = convert.band_layout_from_numpy(
        *(np.asarray(a) for a in (c.jl.offset, c.jl.d, c.jl.d_next)),
        c.jl.width, device="cpu")
    for a, b in zip(moved, c.tl):
        assert a == b if isinstance(a, int) else torch.equal(a, b)


# --- module 2: the banded oracle ------------------------------------------------

_jref = jax.jit(jbanded.rnnt_loss_banded_reference,
                static_argnames=("blank_id", "with_grads"))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_banded_reference_matches_jax(case):
    c = Both(case)
    want_c, want_g = _jref(c.j_band, c.j[1], c.j[2], c.j[3], c.jb,
                           blank_id=c.blank)
    got_c, got_g = tbanded.rnnt_loss_banded_reference(
        c.t_band, c.t[1], c.t[2], c.t[3], c.tb, blank_id=c.blank)
    assert got_g.shape == (c.batch, c.t_max, c.w, c.t[0].shape[3])
    _close(got_c, want_c, 1e-5, 1e-6, "costs")
    _close(got_g, want_g, 1e-4, 1e-6, "grads")
    cost_only, none = tbanded.rnnt_loss_banded_reference(
        c.t_band, c.t[1], c.t[2], c.t[3], c.tb, blank_id=c.blank,
        with_grads=False)
    assert none is None and torch.equal(cost_only, got_c)


@pytest.mark.parametrize("case", CASES[:3], ids=IDS[:3])
def test_banded_reference_equals_padded_restricted(case):
    """Banded costs and unpacked gradients equal the padded oracle's on the
    same (exact) band: 1e-5 / 1e-4 relative, the summation orders differ."""
    c = Both(case)
    assert bool(tbands.band_layout_is_exact(*c.targs(), c.t_max, c.s1,
                                            c.w).all())
    c_band, g_band = tbanded.rnnt_loss_banded_reference(
        c.t_band, c.t[1], c.t[2], c.t[3], c.tb, blank_id=c.blank)
    c_full, g_full = mt.rnnt_loss_reference(*c.t, blank_id=c.blank,
                                            bands=c.tb)
    _close(c_band, c_full.numpy(), 1e-5, 1e-5, "costs")
    _close(tbands.unpack_band(g_band, c.tl, c.s1), g_full.numpy(), 1e-4,
           1e-6, "grads")


def test_banded_width_clipping_and_infeasible_band():
    """A too-narrow W scores clip_bands_to_width(bands); a band whose final
    cell falls outside the window costs +inf with a zero gradient."""
    c = Both((7, 2, 30, 10, 15, 4, 0))
    width = max(2, c.w - 2)
    assert not bool(tbands.band_layout_is_exact(*c.targs(), c.t_max, c.s1,
                                                width).all())
    layout = tbands.compute_band_layout(*c.targs(), c.t_max, c.s1, width)
    lb = tbands.pack_band(c.t[0], layout)
    c_band, g_band = tbanded.rnnt_loss_banded_reference(
        lb, c.t[1], c.t[2], c.t[3], c.tb)
    clipped = tbands.clip_bands_to_width(c.tb, layout)
    c_full, g_full = mt.rnnt_loss_reference(*c.t, bands=clipped)
    _close(c_band, c_full.numpy(), 1e-5, 1e-5, "clipped costs")
    _close(tbands.unpack_band(g_band, layout, c.s1), g_full.numpy(), 1e-4,
           1e-6, "clipped grads")

    # W = 1 cannot reach S_b = 10 at the last frame: infeasible.
    layout = tbands.compute_band_layout(*c.targs(), c.t_max, c.s1, 1)
    lb = tbands.pack_band(c.t[0], layout).requires_grad_(True)
    for route in ("reference", "cuda"):
        lb.grad = None
        costs = tbanded._BandedCore.apply(lb, c.t[1], c.t[2], c.t[3],
                                          c.tb.min_s, c.tb.max_s, 0, route)
        (costs * torch.tensor([1.0, 0.0])).sum().backward()
        costs = costs.detach()
        assert bool(torch.isinf(costs[0])) and float(costs[0]) > 0, route
        assert bool((lb.grad[0] == 0).all()), route
        assert bool(torch.isfinite(lb.grad).all()), route


# --- the kernels' plain versions against the Pallas functions (interpret) -------

def _stats_operands(c):
    jrel = jbands.band_relative_bounds(*c.jargs(), c.jl, c.t_max, c.s1)
    trel = tbands.band_relative_bounds(*c.targs(), c.tl, c.t_max, c.s1)
    jlab = jbanded.band_labels(c.j[1], c.j[3], c.jl, c.s1)
    tlab = tbanded.band_labels(c.t[1], c.t[3], c.tl, c.s1)
    return (jlab, jrel), (tlab, trel)


# Stats-only shapes that reach the CUDA kernel's other paths (the card's
# tests run them on the kernel): W = 41 and 64 past a warp, odd V (two-byte
# bf16 rows), V past a bf16 round.
STATS_CASES = [(6, 2, 44, 40, 21, None, 3), (7, 3, 9, 4, 1001, 1, 5),
               (8, 1, 66, 63, 50, None, 0)]
STATS_IDS = ["wide2x44x40x21b3", "3x9x4x1001s1b5", "wide1x66x63x50"]


@pytest.mark.parametrize("with_beta", [True, False], ids=["beta", "nobeta"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES[1:] + STATS_CASES,
                         ids=IDS[1:] + STATS_IDS)
def test_softmax_stats_banded_plain_matches_pallas(case, dtype, with_beta):
    c = Both(case)
    (jlab, jrel), (tlab, trel) = _stats_operands(c)
    jx, tx = c.j_band, c.t_band
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = jk.softmax_stats_banded(jx, jlab, jrel, c.blank,
                                   with_beta=with_beta, interpret=True)
    got = tbk.softmax_stats_banded(tx, tlab, trel, c.blank,
                                   with_beta=with_beta)
    assert len(got) == len(want) == (5 if with_beta else 3)
    for name, g, w in zip(("denom", "lpba", "lpla", "lpbb", "lplb"), got,
                          want):
        assert g.dtype == torch.float32
        w = np.asarray(w)
        fin = np.isfinite(w)
        assert (np.isfinite(g.numpy()) == fin).all(), name   # exact -inf
        np.testing.assert_allclose(g.numpy()[fin], w[fin], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _scan_operands(seed, batch, t_max, w, t_short=None):
    """Random finite streams and 0/1 shifts that switch along t (so a shift
    read in the wrong direction fails), a short second sample (T_b =
    t_short where given, else T - 5)."""
    rng = np.random.RandomState(seed)
    mk = lambda: (rng.randn(batch, t_max, w) - 1.0).astype(np.float32)
    streams = [mk() for _ in range(4)]
    d = rng.randint(0, 2, (batch, t_max)).astype(np.int32)
    dn = rng.randint(0, 2, (batch, t_max)).astype(np.int32)
    assert d.min() == 0 and d.max() == 1 and dn.min() == 0 and dn.max() == 1
    short = t_max - 5 if t_short is None else t_short
    ilen = np.array([t_max] + [short] * (batch - 1), np.int32)
    bvirt = np.where(rng.rand(batch, t_max, w) < 0.2, 0.0,
                     -np.inf).astype(np.float32)
    return streams, d, dn, ilen, bvirt


# W on both sides of the CUDA scans' one-warp chain (W <= 32); the last case
# has a second sample of T_b = 6, whose virtual row feeds 58 beta steps.
SCAN_CASES = [pytest.param(*c, id=f"{c[0]}-{c[1]}") for c in
              ((32, 8, None), (20, 16, None), (12, 40, None), (40, 32, None),
               (40, 33, None), (64, 16, 6))]


@pytest.mark.parametrize("t_max,w,t_short", SCAN_CASES)
def test_alpha_scan_banded_plain_matches_pallas(t_max, w, t_short):
    (lpb, lpl, _, _), d, _, _, _ = _scan_operands(t_max + w, 2, t_max, w)
    want = jk.alpha_scan_banded(jnp.asarray(lpb), jnp.asarray(lpl),
                                jnp.asarray(d)[..., None], interpret=True,
                                tiles=(2, t_max))
    got = tbk.alpha_scan_banded(torch.from_numpy(lpb), torch.from_numpy(lpl),
                                torch.from_numpy(d))
    _close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("t_max,w,t_short", SCAN_CASES)
def test_fwdbwd_scan_banded_plain_matches_pallas(t_max, w, t_short):
    streams, d, dn, ilen, bvirt = _scan_operands(t_max * w, 2, t_max, w,
                                                 t_short)
    j_args = [jnp.asarray(a) for a in streams]
    want = jk.fwdbwd_scan_banded(
        j_args[0], j_args[1], jnp.asarray(d)[..., None], j_args[2], j_args[3],
        jnp.asarray(dn)[..., None], jnp.asarray(ilen)[:, None, None],
        jnp.asarray(bvirt), interpret=True, tiles=(2, t_max))
    t_args = [torch.from_numpy(a) for a in streams]
    got = tbk.fwdbwd_scan_banded(
        t_args[0], t_args[1], torch.from_numpy(d), t_args[2], t_args[3],
        torch.from_numpy(dn), torch.from_numpy(ilen), torch.from_numpy(bvirt))
    for name, g, w_ in zip(("alphas", "betas"), got, want):
        w_ = np.asarray(w_)
        assert (np.isfinite(g.numpy()) == np.isfinite(w_)).all(), name
        _close(g, w_, 1e-5, 1e-5, name)
    # The alpha half is alpha_scan_banded's.
    assert torch.equal(got[0], tbk.alpha_scan_banded(t_args[0], t_args[1],
                                                     torch.from_numpy(d)))


def _grad_operands(c, labels_3d):
    """grad_pass operands from the banded oracle (3-D labels) or the padded
    oracle (2-D labels)."""
    if labels_3d:
        x = c.t_band
        lab = tbanded.band_labels(c.t[1], c.t[3], c.tl, c.s1)
        masks = tbands.band_lattice_masks(*c.targs(), c.tl, c.t_max, c.s1)
        stats = tbanded.band_stats(x, lab, c.blank)
        al, be, ll = tbanded.band_forward_backward(stats, masks, c.tl,
                                                   c.t[2], c.t[3])
        coefs = tbanded.band_occupancy_coefficients(al, be, ll, c.t[2],
                                                    c.t[3], c.tl)
    else:
        x = c.t[0]
        lab = thelpers.extend_labels(c.t[1], c.t[3], c.s1)
        masks = tbands.lattice_masks(c.t[2], c.t[3], c.tb, c.t_max, c.s1)
        stats = tref.compute_stats(x, c.t[1], c.t[3], c.blank)
        al, be, ll, _ = tref.forward_backward(stats, masks, c.t[2], c.t[3])
        coefs = tref.occupancy_coefficients(al, be, ll, c.t[2], c.t[3])
    return x, stats.denom, coefs, lab


def _grad_case(v_case, labels_3d):
    """(logits, denom, coefficients, labels, blank): from the oracles at V =
    130 and the odd V = 21, or random at V = 1 (the blank the only column;
    ids 1 and -1 match none; a third of the coefficients 0)."""
    if v_case != "v1":
        c = Both(CASES[2 if v_case == "v130" else 0])
        return (*_grad_operands(c, labels_3d), c.blank)
    rng = np.random.RandomState(1)
    b, t, s1 = 2, 5, 4
    f = lambda a: torch.from_numpy(a.astype(np.float32))
    coef = lambda: f(np.where(rng.rand(b, t, s1) < 0.3, 0.0,
                              rng.randn(b, t, s1)))
    lab = torch.from_numpy(rng.randint(-1, 2, (b, t, s1) if labels_3d
                                       else (b, s1)).astype(np.int32))
    return (f(rng.randn(b, t, s1, 1) * 2), f(rng.randn(b, t, s1)),
            (coef(), coef(), coef()), lab, 0)


@pytest.mark.parametrize("v_case", ["v130", "v21", "v1"])
@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("labels_3d", [True, False], ids=["BTW", "BS1"])
def test_grad_pass_plain_matches_pallas(labels_3d, dtype, out, v_case):
    x, denom, (occ, cb, cl), lab, blank = _grad_case(v_case, labels_3d)
    dt = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
    x = x.to(dt[dtype][0])
    j = [jnp.asarray(a.float().numpy()) for a in (x, denom, occ, cb, cl)]
    want = jk.grad_pass(j[0].astype(dt[dtype][1]), *j[1:],
                        jnp.asarray(lab.numpy()), blank,
                        out_dtype=dt[out][1], interpret=True)
    got = tk.grad_pass(x, denom, occ, cb, cl, lab, blank,
                       out_dtype=dt[out][0])
    assert got.dtype == dt[out][0]
    # bf16 output: both sides round the same f32 value, whose last bits may
    # differ (one bf16 ulp).
    _close(got, np.asarray(want.astype(jnp.float32)),
           8e-3 if out == "bf16" else 1e-5, 1e-6)


def test_banded_wrappers_take_plain_version_on_cpu_and_raise_elsewhere():
    c = Both(CASES[0])
    (_, _), (lab, rel) = _stats_operands(c)
    before = dict(tk.LAUNCHES)
    got = tbk.softmax_stats_banded(c.t_band, lab, rel, c.blank)
    want = tbk.softmax_stats_banded_plain(c.t_band, lab, rel, c.blank)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tk.LAUNCHES == before
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    bound = meta(2, 3, dt=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbk.softmax_stats_banded(meta(2, 3, 4, 5), meta(2, 3, 4, dt=torch.int32),
                                 (bound,) * 4, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbk.alpha_scan_banded(meta(2, 3, 4), meta(2, 3, 4), bound)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbk.fwdbwd_scan_banded(*([meta(2, 3, 4)] * 2), bound,
                               *([meta(2, 3, 4)] * 2), bound,
                               meta(2, dt=torch.int32), meta(2, 3, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.grad_pass(meta(2, 3, 4, 5), *([meta(2, 3, 4)] * 4),
                     meta(2, 3, 4, dt=torch.int32), 0)


# --- the public loss under autograd ----------------------------------------------

def _jax_banded_value_and_grad(c, backend, dtype=jnp.float32):
    wgt = jnp.asarray(WEIGHTS[:c.batch], jnp.float32)

    def total(x):
        return jnp.sum(wgt * jbanded.monotonic_rnnt_loss_banded(
            x, c.j[1], c.j[2], c.j[3], bands=c.jb, blank_id=c.blank,
            backend=backend))

    fn = jax.jit(jax.value_and_grad(total))
    x = c.j_band.astype(dtype)
    if backend == "pallas":
        with interpret_mode():
            return fn(x)
    return fn(x)


def _port_banded_value_and_grad(c, route, dtype=torch.float32):
    x = c.t_band.to(dtype).requires_grad_(True)
    if route == "reference":
        costs = mt.monotonic_rnnt_loss_banded(x, c.t[1], c.t[2], c.t[3],
                                              bands=c.tb, blank_id=c.blank)
    else:
        costs = tbanded._BandedCore.apply(x, c.t[1], c.t[2], c.t[3],
                                          c.tb.min_s, c.tb.max_s, c.blank,
                                          route)
    total = (costs * torch.tensor(WEIGHTS[:c.batch])).sum()
    total.backward()
    return total.detach(), x.grad


@pytest.mark.parametrize("route", ["reference", "cuda"])
@pytest.mark.parametrize("case", CASES[:3], ids=IDS[:3])
def test_banded_loss_autograd_matches_jax(case, route):
    """The port's reference route against the JAX reference backend; its
    deferred route (the kernels' plain versions) against the JAX Pallas
    deferred route in interpret mode. Costs rtol 1e-5, grads rtol 1e-4."""
    c = Both(case)
    v_want, g_want = _jax_banded_value_and_grad(
        c, "pallas" if route == "cuda" else "reference")
    v_got, g_got = _port_banded_value_and_grad(c, route)
    assert g_got.dtype == torch.float32
    _close(v_got, v_want, 1e-5, 1e-5, "weighted cost")
    _close(g_got, g_want, 1e-4, 1e-6, "grads")


def test_banded_loss_bf16_deferred_route_matches_jax():
    c = Both(CASES[0])
    v_want, g_want = _jax_banded_value_and_grad(c, "pallas", jnp.bfloat16)
    v_got, g_got = _port_banded_value_and_grad(c, "cuda", torch.bfloat16)
    assert g_got.dtype == torch.bfloat16
    _close(v_got, v_want, 1e-5, 1e-4, "weighted cost")
    # Both round an f32 gradient to bf16 once; its last bits may differ.
    _close(g_got, np.asarray(g_want.astype(jnp.float32)), 8e-3, 1e-6,
           "grads")


def test_banded_cost_only_route_and_residuals():
    """A cost-only call runs stats (no beta streams) + the alpha scan and
    gives the training forward's costs; the deferred forward keeps four
    [B, T, W] f32 residuals; the eager route's gradient is the oracle's."""
    c = Both(CASES[0])
    args = (c.t_band, c.t[1], c.t[2], c.t[3], c.tb, c.blank)
    costs, none = tcbanded.rnnt_loss_banded_cuda(*args, with_grads=False)
    fwd_costs, res = tcbanded.banded_deferred_fwd(*args)
    assert none is None and torch.equal(costs, fwd_costs)
    eager_costs, eager_grads = tcbanded.rnnt_loss_banded_cuda(*args)
    assert torch.equal(eager_costs, costs)
    _, want_grads = tbanded.rnnt_loss_banded_reference(*args[:5],
                                                       blank_id=c.blank)
    _close(eager_grads, want_grads.numpy(), 1e-5, 1e-7, "eager grads")
    assert [tuple(r.shape) for r in res[:3]] == [(c.batch, c.t_max, c.w)] * 3
    with torch.no_grad():
        via_api = tbanded._BandedCore.apply(c.t_band, c.t[1], c.t[2], c.t[3],
                                            c.tb.min_s, c.tb.max_s, c.blank,
                                            "cuda")
    assert torch.equal(via_api, costs)
    ref, _ = tbanded.rnnt_loss_banded_reference(*args[:5], blank_id=c.blank,
                                                with_grads=False)
    _close(costs, ref.numpy(), 1e-5, 1e-5)


@pytest.mark.parametrize("route", ["reference", "cuda"])
def test_banded_golden_alignment_losses(route):
    """Reference test_cpu.cpp:405-433/532-545 constants on the packed path."""
    lg, lb, il, sl = convert.loss_inputs_from_numpy(*golden.readme_batch(),
                                                    device="cpu")
    for align, losses in ((golden.ALIGN_A, golden.ALIGN_A_LOSSES),
                          (golden.ALIGN_B, golden.ALIGN_B_LOSSES)):
        for shift, expected in losses.items():
            bands = mt.bands_from_alignment(torch.from_numpy(align[None]), il,
                                            sl, shift, 0)
            w = mt.suggested_band_width(il, sl, bands, 4, 3)
            layout = mt.compute_band_layout(il, sl, bands, 4, 3, w)
            x = mt.pack_band(lg, layout).requires_grad_(True)
            costs = tbanded._BandedCore.apply(x, lb, il, sl, bands.min_s,
                                              bands.max_s, 0, route)
            costs.sum().backward()
            np.testing.assert_allclose(costs.detach().numpy(), [expected],
                                       rtol=1e-4, atol=1e-4)
            assert bool(torch.isfinite(x.grad).all())


def test_banded_loss_validation():
    c = Both(CASES[0])
    with pytest.raises(RnntError, match="exceeds S_max"):
        mt.monotonic_rnnt_loss_banded(torch.zeros(3, 24, c.s1 + 1, 21),
                                      *c.t[1:], bands=c.tb)
    with pytest.raises(RnntError, match=r"\[B, T, W, V\]"):
        mt.monotonic_rnnt_loss_banded(c.t_band[0], *c.t[1:], bands=c.tb)
    with pytest.raises(RnntError, match="input_lengths must be >= 1"):
        mt.monotonic_rnnt_loss_banded(c.t_band, c.t[1],
                                      torch.zeros_like(c.t[2]), c.t[3],
                                      bands=c.tb)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mt.monotonic_rnnt_loss_banded(c.t_band, *c.t[1:], bands=c.tb,
                                      backend="cuda")


@pytest.mark.parametrize("api", ["padded", "banded"])
def test_no_grad_call_takes_the_cost_only_route(api, monkeypatch):
    """Under torch.no_grad(), a logits tensor that requires grad must not
    send the call down the training forward: ctx.needs_input_grad ignores
    the grad mode, so the public API detaches its input there."""
    from monotonic_rnnt_tpu_torch.ops import loss as tloss
    c = Both(CASES[0])
    core = tloss._LossCore if api == "padded" else tbanded._BandedCore
    seen = []
    real_apply = core.apply

    def spy(x, *rest):
        seen.append(x.requires_grad)
        return real_apply(x, *rest)

    monkeypatch.setattr(core, "apply", spy)
    x = (c.t[0] if api == "padded" else c.t_band).clone().requires_grad_(True)
    fn = (mt.monotonic_rnnt_loss if api == "padded"
          else mt.monotonic_rnnt_loss_banded)
    with torch.no_grad():
        costs = fn(x, *c.t[1:], bands=c.tb, blank_id=c.blank)
    assert seen == [False] and not costs.requires_grad
    fn(x, *c.t[1:], bands=c.tb, blank_id=c.blank).sum().backward()
    assert seen == [False, True] and x.grad is not None


@pytest.mark.parametrize("route", ["oracle", "reference"])
def test_banded_nan_cost_gets_the_jax_oracles_nan_gradient(route):
    """The NaN-cost case of tests/test_torch_reference.py on the default
    band at W = S1: the banded oracle, and the public banded loss on the
    reference backend, against the JAX banded oracle."""
    case, finite = nan_cost_case()
    t_max, s1 = case[0].shape[1], case[0].shape[2]
    j_il, j_sl = jnp.asarray(case[2]), jnp.asarray(case[3])
    jb = jbands.default_bands(j_il, j_sl, t_max)
    jl = jbands.compute_band_layout(j_il, j_sl, jb, t_max, s1, s1)
    want_c, want_g = _jref(jbands.pack_band(jnp.asarray(case[0]), jl),
                           jnp.asarray(case[1]), j_il, j_sl, jb)
    assert int(np.isnan(np.asarray(want_g)).sum()) == 5
    lg, lb, il, sl = convert.loss_inputs_from_numpy(*case, device="cpu")
    tb = tbands.default_bands(il, sl, t_max)
    layout = tbands.compute_band_layout(il, sl, tb, t_max, s1, s1)
    _, finite_g = tbanded.rnnt_loss_banded_reference(
        tbands.pack_band(torch.from_numpy(finite), layout), lb, il, sl, tb)
    x = tbands.pack_band(lg, layout)
    if route == "oracle":
        got_c, got_g = tbanded.rnnt_loss_banded_reference(x, lb, il, sl, tb)
    else:
        x.requires_grad_(True)
        got_c = mt.monotonic_rnnt_loss_banded(x, lb, il, sl, bands=tb,
                                              backend="reference")
        got_c.sum().backward()
        got_g = x.grad
    assert_nan_cost_contract(got_c, got_g, want_c, want_g, finite_g.numpy())


def test_banded_kernel_route_nan_cost_gradient_matches_jax_pallas():
    """The NaN-cost case on the banded loss's kernel route: like the JAX
    package's Pallas route (interpret mode), costs [8.5436, NaN] and an
    all-zero gradient for sample 1. Both form the coefficients with the
    occupancy rule that zeroes a sample whose ll is not finite, and the
    gradient pass writes 0 where the coefficient is 0 (ROADMAP §3's
    recorded difference from the oracles' NaN cells)."""
    case, _ = nan_cost_case()
    t_max, s1 = case[0].shape[1], case[0].shape[2]
    j_lb, j_il, j_sl = (jnp.asarray(a) for a in case[1:])
    jb = jbands.default_bands(j_il, j_sl, t_max)
    jl = jbands.compute_band_layout(j_il, j_sl, jb, t_max, s1, s1)

    def total(x):
        return jnp.sum(jbanded.monotonic_rnnt_loss_banded(
            x, j_lb, j_il, j_sl, bands=jb, backend="pallas"))

    with interpret_mode():
        j_band = jbands.pack_band(jnp.asarray(case[0]), jl)
        want_c = jbanded.monotonic_rnnt_loss_banded(
            j_band, j_lb, j_il, j_sl, bands=jb, backend="pallas")
        want_g = np.asarray(jax.grad(total)(j_band))
    lg, lb, il, sl = convert.loss_inputs_from_numpy(*case, device="cpu")
    tb = tbands.default_bands(il, sl, t_max)
    layout = tbands.compute_band_layout(il, sl, tb, t_max, s1, s1)
    x = tbands.pack_band(lg, layout).requires_grad_(True)
    costs = tbanded._BandedCore.apply(x, lb, il, sl, tb.min_s, tb.max_s, 0,
                                      "cuda")
    costs.sum().backward()
    got_g = x.grad.numpy()
    np.testing.assert_allclose(costs.detach().numpy(), np.asarray(want_c),
                               rtol=1e-5)
    assert np.isnan(costs.detach().numpy()[1])
    assert not np.isnan(want_g).any() and (want_g[1] == 0).all()
    assert not np.isnan(got_g).any() and (got_g[1] == 0).all()
    np.testing.assert_allclose(got_g, want_g, rtol=1e-4, atol=1e-6)
