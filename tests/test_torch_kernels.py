"""The CUDA kernels' plain versions against the JAX Pallas kernels (interpret).

On the CPU the kernel wrappers take their plain versions, so these tests
hold the arithmetic the CUDA kernels must reproduce against the Pallas
kernels they replace; tests/test_torch_cuda.py holds the CUDA kernels
against the plain versions on a GPU.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
import monotonic_rnnt_tpu as jmr
from glue_lattices import GLUE_LATTICES, glue_case
from monotonic_rnnt_tpu.ops import bands as jbands
from monotonic_rnnt_tpu.ops import helpers as jhelpers
from monotonic_rnnt_tpu.ops.pallas import kernels as jk
from monotonic_rnnt_tpu_torch import config_override, convert
from monotonic_rnnt_tpu_torch import monotonic_rnnt_loss as mt_loss
from monotonic_rnnt_tpu_torch.ops import bands as tbands
from monotonic_rnnt_tpu_torch.ops import loss as tloss
from monotonic_rnnt_tpu_torch.ops.cuda import _build, fused
from monotonic_rnnt_tpu_torch.ops.cuda import kernels as tk

# (seed, B, T, S, V, blank[, (T_b...), (S_b...)]): V not a multiple of 128,
# blank != 0, repeats; V = 79 and 1030 (the CUDA kernels' scalar path), with
# T_b = 1 and S_b = 0 samples. Every S1 here is <= 32 (a one-warp beta
# chain on the card).
SHAPES = [(21, 3, 9, 4, 37, 2), (22, 2, 12, 5, 130, 0),
          (23, 3, 7, 3, 79, 5, (7, 1, 5), (3, 0, 2)),
          (24, 2, 5, 4, 1030, 1, (5, 1), (4, 1))]


def _shape_id(shape):
    return "x".join(map(str, shape[:6])) + "".join(
        "-" + "_".join(map(str, lens)) for lens in shape[6:])
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                        jnp.bfloat16)}


def _inputs(seed, batch, t, s, v, blank, *lengths, dtype):
    logits, labels, ilen, slen = golden.repeat_label_case(seed, batch, t, s,
                                                          v, blank_id=blank)
    if lengths:
        ilen, slen = (np.asarray(x, np.int32) for x in lengths)
    tdt, jdt = DTYPES[dtype]
    t_in = convert.loss_inputs_from_numpy(logits, labels, ilen, slen,
                                          device="cpu", dtype=tdt)
    j_in = (jnp.asarray(logits).astype(jdt), jnp.asarray(labels),
            jnp.asarray(ilen), jnp.asarray(slen))
    return t_in, j_in


def _windows(j_in, t_in):
    """Each package's alpha windows from its own _window_bounds."""
    jl, jlab, ji, js = j_in
    tl, tlab, ti, ts = t_in
    t_max, s1 = tl.shape[1], tl.shape[2]
    a_lo, a_hi, _, _ = jbands._window_bounds(
        ji, js, jbands.default_bands(ji, js, t_max), t_max, s1)
    a_hi = jnp.where(jnp.arange(t_max)[None, :] < ji[:, None], a_hi, -1)
    j_args = (jl, jhelpers.extend_labels(jlab, js, s1), a_lo, a_hi)
    t_lab, t_lo, t_hi, _, _ = tk.loss_prologue_plain(
        tlab, ti, ts, *tbands.default_bands(ti, ts, t_max), t_max, s1)
    t_args = (tl, t_lab, t_lo, t_hi)
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(a_lo))
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(a_hi))
    return j_args, t_args


ROW1_OUTPUTS = ("denom", "lp_blank", "lp_label", "alphas")
# Row 1's fill on the cells past the live lattice: a row of probability 0.
ROW1_FILL = (0.0, float("-inf"), float("-inf"), float("-inf"))


def _hold_row1_contract(got, want, live):
    """Row 1's outputs `got` against the Pallas kernel's `want` on the live
    cells (t < T'_b, s <= S_b; torch.logsumexp sums in another order than
    JAX, an ulp apart), and exactly the fill on every other cell."""
    for name, g, w, fill in zip(ROW1_OUTPUTS, got, want, ROW1_FILL):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g[live].numpy(), np.asarray(w)[live.numpy()],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        dead = g[~live]          # the fill's bits: +0.0, never -0.0
        assert torch.equal(dead.view(torch.int32),
                           torch.full_like(dead, fill).view(torch.int32)), name


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_stats_alpha_plain_matches_pallas(shape, dtype):
    blank = shape[5]
    t_in, j_in = _inputs(*shape, dtype=dtype)
    j_args, t_args = _windows(j_in, t_in)
    ilen, slen = (x.to(torch.int32) for x in t_in[2:])
    want = jk.stats_alpha_fused(*j_args, blank, interpret=True)
    got = tk.stats_alpha_fused_plain(*t_args, ilen, slen, blank)
    _hold_row1_contract(got, want, tk.live_cells(ilen, slen,
                                                 *t_in[0].shape[1:3]))


# Row 1's live-lattice contract is held on GLUE_LATTICES' first eight (S_b
# = 0, T_b = 1, T_b = T_max, alignment bands narrower than the default,
# +-inf padding, lengths past the shape) and on "infeasible": the default
# lattice with sample 2's band cut below S_b, so its cost is +inf.
ROW1_LATTICES = [*GLUE_LATTICES[:8], ("infeasible", *GLUE_LATTICES[0][1:])]


def _row1_case(case, dtype):
    """_glue_case's arrays as torch tensors in `dtype` (logits with the
    case's padding, the JAX side's finite-padding logits) and each
    package's bands, sample 2's cut below S_b where the case is
    "infeasible"."""
    logits, clean, labels, ilen, slen, tb, jb = _glue_case(case)
    if case[0] == "infeasible":
        tb = tbands.Bands(tb.min_s, tb.max_s.clone())
        tb.max_s[2] = int(slen[2]) - 1
        jb = jbands.Bands(jb.min_s, jb.max_s.at[2].set(int(slen[2]) - 1))
    tdt, jdt = DTYPES[dtype]
    x, lab, il, sl = (torch.from_numpy(a) for a in (logits, labels, ilen,
                                                     slen))
    return (x.to(tdt), lab, il, sl, tb, jnp.asarray(clean).astype(jdt),
            labels, ilen, slen, jb)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ROW1_LATTICES, ids=lambda c: c[0])
def test_stats_alpha_plain_reads_only_the_live_lattice(case, dtype):
    """The plain twin (the operator's CPU implementation) against the
    Pallas kernel on ragged lattices: the live cells at the tolerance of
    the shapes above, the fill elsewhere. The live cells equal bit for bit
    what the twin gives with every cell live: the fill moves no value that
    a caller reads."""
    x, lab, il, sl, tb, jx, *_ = _row1_case(case, dtype)
    blank, (_, t_max, s1, _) = case[6], x.shape
    lab_ext, a_lo, a_hi, _, _ = tk.loss_prologue(lab, il, sl, tb.min_s,
                                                 tb.max_s, t_max, s1)
    got = tk.stats_alpha_fused(x, lab_ext, a_lo, a_hi, il, sl, blank)
    want = jk.stats_alpha_fused(
        jx, *(jnp.asarray(a.numpy()) for a in (lab_ext, a_lo, a_hi)), blank,
        interpret=True)
    live = tk.live_cells(il, sl, t_max, s1)
    _hold_row1_contract(got, want, live)
    every = tk.stats_alpha_fused_plain(
        x, lab_ext, a_lo, a_hi, torch.full_like(il, t_max),
        torch.full_like(sl, s1 - 1), blank)
    for name, g, w in zip(ROW1_OUTPUTS, got, every):
        assert torch.equal(g[live], w[live]), name


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", [c for c in ROW1_LATTICES
                                  if c[0] != "past-shape"],
                         ids=lambda c: c[0])
def test_padded_loss_on_the_live_lattice_matches_the_oracle(monkeypatch, case,
                                                            dtype):
    """monotonic_rnnt_loss through the operators' CPU implementations (the
    deferred route of rows 1-2) on ragged lattices: costs and gradients
    equal the JAX oracle's at the loss tests' tolerances, and equal bit for
    bit those of the same route with row 1 reading every cell."""
    x, lab, il, sl, tb, jx, labels, ilen, slen, jb = _row1_case(case, dtype)
    blank = case[6]
    w = torch.linspace(-0.5, 2.0, x.shape[0])

    def port():
        xg = x.clone().requires_grad_(True)
        costs = tloss.loss_on_route(xg, lab, il, sl, tb, blank, "cuda")
        grads, = torch.autograd.grad((costs * w).sum(), xg)
        return costs.detach(), grads

    def oracle(lg):
        return jnp.sum(jnp.asarray(w.numpy()) * jmr.monotonic_rnnt_loss(
            lg, jnp.asarray(labels), jnp.asarray(ilen), jnp.asarray(slen),
            blank_id=blank, bands=jb, backend="reference"))

    costs, grads = port()
    want_costs = jmr.monotonic_rnnt_loss(
        jx, jnp.asarray(labels), jnp.asarray(ilen), jnp.asarray(slen),
        blank_id=blank, bands=jb, backend="reference")
    want_grads = jax.grad(oracle)(jx)
    np.testing.assert_allclose(costs.numpy(), np.asarray(want_costs),
                               rtol=1e-5)
    rtol = 8e-3 if dtype == "bf16" else 1e-4
    np.testing.assert_allclose(grads.float().numpy(),
                               np.asarray(want_grads.astype(jnp.float32)),
                               rtol=rtol, atol=1e-6)
    assert bool(torch.isinf(costs).any()) == (case[0] == "infeasible")

    t_max, s1 = x.shape[1], x.shape[2]
    monkeypatch.setattr(
        fused, "stats_alpha_fused",
        lambda lg, lab_ext, a_lo, a_hi, i, s, b: tk.stats_alpha_fused(
            lg, lab_ext, a_lo, a_hi, torch.full_like(i, t_max),
            torch.full_like(s, s1 - 1), b))
    for got, want in zip((costs, grads), port()):
        assert torch.equal(got, want)


def _plain_glue(t_in, blank):
    """The deferred route's operands on the default bands through the
    plain versions: (labels_ext, a_lo, a_hi, row 1's outputs, row 2's
    operands but the logits, the stats and labels_ext)."""
    tl, tlab, ti, ts = t_in
    t_max, s1 = tl.shape[1], tl.shape[2]
    ilen, slen = ti.to(torch.int32), ts.to(torch.int32)
    lab, a_lo, a_hi, b_lo, b_hi = tk.loss_prologue_plain(
        tlab, ilen, slen, *tbands.default_bands(ilen, slen, t_max), t_max, s1)
    row1 = tk.stats_alpha_fused_plain(tl, lab, a_lo, a_hi, ilen, slen, blank)
    ll, _ = tk.loss_costs_plain(row1[3], ilen, slen)
    ops = tk.beta_operands_plain(row1[1], row1[2], row1[3], ll, ilen, slen,
                                 b_lo, b_hi)
    return lab, a_lo, a_hi, row1, (ops[:3], ilen, *ops[3:])


def _beta_operands(t_in, blank):
    """The beta_grad operands, made once and handed to both packages."""
    lab, _, _, row1, ((lpbb, lplb, aprev), ilen, llb, bvirt) = _plain_glue(
        t_in, blank)
    return (t_in[0], row1[0], lpbb, lplb, aprev, ilen, llb, bvirt, lab)


@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_beta_grad_plain_matches_pallas(shape, dtype, scaled):
    batch, blank = shape[1], shape[5]
    t_in, j_in = _inputs(*shape, dtype=dtype)
    ops = _beta_operands(t_in, blank)
    scale = torch.linspace(-0.5, 2.0, batch) if scaled else None
    j_ops = [j_in[0]] + [jnp.asarray(o.numpy()) for o in ops[1:]]
    j_ops[5] = j_ops[5][:, None, None]          # input_lengths [B, 1, 1]
    j_ops[6] = j_ops[6][:, None, None]          # ll_bounded [B, 1, 1]
    j_scale = None if scale is None else jnp.asarray(scale.numpy())[:, None,
                                                                    None]
    want_g, want_b = jk.beta_grad_fused(*j_ops, blank,
                                        out_dtype=j_in[0].dtype,
                                        interpret=True, grad_scale=j_scale)
    got_g, got_b = tk.beta_grad_fused_plain(*ops, blank, grad_scale=scale)
    assert got_g.dtype == t_in[0].dtype
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-5,
                               atol=1e-6)
    # bf16: both sides round the same f32 value, whose last bits may differ
    # (one bf16 ulp).
    rtol = 8e-3 if dtype == "bf16" else 1e-5
    np.testing.assert_allclose(got_g.float().numpy(),
                               np.asarray(want_g.astype(jnp.float32)),
                               rtol=rtol, atol=1e-6)


def test_wrappers_take_plain_version_on_cpu_without_counting():
    t_in, _ = _inputs(*SHAPES[0], dtype="f32")
    ops = _beta_operands(t_in, SHAPES[0][5])
    before = dict(tk.LAUNCHES)
    got = tk.beta_grad_fused(*ops, SHAPES[0][5])
    want = tk.beta_grad_fused_plain(*ops, SHAPES[0][5])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tk.LAUNCHES == before


def test_use_kernels_follows_the_device_and_the_backend():
    """The paths' one switch: a CUDA tensor and a backend other than
    'reference'. A stand-in with is_cuda set plays the CUDA tensor."""
    cpu, card = torch.zeros(2), types.SimpleNamespace(is_cuda=True)
    for backend in ("auto", "cuda", "reference"):
        with config_override(backend=backend):
            assert not tk.use_kernels(cpu)
            assert tk.use_kernels(card) == (backend != "reference")
    assert tk.use_kernels(card)          # the override is undone


def test_wrappers_raise_off_the_cpu_without_cuda():
    # A tensor on neither the CPU nor a GPU reaches the kernel path's
    # checks, which refuse it: nothing falls back to the plain version.
    logits = torch.empty((2, 3, 4, 5), device="meta")
    lab = torch.empty((2, 4), dtype=torch.int32, device="meta")
    bound = torch.empty((2, 3), dtype=torch.int32, device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.stats_alpha_fused(logits, lab, bound, bound, lens, lens, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.beta_grad_fused(logits, *([None] * 8), 0)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("stats_alpha")


def test_library_name_hashes_sources_and_flags(monkeypatch):
    paths = {name: _build.library_path(name) for name in _build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for name, path in paths.items():
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"libmrnnt_{name}-")
        assert _build.library_path(name) == path
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("stats_alpha") != paths["stats_alpha"]


# --- rows 1-2 as torch.library operators ------------------------------------

def _op_args(shape, dtype, scaled):
    """Both operators' arguments at `shape` (the CPU implementations'
    inputs, from the plain stats+alpha)."""
    t_in, _ = _inputs(*shape, dtype=dtype)
    lab, a_lo, a_hi, _, _ = _plain_glue(t_in, shape[5])
    ops = _beta_operands(t_in, shape[5])
    scale = torch.linspace(-0.5, 2.0, shape[1]) if scaled else None
    ilen, slen = (x.to(torch.int32) for x in t_in[2:])
    return ((t_in[0], lab, a_lo, a_hi, ilen, slen, shape[5]),
            (*ops, shape[5], scale))


@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES[:3:2], ids=_shape_id)
def test_rows_1_2_operators_pass_opcheck(shape, dtype, scaled):
    """torch.library.opcheck on each operator's CPU implementation: schema,
    fake (shape-only) implementation against the real one, and the graph
    that AOT dispatch traces."""
    sa_args, bg_args = _op_args(shape, dtype, scaled)
    torch.library.opcheck(torch.ops.mrnnt.stats_alpha_fused.default,
                          sa_args)
    torch.library.opcheck(torch.ops.mrnnt.beta_grad_fused.default, bg_args)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rows_1_2_fake_outputs_match_the_plain_versions(dtype):
    """Under FakeTensorMode (what torch.export traces with) the operators
    give the plain versions' shapes and dtypes, and no values."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    sa_args, bg_args = _op_args(SHAPES[1], dtype, True)
    want_sa = tk.stats_alpha_fused_plain(*sa_args)
    want_bg = tk.beta_grad_fused_plain(*bg_args[:-1], grad_scale=bg_args[-1])
    with FakeTensorMode() as mode:
        fake = lambda args: [mode.from_tensor(a) if torch.is_tensor(a)
                             else a for a in args]
        got_sa = tk.stats_alpha_fused(*fake(sa_args))
        got_bg = tk.beta_grad_fused(*fake(bg_args[:-1]),
                                    grad_scale=fake(bg_args[-1:])[0])
    assert len(got_sa) == 4 and len(got_bg) == 2
    for g, w in zip((*got_sa, *got_bg), (*want_sa, *want_bg)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert type(g).__name__ == "FakeTensor"


def test_rows_1_2_wrappers_call_the_operators(monkeypatch):
    """The live route goes through torch.ops.mrnnt: one call of each
    operator per training step of the padded loss's deferred route, rows
    1-2 and the three glue operators around them."""
    calls = []
    real = torch.ops.mrnnt

    class Ops:
        def __getattr__(self, name):
            op = getattr(real, name)

            def counted(*a, **k):
                calls.append(name)
                return op(*a, **k)
            return counted

    monkeypatch.setattr(torch.ops, "mrnnt", Ops())
    t_in, _ = _inputs(*SHAPES[0], dtype="f32")
    x = t_in[0].clone().requires_grad_(True)
    bands = tbands.default_bands(t_in[2], t_in[3], x.shape[1])
    costs = tloss._LossCore.apply(x, t_in[1], t_in[2], t_in[3], bands.min_s,
                                  bands.max_s, SHAPES[0][5], "cuda")
    costs.sum().backward()
    assert calls == ["loss_prologue", "stats_alpha_fused", "loss_costs",
                     "beta_operands", "beta_grad_fused"]


# --- the glue operators around rows 1-2 against the JAX package's glue -------

def _glue_case(case):
    """glue_case's arrays with each package's bands: (logits, clean
    logits, labels, T_b, S_b, torch bands, JAX bands)."""
    logits, clean, labels, ilen, slen, align = glue_case(case)
    t, band, blank = logits.shape[1], case[-1], case[6]
    t_il, t_sl = torch.from_numpy(ilen), torch.from_numpy(slen)
    j_il, j_sl = jnp.asarray(ilen), jnp.asarray(slen)
    if align is None:
        return (logits, clean, labels, ilen, slen,
                tbands.default_bands(t_il, t_sl, t),
                jbands.default_bands(j_il, j_sl, t))
    return (logits, clean, labels, ilen, slen,
            tbands.bands_from_alignment(torch.from_numpy(align), t_il, t_sl,
                                        band, blank),
            jbands.bands_from_alignment(jnp.asarray(align), j_il, j_sl, band,
                                        blank))


def _jax_glue(monkeypatch, logits, labels, ilen, slen, bands, blank):
    """JAX's DP-fused rnnt_loss_pallas (interpret) with the operands its
    glue gives its two kernels kept: (stats_alpha_fused's, beta_grad_fused's,
    costs, d sum(costs) / d logits)."""
    from monotonic_rnnt_tpu.ops.pallas import fused as jfused
    kept = {}

    def keep(name):
        real = getattr(jfused, name)

        def call(*args, **kwargs):
            kept[name] = [np.asarray(a) if isinstance(a, jnp.ndarray) else a
                          for a in args]
            return real(*args, **kwargs)
        monkeypatch.setattr(jfused, name, call)

    keep("stats_alpha_fused")
    keep("beta_grad_fused")
    costs, grads = jfused.rnnt_loss_pallas(
        *(jnp.asarray(a) for a in (logits, labels, ilen, slen)),
        blank_id=blank, bands=bands, interpret=True)
    return (kept["stats_alpha_fused"], kept["beta_grad_fused"],
            np.asarray(costs), np.asarray(grads))


@pytest.mark.parametrize("case", GLUE_LATTICES[:8], ids=lambda c: c[0])
def test_glue_operators_match_jax_fused_glue(monkeypatch, case):
    """loss_prologue, loss_costs and beta_operands on the CPU route (their
    plain versions, through the operators) give what the JAX package's
    ops/pallas/fused.py glue gives its two kernels, and the padded loss
    through them (the deferred route) its costs and gradients. JAX runs on
    finite padding: its additive window fold lets a NaN statistic of a
    +-inf padding cell into the recurrence, where the port's select keeps
    it out."""
    logits, clean, labels, ilen, slen, tb, jb = _glue_case(case)
    blank, (_, t_max, s1, _) = case[6], logits.shape
    j_sa, j_bg, j_costs, j_grads = _jax_glue(monkeypatch, clean, labels, ilen,
                                             slen, jb, blank)
    x, lab, il, sl = (torch.from_numpy(a) for a in (logits, labels, ilen,
                                                     slen))
    before = dict(tk.LAUNCHES)
    lab_ext, a_lo, a_hi, b_lo, b_hi = tk.loss_prologue(
        lab, il, sl, tb.min_s, tb.max_s, t_max, s1)
    for got, want in zip((lab_ext, a_lo, a_hi), j_sa[1:4]):
        np.testing.assert_array_equal(got.numpy(), want)
    row1 = tk.stats_alpha_fused(x, lab_ext, a_lo, a_hi, il, sl, blank)
    ll, costs = tk.loss_costs(row1[3], il, sl)
    torch.testing.assert_close(costs, -ll, rtol=0, atol=0, equal_nan=True)
    np.testing.assert_allclose(costs.numpy(), j_costs, rtol=1e-5)
    ops = tk.beta_operands(row1[1], row1[2], row1[3], ll, il, sl, b_lo, b_hi)
    for got, want in zip(ops[:3], j_bg[2:5]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ops[3].numpy(), j_bg[6].reshape(-1),
                               rtol=1e-5)
    np.testing.assert_array_equal(ops[4].numpy(), j_bg[7])
    assert tk.LAUNCHES == before

    xg = x.clone().requires_grad_(True)
    if case[0] == "past-shape":
        # A traced graph checks no length values (utils/status.py).
        monkeypatch.setattr(tloss, "_resolve_backend", lambda b, x: "cuda")
        loss = torch.compile(
            lambda x: mt_loss(x, lab, il, sl, bands=tb, blank_id=blank),
            fullgraph=True, backend="aot_eager")
        got_costs = loss(xg)
        torch._dynamo.reset()
    else:
        got_costs = tloss.loss_on_route(xg, lab, il, sl, tb, blank, "cuda")
    grads, = torch.autograd.grad(got_costs.sum(), xg)
    np.testing.assert_allclose(got_costs.detach().numpy(), j_costs,
                               rtol=1e-5)
    np.testing.assert_allclose(grads.numpy(), j_grads, rtol=1e-4, atol=1e-6)
    nan_cost = torch.isnan(got_costs.detach())
    assert bool(nan_cost.any()) == (case[0] == "past-shape")
    assert bool((grads[nan_cost] == 0).all())
