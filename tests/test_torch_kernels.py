"""The CUDA kernels' plain versions against the JAX Pallas kernels (interpret).

On the CPU the kernel wrappers take their plain versions, so these tests
hold the arithmetic the CUDA kernels must reproduce against the Pallas
kernels they replace; tests/test_torch_cuda.py holds the CUDA kernels
against the plain versions on a GPU.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
from monotonic_rnnt_tpu.ops import bands as jbands
from monotonic_rnnt_tpu.ops import helpers as jhelpers
from monotonic_rnnt_tpu.ops.pallas import kernels as jk
from monotonic_rnnt_tpu_torch import config_override, convert
from monotonic_rnnt_tpu_torch.ops import bands as tbands
from monotonic_rnnt_tpu_torch.ops import helpers as thelpers
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
    t_lo, t_hi, _ = fused._windows(ti, ts, tbands.default_bands(ti, ts, t_max),
                                   t_max, s1)
    t_args = (tl, thelpers.extend_labels(tlab, ts, s1), t_lo, t_hi)
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(a_lo))
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(a_hi))
    return j_args, t_args


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_stats_alpha_plain_matches_pallas(shape, dtype):
    blank = shape[5]
    t_in, j_in = _inputs(*shape, dtype=dtype)
    j_args, t_args = _windows(j_in, t_in)
    want = jk.stats_alpha_fused(*j_args, blank, interpret=True)
    got = tk.stats_alpha_fused_plain(*t_args, blank)
    for name, g, w in zip(("denom", "lp_blank", "lp_label", "alphas"), got,
                          want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _beta_operands(t_in, blank):
    """The beta_grad operands, made once and handed to both packages."""
    tl, tlab, ti, ts = t_in
    t_max, s1 = tl.shape[1], tl.shape[2]
    ilen, slen, bands, lab = fused._prepare(tl, tlab, ti, ts, None)
    denom, lpb, lpl, alphas, ll, bwin = fused._dp_fused_alpha_half(
        tl, lab, ilen, slen, bands, blank)
    lpbb, lplb, aprev, llb, bvirt = fused.beta_grad_operands(
        lpb, lpl, alphas, ll, slen, bwin)
    return (tl, denom, lpbb, lplb, aprev, ilen, llb, bvirt, lab)


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
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.stats_alpha_fused(logits, lab, bound, bound, 0)
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
    tl, tlab, ti, ts = t_in
    ilen, slen, bands, lab = fused._prepare(tl, tlab, ti, ts, None)
    a_lo, a_hi, _ = fused._windows(ilen, slen, bands, tl.shape[1],
                                   tl.shape[2])
    ops = _beta_operands(t_in, shape[5])
    scale = torch.linspace(-0.5, 2.0, shape[1]) if scaled else None
    return ((tl, lab, a_lo, a_hi, shape[5]),
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
    operator per training step of the padded loss's deferred route."""
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
    from monotonic_rnnt_tpu_torch.ops import loss as tloss
    costs = tloss._LossCore.apply(x, t_in[1], t_in[2], t_in[3], bands.min_s,
                                  bands.max_s, SHAPES[0][5], "cuda")
    costs.sum().backward()
    assert calls == ["stats_alpha_fused", "beta_grad_fused"]
