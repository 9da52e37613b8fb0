"""The CUDA kernels' plain versions against the JAX Pallas kernels (interpret).

On the CPU the kernel wrappers take their plain versions, so these tests
hold the arithmetic the CUDA kernels must reproduce against the Pallas
kernels they replace; tests/test_torch_cuda.py holds the CUDA kernels
against the plain versions on a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
from monotonic_rnnt_tpu.ops import bands as jbands
from monotonic_rnnt_tpu.ops import helpers as jhelpers
from monotonic_rnnt_tpu.ops.pallas import kernels as jk
from monotonic_rnnt_tpu_torch import convert
from monotonic_rnnt_tpu_torch.ops import bands as tbands
from monotonic_rnnt_tpu_torch.ops import helpers as thelpers
from monotonic_rnnt_tpu_torch.ops.cuda import _build, fused
from monotonic_rnnt_tpu_torch.ops.cuda import kernels as tk

# (seed, B, T, S, V, blank): V not a multiple of 128, blank != 0, repeats.
SHAPES = [(21, 3, 9, 4, 37, 2), (22, 2, 12, 5, 130, 0)]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                        jnp.bfloat16)}


def _inputs(seed, batch, t, s, v, blank, dtype):
    logits, labels, ilen, slen = golden.repeat_label_case(seed, batch, t, s,
                                                          v, blank_id=blank)
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
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_stats_alpha_plain_matches_pallas(shape, dtype):
    seed, batch, t, s, v, blank = shape
    t_in, j_in = _inputs(seed, batch, t, s, v, blank, dtype)
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
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_beta_grad_plain_matches_pallas(shape, dtype, scaled):
    seed, batch, t, s, v, blank = shape
    t_in, j_in = _inputs(seed, batch, t, s, v, blank, dtype)
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
    t_in, _ = _inputs(*SHAPES[0], "f32")
    ops = _beta_operands(t_in, SHAPES[0][5])
    before = dict(tk.LAUNCHES)
    got = tk.beta_grad_fused(*ops, SHAPES[0][5])
    want = tk.beta_grad_fused_plain(*ops, SHAPES[0][5])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tk.LAUNCHES == before


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
