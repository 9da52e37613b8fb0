"""The port's config flags, debug hooks and provenance against the JAX package.

Counterparts of tests/test_utils.py. The debug lines are held against the
JAX package's on the same numpy inputs: ``report_space`` field by field
(less the JAX line's TPU-only ``tiles=`` and ``kernel_vmem=``),
``emit_loss_debug`` word for word where the values are exact in f32 (the
mismatch and gradient lines on small dyadic inputs) and its
log-likelihoods within 1e-5 relative on a loss call (the oracles'
agreement). ``interpret_mode`` has no counterpart (the kernels' plain
versions serve CPU tensors), so scoping is tested on ``debug_time``.
"""

import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
import monotonic_rnnt_tpu as jmr
import monotonic_rnnt_tpu_torch as mt
from monotonic_rnnt_tpu.ops.pallas import banded as jpbanded
from monotonic_rnnt_tpu.ops.pallas import fused as jfused
from monotonic_rnnt_tpu.utils import config as jconfig
from monotonic_rnnt_tpu.utils import debug as jdebug
from monotonic_rnnt_tpu_torch.ops import bands as tbands
from monotonic_rnnt_tpu_torch.ops import helpers as thelpers
from monotonic_rnnt_tpu_torch.ops import loss as tloss
from monotonic_rnnt_tpu_torch.ops.cuda import banded as tcbanded
from monotonic_rnnt_tpu_torch.ops.cuda import fused
from monotonic_rnnt_tpu_torch.utils import config as tconfig
from monotonic_rnnt_tpu_torch.utils import debug as tdebug
from monotonic_rnnt_tpu_torch.utils import provenance

from torch_decode_pair import t

FLAGS = ("debug_time", "debug_space", "debug_fwdbwd", "debug_grads",
         "check_fwd_bwd", "fwd_bwd_tol")


def test_config_override_scoping():
    cfg = tconfig.get_config()
    base = cfg.debug_time
    with tconfig.config_override(debug_time=not base):
        assert tconfig.get_config().debug_time == (not base)
        with tconfig.config_override(debug_time=True, debug_space=True):
            assert tconfig.get_config().debug_time is True
        assert tconfig.get_config().debug_time == (not base)
    assert tconfig.get_config().debug_time == base
    assert cfg.debug_space is False


def test_config_rejects_unknown():
    with pytest.raises(AttributeError, match="unknown config field"):
        tconfig.update_config(nonexistent_flag=1)
    with pytest.raises(AttributeError, match="unknown config field"):
        tconfig.update_config(interpret=True)       # JAX-only, TPU-specific
    with pytest.raises(ValueError, match="pipeline must be"):
        tconfig.update_config(pipeline="pallas")


def test_config_flags_match_jax():
    """The six debug flags: the JAX package's names, defaults and types,
    and its environment parsing."""
    j, p = jconfig.Config(), tconfig.Config()
    for name in FLAGS:
        assert getattr(p, name) == getattr(j, name), name
        assert type(getattr(p, name)) is type(getattr(j, name)), name
    for raw in (None, "", "0", "false", "OFF", "1", "true", "yes", "On"):
        for default in (False, True):
            env = {} if raw is None else {"MRNNT_X": raw}
            with pytest.MonkeyPatch.context() as mp:
                mp.delenv("MRNNT_X", raising=False)
                for k, v in env.items():
                    mp.setenv(k, v)
                assert (tconfig._env_bool("MRNNT_X", default)
                        == jconfig._env_bool("MRNNT_X", default)), raw


def test_config_reads_the_environment():
    """The flags' environment variables, read when the module is imported,
    as in the JAX package."""
    env = {"MRNNT_DEBUG_TIME": "1", "MRNNT_DEBUG_SPACE": "true",
           "MRNNT_DEBUG_FWDBWD": "on", "MRNNT_DEBUG_GRADS": "yes",
           "MRNNT_CHECK_FWD_BWD": "1", "MRNNT_FWD_BWD_TOL": "0.25",
           "JAX_PLATFORMS": "cpu"}
    code = ("from monotonic_rnnt_tpu_torch.utils.config import get_config;"
            "c = get_config(); print(c.debug_time, c.debug_space, "
            "c.debug_fwdbwd, c.debug_grads, c.check_fwd_bwd, c.fwd_bwd_tol)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         env={**_base_env(), **env}).stdout.split()
    assert out == ["True"] * 5 + ["0.25"]


def _base_env():
    import os
    return {k: v for k, v in os.environ.items() if not k.startswith("MRNNT_")}


def test_dump_lattice_readme():
    logits, labels, ilen, slen = golden.readme_batch()
    text = tdebug.dump_lattice(logits, labels, ilen, slen, sample=0,
                               file=False, device="cpu")
    # ll values from the README worked example (README.md:138,150)
    assert "ll_fwd=-1.0134" in text
    assert "ll_bwd=-1.0134" in text
    assert "alphas" in text and "betas" in text
    assert text == jdebug.dump_lattice(logits, labels, ilen, slen, sample=0,
                                       file=False)


def test_check_lattice():
    assert not tdebug.check_lattice(np.array([1.0]), np.array([1.05])).any()
    assert tdebug.check_lattice(np.array([1.0]), np.array([2.0])).all()
    got = tdebug.check_lattice(torch.tensor([1.0, 3.0]),
                               torch.tensor([1.2, 3.05]), tol=0.1)
    np.testing.assert_array_equal(got, jdebug.check_lattice(
        np.array([1.0, 3.0]), np.array([1.2, 3.05]), tol=0.1))


def _jax_loss_and_grad(logits, labels, ilen, slen):
    val = jax.jit(jax.value_and_grad(lambda lg: jnp.sum(
        jmr.monotonic_rnnt_loss(lg, jnp.asarray(labels), jnp.asarray(ilen),
                                jnp.asarray(slen), backend="reference"))))(
        jnp.asarray(logits))
    jax.block_until_ready(val)


def _port_loss_and_grad(logits, labels, ilen, slen, backend="reference"):
    x = torch.from_numpy(np.asarray(logits, np.float32)).requires_grad_(True)
    mt.monotonic_rnnt_loss(x, *t(labels, ilen, slen),
                           backend=backend).sum().backward()


def _numbers(line, key):
    m = re.search(key + r"=\[?([^\]=]*?)\]?(?: \w+=|$)", line)
    return np.array([float(v) for v in m.group(1).split()])


def _lines(out, prefix):
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def test_debug_flags_emit_output(capfd):
    logits, labels, ilen, slen = golden.readme_batch()
    flags = dict(debug_fwdbwd=True, debug_grads=True, check_fwd_bwd=True)
    with tconfig.config_override(**flags):
        _port_loss_and_grad(logits, labels, ilen, slen)
    out = capfd.readouterr().out
    assert "mrnnt fwdbwd" in out
    assert "mrnnt grads" in out
    # fwd/bwd agree on a healthy lattice: the mismatch warning must NOT fire.
    assert "mismatch" not in out
    with jconfig.config_override(**flags):
        _jax_loss_and_grad(logits, labels, ilen, slen)
    jout = capfd.readouterr().out
    for prefix, keys in (("mrnnt fwdbwd", ("ll_fwd", "ll_bwd")),
                         ("mrnnt grads", ("min", "max", "l2"))):
        (got,), (want,) = _lines(out, prefix), _lines(jout, prefix)
        for key in keys:
            np.testing.assert_allclose(_numbers(got, key),
                                       _numbers(want, key), rtol=1e-5,
                                       err_msg=f"{prefix} {key}")

    _port_loss_and_grad(logits, labels, ilen, slen)
    out = capfd.readouterr().out
    assert "mrnnt" not in out  # flags off -> silent


def test_emit_loss_debug_lines_word_for_word(capfd):
    """The same f32 values print the JAX package's lines: exact sums of
    dyadic values, so both sides hold the same numbers."""
    ll_f = np.array([-1.5, -2.25, -3.0], np.float32)
    ll_b = np.array([-1.5, -2.0, -3.5], np.float32)
    grads = np.array([[0.5, -0.25], [1.0, 2.0]], np.float32)
    flags = dict(debug_fwdbwd=True, debug_grads=True, check_fwd_bwd=True,
                 fwd_bwd_tol=0.3)
    with tconfig.config_override(**flags):
        tdebug.emit_loss_debug(*t(ll_f, ll_b, grads))
    got = sorted(capfd.readouterr().out.splitlines())
    with jconfig.config_override(**flags):
        jax.block_until_ready(jax.jit(
            lambda a, b, g: jdebug.emit_loss_debug(a, b, g) or a)(
                ll_f, ll_b, grads))
    want = sorted(capfd.readouterr().out.splitlines())
    assert got == want
    assert "monotonic_rnnt: fwd/bwd mismatch on 1 samples (max |diff| = 0.5)" \
        in got


class _Untouchable:
    """A stand-in tensor that fails on any use."""

    def __getattr__(self, name):
        raise AssertionError(f"emit_loss_debug read .{name}")


def test_emit_loss_debug_reads_nothing_when_off():
    x = _Untouchable()
    with tconfig.config_override(debug_fwdbwd=False, debug_grads=False,
                                 check_fwd_bwd=False):
        tdebug.emit_loss_debug(x, x, x)
    with tconfig.config_override(debug_grads=True):
        tdebug.emit_loss_debug(x, x, None)     # no grads: nothing to read
    with tconfig.config_override(debug_fwdbwd=True, check_fwd_bwd=True):
        tdebug.emit_loss_debug(x, None, x)     # no ll_bwd: nothing to read


def test_row2_betas_reach_emit_loss_debug(monkeypatch):
    """On the DP-fused route (rows 1-2's plain versions on the CPU) the
    backward hands emit_loss_debug row 2's betas[:, 0, 0] as ll_bwd; they
    equal ll_fwd within f32 rounding, and the check prints on every sample
    when the tolerance is below their gap."""
    logits, labels, ilen, slen = golden.repeat_label_case(5, 3, 9, 4, 13)
    seen, betas = [], []
    real = fused.beta_grad_fused

    def keep_betas(*a, **k):
        out = real(*a, **k)
        betas.append(out[1])
        return out

    monkeypatch.setattr(fused, "beta_grad_fused", keep_betas)
    monkeypatch.setattr(fused, "emit_loss_debug",
                        lambda *a: seen.append(a))
    monkeypatch.setattr(tloss, "_resolve_backend", lambda *a: "cuda")
    _port_loss_and_grad(logits, labels, ilen, slen)
    (ll_fwd, ll_bwd, grads), = seen
    assert torch.equal(ll_bwd, betas[0][:, 0, 0])
    np.testing.assert_allclose(ll_bwd.numpy(), ll_fwd.numpy(), rtol=1e-5)
    assert grads.shape == logits.shape


def test_debug_space_reports_pipeline(capsys):
    """DEBUG_SPACE (reference cpu_workspace_manager.h:110-112): the port's
    line on each route equals the JAX package's (Pallas in interpret mode)
    less tiles= and kernel_vmem=."""
    rng = np.random.RandomState(0)
    B, T, S, V = 2, 6, 3, 20
    logits = rng.randn(B, T, S + 1, V).astype(np.float32)
    labels = rng.randint(1, V, size=(B, S)).astype(np.int32)
    ilen = np.full((B,), T, np.int32)
    slen = np.full((B,), S, np.int32)
    j_args = [jnp.asarray(a) for a in (logits, labels, ilen, slen)]
    p_args = t(logits, labels, ilen, slen)

    def jax_line(fn):
        fn()
        line, = capsys.readouterr().out.splitlines()
        return re.sub(r" (tiles=\([^)]*\)|kernel_vmem=\S+)", "", line)

    def port_line(fn):
        fn()
        line, = capsys.readouterr().out.splitlines()
        return line

    bf16 = lambda a: [a[0].astype(jnp.bfloat16)] + a[1:]
    pbf16 = lambda a: [a[0].to(torch.bfloat16)] + a[1:]
    cases = [
        (lambda: jfused.rnnt_loss_pallas(*j_args, interpret=True),
         lambda: fused.rnnt_loss_cuda(*p_args), "2r+1w"),
        (lambda: jfused.rnnt_loss_pallas(*j_args, with_grads=False,
                                         interpret=True),
         lambda: fused.rnnt_loss_cuda(*p_args, with_grads=False), "1r+0w"),
        (lambda: jfused.rnnt_loss_pallas(*bf16(j_args), interpret=True),
         lambda: fused.rnnt_loss_cuda(*pbf16(p_args)), "dtype=bfloat16"),
        (lambda: jfused.rnnt_loss_pallas_deferred_fwd(*j_args,
                                                      interpret=True),
         lambda: fused.rnnt_loss_cuda_deferred_fwd(*p_args),
         "dp-fused-deferred-fwd"),
    ]
    with jconfig.config_override(debug_space=True), \
            tconfig.config_override(debug_space=True):
        for jfn, pfn, must in cases:
            want, got = jax_line(jfn), port_line(pfn)
            assert got == want and must in got
            assert f"shape=({B}, {T}, {S + 1}, {V})" in got
        _, j_res = jfused.rnnt_loss_pallas_deferred_fwd(*j_args,
                                                        interpret=True)
        _, p_res = fused.rnnt_loss_cuda_deferred_fwd(*p_args)
        capsys.readouterr()
        cot = np.array([1.0, -0.5], np.float32)
        want = jax_line(lambda: jfused.rnnt_loss_pallas_deferred_bwd(
            *j_args, j_res, jnp.asarray(cot), interpret=True))
        got = port_line(lambda: fused.rnnt_loss_cuda_deferred_bwd(
            *p_args, p_res, torch.from_numpy(cot)))
        assert got == want and "(1r+1w)" in got
        with jconfig.config_override(pipeline="split"), \
                tconfig.config_override(pipeline="split"):
            want = jax_line(lambda: jfused.rnnt_loss_pallas(*j_args,
                                                            interpret=True))
            got = port_line(lambda: fused.rnnt_loss_cuda(*p_args))
        assert got == want and "pipeline=split" in got

    fused.rnnt_loss_cuda(*p_args)
    assert "pipeline=" not in capsys.readouterr().out  # flag off -> silent


def test_debug_space_reports_the_banded_route(capsys):
    logits, labels, ilen, slen = golden.readme_batch()
    jb = jmr.default_bands(jnp.asarray(ilen), jnp.asarray(slen),
                           logits.shape[1])
    w = logits.shape[2]
    layout = jmr.compute_band_layout(jnp.asarray(ilen), jnp.asarray(slen),
                                     jb, logits.shape[1], w, w)
    lb = np.asarray(jmr.pack_band(jnp.asarray(logits), layout), np.float32)
    p_args = t(lb, labels, ilen, slen)
    p_bands = tbands.Bands(*t(np.asarray(jb.min_s), np.asarray(jb.max_s)))
    with jconfig.config_override(debug_space=True), \
            tconfig.config_override(debug_space=True):
        for grads in (True, False):
            jpbanded.rnnt_loss_banded_pallas(
                jnp.asarray(lb), jnp.asarray(labels), jnp.asarray(ilen),
                jnp.asarray(slen), jb, with_grads=grads, interpret=True)
            want = capsys.readouterr().out
            tcbanded.rnnt_loss_banded_cuda(*p_args, p_bands,
                                           with_grads=grads)
            got = capsys.readouterr().out
            assert got == want and "pipeline=banded" in got


def test_debug_time_times_the_public_losses(capsys):
    logits, labels, ilen, slen = golden.readme_batch()
    args = t(np.asarray(logits, np.float32), labels, ilen, slen)
    jb = tbands.default_bands(args[2], args[3], logits.shape[1])
    with tconfig.config_override(debug_time=True):
        mt.monotonic_rnnt_loss(*args, backend="reference")
        mt.monotonic_rnnt_loss_banded(*args, bands=jb, backend="reference")
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"\[mrnnt\] monotonic_rnnt_loss\[reference\]: "
                        r"\d+\.\d\d ms", out[0])
    assert out[1].startswith("[mrnnt] monotonic_rnnt_loss_banded[reference]")
    mt.monotonic_rnnt_loss(*args, backend="reference")
    assert capsys.readouterr().out == ""


def test_provenance_stamp(monkeypatch):
    stamp = provenance.provenance_stamp(seed=7, device="cpu", run="unit")
    for key in ("timestamp", "git_sha", "git_dirty", "device", "device_kind",
                "torch_version", "cuda_version", "power_limit"):
        assert key in stamp, key
    assert stamp["seed"] == 7 and stamp["run"] == "unit"
    assert stamp["device"] == "cpu" and stamp["power_limit"] is None
    assert stamp["torch_version"] == torch.__version__
    assert "seed" not in provenance.provenance_stamp(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        provenance.provenance_stamp(seed=7)


def test_version_matches_jax():
    assert mt.__version__ == jmr.__version__ == "0.3.0"


def test_log_diff_exp():
    a, b = torch.log(torch.tensor(5.0)), torch.log(torch.tensor(3.0))
    np.testing.assert_allclose(float(thelpers.log_diff_exp(a, b)),
                               np.log(2.0), rtol=1e-6)
    # exp(a) - exp(a) = 0
    assert float(thelpers.log_diff_exp(a, a)) == thelpers.NEG_INF
    assert float(thelpers.log_diff_exp(
        a, torch.tensor(thelpers.NEG_INF))) == float(a)
