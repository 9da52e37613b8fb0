"""The port's split pipeline against the JAX package's.

The four kernels' plain versions (softmax_stats, alpha_scan, beta_scan,
fwdbwd_scan) against the Pallas kernels in interpret mode; a torch model of
the CUDA stats reduction's order (tests/torch_stats_model.py's stats_model)
against softmax_stats and softmax_stats_partial in interpret mode and the
plain versions, with its -inf, NaN and +inf rules; and the split
route (``pipeline='split'``) against ``rnnt_loss_pallas`` under the same
pipeline and against the oracle, on CPU tensors, where the port's wrappers
take their plain versions. Tolerances: costs and statistics 1e-5 relative,
gradients 1e-4 relative and 1e-5 absolute (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
import monotonic_rnnt_tpu as mr
import monotonic_rnnt_tpu_torch as mt
from monotonic_rnnt_tpu.ops.bands import default_bands, lattice_masks
from monotonic_rnnt_tpu.ops.helpers import NEG_INF, mask_to_additive
from monotonic_rnnt_tpu.ops.pallas import kernels as PK
from monotonic_rnnt_tpu.ops.pallas.fused import rnnt_loss_pallas
from monotonic_rnnt_tpu.ops.reference import (compute_stats,
                                              rnnt_loss_reference)
from monotonic_rnnt_tpu.utils.config import config_override as jax_config
from monotonic_rnnt_tpu_torch import convert
from monotonic_rnnt_tpu_torch.ops import loss as tloss
from monotonic_rnnt_tpu_torch.ops.cuda import fused
from monotonic_rnnt_tpu_torch.ops.cuda import split_kernels as SK
from monotonic_rnnt_tpu_torch.utils import config
from test_torch_reference import nan_cost_case
from torch_scan_model import alpha_chain_model, beta_chain_model
from torch_stats_model import special_rows, stats_model

WEIGHTS = np.array([1.0, -0.5, 2.0], np.float32)   # one negative cotangent


def _t(a):
    return torch.from_numpy(np.array(a))     # a writable copy


# --- softmax_stats -----------------------------------------------------------------

def _stats_case(labels_3d, seed=0):
    rng = np.random.RandomState(seed)
    b, t, s1, v = 2, 5, 4, 130                 # V not a multiple of 128
    x = (rng.randn(b, t, s1, v) * 2).astype(np.float32)
    shape = (b, t, s1) if labels_3d else (b, s1)
    lab = rng.randint(0, v, size=shape).astype(np.int32)
    # The -1 sentinel, another negative id and an id far past V select
    # nothing in both packages.
    lab[..., 1] = -1
    lab[0, ..., 2] = -7
    lab[1, ..., 3] = 10 * v
    return x, lab


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("labels_3d", [False, True], ids=["BS1", "BTS1"])
def test_softmax_stats_plain_matches_pallas(labels_3d, dtype):
    x, lab = _stats_case(labels_3d)
    want = PK.softmax_stats(jnp.asarray(x).astype(dtype), jnp.asarray(lab), 3,
                            interpret=True)
    x_t = _t(x).to(getattr(torch, dtype))    # rounds as astype does
    got = SK.softmax_stats(x_t, _t(lab), 3)   # a CPU tensor: the plain version
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # An id outside [0, V) selects nothing: the raw label log-prob is denom.
    np.testing.assert_array_equal(got[2][..., 1].numpy(), got[0][..., 1].numpy())


def test_softmax_stats_ids_just_past_v_select_nothing():
    # The Pallas kernel pads V to its lane tile with -inf, so an id in
    # [V, padded V) selects -inf there; the port keeps the documented
    # contract (0 + denom) for every id outside [0, V). Callers mask such
    # slots either way.
    x, lab = _stats_case(False, seed=1)
    lab[:, 2] = x.shape[3]
    lab[:, 3] = x.shape[3] + 5
    denom, _, lpl = SK.softmax_stats_plain(_t(x), _t(lab), 0)
    np.testing.assert_array_equal(lpl[..., 2:].numpy(), denom[..., 2:].numpy())
    _, _, lpl_pallas = PK.softmax_stats(jnp.asarray(x), jnp.asarray(lab), 0,
                                        interpret=True)
    assert np.all(np.asarray(lpl_pallas)[..., 2:] == -np.inf)
    np.testing.assert_allclose(lpl[..., :2].numpy(),
                               np.asarray(lpl_pallas)[..., :2], rtol=1e-5)


# --- the CUDA stats reduction's order ------------------------------------------------

# One lane's row (1, 7), half-warp rows (130; 500 bf16), a partial first
# round (500 f32), one round (1000 bf16), two rounds (1000 f32) and a
# partial second (1030 bf16).
MODEL_V = [1, 7, 130, 500, 1000, 1030]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v", MODEL_V)
def test_stats_model_matches_pallas_and_plain(v, dtype):
    rng = np.random.RandomState(v)
    x = (rng.randn(2, 3, 4, v) * 2).astype(np.float32)
    lab = rng.randint(0, v, (2, 4)).astype(np.int32)
    lab[:, 1] = -1
    blank = v // 2
    x_t = _t(x).to(getattr(torch, dtype))    # rounds as astype does
    x_j = jnp.asarray(x).astype(dtype)
    m, s = stats_model(x_t)
    denom = -(m + torch.log(s))
    want = PK.softmax_stats(x_j, jnp.asarray(lab), blank, interpret=True)
    np.testing.assert_allclose(denom.numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    plain = SK.softmax_stats_plain(x_t, _t(lab), blank)
    np.testing.assert_allclose(denom.numpy(), plain[0].numpy(), rtol=1e-6,
                               atol=1e-5)
    m_j, se_j = PK.softmax_stats_partial(x_j, interpret=True)
    m_p, se_p = SK.softmax_stats_partial_plain(x_t)
    np.testing.assert_array_equal(m.numpy(), m_p.numpy())   # the exact max
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(s.numpy(), se_p.numpy(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(se_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v", MODEL_V)
def test_stats_model_rules_match_plain(v, dtype):
    """An all -inf row gives m = -inf, s = 0 (denom +inf, as logsumexp); a
    NaN gives m and s NaN, as torch.amax and the plain sum; a +inf gives
    s NaN (inf - inf), where logsumexp gives -inf."""
    x = torch.from_numpy(
        (np.random.RandomState(v).randn(2, 3, 4, v) * 2).astype(np.float32))
    inf_row = special_rows(x)
    x = x.to(getattr(torch, dtype))
    m, s = stats_model(x)
    m_p, se_p = SK.softmax_stats_partial_plain(x)
    np.testing.assert_array_equal(m.numpy(), m_p.numpy())   # NaN equal
    np.testing.assert_allclose(s.numpy(), se_p.numpy(), rtol=1e-6, atol=1e-5)
    assert m[0, 1, 0] == -np.inf and s[0, 1, 0] == 0
    assert bool(torch.isnan(m[1, 0, 1])) and bool(torch.isnan(s[1, 0, 1]))
    assert m[inf_row] == np.inf and bool(torch.isnan(s[inf_row]))
    denom = -(m + torch.log(s))
    want = SK.softmax_stats_plain(x, torch.zeros((2, 4), dtype=torch.int32),
                                  0)[0]
    assert want[inf_row] == -np.inf and bool(torch.isnan(denom[inf_row]))
    keep = torch.ones(x.shape[:3], dtype=torch.bool)
    keep[inf_row] = False
    np.testing.assert_allclose(denom[keep].numpy(), want[keep].numpy(),
                               rtol=1e-6, atol=1e-5)


# --- the scans ---------------------------------------------------------------------

# (seed, B, T, S, V, input_lengths, label_lengths, align_shift): odd lengths,
# an S_b = 0 sample, S1 = 1, and an alignment band.
SCAN_CASES = [
    (11, 3, 21, 6, 40, [21, 13, 8], [6, 4, 0], None),
    (12, 2, 9, 0, 7, [9, 4], [0, 0], None),
    (13, 3, 17, 5, 11, [17, 11, 6], [5, 2, 3], 1),
]


def _scan_operands(seed, b, t, s, v, ilen, slen, shift):
    """The JAX stats, masks and virtual rows of a random lattice, as numpy."""
    rng = np.random.RandomState(seed)
    logits = jnp.asarray((rng.randn(b, t, s + 1, v) * 2).astype(np.float32))
    labels = jnp.asarray(rng.randint(1, v, size=(b, s)).astype(np.int32))
    ilen, slen = jnp.asarray(np.array(ilen, np.int32)), jnp.asarray(
        np.array(slen, np.int32))
    if shift is None:
        bands = default_bands(ilen, slen, t)
    else:
        align = np.zeros((b, t), np.int32)
        for i in range(b):
            pos = np.sort(rng.choice(int(ilen[i]), size=int(slen[i]),
                                     replace=False))
            align[i, pos] = np.asarray(labels)[i, :int(slen[i])]
        bands = mr.bands_from_alignment(jnp.asarray(align), ilen, slen, shift,
                                        0)
    stats = compute_stats(logits, labels, slen, 0)
    masks = lattice_masks(ilen, slen, bands, t, s + 1)
    bvirt = mask_to_additive(jnp.arange(s + 1)[None, :] == slen[:, None])
    return tuple(np.asarray(a) for a in (
        stats.lp_blank, stats.lp_label, mask_to_additive(masks.alpha),
        mask_to_additive(masks.beta), ilen, bvirt))


def _jax_scans(lpb, lpl, am, bm, ilen, bvirt):
    """alpha_scan, beta_scan and fwdbwd_scan in interpret mode, padded to
    full DP tiles as ops/pallas/fused.py pads them (tests/test_pallas.py)."""
    b, t, s1 = lpb.shape
    bt, b_pad, tt, t_pad = PK.dp_tiles(b, t, 2 * s1)
    pad = lambda x, f: jnp.pad(jnp.asarray(x), ((0, b_pad - b),
                                                (0, t_pad - t), (0, 0)),
                               constant_values=f)
    args = (pad(lpb, 0.0), pad(lpl, 0.0))
    am_p, bm_p = pad(am, NEG_INF), pad(bm, NEG_INF)
    il_p = jnp.pad(jnp.asarray(ilen), (0, b_pad - b),
                   constant_values=1)[:, None, None]
    bv_p = jnp.pad(jnp.asarray(bvirt), ((0, b_pad - b), (0, 0)),
                   constant_values=NEG_INF)
    cut = lambda x: np.asarray(x)[:b, :t]
    alphas = PK.alpha_scan(*args, am_p, interpret=True, tiles=(bt, tt))
    betas = PK.beta_scan(*args, bm_p, il_p, bv_p, interpret=True,
                         tiles=(bt, tt))
    fb = PK.fwdbwd_scan(*args, am_p, bm_p, il_p, bv_p, interpret=True,
                        tiles=(bt, tt))
    return cut(alphas), cut(betas), tuple(cut(x) for x in fb)


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: f"seed{c[0]}")
def test_scans_plain_match_pallas(case):
    ops = _scan_operands(*case)
    want_a, want_b, want_fb = _jax_scans(*ops)
    lpb, lpl, am, bm, ilen, bvirt = (_t(a) for a in ops)
    # CPU tensors: the wrappers take their plain versions.
    alphas = SK.alpha_scan(lpb, lpl, am)
    betas = SK.beta_scan(lpb, lpl, bm, ilen, bvirt)
    fb = SK.fwdbwd_scan(lpb, lpl, am, bm, ilen, bvirt)
    for got, want in ((alphas, want_a), (betas, want_b), (fb[0], want_fb[0]),
                      (fb[1], want_fb[1])):
        assert np.array_equal(np.isfinite(got.numpy()), np.isfinite(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(fb[0], alphas) and torch.equal(fb[1], betas)


def test_scan_masks_select_where_the_pallas_kernels_add():
    # A NaN statistic in a masked cell (from +-inf padding logits) stays
    # out of the port's recurrences; the additive form would carry it on.
    lpb, lpl, am, bm, ilen, bvirt = (_t(a) for a in
                                     _scan_operands(*SCAN_CASES[0]))
    want_a = SK.alpha_scan_plain(lpb, lpl, am)
    want_b = SK.beta_scan_plain(lpb, lpl, bm, ilen, bvirt)
    lpb_nan = torch.where((am == NEG_INF) & (bm == NEG_INF), float("nan"), lpb)
    assert torch.isnan(lpb_nan).any()
    alphas, betas = SK.fwdbwd_scan(lpb_nan, lpl, am, bm, ilen, bvirt)
    assert torch.equal(alphas, want_a) and torch.equal(betas, want_b)


# --- beta_scan's warp chain, as a torch model ---------------------------------------

# One warp (1, 31, 32), two (33, 51, 64), three (96), four (128), five
# (129): the model's exchange holds at every warp count.
CHAIN_S1 = [1, 31, 32, 33, 51, 64, 96, 128, 129]


@pytest.mark.parametrize("s1", CHAIN_S1)
def test_beta_chain_model_matches_pallas_and_plain(s1):
    """Samples at T_b = T, T/2, 0 and T - 5; random 0 / -inf masks and
    virtual rows."""
    rng = np.random.RandomState(s1)
    b, t = 4, 13
    lpb, lpl = ((rng.randn(b, t, s1) - 1).astype(np.float32)
                for _ in range(2))
    bm = np.where(rng.rand(b, t, s1) < 0.8, 0.0, -np.inf).astype(np.float32)
    ilen = np.array([t, t // 2, 0, t - 5], np.int32)
    bvirt = np.where(rng.rand(b, s1) < 0.3, 0.0, -np.inf).astype(np.float32)
    got = beta_chain_model(*(_t(a) for a in (lpb, lpl, bm, ilen, bvirt)))
    plain = SK.beta_scan_plain(*(_t(a) for a in (lpb, lpl, bm, ilen, bvirt)))
    bt, b_pad, tt, t_pad = PK.dp_tiles(b, t, s1)
    pad = lambda x, f: jnp.pad(jnp.asarray(x), ((0, b_pad - b),
                                                (0, t_pad - t), (0, 0)),
                               constant_values=f)
    want = PK.beta_scan(pad(lpb, 0.0), pad(lpl, 0.0), pad(bm, NEG_INF),
                        jnp.pad(jnp.asarray(ilen), (0, b_pad - b),
                                constant_values=1)[:, None, None],
                        jnp.pad(jnp.asarray(bvirt), ((0, b_pad - b), (0, 0)),
                                constant_values=NEG_INF),
                        interpret=True, tiles=(bt, tt))
    want = np.asarray(want)[:b, :t]
    assert np.array_equal(np.isfinite(got.numpy()), np.isfinite(want))
    assert torch.equal(torch.isfinite(got), torch.isfinite(plain))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # The same operations slot by slot; CPU exp/log1p may round a tail
    # element differently from a vectorised one, so not bit for bit.
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6,
                               atol=1e-6)


# S1 for the alpha chain: one warp (1, 31, 32), two (33, 51 the padded
# lattice, 64 the fused-joint forward), three (65), four (128).
ALPHA_CHAIN_S1 = [1, 31, 32, 33, 51, 64, 65, 128]


@pytest.mark.parametrize("s1", ALPHA_CHAIN_S1)
def test_alpha_chain_model_matches_pallas_and_plain(s1):
    """Random 0 / -inf masks; the JAX alpha_scan and fwdbwd_scan's alphas
    (interpret mode) and alpha_scan_plain. T > S1, so that alpha reaches
    every slot (it climbs one slot a step) and every warp edge is used."""
    rng = np.random.RandomState(100 + s1)
    b, t = 4, s1 + 3
    lpb, lpl = ((rng.randn(b, t, s1) - 1).astype(np.float32)
                for _ in range(2))
    am, bm = (np.where(rng.rand(b, t, s1) < 0.8, 0.0,
                       -np.inf).astype(np.float32) for _ in range(2))
    ilen = np.array([t, t // 2, 1, t - 5], np.int32)
    bvirt = np.where(rng.rand(b, s1) < 0.3, 0.0, -np.inf).astype(np.float32)
    want, _, (want_fb, _) = _jax_scans(lpb, lpl, am, bm, ilen, bvirt)
    got = alpha_chain_model(_t(lpb), _t(lpl), _t(am))
    plain = SK.alpha_scan_plain(_t(lpb), _t(lpl), _t(am))
    assert np.array_equal(np.isfinite(got.numpy()), np.isfinite(want))
    assert torch.equal(torch.isfinite(got), torch.isfinite(plain))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_fb, rtol=1e-5, atol=1e-5)
    # The same operations slot by slot; CPU exp/log1p may round a tail
    # element differently from a vectorised one, so not bit for bit.
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6,
                               atol=1e-6)


# --- the split route ---------------------------------------------------------------

def _loss_case(seed=29, blank=0):
    return golden.repeat_label_case(seed, 3, 16, 7, 33, blank_id=blank)


def _alignment(labels, ilen, slen, t, seed=3):
    rng = np.random.RandomState(seed)
    align = np.zeros((len(ilen), t), np.int32)
    for b in range(len(ilen)):
        frames = np.sort(rng.choice(ilen[b], size=slen[b], replace=False))
        align[b, frames] = labels[b, :slen[b]]
    return align


@pytest.mark.parametrize("banded", [False, True], ids=["full", "band"])
@pytest.mark.parametrize("blank", [0, 32])
def test_split_route_matches_jax_split_pipeline_and_oracle(blank, banded):
    lg, lb, il, sl = _loss_case(blank=blank)
    args = tuple(jnp.asarray(a) for a in (lg, lb, il, sl))
    j_bands = t_bands = None
    if banded:
        align = _alignment(lb, il, sl, lg.shape[1])
        j_bands = mr.bands_from_alignment(jnp.asarray(align), args[2],
                                          args[3], 2, blank)
        t_bands = convert.bands_from_numpy(*(np.asarray(a) for a in j_bands),
                                           device="cpu")
    with jax_config(pipeline="split"):
        c_pal, g_pal = jax.jit(rnnt_loss_pallas, static_argnames=(
            "blank_id", "with_grads", "interpret"))(
            *args, blank_id=blank, bands=j_bands, interpret=True)
    c_ref, g_ref = rnnt_loss_reference(*args, blank_id=blank, bands=j_bands)
    t_in = convert.loss_inputs_from_numpy(lg, lb, il, sl, device="cpu")
    with mt.config_override(pipeline="split"):
        c, g = fused.rnnt_loss_cuda(*t_in, blank_id=blank, bands=t_bands)
        c_only, none = fused.rnnt_loss_cuda(*t_in, blank_id=blank,
                                            bands=t_bands, with_grads=False)
    assert none is None and torch.equal(c_only, c)
    for want_c, want_g in ((c_pal, g_pal), (c_ref, g_ref)):
        np.testing.assert_allclose(c.numpy(), np.asarray(want_c), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-4,
                                   atol=1e-5)


def _counting(monkeypatch):
    """Counts the calls of every kernel wrapper ops/cuda/fused.py makes."""
    calls = {}
    for name in ("softmax_stats", "fwdbwd_scan", "alpha_scan", "grad_pass",
                 "stats_alpha_fused", "beta_grad_fused"):
        fn = getattr(fused, name)

        def shim(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(fused, name, shim)
    return calls


def _jax_weighted(lg, lb, il, sl, dtype):
    from monotonic_rnnt_tpu.utils.debug import interpret_mode

    def total(x):
        return jnp.sum(jnp.asarray(WEIGHTS) * mr.monotonic_rnnt_loss(
            x, jnp.asarray(lb), jnp.asarray(il), jnp.asarray(sl),
            backend="pallas"))

    with jax_config(pipeline="split"), interpret_mode():
        return jax.jit(jax.value_and_grad(total))(
            jnp.asarray(lg).astype(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eager_route_training_step_matches_jax(monkeypatch, dtype):
    lg, lb, il, sl = _loss_case(seed=31)
    v_j, g_j = _jax_weighted(lg, lb, il, sl, dtype)
    lg_t, lb_t, il_t, sl_t = convert.loss_inputs_from_numpy(
        lg, lb, il, sl, device="cpu", dtype=getattr(torch, dtype))
    bands = mt.default_bands(il_t, sl_t, lg.shape[1])
    calls = _counting(monkeypatch)
    x = lg_t.clone().requires_grad_(True)
    with mt.config_override(pipeline="split"):
        costs = tloss._LossCore.apply(x, lb_t, il_t, sl_t, bands.min_s,
                                      bands.max_s, 0, "cuda")
        (costs * _t(WEIGHTS)).sum().backward()
        assert calls == {"softmax_stats": 1, "fwdbwd_scan": 1, "grad_pass": 1}
        calls.clear()
        with torch.no_grad():
            c_only = mt.monotonic_rnnt_loss(x, lb_t, il_t, sl_t,
                                            backend="reference")
            c_cuda = tloss._LossCore.apply(x.detach(), lb_t, il_t, sl_t,
                                           bands.min_s, bands.max_s, 0,
                                           "cuda")
        assert calls == {"softmax_stats": 1, "alpha_scan": 1}
    assert x.grad.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(c_cuda.numpy(), c_only.numpy(), rtol=1e-5)
    np.testing.assert_allclose(float((costs.detach() * _t(WEIGHTS)).sum()),
                               float(v_j), rtol=1e-5)
    bf16 = dtype == "bfloat16"
    # bf16: both round an f32 gradient scaled by the same cotangent.
    np.testing.assert_allclose(x.grad.float().numpy(),
                               np.asarray(g_j.astype(jnp.float32)),
                               rtol=8e-3 if bf16 else 1e-4, atol=1e-5)


def test_fused_pipeline_takes_the_deferred_route(monkeypatch):
    lg, lb, il, sl = convert.loss_inputs_from_numpy(*_loss_case(), device="cpu")
    bands = mt.default_bands(il, sl, lg.shape[1])
    calls = _counting(monkeypatch)
    for pipeline in ("auto", "fused"):
        calls.clear()
        x = lg.clone().requires_grad_(True)
        with mt.config_override(pipeline=pipeline):
            tloss._LossCore.apply(x, lb, il, sl, bands.min_s, bands.max_s, 0,
                                  "cuda").sum().backward()
        assert calls == {"stats_alpha_fused": 1, "beta_grad_fused": 1}
    with pytest.raises(ValueError, match="pipeline must be one of"):
        with mt.config_override(pipeline="eager"):
            pass
    assert mt.get_config().pipeline == "auto"


@pytest.mark.parametrize("backend", ["auto", "cuda", "reference"])
def test_bad_pipeline_raises_where_it_is_set_on_every_backend(backend):
    # A misspelt pipeline never reaches a loss call, whatever its backend.
    with pytest.raises(ValueError, match="pipeline must be one of"):
        mt.update_config(backend=backend, pipeline="splt")
    assert mt.get_config().backend == "auto"
    with pytest.raises(ValueError, match="pipeline must be one of"):
        config.Config(backend=backend, pipeline="splt")


def test_split_route_readme_golden():
    lg, lb, il, sl = convert.loss_inputs_from_numpy(*golden.readme_batch(),
                                                    device="cpu")
    with mt.config_override(pipeline="split"):
        costs, grads = fused.rnnt_loss_cuda(lg, lb, il, sl)
    np.testing.assert_allclose(costs.numpy(), [golden.README_LOSS], atol=1e-4)
    np.testing.assert_allclose(grads[0].numpy(), golden.README_GRADS,
                               atol=1e-2)


def test_split_route_inf_padding_and_infeasible_sample():
    lg, lb, il, sl = _loss_case(seed=4)
    lg_t, lb_t, il_t, sl_t = convert.loss_inputs_from_numpy(lg, lb, il, sl,
                                                            device="cpu")
    padded = lg_t.clone()
    for b in range(3):
        padded[b, int(il[b]):, :, ::2] = float("inf")
        padded[b, int(il[b]):, :, 1::2] = float("-inf")
        padded[b, :, int(sl[b]) + 1:, 3] = float("inf")
    # Sample 2 must emit its labels inside an exact path it cannot hold.
    align = np.zeros((3, lg.shape[1]), np.int32)
    align[0, :int(sl[0])] = lb[0, :int(sl[0])]
    align[1, :int(sl[1])] = lb[1, :int(sl[1])]
    bands = mt.bands_from_alignment(_t(align), il_t, sl_t, 0, 0)
    with mt.config_override(pipeline="split"):
        c_fin, _ = fused.rnnt_loss_cuda(lg_t, lb_t, il_t, sl_t)
        c_inf, g_inf = fused.rnnt_loss_cuda(padded, lb_t, il_t, sl_t)
        c_bad, g_bad = fused.rnnt_loss_cuda(lg_t, lb_t, il_t, sl_t,
                                            bands=bands)
    assert torch.equal(c_fin, c_inf)
    t_idx = torch.arange(lg.shape[1])[None, :, None]
    s_idx = torch.arange(lg.shape[2])[None, None, :]
    pad = (t_idx >= il_t[:, None, None]) | (s_idx > sl_t[:, None, None])
    assert (g_inf[pad] == 0).all() and torch.isfinite(g_inf).all()
    assert sl[2] > 0 and torch.isfinite(c_bad[:2]).all()
    assert c_bad[2].item() == np.inf
    assert (g_bad[2] == 0).all() and torch.isfinite(g_bad).all()


def test_split_nan_cost_gradient_matches_jax_split():
    """The NaN-cost case on the split route: like the JAX package's Pallas
    split route (interpret mode), costs [8.5436, NaN] and an all-zero
    gradient for sample 1, where the oracles and the deferred route put NaN
    on lattice cells. JAX's occupancy coefficients are all 0 for a sample
    whose ll is not finite (reference.py occupancy_coefficients), and its
    grad_pass writes 0 where the coefficient is 0; the port's row 6 keeps
    that contract (ROADMAP §3's recorded difference)."""
    from monotonic_rnnt_tpu.utils.debug import interpret_mode

    case, _ = nan_cost_case()
    args = tuple(jnp.asarray(a) for a in case)

    def total(x):
        return jnp.sum(mr.monotonic_rnnt_loss(x, *args[1:], backend="pallas"))

    with jax_config(pipeline="split"), interpret_mode():
        want_c = mr.monotonic_rnnt_loss(*args, backend="pallas")
        want_g = np.asarray(jax.grad(total)(args[0]))
    lg, lb, il, sl = convert.loss_inputs_from_numpy(*case, device="cpu")
    bands = mt.default_bands(il, sl, lg.shape[1])
    x = lg.clone().requires_grad_(True)
    with mt.config_override(pipeline="split"):
        costs = tloss._LossCore.apply(x, lb, il, sl, bands.min_s,
                                      bands.max_s, 0, "cuda")
        costs.sum().backward()
    got_g = x.grad.numpy()
    np.testing.assert_allclose(costs.detach().numpy(), np.asarray(want_c),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(want_c)[0], 8.5436, rtol=1e-5)
    assert np.isnan(costs.detach().numpy()[1])
    assert not np.isnan(want_g).any() and (want_g[1] == 0).all()
    assert not np.isnan(got_g).any() and (got_g[1] == 0).all()
    np.testing.assert_allclose(got_g, want_g, rtol=1e-4, atol=1e-6)
