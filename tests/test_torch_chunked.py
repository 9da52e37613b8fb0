"""The port's fused-joint losses against the JAX package's.

``rnnt_loss_fused_joint`` and ``rnnt_loss_fused_joint_banded`` on the same
numpy-seeded encoder, predictor and joint weights as JAX's
(tests/test_chunked.py, tests/test_chunked_banded.py): costs, d_enc, d_pred
and every d_params leaf, with per-sample weights; and each against the
port's own materialised route (the joint, then monotonic_rnnt_loss or
monotonic_rnnt_loss_banded). CPU tensors, where the kernel wrappers take
their plain versions. Tolerances: costs 1e-5 relative, gradients 1e-4
relative and 1e-5 absolute (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monotonic_rnnt_tpu_torch as mt
from monotonic_rnnt_tpu.ops.bands import bands_from_alignment as j_bands_from
from monotonic_rnnt_tpu.ops.bands import default_bands as jbands_default
from monotonic_rnnt_tpu.ops.bands import required_band_width
from monotonic_rnnt_tpu.ops.chunked import rnnt_loss_fused_joint as j_fused
from monotonic_rnnt_tpu.ops.chunked_banded import \
    rnnt_loss_fused_joint_banded as j_fused_banded
from monotonic_rnnt_tpu_torch import convert
from monotonic_rnnt_tpu_torch.ops import banded as tbanded
from monotonic_rnnt_tpu_torch.ops import chunked, chunked_banded
from monotonic_rnnt_tpu_torch.ops import loss as tloss
from monotonic_rnnt_tpu_torch.ops.cuda import banded_kernels, split_kernels
from monotonic_rnnt_tpu_torch.ops.helpers import mask_to_additive
from monotonic_rnnt_tpu_torch.ops.reference import LatticeStats

KEYS = ("we", "wp", "wv", "bv")


# The additive tanh joint (benchmarks/fused_banded_bench.py:27-42) in both
# frameworks: full lattice and band-gathered predictor rows.
def j_joint(params, enc_c, pred):
    e = enc_c.astype(jnp.float32) @ params["we"]
    p = pred.astype(jnp.float32) @ params["wp"]
    return jnp.tanh(e[:, :, None, :] + p[:, None, :, :]) @ params["wv"] + \
        params["bv"]


def j_joint_banded(params, enc_c, pred_band):
    e = enc_c.astype(jnp.float32) @ params["we"]
    p = pred_band.astype(jnp.float32) @ params["wp"]
    return jnp.tanh(e[:, :, None, :] + p) @ params["wv"] + params["bv"]


def _add_joint_banded(params, enc_c, pred_band):
    return enc_c[:, :, None, :] + pred_band + params["bv"]


def t_joint(params, enc_c, pred):
    e = enc_c.float() @ params["we"]
    p = pred.float() @ params["wp"]
    return torch.tanh(e[:, :, None, :] + p[:, None, :, :]) @ params["wv"] + \
        params["bv"]


def t_joint_banded(params, enc_c, pred_band):
    e = enc_c.float() @ params["we"]
    p = pred_band.float() @ params["wp"]
    return torch.tanh(e[:, :, None, :] + p) @ params["wv"] + params["bv"]


def _setup(seed=0, batch=2, t=11, s=4, v=9, de=6, dp=5, j=7):
    """tests/test_chunked.py:_setup, as numpy arrays."""
    rng = np.random.RandomState(seed)
    enc = rng.randn(batch, t, de).astype(np.float32)
    pred = rng.randn(batch, s + 1, dp).astype(np.float32)
    labels = rng.randint(1, v, size=(batch, s)).astype(np.int32)
    ilen = rng.randint(s + 1, t + 1, (batch,)).astype(np.int32)
    slen = rng.randint(1, s + 1, (batch,)).astype(np.int32)
    params = {
        "we": rng.randn(de, j).astype(np.float32) * 0.5,
        "wp": rng.randn(dp, j).astype(np.float32) * 0.5,
        "wv": rng.randn(j, v).astype(np.float32) * 0.5,
        "bv": rng.randn(v).astype(np.float32) * 0.1,
    }
    return enc, pred, labels, ilen, slen, params


def _alignment_bands(labels, ilen, slen, t, shift, seed):
    rng = np.random.RandomState(seed)
    align = np.zeros((len(ilen), t), np.int32)
    for b in range(len(ilen)):
        pos = np.sort(rng.choice(int(ilen[b]), size=int(slen[b]),
                                 replace=False))
        align[b, pos] = labels[b, :int(slen[b])]
    j_b = j_bands_from(jnp.asarray(align), jnp.asarray(ilen),
                       jnp.asarray(slen), shift, 0)
    return j_b, convert.bands_from_numpy(*(np.asarray(a) for a in j_b),
                                         device="cpu")


def _jax_grads(loss, enc, pred, params, weights):
    def total(e, p, pr):
        return jnp.sum(jnp.asarray(weights) * loss(e, p, pr))

    v, (g_e, g_p, g_pr) = jax.jit(jax.value_and_grad(total, argnums=(0, 1, 2)))(
        jnp.asarray(enc), jnp.asarray(pred),
        {k: jnp.asarray(a) for k, a in params.items()})
    return float(v), [np.asarray(g_e), np.asarray(g_p)] + [
        np.asarray(g_pr[k]) for k in KEYS]


def _port_grads(loss, enc, pred, params, weights):
    e = torch.from_numpy(enc).requires_grad_(True)
    p = torch.from_numpy(pred).requires_grad_(True)
    pr = {k: v.requires_grad_(True) for k, v in
          convert.joint_params_from_numpy(params, device="cpu").items()}
    costs = loss(e, p, pr)
    total = (costs * torch.from_numpy(np.asarray(weights))).sum()
    total.backward()
    return float(total.detach()), [e.grad.numpy(), p.grad.numpy()] + [
        pr[k].grad.numpy() for k in KEYS]


def _assert_match(got, want):
    (v, grads), (v_w, grads_w) = got, want
    np.testing.assert_allclose(v, v_w, rtol=1e-5)
    for name, g, w in zip(("enc", "pred") + KEYS, grads, grads_w):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)


def _t_args(labels, ilen, slen):
    return tuple(torch.from_numpy(a) for a in (labels, ilen, slen))


# --- rnnt_loss_fused_joint -----------------------------------------------------------

@pytest.mark.parametrize("chunk_t", [1, 4, 11, 32])   # T = 11
def test_fused_joint_matches_jax(chunk_t):
    enc, pred, labels, ilen, slen, params = _setup()
    w = np.array([1.0, 0.35], np.float32)      # per-sample weights
    j_args = tuple(jnp.asarray(a) for a in (labels, ilen, slen))
    want = _jax_grads(lambda e, p, pr: j_fused(
        e, p, *j_args, j_joint, pr, chunk_t=chunk_t), enc, pred, params, w)
    got = _port_grads(lambda e, p, pr: mt.rnnt_loss_fused_joint(
        e, p, *_t_args(labels, ilen, slen), t_joint, pr, chunk_t=chunk_t),
        enc, pred, params, w)
    _assert_match(got, want)


def test_fused_joint_with_bands_matches_jax():
    enc, pred, labels, ilen, slen, params = _setup(seed=3)
    j_b, t_b = _alignment_bands(labels, ilen, slen, enc.shape[1], 2, 1)
    w = np.array([0.7, -1.3], np.float32)
    j_args = tuple(jnp.asarray(a) for a in (labels, ilen, slen))
    want = _jax_grads(lambda e, p, pr: j_fused(
        e, p, *j_args, j_joint, pr, chunk_t=4, bands=j_b), enc, pred, params,
        w)
    got = _port_grads(lambda e, p, pr: mt.rnnt_loss_fused_joint(
        e, p, *_t_args(labels, ilen, slen), t_joint, pr, chunk_t=4,
        bands=t_b), enc, pred, params, w)
    _assert_match(got, want)


def _counting_stats(monkeypatch, module, name="softmax_stats"):
    """Records each call of the module's kernel wrapper `name`."""
    calls = []
    fn = getattr(module, name)

    def shim(*a, **k):
        calls.append(torch.is_grad_enabled())
        return fn(*a, **k)

    monkeypatch.setattr(module, name, shim)
    return calls


def test_fused_joint_cost_only_under_no_grad(monkeypatch):
    enc, pred, labels, ilen, slen, params = _setup(seed=5)
    want = j_fused(*(jnp.asarray(a) for a in (enc, pred, labels, ilen, slen)),
                   j_joint, {k: jnp.asarray(a) for k, a in params.items()},
                   chunk_t=4)
    calls = _counting_stats(monkeypatch, chunked)
    alpha_calls = _counting_stats(monkeypatch, chunked, "alpha_scan")
    beta_calls = _counting_stats(monkeypatch, chunked, "beta_scan")
    e = torch.from_numpy(enc).requires_grad_(True)
    pr = convert.joint_params_from_numpy(params, device="cpu")
    with torch.no_grad():
        costs = mt.rnnt_loss_fused_joint(e, torch.from_numpy(pred),
                                         *_t_args(labels, ilen, slen),
                                         t_joint, pr, chunk_t=4)
    assert not costs.requires_grad
    assert len(calls) == 3                    # ceil(11 / 4) chunks, forward
    assert len(alpha_calls) == 1 and not beta_calls
    np.testing.assert_allclose(costs.numpy(), np.asarray(want), rtol=1e-5)


def test_fused_joint_stats_once_per_chunk_each_way(monkeypatch):
    enc, pred, labels, ilen, slen, params = _setup(seed=6, t=13)
    calls = _counting_stats(monkeypatch, chunked)
    beta_calls = _counting_stats(monkeypatch, chunked, "beta_scan")
    alpha_calls = _counting_stats(monkeypatch, chunked, "alpha_scan")
    got = _port_grads(lambda e, p, pr: mt.rnnt_loss_fused_joint(
        e, p, *_t_args(labels, ilen, slen), t_joint, pr, chunk_t=4),
        enc, pred, params, np.ones(2, np.float32))
    assert len(calls) == 8                    # 4 chunks forward, 4 backward
    assert len(beta_calls) == 4               # one beta scan per chunk
    assert len(alpha_calls) == 1              # one alpha scan over all of T
    assert all(np.isfinite(g).all() for g in got[1])


@pytest.mark.parametrize("chunk_t", [1, 3, 7, 13])
def test_chunk_betas_equal_one_beta_scan_over_t(chunk_t):
    # Chunk by chunk in reverse, each beta_scan fed the next chunk's carry,
    # against one scan over all of T; lengths end inside, at and before a
    # chunk's edge.
    rng = np.random.RandomState(chunk_t)
    batch, t_max, s1 = 4, 13, 5
    lpb, lpl = (torch.from_numpy((rng.randn(batch, t_max, s1) - 1).astype(
        np.float32)) for _ in range(2))
    mask = torch.from_numpy(rng.rand(batch, t_max, s1) < 0.8)
    bm = mask_to_additive(mask)
    ilen = torch.tensor([13, 7, 6, 1], dtype=torch.int32)
    virt = mask_to_additive(torch.from_numpy(rng.rand(batch, s1) < 0.4))
    want = split_kernels.beta_scan_plain(lpb, lpl, bm, ilen, virt)
    row = torch.full((batch, s1), float("-inf"))
    for t0 in reversed(range(0, t_max, chunk_t)):
        t1 = min(t0 + chunk_t, t_max)
        stats = LatticeStats(denom=None, lp_blank=lpb[:, t0:t1].contiguous(),
                             lp_label=lpl[:, t0:t1].contiguous())
        betas, bnext = chunked.chunk_betas(row, stats,
                                           bm[:, t0:t1].contiguous(), virt,
                                           ilen, t0)
        torch.testing.assert_close(betas, want[:, t0:t1], rtol=0, atol=0)
        after = torch.cat([want[:, t0 + 1:t1], row[:, None]], dim=1)
        t_idx = torch.arange(t0 + 1, t1 + 1)
        torch.testing.assert_close(
            bnext, torch.where(t_idx[None, :, None] >= ilen[:, None, None],
                               virt[:, None], after), rtol=0, atol=0)
        row = betas[:, 0]


@pytest.mark.parametrize("chunk_t", [1, 3, 7, 13])
def test_chunk_band_betas_equal_one_band_scan_over_t(chunk_t):
    # The band beta chain chunk by chunk in reverse, each launch fed the next
    # chunk's carry, against one scan over all of T; bnext is beta(t+1)
    # (the virtual row past T_b) realigned by d_next.
    rng = np.random.RandomState(chunk_t)
    batch, t_max, w = 4, 13, 5
    lpb, lpl, bvirt = (torch.from_numpy((rng.randn(batch, t_max, w) - 1)
                                        .astype(np.float32))
                       for _ in range(3))
    mask = torch.from_numpy(rng.rand(batch, t_max, w) < 0.8)
    d_next = torch.from_numpy(rng.randint(0, 2, (batch, t_max)).astype(
        np.int32))
    ilen = torch.tensor([13, 7, 6, 1], dtype=torch.int32)
    neg = float("-inf")
    want = banded_kernels.beta_scan_banded_plain(
        torch.where(mask, lpb, neg), torch.where(mask, lpl, neg), d_next,
        ilen, bvirt)
    row = torch.full((batch, w), neg)
    for t0 in reversed(range(0, t_max, chunk_t)):
        t1 = min(t0 + chunk_t, t_max)
        stats = tbanded.BandStats(denom=None, lp_blank=lpb[:, t0:t1],
                                  lp_label=lpl[:, t0:t1])
        betas, bnext = chunked_banded.chunk_band_betas(
            row, stats, d_next[:, t0:t1].contiguous(), bvirt[:, t0:t1],
            mask[:, t0:t1], ilen, t0)
        torch.testing.assert_close(betas, want[:, t0:t1], rtol=0, atol=0)
        after = torch.cat([want[:, t0 + 1:t1], row[:, None]], dim=1)
        t_idx = torch.arange(t0 + 1, t1 + 1)
        nxt = torch.where(t_idx[None, :, None] >= ilen[:, None, None],
                          bvirt[:, t0:t1], after)
        shifted = torch.cat([torch.full((batch, t1 - t0, 1), neg),
                             nxt[..., :-1]], dim=-1)
        torch.testing.assert_close(
            bnext, torch.where((d_next[:, t0:t1] == 1)[:, :, None], shifted,
                               nxt), rtol=0, atol=0)
        row = betas[:, 0]


def test_fused_joint_banded_scans_once_forward_once_per_chunk_back(
        monkeypatch):
    enc, pred, labels, ilen, slen, params = _setup(seed=2, batch=3, t=13)
    j_b, t_b = _alignment_bands(labels, ilen, slen, enc.shape[1], 2, 0)
    width = int(required_band_width(jnp.asarray(ilen), jnp.asarray(slen), j_b,
                                    enc.shape[1], pred.shape[1]))
    counts = {n: _counting_stats(monkeypatch, chunked_banded, n)
              for n in ("softmax_stats", "alpha_scan_banded",
                        "fwdbwd_scan_banded")}
    got = _port_grads(lambda e, p, pr: mt.rnnt_loss_fused_joint_banded(
        e, p, *_t_args(labels, ilen, slen), t_joint_banded, pr, bands=t_b,
        band_width=width, chunk_t=4), enc, pred, params,
        np.ones(3, np.float32))
    assert {n: len(c) for n, c in counts.items()} == {
        "softmax_stats": 8, "alpha_scan_banded": 1, "fwdbwd_scan_banded": 4}
    assert all(np.isfinite(g).all() for g in got[1])


def test_fused_joint_infeasible_sample_inf_cost_zero_grads():
    enc, pred, labels, ilen, slen, params = _setup(seed=7, batch=3)
    slen[2] = max(int(slen[2]), 1)
    align = np.zeros((3, enc.shape[1]), np.int32)
    for b in range(2):                         # sample 2: no aligned label
        align[b, :slen[b]] = labels[b, :slen[b]]
    j_b = j_bands_from(jnp.asarray(align), jnp.asarray(ilen),
                       jnp.asarray(slen), 0, 0)
    t_b = convert.bands_from_numpy(*(np.asarray(a) for a in j_b), device="cpu")
    j_args = tuple(jnp.asarray(a) for a in (labels, ilen, slen))
    j_costs, j_vjp = jax.vjp(lambda e: j_fused(e, jnp.asarray(pred), *j_args,
                                               j_joint, {k: jnp.asarray(a) for
                                                         k, a in
                                                         params.items()},
                                               chunk_t=4, bands=j_b),
                             jnp.asarray(enc))
    (j_denc,) = j_vjp(jnp.ones(3, jnp.float32))
    e = torch.from_numpy(enc).requires_grad_(True)
    costs = mt.rnnt_loss_fused_joint(
        e, torch.from_numpy(pred), *_t_args(labels, ilen, slen), t_joint,
        convert.joint_params_from_numpy(params, device="cpu"), chunk_t=4,
        bands=t_b)
    costs.backward(torch.ones(3))
    assert costs[2].item() == np.inf and np.isinf(np.asarray(j_costs)[2])
    np.testing.assert_allclose(costs[:2].detach().numpy(),
                               np.asarray(j_costs)[:2], rtol=1e-5)
    assert (e.grad[2] == 0).all() and torch.isfinite(e.grad).all()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(j_denc), rtol=1e-4,
                               atol=1e-5)


def _add_joint(params, enc_c, pred):
    """An additive joint (De = Dp = V), so a non-finite encoder value
    reaches exactly one vocab column of its frame's logits."""
    return enc_c[:, :, None, :] + pred[:, None, :, :] + params["bv"]


@pytest.mark.parametrize("banded", [False, True], ids=["full", "band"])
def test_fused_joint_nan_cost_gets_the_jax_nan_gradient(banded):
    """enc[1, 1, 2] = +inf: sample 1's logits at frame 1 are +inf in
    column 2 and its cost is not finite. Its coefficients are all 0 in both
    packages; the JAX oracle's p * 0 puts NaN in d_enc[1, 1, 2], d_pred[1,
    :, 2] and d_bv[2], where the port's lattice cells must be NaN too (the
    port keeps d_pred's padding rows s > S_b at zero, as the padded oracle
    does). Sample 0's gradients keep their bits."""
    rng = np.random.RandomState(0)
    b, t, s, v = 2, 11, 4, 9
    enc = rng.randn(b, t, v).astype(np.float32)
    pred = rng.randn(b, s + 1, v).astype(np.float32)
    labels = rng.randint(1, v, (b, s)).astype(np.int32)
    ilen, slen = np.array([11, 9], np.int32), np.array([4, 3], np.int32)
    bv = rng.randn(v).astype(np.float32)
    finite = enc.copy()
    enc[1, 1, 2] = np.inf
    j_args = tuple(jnp.asarray(a) for a in (labels, ilen, slen))
    jb = jbands_default(j_args[1], j_args[2], t)
    width = int(required_band_width(j_args[1], j_args[2], jb, t, s + 1))
    tb = convert.bands_from_numpy(*(np.asarray(a) for a in jb), device="cpu")

    def j_loss(e, p, bias):
        if banded:
            return j_fused_banded(e, p, *j_args, _add_joint_banded,
                                  {"bv": bias}, bands=jb, band_width=width,
                                  chunk_t=4)
        return j_fused(e, p, *j_args, _add_joint, {"bv": bias}, chunk_t=4)

    def port(e_np):
        e, p = (torch.from_numpy(a).requires_grad_(True) for a in (e_np, pred))
        bias = torch.from_numpy(bv).requires_grad_(True)
        kw = ({"bands": tb, "band_width": width} if banded else {})
        loss = (mt.rnnt_loss_fused_joint_banded if banded
                else mt.rnnt_loss_fused_joint)
        costs = loss(e, p, *_t_args(labels, ilen, slen),
                     _add_joint_banded if banded else _add_joint,
                     {"bv": bias}, chunk_t=4, **kw)
        costs.sum().backward()
        return costs.detach().numpy(), [e.grad.numpy(), p.grad.numpy(),
                                        bias.grad.numpy()]

    j_costs, j_vjp = jax.vjp(j_loss, *(jnp.asarray(a) for a in (enc, pred,
                                                                bv)))
    want = [np.asarray(g) for g in j_vjp(jnp.ones(b, jnp.float32))]
    got_c, got = port(enc)
    _, fin = port(finite)
    np.testing.assert_allclose(got_c, np.asarray(j_costs), rtol=1e-5)
    assert np.isfinite(got_c[0]) and not np.isfinite(got_c[1])
    lattice = [(1, 1, slice(None)), (1, slice(0, slen[1] + 1)), ...]
    for g, w, cells in zip(got, want, lattice):
        assert np.isnan(w[cells]).any()
        assert np.isnan(g[cells])[np.isnan(w[cells])].all()
    for g, f in zip(got[:2], fin[:2]):
        np.testing.assert_array_equal(g[0], f[0])


@pytest.mark.parametrize("route", ["reference", "cuda"])
def test_fused_joint_matches_materialised_route(route):
    # The joint's [B, T, S1, V] logits, then monotonic_rnnt_loss: the oracle,
    # or the cuda route's autograd Function (plain versions on CPU tensors).
    enc, pred, labels, ilen, slen, params = _setup(seed=8, t=9)
    w = np.array([1.5, 0.25], np.float32)
    lb, il, sl = _t_args(labels, ilen, slen)

    def materialised(e, p, pr):
        logits = t_joint(pr, e, p)
        if route == "reference":
            return mt.monotonic_rnnt_loss(logits, lb, il, sl)
        bands = mt.default_bands(il, sl, logits.shape[1])
        return tloss._LossCore.apply(logits, lb, il, sl, bands.min_s,
                                     bands.max_s, 0, "cuda")

    want = _port_grads(materialised, enc, pred, params, w)
    got = _port_grads(lambda e, p, pr: mt.rnnt_loss_fused_joint(
        e, p, lb, il, sl, t_joint, pr, chunk_t=4), enc, pred, params, w)
    _assert_match(got, want)


def test_fused_joint_validation():
    enc, pred, labels, ilen, slen, params = _setup()
    pr = convert.joint_params_from_numpy(params, device="cpu")
    e, p = torch.from_numpy(enc), torch.from_numpy(pred)
    lb, il, sl = _t_args(labels, ilen, slen)
    with pytest.raises(mt.RnntError, match="enc must be"):
        mt.rnnt_loss_fused_joint(e[:, 0], p, lb, il, sl, t_joint, pr)
    with pytest.raises(mt.RnntError, match="labels must be"):
        mt.rnnt_loss_fused_joint(e, p, lb[:, :2], il, sl, t_joint, pr)
    with pytest.raises(mt.RnntError, match="input_lengths must be int"):
        mt.rnnt_loss_fused_joint(e, p, lb, il.float(), sl, t_joint, pr)


# --- rnnt_loss_fused_joint_banded ----------------------------------------------------

def _banded_setup(seed=0, t=11, s=4, shift=1):
    """tests/test_chunked_banded.py:_setup: the same draws in the same order."""
    rng = np.random.RandomState(seed)
    batch, de, dp, j, v = 2, 6, 5, 7, 9
    enc = rng.randn(batch, t, de).astype(np.float32)
    pred = rng.randn(batch, s + 1, dp).astype(np.float32)
    labels = rng.randint(1, v, size=(batch, s)).astype(np.int32)
    ilen = rng.randint(s + 1, t + 1, (batch,)).astype(np.int32)
    slen = rng.randint(1, s + 1, (batch,)).astype(np.int32)
    align = np.zeros((batch, t), np.int32)
    for b in range(batch):
        pos = np.sort(rng.choice(int(ilen[b]), size=int(slen[b]),
                                 replace=False))
        align[b, pos] = labels[b, :int(slen[b])]
    j_b = j_bands_from(jnp.asarray(align), jnp.asarray(ilen),
                       jnp.asarray(slen), shift, 0)
    params = {
        "we": rng.randn(de, j).astype(np.float32) * 0.5,
        "wp": rng.randn(dp, j).astype(np.float32) * 0.5,
        "wv": rng.randn(j, v).astype(np.float32) * 0.5,
        "bv": rng.randn(v).astype(np.float32) * 0.1,
    }
    t_b = convert.bands_from_numpy(*(np.asarray(a) for a in j_b), device="cpu")
    return enc, pred, labels, ilen, slen, j_b, t_b, params


def _banded_pair(enc, pred, labels, ilen, slen, j_b, t_b, params, width,
                 chunk_t, w):
    j_args = tuple(jnp.asarray(a) for a in (labels, ilen, slen))
    want = _jax_grads(lambda e, p, pr: j_fused_banded(
        e, p, *j_args, j_joint_banded, pr, bands=j_b, band_width=width,
        chunk_t=chunk_t), enc, pred, params, w)
    got = _port_grads(lambda e, p, pr: mt.rnnt_loss_fused_joint_banded(
        e, p, *_t_args(labels, ilen, slen), t_joint_banded, pr, bands=t_b,
        band_width=width, chunk_t=chunk_t), enc, pred, params, w)
    return got, want


@pytest.mark.parametrize("chunk_t", [4, 11, 32])
def test_fused_joint_banded_matches_jax(chunk_t):
    case = _banded_setup()
    enc, _, _, ilen, slen, j_b, _, _ = case
    width = int(required_band_width(jnp.asarray(ilen), jnp.asarray(slen), j_b,
                                    enc.shape[1], case[1].shape[1]))
    _assert_match(*_banded_pair(*case, width, chunk_t,
                                np.array([1.0, 0.35], np.float32)))


def test_fused_joint_banded_width_clipping():
    case = _banded_setup(seed=3, t=16, s=6, shift=3)
    enc, pred, _, ilen, slen, j_b, _, _ = case
    w_req = int(required_band_width(jnp.asarray(ilen), jnp.asarray(slen), j_b,
                                    enc.shape[1], pred.shape[1]))
    assert w_req > 2
    _assert_match(*_banded_pair(*case, w_req - 1, 8,
                                np.array([1.0, 1.0], np.float32)))


def test_fused_joint_banded_validation():
    enc, pred, labels, ilen, slen, _, t_b, params = _banded_setup()
    pr = convert.joint_params_from_numpy(params, device="cpu")
    e, p = torch.from_numpy(enc), torch.from_numpy(pred)
    args = _t_args(labels, ilen, slen)
    with pytest.raises(mt.RnntError, match="band_width must be in"):
        mt.rnnt_loss_fused_joint_banded(e, p, *args, t_joint_banded, pr,
                                        bands=t_b,
                                        band_width=pred.shape[1] + 1)
    with pytest.raises(mt.RnntError, match="enc must be"):
        mt.rnnt_loss_fused_joint_banded(e[:, 0], p, *args, t_joint_banded, pr,
                                        bands=t_b, band_width=2)


@pytest.mark.parametrize("route", ["reference", "cuda"])
def test_fused_joint_banded_matches_materialised_route(route, monkeypatch):
    enc, pred, labels, ilen, slen, _, t_b, params = _banded_setup(seed=9,
                                                                  shift=2)
    lb, il, sl = _t_args(labels, ilen, slen)
    t, s1 = enc.shape[1], pred.shape[1]
    width = mt.suggested_band_width(il, sl, t_b, t, s1)
    layout = mt.compute_band_layout(il, sl, t_b, t, s1, width)
    w = np.array([0.5, 2.0], np.float32)
    calls = _counting_stats(monkeypatch, chunked_banded)

    def materialised(e, p, pr):
        idx = layout.offset.long()[:, :, None] + torch.arange(width)
        logits_band = t_joint_banded(
            pr, e, p[torch.arange(2)[:, None, None], idx])
        if route == "reference":
            return mt.monotonic_rnnt_loss_banded(logits_band, lb, il, sl,
                                                 bands=t_b)
        return tbanded._BandedCore.apply(logits_band, lb, il, sl, t_b.min_s,
                                         t_b.max_s, 0, "cuda")

    want = _port_grads(materialised, enc, pred, params, w)
    got = _port_grads(lambda e, p, pr: mt.rnnt_loss_fused_joint_banded(
        e, p, lb, il, sl, t_joint_banded, pr, bands=t_b, band_width=width,
        chunk_t=4), enc, pred, params, w)
    assert len(calls) == 6                    # 3 chunks forward, 3 backward
    _assert_match(got, want)


def test_fused_joint_banded_matches_full_lattice_with_same_bands():
    enc, pred, labels, ilen, slen, _, t_b, params = _banded_setup(seed=4)
    lb, il, sl = _t_args(labels, ilen, slen)
    width = mt.suggested_band_width(il, sl, t_b, enc.shape[1], pred.shape[1])
    assert bool(mt.band_layout_is_exact(il, sl, t_b, enc.shape[1],
                                        pred.shape[1], width).all())
    w = np.array([1.0, -0.5], np.float32)
    full = _port_grads(lambda e, p, pr: mt.rnnt_loss_fused_joint(
        e, p, lb, il, sl, t_joint, pr, chunk_t=5, bands=t_b), enc, pred,
        params, w)
    banded = _port_grads(lambda e, p, pr: mt.rnnt_loss_fused_joint_banded(
        e, p, lb, il, sl, t_joint_banded, pr, bands=t_b, band_width=width,
        chunk_t=3), enc, pred, params, w)
    _assert_match(banded, full)


def test_joint_params_from_numpy_carries_jax_arrays():
    _, _, _, _, _, params = _setup()
    j_params = {k: jnp.asarray(a) for k, a in params.items()}
    j_params["bv"] = j_params["bv"].astype(jnp.bfloat16)
    got = convert.joint_params_from_numpy(j_params, device="cpu")
    assert tuple(got) == KEYS and got["bv"].dtype == torch.bfloat16
    for k in KEYS:
        np.testing.assert_array_equal(
            got[k].float().numpy(), np.asarray(j_params[k], np.float32))
    got["we"].add_(1.0)                        # a copy, not a view
    np.testing.assert_array_equal(np.asarray(j_params["we"]), params["we"])
