"""The port's Conformer transducer against the JAX package's.

Each flax model is initialised once (``model.init(PRNGKey(0), ...)``) and
its parameters go through ``convert.transducer_params_from_flax`` into the
port's model on the CPU, where the loss takes its oracle and the kernel
wrappers their plain versions. The same numpy inputs (``tiny_batch``,
RandomState seeds) then go through both. Tolerances, float32 configs: module
outputs rtol 1e-4 / atol 1e-5 (another summation order in each matmul and
LayerNorm); transducer costs 1e-5 relative; each parameter's gradient a
relative L2 error of 1e-4; greedy hypotheses equal. bfloat16 configs:
costs 2e-2 relative (two frameworks round each bf16 layer apart).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monotonic_rnnt_tpu.models as jmodels
import monotonic_rnnt_tpu_torch as mt
import monotonic_rnnt_tpu_torch.models as tmodels
from monotonic_rnnt_tpu.data.synthetic import tiny_batch
from monotonic_rnnt_tpu.models import conformer as jc
from monotonic_rnnt_tpu.models import predictor as jp
from monotonic_rnnt_tpu.models import transducer as jt
from monotonic_rnnt_tpu.utils import metrics as jmetrics
from monotonic_rnnt_tpu_torch import convert
from monotonic_rnnt_tpu_torch.models import conformer as tc
from monotonic_rnnt_tpu_torch.models import predictor as tp
from monotonic_rnnt_tpu_torch.models import transducer as tt
from monotonic_rnnt_tpu_torch.utils import metrics as tmetrics
from monotonic_rnnt_tpu_torch.utils.status import RnntError

# An odd feature width, so that both SAME paddings run; V = 128, so that the
# embedding has 2048 entries for the init statistics.
FEAT, S, V = 15, 4, 128
WEIGHTS = np.array([1.5, -0.5], np.float32)   # one negative cotangent


def _configs(kind="lstm", causal=False, left=-1, dtype="float32"):
    """The same tiny config in both frameworks: 2 layers, dim 32."""
    def make(mod_c, mod_p, mod_t, dt):
        enc = mod_c.ConformerConfig(num_layers=2, dim=32, num_heads=2,
                                    dropout=0.0, causal=causal,
                                    attn_left_context=left, dtype=dt)
        pred = mod_p.PredictorConfig(vocab_size=V, dim=32, embed_dim=16,
                                     dtype=dt)
        return mod_t.TransducerConfig(encoder=enc, predictor=pred,
                                      joint_dim=32, vocab_size=V,
                                      predictor_kind=kind, dtype=dt)
    return (make(jc, jp, jt, getattr(jnp, dtype)),
            make(tc, tp, tt, getattr(torch, dtype)))


@functools.lru_cache(maxsize=None)
def _pair(kind="lstm", causal=False, left=-1, dtype="float32"):
    """(flax model, its params, the port's model with the same weights on
    the CPU): one JAX init per config, shared by the tests of a worker."""
    jcfg, tcfg = _configs(kind, causal, left, dtype)
    jm = jt.MonotonicTransducer(jcfg)
    params = jm.init(jax.random.PRNGKey(0), *_batch())
    tm = tt.MonotonicTransducer(tcfg, FEAT, device="cpu")
    tm.load_state_dict(convert.transducer_params_from_flax(params, tcfg,
                                                           device="cpu"))
    return jm, params, tm


def _batch(t=32, lengths=None, seed=0):
    feats, flen, labels, slen = tiny_batch(batch=2, t=t, feat_dim=FEAT, s=S,
                                           vocab=V, seed=seed)
    if lengths is not None:
        flen = np.asarray(lengths, np.int32)
    return feats, flen, labels, slen


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


# --- modules ---------------------------------------------------------------------

ENCODER_CASES = {  # (causal, attn_left_context, T, frame lengths)
    "even": (False, -1, 32, [32, 32]),
    "odd": (False, -1, 31, [31, 31]),
    "odd-odd": (False, -1, 29, [29, 29]),
    "padded": (False, -1, 32, [32, 27]),
    "causal-even": (True, -1, 32, [32, 27]),
    "causal-odd": (True, -1, 31, [31, 26]),
    "causal-window": (True, 2, 32, [32, 27]),
}


@pytest.mark.parametrize("case", list(ENCODER_CASES))
def test_encoder_matches_jax(case):
    causal, left, t, lengths = ENCODER_CASES[case]
    jm, params, tm = _pair(causal=causal, left=left)
    feats, flen, _, _ = _batch(t, lengths)
    want, want_len = jm.apply(params, feats, flen, method="encode")
    got, got_len = tm.encode(*_t(feats, flen))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    _close(got, want)


def _stepwise(predictor, labels):
    """ctx after consuming history[:k], for k = 0..S, by step()."""
    b = labels.shape[0]
    state = predictor.init_state(b)
    ctxs = []
    zeros = (jnp.zeros((b, 1), jnp.int32) if isinstance(labels, jax.Array)
             else torch.zeros((b, 1), dtype=labels.dtype))
    cat = jnp.concatenate if isinstance(labels, jax.Array) else torch.cat
    hist = cat([zeros, labels], 1)
    for k in range(labels.shape[1] + 1):
        state, ctx = predictor.step(state, hist[:, k])
        ctxs.append(ctx)
    return (jnp.stack if isinstance(labels, jax.Array) else torch.stack)(
        ctxs, 1)


@pytest.mark.parametrize("kind", ["lstm", "conv"])
def test_predictor_matches_jax_batched_and_stepwise(kind):
    jm, params, tm = _pair(kind)
    labels = np.random.RandomState(4).randint(1, V, (3, 5)).astype(np.int32)
    want = jm.apply(params, jnp.asarray(labels),
                    method=lambda m, lab: m.predictor(lab))
    want_steps = jm.apply(params, jnp.asarray(labels),
                          method=lambda m, lab: _stepwise(m.predictor, lab))
    (lab_t,) = _t(labels)
    got = tm.predictor(lab_t)
    got_steps = _stepwise(tm.predictor, lab_t)
    assert got.dtype == torch.float32 and got.shape == (3, 6, 32)
    _close(got, want)
    _close(got_steps, want_steps)


@pytest.mark.parametrize("kind", ["lstm", "conv"])
def test_predictor_step_matches_batched_call(kind):
    """tests/test_models.py::test_predictor_step_matches_batched_call on the
    port: ctx after consuming history[:k] == column k of the batched call."""
    cfg = tp.PredictorConfig(vocab_size=16, dim=32, embed_dim=16,
                             dtype=torch.float32)
    cls = tp.LstmPredictor if kind == "lstm" else tp.ConvPredictor
    model = cls(cfg, generator=torch.Generator().manual_seed(0),
                device="cpu")
    (labels,) = _t(np.random.RandomState(4).randint(1, 16, (3, 5))
                   .astype(np.int32))
    with torch.no_grad():
        np.testing.assert_allclose(_stepwise(model, labels).numpy(),
                                   model(labels).numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_joint_and_banded_joint_match_jax():
    jm, params, tm = _pair()
    rng = np.random.RandomState(5)
    enc = rng.randn(2, 7, 32).astype(np.float32)
    pred = rng.randn(2, S + 1, 32).astype(np.float32)
    pred_band = rng.randn(2, 7, 3, 32).astype(np.float32)
    want = jm.apply(params, enc, pred, method=lambda m, e, p: m.joint(e, p))
    want_band = jm.apply(params, enc, pred_band,
                         method=lambda m, e, p: m.joint.banded(e, p))
    enc_t, pred_t, band_t = _t(enc, pred, pred_band)
    got = tm.joint(enc_t, pred_t)
    assert got.dtype == torch.float32 and got.shape == (2, 7, S + 1, V)
    _close(got, want)
    _close(tm.joint.banded(enc_t, band_t), want_band)


# --- the transducer ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(kind):
    jm, params, _ = _pair(kind)
    feats, flen, labels, slen = _batch(lengths=[32, 27])
    weights = jnp.asarray(WEIGHTS)

    def total(p):
        costs = jm.apply(p, feats, flen, labels, slen)
        return jnp.sum(costs * weights), costs

    (_, costs), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        params)
    return np.asarray(costs), grads


def _port_costs_and_grads(kind, dtype="float32"):
    _, _, tm = _pair(kind, dtype=dtype)
    tm.zero_grad(set_to_none=True)
    costs = tm(*_t(*_batch(lengths=[32, 27])))
    (costs * torch.from_numpy(WEIGHTS)).sum().backward()
    return costs.detach(), {n: p.grad for n, p in tm.named_parameters()}


@pytest.mark.parametrize("kind", ["lstm", "conv"])
def test_transducer_costs_and_grads_match_jax(kind):
    want_c, want_g = _jax_value_and_grad(kind)
    got_c, got_g = _port_costs_and_grads(kind)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-5)
    _, tcfg = _configs(kind)
    want = convert.transducer_params_from_flax(want_g, tcfg, device="cpu")
    assert set(got_g) == set(want)
    for name, g in got_g.items():
        w = want[name].double()
        if name.endswith("mhsa.key.bias"):
            # Exactly 0: a bias on the keys adds q.b to a whole softmax row.
            # Both frameworks leave rounding noise (~1e-7), where a relative
            # error means nothing.
            assert float(g.norm()) < 1e-6 and float(w.norm()) < 1e-6, name
            continue
        err = float((g.double() - w).norm() / w.norm())
        assert err <= 1e-4, f"{name}: relative L2 error {err:.3g}"


@pytest.mark.parametrize("kind", ["lstm", "conv"])
def test_bf16_transducer_costs_match_jax(kind):
    jm, params, _ = _pair(kind, dtype="bfloat16")
    want_c = np.asarray(jax.jit(jm.apply)(params,
                                          *_batch(lengths=[32, 27])))
    got_c, got_g = _port_costs_and_grads(kind, "bfloat16")
    assert all(bool(torch.isfinite(g).all()) for g in got_g.values())
    assert all(g.dtype == torch.float32 for g in got_g.values())
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=2e-2)


@pytest.mark.parametrize("max_labels", [3, 8])
@pytest.mark.parametrize("kind", ["lstm", "conv"])
def test_greedy_decode_matches_jax(kind, max_labels):
    jm, params, tm = _pair(kind)
    feats, flen, _, _ = _batch(lengths=[32, 19], seed=2)
    want_h, want_n = jm.apply(params, feats, flen, max_labels,
                              method="greedy_decode")
    got_h, got_n = tm.greedy_decode(*_t(feats, flen), max_labels)
    assert got_h.dtype == torch.int32 and got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


def test_short_encoder_raises_where_jax_jit_scores_inf():
    """T'_b < S_b: 8 input frames leave 2 encoder frames for 4 labels. The
    JAX model under jit costs +inf (its length check skips traced lengths);
    the port is eager and raises (ROADMAP §3's recorded difference)."""
    jm, params, tm = _pair()
    batch = _batch(t=8)
    costs = jax.jit(jm.apply)(params, *batch)
    assert np.isposinf(np.asarray(costs)).all()
    with pytest.raises(RnntError, match="T_b >= S_b"):
        tm(*_t(*batch))


@pytest.mark.parametrize("route", ["full", "banded"])
def test_joint_is_the_fused_joint_losses_joint_fn(route):
    """Joint.joint_fn / banded_fn with joint_params() as the joint of
    rnnt_loss_fused_joint / rnnt_loss_fused_joint_banded (the default,
    unrestricted bands): the materialised model loss's costs, and its
    gradients of enc, pred and every joint parameter."""
    _, _, tm = _pair()
    feats, flen, labels, slen = _t(*_batch(lengths=[32, 27]))
    with torch.no_grad():
        enc, enc_len = tm.encode(feats, flen)
        pred = tm.predictor(labels)
    weights = torch.from_numpy(WEIGHTS)

    def step(loss_fn):
        e = enc.clone().requires_grad_(True)
        p = pred.clone().requires_grad_(True)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in tm.joint.joint_params().items()}
        costs = loss_fn(e, p, params)
        (costs * weights).sum().backward()
        return costs.detach(), [e.grad, p.grad] + [params[k].grad
                                                   for k in sorted(params)]

    args = (labels, enc_len, slen)
    want_c, want_g = step(lambda e, p, pr: mt.monotonic_rnnt_loss(
        tm.joint.joint_fn(pr, e, p), *args))
    if route == "full":
        got_c, got_g = step(lambda e, p, pr: mt.rnnt_loss_fused_joint(
            e, p, *args, tm.joint.joint_fn, pr, chunk_t=3))
    else:
        bands = mt.default_bands(enc_len, slen, enc.shape[1])
        width = mt.suggested_band_width(enc_len, slen, bands, enc.shape[1],
                                        S + 1)
        got_c, got_g = step(lambda e, p, pr: mt.rnnt_loss_fused_joint_banded(
            e, p, *args, tm.joint.banded_fn, pr, bands=bands,
            band_width=width, chunk_t=3))
    np.testing.assert_allclose(got_c.numpy(), want_c.numpy(), rtol=1e-5)
    for g, w in zip(got_g, want_g, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5)


# --- the port's counterparts of tests/test_models.py --------------------------------

def _tiny_cfg(vocab=32, dropout=0.0, **enc):
    """tests/test_models.py's _tiny_cfg (bf16 compute), in the port."""
    return tt.TransducerConfig(
        encoder=tc.ConformerConfig(num_layers=1, dim=64, num_heads=2,
                                   dropout=dropout, **enc),
        predictor=tp.PredictorConfig(vocab_size=vocab, dim=64, embed_dim=32),
        joint_dim=64, vocab_size=vocab)


def _tiny_model(cfg=None, seed=0):
    return tt.MonotonicTransducer(cfg or _tiny_cfg(), 16,
                                  generator=torch.Generator().manual_seed(seed),
                                  device="cpu")


def test_transducer_forward_loss():
    model = _tiny_model()
    costs = model(*_t(*tiny_batch(batch=2, t=32, feat_dim=16, s=4, vocab=32)))
    assert costs.shape == (2,) and costs.dtype == torch.float32
    assert bool(torch.isfinite(costs).all()) and bool((costs > 0).all())


def test_greedy_decode_shapes():
    model = _tiny_model()
    feats, flen, _, _ = _t(*tiny_batch(batch=2, t=32, feat_dim=16, s=4,
                                       vocab=32))
    hyp, n_hyp = model.greedy_decode(feats, flen, 6)
    assert hyp.shape == (2, 6) and hyp.dtype == torch.int32
    assert bool((n_hyp <= 6).all())


def test_causal_encoder_is_future_independent():
    """With causal=True, the encoder frames of the common prefix do not
    change when the future is replaced; the non-causal encoder's do."""
    def encoder(causal):
        cfg = tc.ConformerConfig(num_layers=2, dim=32, num_heads=2,
                                 dropout=0.0, causal=causal,
                                 dtype=torch.float32)
        return tc.ConformerEncoder(cfg, 16,
                                   generator=torch.Generator().manual_seed(0),
                                   device="cpu")

    rng = np.random.RandomState(0)
    t, cut = 64, 32
    a = rng.randn(1, t, 16).astype(np.float32)
    b = a.copy()
    b[0, cut:] = rng.randn(t - cut, 16)            # a different future
    a, b, flen = _t(a, b, np.array([t], np.int32))
    safe = cut // 4 - 1    # frames strictly inside the common prefix
    with torch.no_grad():
        causal = encoder(True)
        np.testing.assert_allclose(causal(a, flen)[0][:, :safe].numpy(),
                                   causal(b, flen)[0][:, :safe].numpy(),
                                   rtol=1e-5, atol=1e-5)
        full = encoder(False)
        assert float((full(a, flen)[0][:, :safe]
                      - full(b, flen)[0][:, :safe]).abs().max()) > 1e-4


def _dropout_step(remat=False, rate=0.1, seed=1, deterministic=False,
                  model=None):
    """Costs and every gradient of the tiny model with encoder dropout
    `rate`, its masks drawn from a generator seeded with `seed`."""
    batch = _t(*tiny_batch(batch=2, t=32, feat_dim=16, s=4, vocab=32))
    if model is None:
        model = _tiny_model(_tiny_cfg(remat=remat, dropout=rate))
    model.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(seed)
    costs = model(*batch, deterministic=deterministic, generator=gen)
    costs.mean().backward()
    return costs.detach(), [p.grad for p in model.parameters()]


def test_remat_encoder_same_loss_and_grads():
    """cfg.encoder.remat=True changes memory, not math: identical grads,
    also with dropout 0.1, whose recompute redraws the forward's masks from
    the generator (torch.utils.checkpoint restores only the global RNG)."""
    for rate in (0.0, 0.1):
        c0, g0 = _dropout_step(remat=False, rate=rate)
        c1, g1 = _dropout_step(remat=True, rate=rate)
        np.testing.assert_allclose(c0.numpy(), c1.numpy(), rtol=1e-6)
        for a, b in zip(g0, g1, strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_dropout_masks_come_from_the_callers_generator():
    """The same seed gives the same costs and gradients, another seed other
    ones; deterministic=True draws nothing (the no-dropout numbers); the
    global RNG is left as it was; and deterministic=False without a
    generator raises, where it would otherwise draw from the global RNG."""
    model = _tiny_model(_tiny_cfg(dropout=0.1))   # nn.Linear's init draws
    before = torch.random.get_rng_state()
    c1, g1 = _dropout_step(model=model)
    c1b, g1b = _dropout_step(model=model)
    c2, g2 = _dropout_step(seed=2, model=model)
    assert torch.equal(torch.random.get_rng_state(), before)
    assert torch.equal(c1, c1b)
    assert all(torch.equal(a, b) for a, b in zip(g1, g1b, strict=True))
    assert not torch.equal(c1, c2)
    assert any(not torch.equal(a, b) for a, b in zip(g1, g2, strict=True))
    c_det, _ = _dropout_step(deterministic=True)
    c_off, _ = _dropout_step(rate=0.0)
    assert torch.equal(c_det, c_off) and not torch.equal(c_det, c1)
    batch = _t(*tiny_batch(batch=2, t=32, feat_dim=16, s=4, vocab=32))
    with pytest.raises(ValueError, match="Generator"):
        _tiny_model(_tiny_cfg(dropout=0.1))(*batch, deterministic=False)


def test_dropout_keeps_flax_scaling():
    """A kept entry is x / (1 - rate), a dropped one 0, about rate of them
    dropped; rate 0 or deterministic returns x itself."""
    x = torch.full((200, 100), 3.0)
    y = tc.dropout(x, 0.25, False, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 4.0))
    assert abs(float((~kept).float().mean()) - 0.25) < 0.01
    assert tc.dropout(x, 0.0, False, None) is x
    assert tc.dropout(x, 0.5, True, None) is x


# --- parameters, the converter and the public names -------------------------------

def test_generator_init_is_reproducible_with_flax_statistics():
    """A model drawn from a torch.Generator seed is the same model every
    time, and each parameter has the distribution flax's default
    initialiser gives it: the same zeros and ones, the standard deviation
    within 10% of the flax model's (leaves of >= 2000 entries), every
    truncated-normal draw inside two of its standard deviations, and
    orthogonal recurrent gates."""
    jm, _, _ = _pair()
    _, cfg = _configs()
    a, b, other = (tt.MonotonicTransducer(
        cfg, FEAT, generator=torch.Generator().manual_seed(seed),
        device="cpu") for seed in (3, 3, 4))
    for (name, x), y, z in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               other.state_dict().values()):
        assert torch.equal(x, y), name
        assert torch.equal(x, z) == bool((x == x.flatten()[0]).all()), name
    flax_params = jm.init(jax.random.PRNGKey(1), *_batch())
    flax_state = convert.transducer_params_from_flax(flax_params, cfg,
                                                     device="cpu")
    for name, x in a.state_dict().items():
        ref = flax_state[name]
        if bool((ref == ref.flatten()[0]).all()):      # zeros or ones
            assert torch.equal(x, ref), name
            continue
        if x.numel() >= 2000:
            ratio = float(x.std() / ref.std())
            assert 0.9 < ratio < 1.1, f"{name}: std ratio {ratio:.3f}"
        if name.endswith("weight_hh"):
            for gate in x.split(32):
                assert torch.allclose(gate @ gate.T, torch.eye(32),
                                      atol=1e-5), name
        elif not name.endswith("embed.weight"):     # truncated normals
            fan_in = x[0].numel()
            bound = 2 * fan_in ** -0.5 / 0.87962566103423978
            assert float(x.abs().max()) <= bound * (1 + 1e-6), name


def test_generator_model_starts_at_the_tpu_runs_loss_scale():
    """examples/train_tiny.py's config and first batch (seed 5, B=8): the
    JAX model's first loss on the TPU was TRAIN_r05.json's loss_first,
    54.08. A port model drawn from a generator, at four seeds, starts at
    that scale: about what a joint giving every token 1/V costs here
    (T' log V - log C(T', S), ~55); logits of a wrong scale cost far more."""
    import json
    from pathlib import Path

    from monotonic_rnnt_tpu_torch.data import synthetic as tsyn

    record = Path(__file__).resolve().parent.parent / "TRAIN_r05.json"
    first = json.loads(record.read_text())["loss_first"]
    data = tsyn.SyntheticDataset(tsyn.SyntheticConfig(
        feat_dim=32, min_frames=32, max_frames=64, frames_per_label=10.0,
        vocab_size=64, seed=5), batch_size=8)
    batch = _t(*next(data.batches()))
    cfg = tt.TransducerConfig(
        encoder=tc.ConformerConfig(num_layers=2, dim=96, num_heads=4,
                                   dropout=0.0),
        predictor=tp.PredictorConfig(vocab_size=64, dim=96, embed_dim=48),
        joint_dim=96, vocab_size=64)
    for seed in range(4):
        model = tt.MonotonicTransducer(
            cfg, 32, generator=torch.Generator().manual_seed(seed),
            device="cpu")
        with torch.no_grad():
            loss = float(model(*batch).mean())
        assert 0.8 < loss / first < 1.25, f"seed {seed}: loss {loss:.2f}"


@pytest.mark.parametrize("kind", ["lstm", "conv"])
def test_port_parameters_are_the_flax_leaves_one_to_one(kind):
    """Module by module (the converter's table), the port's parameters hold
    exactly the flax leaves' elements: the same count per module, and every
    leaf and every parameter in one module pair. Each flax leaf is one
    parameter, but the LSTM stacks flax's 8 gate kernels and 4 gate biases
    into weight_ih, weight_hh and bias_hh (gates i, f, g, o): one bias, not
    nn.LSTMCell's two. So an optimiser holds the same moments."""
    _, params, tm = _pair(kind)
    _, tcfg = _configs(kind)
    leaves = {"/".join(str(k.key) for k in path): int(np.size(x))
              for path, x in jax.tree_util.tree_leaves_with_path(
                  params["params"])}
    named = {n: p.numel() for n, p in tm.named_parameters()}
    seen_leaves, seen_params = set(), set()
    for flax_mod, torch_mod, _ in convert._transducer_modules(tcfg):
        mine = [k for k in leaves if k.startswith(flax_mod + "/")]
        ours = [n for n in named if n.rsplit(".", 1)[0] == torch_mod]
        assert sum(leaves[k] for k in mine) == sum(named[n] for n in ours), (
            flax_mod, torch_mod)
        if torch_mod == "predictor.cell":
            assert sorted(n.rsplit(".", 1)[1] for n in ours) == [
                "bias_hh", "weight_hh", "weight_ih"] and len(mine) == 12
        else:
            assert len(ours) == len(mine), (flax_mod, ours, mine)
        seen_leaves.update(mine)
        seen_params.update(ours)
    assert seen_leaves == set(leaves) and seen_params == set(named)
    assert sum(named.values()) == sum(leaves.values())


def test_converter_rejects_params_the_config_does_not_name():
    _, params, _ = _pair()
    _, tcfg = _configs()
    one_layer = dataclasses.replace(
        tcfg, encoder=dataclasses.replace(tcfg.encoder, num_layers=1))
    with pytest.raises(ValueError, match="ConformerBlock_1"):
        convert.transducer_params_from_flax(params, one_layer, device="cpu")
    conv = dataclasses.replace(tcfg, predictor_kind="conv")
    with pytest.raises(ValueError, match="predictor/conv"):
        convert.transducer_params_from_flax(params, conv, device="cpu")


def test_models_export_the_jax_names():
    assert tmodels.__all__ == jmodels.__all__
    for name in tmodels.__all__:
        assert hasattr(tmodels, name)


# --- metrics ---------------------------------------------------------------------

def _sequences(seed):
    rng = np.random.RandomState(seed)
    b, n, m = 6, 7, 5
    hyp = rng.randint(0, 4, (b, n)).astype(np.int32)
    ref = rng.randint(0, 4, (b, m)).astype(np.int32)
    hlen = np.array([7, 0, 3, 7, 5, 2], np.int32)
    rlen = np.array([5, 4, 0, 5, 1, 2], np.int32)
    hyp[3, :5], ref[3] = ref[3], ref[3]     # an exact match, padded
    return hyp, hlen, ref, rlen


@pytest.mark.parametrize("seed", [0, 1])
def test_edit_distance_and_error_rate_match_jax(seed):
    args = _sequences(seed)
    want = jmetrics.edit_distance(*args)
    got = tmetrics.edit_distance(*_t(*args))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_r = jmetrics.error_rate(*args)
    got_r = tmetrics.error_rate(*_t(*args))
    np.testing.assert_array_equal(got_r.errors.numpy(),
                                  np.asarray(want_r.errors))
    np.testing.assert_array_equal(got_r.lengths.numpy(),
                                  np.asarray(want_r.lengths))
    assert got_r.rate.dtype == torch.float32
    np.testing.assert_allclose(float(got_r.rate), float(want_r.rate),
                               rtol=1e-6)
