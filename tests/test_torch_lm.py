"""The port's language models (models/lm.py) and LM shallow fusion in beam
search, against the JAX package's.

A flax ``LstmLm`` is initialised once per dtype and its parameters go
through ``convert.lstm_lm_params_from_flax``; the transducers share weights
as in tests/test_torch_decode.py. Tolerances: LM log-probs (teacher-forced
and stepwise) rtol 1e-4 / atol 1e-5 in float32 and 2e-2 (both) in bfloat16;
the port's own teacher-forced call against its steps 1e-5 / 1e-6 (f32);
fused beams: tokens and lengths equal, scores within rtol 1e-5; weight 0
is an exact identity.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monotonic_rnnt_tpu.models import lm as jlm
from monotonic_rnnt_tpu.models import transducer as jt
from monotonic_rnnt_tpu_torch import convert
from monotonic_rnnt_tpu_torch.models import lm as tlm

from torch_decode_pair import assert_beams_equal, batch, pair, t

V = 128                      # the beam cell's vocabulary
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}


@functools.lru_cache(maxsize=None)
def lm_pair(dtype="float32", vocab=V):
    """(flax LstmLm, its variables, the port's LstmLm with its weights)."""
    jcfg = jlm.LstmLmConfig(vocab_size=vocab, dim=32, embed_dim=16,
                            dtype=getattr(jnp, dtype))
    tcfg = tlm.LstmLmConfig(vocab_size=vocab, dim=32, embed_dim=16,
                            dtype=getattr(torch, dtype))
    jm = jlm.LstmLm(jcfg)
    variables = jm.init(jax.random.PRNGKey(5), jnp.zeros((2, 3), jnp.int32))
    tm = tlm.LstmLm(tcfg, device="cpu")
    tm.load_state_dict(convert.lstm_lm_params_from_flax(variables, tcfg,
                                                        device="cpu"))
    return jm, variables, tm


def tokens(b=3, s=5, seed=0):
    return np.random.RandomState(seed).randint(1, V, (b, s)).astype(np.int32)


def bigram_table(seed=0):
    return np.asarray(jax.nn.log_softmax(
        np.random.RandomState(seed).randn(V, V).astype(np.float32), axis=-1))


# --- the LMs ---------------------------------------------------------------------

def test_bigram_lm_protocol():
    table = bigram_table()
    lm = tlm.BigramLm(table, device="cpu")
    state = lm.init_state(3)
    assert state.dtype == torch.int32 and state.shape == (3,)
    state, logp = lm.step(state, torch.tensor([0, 5, 7]))
    assert torch.equal(state, torch.tensor([0, 5, 7], dtype=torch.int32))
    assert logp.dtype == torch.float32
    np.testing.assert_array_equal(logp.numpy(), table[[0, 5, 7]])
    with pytest.raises(ValueError, match="square"):
        tlm.BigramLm(np.zeros((4, 5), np.float32), device="cpu")
    with pytest.raises(ValueError, match="square"):
        tlm.BigramLm(np.zeros(4, np.float32), device="cpu")


def test_lstm_lm_defaults_are_jax_s():
    assert tlm.LstmLmConfig() == tlm.LstmLmConfig(
        vocab_size=1024, dim=256, embed_dim=128, dtype=torch.bfloat16)
    j = jlm.LstmLmConfig()
    assert (j.vocab_size, j.dim, j.embed_dim) == (1024, 256, 128)


def test_lstm_lm_teacher_forced_equals_its_steps():
    """tests/test_models.py::test_lstm_lm_stepwise_matches_teacher_forced on
    the port, from a seeded generator."""
    lm = tlm.LstmLm(tlm.LstmLmConfig(vocab_size=V, dim=32, embed_dim=16,
                                     dtype=torch.float32),
                    generator=torch.Generator().manual_seed(0), device="cpu")
    (tok,) = t(tokens())
    with torch.no_grad():
        batched = lm(tok)
        state = lm.init_state(3)
        hist = torch.cat([torch.zeros_like(tok[:, :1]), tok[:, :-1]], 1)
        for i in range(tok.shape[1]):
            state, logp = lm.step(state, hist[:, i])
            np.testing.assert_allclose(logp.numpy(), batched[:, i].numpy(),
                                       rtol=1e-5, atol=1e-6)
    assert batched.dtype == torch.float32 and batched.shape == (3, 5, V)
    assert not any(isinstance(m, torch.nn.LSTMCell) for m in lm.modules())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_lm_matches_jax(dtype):
    jm, variables, tm = lm_pair(dtype)
    rtol, atol = TOL[dtype]
    tok = tokens()
    want = jm.apply(variables, jnp.asarray(tok))
    with torch.no_grad():
        got = tm(*t(tok))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)
    j_state = jm.apply(variables, 3, method="init_state")
    state = tm.init_state(3)
    hist = np.concatenate([np.zeros((3, 1), np.int32), tok[:, :-1]], 1)
    for i in range(tok.shape[1]):
        j_state, j_logp = jm.apply(variables, j_state, jnp.asarray(hist[:, i]),
                                   method="step")
        with torch.no_grad():
            state, logp = tm.step(state, *t(hist[:, i]))
        np.testing.assert_allclose(logp.numpy(), np.asarray(j_logp),
                                   rtol=rtol, atol=atol, err_msg=f"step {i}")
        for got_c, want_c in zip(state, j_state):
            assert got_c.dtype == torch.float32
            np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                                       rtol=rtol, atol=atol)


def test_lm_converter_rejects_unknown_missing_and_misfit_leaves():
    _, variables, _ = lm_pair()
    params = jax.tree.map(np.asarray, variables["params"])
    cfg = tlm.LstmLmConfig(vocab_size=V, dim=32, embed_dim=16)
    extra = {**params, "proj": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(ValueError, match="proj/kernel"):
        convert.lstm_lm_params_from_flax(extra, cfg, device="cpu")
    missing = {k: v for k, v in params.items() if k != "out"}
    with pytest.raises(ValueError, match="'out'"):
        convert.lstm_lm_params_from_flax(missing, cfg, device="cpu")
    with pytest.raises(ValueError, match="embed.weight"):
        convert.lstm_lm_params_from_flax(
            params, tlm.LstmLmConfig(vocab_size=64, dim=32, embed_dim=16),
            device="cpu")


def test_module_lm_adapter():
    _, _, lm = lm_pair()
    lm.train()
    adapter = tlm.ModuleLmAdapter(lm)
    assert not lm.training
    state, logp = adapter.step(adapter.init_state(2),
                               torch.zeros(2, dtype=torch.int32))
    assert not logp.requires_grad and logp.shape == (2, V)
    with pytest.raises(TypeError, match="step"):
        tlm.ModuleLmAdapter(torch.nn.Linear(2, 2))


# --- shallow fusion ----------------------------------------------------------------

def lms(kind):
    """(JAX LM, the port's LM) with the same log-probs."""
    if kind == "bigram":
        table = bigram_table()
        return (jlm.BigramLm(jnp.asarray(table)),
                tlm.BigramLm(table, device="cpu"))
    jm, variables, tm = lm_pair()
    return jlm.FlaxLmAdapter(jm, variables), tlm.ModuleLmAdapter(tm)


def jax_beam(jm, params, feats, flen, k, **kw):
    return jax.jit(lambda p, f, fl: jm.apply(
        p, f, fl, 6, k, method=jt.MonotonicTransducer.beam_search_decode,
        **kw))(params, feats, flen)


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("lm_kind", ["bigram", "lstm"])
def test_lm_fusion_matches_jax(lm_kind, merge):
    jm, params, tm = pair()
    j_lm, lm = lms(lm_kind)
    feats, flen = batch(b=3, seed=2)[:2]
    flen = np.array([4, 24, 17], np.int32)
    want = jax_beam(jm, params, feats, flen, 4, merge_paths=merge, lm=j_lm,
                    lm_weight=0.7)
    got = tm.beam_search_decode(*t(feats, flen), 6, 4, merge_paths=merge,
                                lm=lm, lm_weight=0.7)
    assert_beams_equal(got, want)
    plain = tm.beam_search_decode(*t(feats, flen), 6, 4, merge_paths=merge)
    assert not torch.equal(got[2], plain[2])


@pytest.mark.parametrize("lm_kind", ["bigram", "lstm"])
def test_lm_fusion_at_weight_zero_is_the_identity(lm_kind):
    _, _, tm = pair()
    _, lm = lms(lm_kind)
    feats, flen = t(*batch(b=3, seed=2)[:2])
    want = tm.beam_search_decode(feats, flen, 6, 4)
    got = tm.beam_search_decode(feats, flen, 6, 4, lm=lm, lm_weight=0.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_lm_fusion_at_weight_zero_ignores_minus_inf_entries():
    """A sparse-count LM (most bigrams -inf): 0 * -inf would be NaN if
    fusion were not skipped."""
    _, _, tm = pair(seed=6)
    table = np.where(np.arange(V)[None, :] < 3, np.log(1 / 3.0),
                     -np.inf) * np.ones((V, 1))
    lm = tlm.BigramLm(table, device="cpu")
    feats, flen = t(*batch()[:2])
    want = tm.beam_search_decode(feats, flen, 6, 4)
    got = tm.beam_search_decode(feats, flen, 6, 4, lm=lm, lm_weight=0.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.isfinite(got[2][:, 0]).all()


def test_lm_fusion_biases_the_labels():
    """An LM that allows only token 5, weighted 5: every emitted label of
    the best beam is 5, its score finite, as JAX's."""
    jm, params, tm = pair(seed=3)
    only5 = np.broadcast_to(np.where(np.arange(V) == 5, 0.0, -40.0),
                            (V, V)).astype(np.float32)
    feats, flen = batch(b=3)[:2]
    got = tm.beam_search_decode(*t(feats, flen), 6, 4, lm=tlm.BigramLm(
        only5, device="cpu"), lm_weight=5.0)
    tok, n, score = got
    for b in range(3):
        assert (tok[b, 0, :n[b, 0]] == 5).all(), tok[b, 0]
    assert torch.isfinite(score[:, 0]).all() and int(n[:, 0].sum()) > 0
    assert_beams_equal(got, jax_beam(jm, params, feats, flen, 4,
                                     lm=jlm.BigramLm(jnp.asarray(only5)),
                                     lm_weight=5.0))


def test_beam_carry_must_match_its_lm():
    """The carry holds the LM's state only when an lm was given: passing
    another lm to a step than to the init raises, as in JAX."""
    _, _, tm = pair()
    _, lm = lms("bigram")
    feats, flen = t(*batch()[:2])
    with_lm = tm.streaming_beam_init(2, 15, 88, 6, 2, lm)
    without = tm.streaming_beam_init(2, 15, 88, 6, 2)
    chunk = feats[:, :8]
    with pytest.raises(ValueError, match="beam carry has 8 elements"):
        tm.streaming_beam_step(with_lm, chunk)
    with pytest.raises(ValueError, match="beam carry has 6 elements"):
        tm.streaming_beam_step(without, chunk, lm=lm, lm_weight=0.5)
    enc = torch.zeros(2, 32)
    active = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="pass the same `lm`"):
        tm._beam_frame_step(tm._beam_init_carry(2, 2, 6, lm), enc, active,
                            merge_paths=False, lm=None, lm_weight=0.0)
