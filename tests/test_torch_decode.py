"""The port's beam search and chunked streaming against the JAX package's.

Both frameworks hold the same weights (``tests/torch_decode_pair.py``); the
same numpy inputs go through the JAX model (jitted, on the CPU) and the
port's (on the CPU). Tolerances, float32: tokens, lengths and emitted ids
equal; the beam's fingerprint ``hseq`` equal bit for bit; scores within
rtol 1e-5 (-inf where JAX's are). Port-only properties (K=1 equals greedy,
a wider beam is never worse, merged mass under the loss's marginal) hold
as in tests/test_models.py; the marginal bound is 1e-4 nats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monotonic_rnnt_tpu.models import transducer as jt
from monotonic_rnnt_tpu.models.conformer import streaming_lookback
from monotonic_rnnt_tpu.models.lm import BigramLm as JaxBigramLm
from monotonic_rnnt_tpu_torch import monotonic_rnnt_loss
from monotonic_rnnt_tpu_torch.models import transducer as tt
from monotonic_rnnt_tpu_torch.models.lm import BigramLm

from torch_decode_pair import assert_beams_equal, batch, pair, t

JBeam = jt.MonotonicTransducer.beam_search_decode
DEC_FLEN = np.array([4, 24], np.int32)   # sample 0: one encoder frame


def jax_beam(jm, params, feats, flen, cap, k, **kw):
    return jax.jit(lambda p, f, fl: jm.apply(
        p, f, fl, cap, k, method=JBeam, **kw))(params, feats, flen)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "conv"])
def test_beam_search_matches_jax(kind, merge, k):
    """Frozen frames (sample 0 ends after one frame) and, with merging,
    killed duplicates are on the path."""
    jm, params, tm = pair(kind)
    feats = batch()[0]
    want = jax_beam(jm, params, feats, DEC_FLEN, 6, k, merge_paths=merge)
    got = tm.beam_search_decode(*t(feats, DEC_FLEN), 6, k,
                                merge_paths=merge)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.float32
    assert_beams_equal(got, want)


@pytest.mark.parametrize("merge", [False, True])
def test_dead_beams_match_jax_and_write_no_tokens(merge):
    """A sample with no frame keeps one live beam: its other slots stay
    -inf, copy the same parent as JAX's and write no token."""
    jm, params, tm = pair()
    feats = batch(b=3)[0]
    flen = np.array([0, 4, 24], np.int32)
    want = jax_beam(jm, params, feats, flen, 6, 3, merge_paths=merge)
    got = tm.beam_search_decode(*t(feats, flen), 6, 3, merge_paths=merge)
    assert_beams_equal(got, want)
    tok, n, score = (x.numpy() for x in got)
    dead = ~np.isfinite(score)
    assert dead[0, 1:].all()
    assert (n[dead] == 0).all() and (tok[dead] == 0).all()


def test_top_k_breaks_ties_as_lax_top_k():
    """The beam's selection on rows full of ties (where torch.topk's order
    differs on the CPU) and on a row of -inf but one entry."""
    x = np.random.RandomState(0).randint(0, 3, (16, 4096)).astype(np.float32)
    x[0] = -np.inf
    x[0, 7] = 0.0
    values, idx = tt._top_k(torch.from_numpy(x), 4)
    want_v, want_i = jax.lax.top_k(x, 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_v))
    assert idx[0].tolist() == [7, 0, 1, 2]


@pytest.mark.parametrize("kind", ["lstm", "conv"])
def test_beam1_equals_greedy(kind):
    _, _, tm = pair(kind)
    feats, flen = t(*batch(b=3, seed=1)[:2])
    hyp, n = tm.greedy_decode(feats, flen, 6)
    tok, n_b, score = tm.beam_search_decode(feats, flen, 6, 1)
    assert torch.equal(tok[:, 0], hyp) and torch.equal(n_b[:, 0], n)
    assert torch.isfinite(score).all()


def test_wider_beam_never_worse():
    _, _, tm = pair(seed=1)
    feats, flen = t(*batch(b=3)[:2])
    s1 = tm.beam_search_decode(feats, flen, 6, 1)[2]
    tok, n, s4 = tm.beam_search_decode(feats, flen, 6, 4)
    assert (s4[:, 0] >= s1[:, 0] - 1e-5).all()
    assert (torch.diff(s4, dim=1) <= 1e-6).all()     # best-first
    assert (n <= 6).all()


def test_beam_size_must_fit_the_vocabulary():
    _, _, tm = pair()
    feats, flen = t(*batch()[:2])
    for k in (0, 129):
        with pytest.raises(ValueError, match="beam_size"):
            tm.beam_search_decode(feats, flen, 6, k)


def test_path_merging_stays_under_the_marginal():
    """tests/test_models.py::test_beam_search_path_merging_recovers_marginal
    on the port (V = 128 for the shared weights): the merged mass dominates
    the best single path, is a log-prob, equals JAX's, and stays at or
    under the decoded sequence's marginal (-loss on the model's own
    logits), within 3 nats of it."""
    jm, params, tm = pair()
    feats, flen = batch(t=16)[:2]
    tf, tl = t(feats, flen)
    _, _, s_path = tm.beam_search_decode(tf, tl, 3, 8)
    got = tm.beam_search_decode(tf, tl, 3, 8, merge_paths=True)
    assert_beams_equal(got, jax_beam(jm, params, feats, flen, 3, 8,
                                     merge_paths=True))
    tok_m, n_m, s_merged = got
    assert (s_merged[:, 0] >= s_path[:, 0] - 1e-5).all()
    assert (s_merged[:, 0] <= 1e-5).all()
    checked = 0
    for b in range(2):
        nb = int(n_m[b, 0])
        if nb == 0:
            continue
        seq = tok_m[b:b + 1, 0, :nb]
        with torch.no_grad():
            logits, el = tm.logits(tf[b:b + 1], tl[b:b + 1], seq)
            cost = monotonic_rnnt_loss(logits, seq, el,
                                       torch.tensor([nb], dtype=torch.int32))
        marginal = -float(cost[0])
        assert float(s_merged[b, 0]) <= marginal + 1e-4, (marginal, s_merged)
        assert float(s_merged[b, 0]) >= marginal - 3.0, (marginal, s_merged)
        checked += 1
    assert checked


# --- streaming -------------------------------------------------------------------

STREAM_T, STREAM_C, STREAM_F_LEN = 128, 16, [128, 115]


def stream_inputs(seed=3):
    rng = np.random.RandomState(seed)
    feats = rng.randn(2, STREAM_T, 15).astype(np.float32)
    return feats, np.asarray(STREAM_F_LEN, np.int32)


def chunks(flen):
    for i in range(0, STREAM_T, STREAM_C):
        yield i, np.clip(flen - i, 0, STREAM_C).astype(np.int32)


@pytest.mark.parametrize("kind", ["lstm", "conv"])
def test_streaming_greedy_matches_jax_and_the_full_decode(kind):
    """T = 128 > lookback = 88: the window's truncation, s0 > 0, a nonzero
    pos_offset and the content roll all run."""
    jm, params, tm = pair(kind, "stream")
    feats, flen = stream_inputs()
    lookback = streaming_lookback(jm.cfg.encoder)
    assert lookback == 88 < STREAM_T
    cap = 24
    j_state = jm.apply(params, 2, 15, lookback, cap, method="streaming_init")
    j_step = jax.jit(lambda p, st, ch, cv: jm.apply(
        p, st, ch, cv, method="streaming_step"))
    state = tm.streaming_init(2, 15, lookback, cap)
    for i, cv in chunks(flen):
        j_state, j_emitted = j_step(params, j_state, feats[:, i:i + 16], cv)
        state, emitted = tm.streaming_step(state, *t(feats[:, i:i + 16], cv))
        np.testing.assert_array_equal(emitted.numpy(), np.asarray(j_emitted),
                                      err_msg=f"chunk at frame {i}")
        assert state["n_seen"] == int(j_state["n_seen"]) == i + STREAM_C
    hyp, n = tm.greedy_decode(*t(feats, flen), cap)
    for got, want in ((state["hyp"], j_state["hyp"]),
                      (state["n_hyp"], j_state["n_hyp"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(state["hyp"], hyp) and torch.equal(state["n_hyp"], n)
    assert int(n.sum()) > 0


def test_streaming_beam_with_an_lm_matches_jax():
    """Each chunk's beam equals JAX's, the carry's fingerprint bit for bit,
    and the last chunk's beam the port's full-utterance beam search."""
    jm, params, tm = pair("lstm", "stream")
    feats, flen = stream_inputs(seed=7)
    table = np.asarray(jax.nn.log_softmax(
        np.random.RandomState(7).randn(32, 32).astype(np.float32), axis=-1))
    j_lm, lm = JaxBigramLm(jnp.asarray(table)), BigramLm(table, device="cpu")
    lookback = streaming_lookback(jm.cfg.encoder)
    cap, k, w = 10, 4, 0.5
    j_state = jm.apply(params, 2, 15, lookback, cap, k, j_lm,
                       method="streaming_beam_init")
    j_step = jax.jit(lambda p, st, ch, cv: jm.apply(
        p, st, ch, cv, j_lm, w, method="streaming_beam_step"))
    state = tm.streaming_beam_init(2, 15, lookback, cap, k, lm)
    assert len(state["beam"]) == 8
    emitted = 0
    for i, cv in chunks(flen):
        j_state, j_beam = j_step(params, j_state, feats[:, i:i + 16], cv)
        state, beam = tm.streaming_beam_step(
            state, *t(feats[:, i:i + 16], cv), lm=lm, lm_weight=w)
        assert_beams_equal(beam, j_beam)
        j_hseq = np.asarray(j_state["beam"][3])
        assert j_hseq.dtype == np.uint32
        np.testing.assert_array_equal(state["beam"][3].numpy(),
                                      j_hseq.astype(np.int64))
        emitted = max(emitted, int(beam[1].max()))
    assert emitted > 1               # the hash has taken several steps
    full = tm.beam_search_decode(*t(feats, flen), cap, k, lm=lm, lm_weight=w)
    for got, want in zip(beam, full):
        assert torch.equal(got, want)


def test_streaming_rejects_a_lookback_or_chunk_off_the_subsampling():
    _, _, tm = pair("lstm", "stream")
    with pytest.raises(ValueError, match="lookback 90"):
        tm.streaming_init(2, 15, 90, 8)
    with pytest.raises(ValueError, match="lookback 6"):
        tm.streaming_beam_init(2, 15, 6, 8, 2)
    state = tm.streaming_init(2, 15, 88, 8)
    with pytest.raises(ValueError, match="chunk frames 10"):
        tm.streaming_step(state, torch.zeros(2, 10, 15))
    beam_state = tm.streaming_beam_init(2, 15, 88, 8, 2)
    with pytest.raises(ValueError, match="chunk frames 6"):
        tm.streaming_beam_step(beam_state, torch.zeros(2, 6, 15))


def test_streaming_step_leaves_its_input_state_alone():
    _, _, tm = pair("conv", "stream")
    feats, flen = stream_inputs()
    state = tm.streaming_init(2, 15, 88, 8)
    before = {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}
    copies = {k: v.clone() for k, v in before.items()}
    tm.streaming_step(state, *t(feats[:, :16], flen.clip(max=16)))
    assert state["n_seen"] == 0
    for k, v in before.items():
        assert state[k] is v and torch.equal(v, copies[k])
