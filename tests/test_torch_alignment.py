"""The port's Viterbi alignment and occupancy posteriors (ops/alignment.py)
against the JAX package's (monotonic_rnnt_tpu/ops/alignment.py): alignments
identical, scores 1e-5 relative, occupancies 1e-5 absolute."""

from itertools import combinations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monotonic_rnnt_tpu_torch as mt
from monotonic_rnnt_tpu.ops import alignment as jal
from monotonic_rnnt_tpu.ops import bands as jbands
from monotonic_rnnt_tpu_torch import convert
from monotonic_rnnt_tpu_torch.ops import alignment as tal
from monotonic_rnnt_tpu_torch.ops.cuda import kernels as tk

import golden


def _case(seed, b, t, s, v, shift=2, scale=2.0):
    """Variable lengths and a random feasible alignment's band."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, t, s + 1, v) * scale).astype(np.float32)
    labels = rng.randint(1, v, (b, s)).astype(np.int32)
    ilen = rng.randint(s + 1, t + 1, (b,)).astype(np.int32)
    slen = rng.randint(1, s + 1, (b,)).astype(np.int32)
    align = np.zeros((b, t), np.int32)
    for i in range(b):
        pos = np.sort(rng.choice(ilen[i], size=slen[i], replace=False))
        align[i, pos] = labels[i, :slen[i]]
    jb = jbands.bands_from_alignment(jnp.asarray(align), jnp.asarray(ilen),
                                     jnp.asarray(slen), shift, 0)
    w = int(jbands.required_band_width(jnp.asarray(ilen), jnp.asarray(slen),
                                       jb, t, s + 1))
    return logits, labels, ilen, slen, jb, w


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _assert_viterbi(got, want):
    np.testing.assert_array_equal(got.alignment.numpy(),
                                  np.asarray(want.alignment))
    assert got.alignment.dtype == torch.int32
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                               rtol=1e-5, atol=1e-6)


@pytest.fixture(params=["oracle", "kernels"])
def route(request, monkeypatch):
    """'kernels' drives the CUDA route's glue on CPU tensors, where the
    kernel wrappers take their plain versions."""
    if request.param == "kernels":
        monkeypatch.setattr(tal, "_use_kernels", lambda x: True)
    return request.param


@pytest.mark.parametrize("banded_search", [False, True])
def test_viterbi_matches_jax(route, banded_search):
    logits, labels, ilen, slen, jb, _ = _case(8, 3, 22, 7, 13)
    j_args = tuple(jnp.asarray(a) for a in (logits, labels, ilen, slen))
    kw = {"bands": jb} if banded_search else {}
    want = jal.viterbi_alignment(*j_args, **kw)
    t_kw = ({"bands": convert.bands_from_numpy(*jb, device="cpu")}
            if banded_search else {})
    got = mt.viterbi_alignment(*_t(logits, labels, ilen, slen), **t_kw)
    _assert_viterbi(got, want)
    # Padding frames are blank; the emitted labels spell each target.
    align = got.alignment.numpy()
    for b in range(3):
        assert (align[b, ilen[b]:] == 0).all()
        active = align[b, :ilen[b]]
        np.testing.assert_array_equal(active[active != 0],
                                      labels[b, :slen[b]])


def test_banded_viterbi_matches_jax_and_the_full_lattice(route):
    logits, labels, ilen, slen, jb, w = _case(8, 3, 22, 7, 13)
    layout = jbands.compute_band_layout(jnp.asarray(ilen), jnp.asarray(slen),
                                        jb, 22, 8, w)
    lb = np.asarray(jbands.pack_band(jnp.asarray(logits), layout))
    want = jal.viterbi_alignment_banded(
        *(jnp.asarray(a) for a in (lb, labels, ilen, slen)), bands=jb)
    bands = convert.bands_from_numpy(*jb, device="cpu")
    got = mt.viterbi_alignment_banded(*_t(lb, labels, ilen, slen),
                                      bands=bands)
    _assert_viterbi(got, want)
    full = mt.viterbi_alignment(*_t(logits, labels, ilen, slen), bands=bands)
    assert torch.equal(got.alignment, full.alignment)
    np.testing.assert_allclose(got.score.numpy(), full.score.numpy(),
                               rtol=1e-5)


def test_banded_viterbi_with_a_clipped_band_matches_jax(route):
    # A band narrower than required: both search the clipped band.
    logits, labels, ilen, slen, jb, w = _case(12, 2, 18, 6, 9, shift=3)
    w = max(2, w - 2)
    layout = jbands.compute_band_layout(jnp.asarray(ilen), jnp.asarray(slen),
                                        jb, 18, 7, w)
    lb = np.asarray(jbands.pack_band(jnp.asarray(logits), layout))
    want = jal.viterbi_alignment_banded(
        *(jnp.asarray(a) for a in (lb, labels, ilen, slen)), bands=jb)
    got = mt.viterbi_alignment_banded(
        *_t(lb, labels, ilen, slen),
        bands=convert.bands_from_numpy(*jb, device="cpu"))
    np.testing.assert_array_equal(got.alignment.numpy(),
                                  np.asarray(want.alignment))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                               rtol=1e-5)


@pytest.mark.parametrize("with_bands", [False, True])
def test_occupancy_matches_jax(route, with_bands):
    logits, labels, ilen, slen, jb, _ = _case(9, 2, 18, 5, 9, scale=1.0)
    j_args = tuple(jnp.asarray(a) for a in (logits, labels, ilen, slen))
    kw = {"bands": jb} if with_bands else {}
    want = np.asarray(jal.occupancy_posteriors(*j_args, **kw))
    t_kw = ({"bands": convert.bands_from_numpy(*jb, device="cpu")}
            if with_bands else {})
    got = mt.occupancy_posteriors(*_t(logits, labels, ilen, slen), **t_kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    occ = got.numpy()
    for b in range(2):
        np.testing.assert_allclose(occ[b, :ilen[b]].sum(-1), 1.0, rtol=1e-5)
        assert (occ[b, ilen[b]:] == 0).all()


def test_banded_occupancy_matches_jax(route):
    logits, labels, ilen, slen, jb, w = _case(9, 2, 18, 5, 9, scale=1.0)
    layout = jbands.compute_band_layout(jnp.asarray(ilen), jnp.asarray(slen),
                                        jb, 18, 6, w)
    lb = np.asarray(jbands.pack_band(jnp.asarray(logits), layout))
    want = np.asarray(jal.occupancy_posteriors_banded(
        *(jnp.asarray(a) for a in (lb, labels, ilen, slen)), bands=jb))
    got = mt.occupancy_posteriors_banded(
        *_t(lb, labels, ilen, slen),
        bands=convert.bands_from_numpy(*jb, device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _brute_force_best(probs, labels):
    """All C(T, S) monotonic paths; (best alignment, its log-probability)."""
    t_max = probs.shape[0]
    best_lp, best = -np.inf, None
    for frames in combinations(range(t_max), len(labels)):
        lp, s, align = 0.0, 0, []
        for t in range(t_max):
            if s < len(labels) and t == frames[s]:
                lp += np.log(probs[t, s, labels[s]])
                align.append(int(labels[s]))
                s += 1
            else:
                lp += np.log(probs[t, s, 0])
                align.append(0)
        if lp > best_lp:
            best_lp, best = lp, align
    return np.asarray(best, np.int32), best_lp


def test_viterbi_matches_brute_force_readme(route):
    logits, labels, ilen, slen = golden.readme_batch()
    res = mt.viterbi_alignment(*_t(logits, labels, ilen, slen))
    exp_align, exp_lp = _brute_force_best(golden.README_PROBS,
                                          golden.README_LABELS)
    np.testing.assert_array_equal(res.alignment[0].numpy(), exp_align)
    np.testing.assert_allclose(float(res.score[0]), -exp_lp, atol=1e-5)
    # The score is the path's own restricted loss at shift 0 (and >= the
    # loss), and shift 0 around ALIGN_B leaves exactly that path.
    t_args = _t(logits, labels, ilen, slen)
    own = mt.monotonic_rnnt_alignment_score(*t_args, res.alignment)
    np.testing.assert_allclose(res.score.numpy(), own.numpy(), atol=1e-5)
    assert float(res.score[0]) >= float(mt.monotonic_rnnt_loss(*t_args)[0])
    bands = mt.bands_from_alignment(torch.from_numpy(golden.ALIGN_B[None]),
                                    t_args[2], t_args[3], 0, 0)
    pinned = mt.viterbi_alignment(*t_args, bands=bands)
    np.testing.assert_array_equal(pinned.alignment[0].numpy(), golden.ALIGN_B)
    np.testing.assert_allclose(float(pinned.score[0]), -np.log(0.0672),
                               atol=1e-3)


def test_viterbi_on_the_cpu_launches_nothing():
    logits, labels, ilen, slen, _, _ = _case(1, 2, 10, 3, 7)
    before = dict(tk.LAUNCHES)
    mt.viterbi_alignment(*_t(logits, labels, ilen, slen))
    mt.occupancy_posteriors(*_t(logits, labels, ilen, slen))
    assert tk.LAUNCHES == before
