"""The PyTorch port's helpers, bands and input validation against the JAX package."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monotonic_rnnt_tpu.ops import bands as jbands
from monotonic_rnnt_tpu.ops import helpers as jhelpers
from monotonic_rnnt_tpu.utils import status as jstatus
from monotonic_rnnt_tpu_torch.ops import bands as tbands
from monotonic_rnnt_tpu_torch.ops import helpers as thelpers
from monotonic_rnnt_tpu_torch.utils import status as tstatus

SPECIALS = [-np.inf, np.inf, 0.0, -1.0, 3.5, -1e30, 88.0]


def _pairs():
    special = np.array(list(itertools.product(SPECIALS, SPECIALS)), np.float32)
    rng = np.random.RandomState(0)
    finite = (rng.randn(200, 2) * 20).astype(np.float32)
    return special[:, 0], special[:, 1], finite[:, 0], finite[:, 1]


@pytest.mark.parametrize("name", ["log_sum_exp", "log_diff_exp"])
def test_log_space_pairs_match_jax(name):
    a_sp, b_sp, a_fin, b_fin = _pairs()
    if name == "log_diff_exp":  # defined for a >= b
        a_fin, b_fin = np.maximum(a_fin, b_fin), np.minimum(a_fin, b_fin)
    jfn, tfn = getattr(jhelpers, name), getattr(thelpers, name)
    with np.errstate(invalid="ignore"):
        # +-inf pairs (and the NaN of an undefined pair) exactly.
        np.testing.assert_array_equal(
            tfn(torch.from_numpy(a_sp), torch.from_numpy(b_sp)).numpy(),
            np.asarray(jfn(jnp.asarray(a_sp), jnp.asarray(b_sp))))
    # Finite pairs to a few ulp: XLA's and torch's CPU exp/log1p may round
    # the last bit differently.
    np.testing.assert_allclose(
        tfn(torch.from_numpy(a_fin), torch.from_numpy(b_fin)).numpy(),
        np.asarray(jfn(jnp.asarray(a_fin), jnp.asarray(b_fin))),
        rtol=1e-6, atol=1e-6)


def test_log_sum_exp_of_two_neg_inf_is_neg_inf():
    out = thelpers.log_sum_exp(torch.tensor([-np.inf]), torch.tensor([-np.inf]))
    assert out.item() == -np.inf


def _case(seed, batch=4, t_max=11, s_max=5, blank=0):
    rng = np.random.RandomState(seed)
    ilen = rng.randint(s_max, t_max + 1, size=batch).astype(np.int32)
    slen = rng.randint(0, s_max + 1, size=batch).astype(np.int32)
    labels = rng.randint(1, 9, size=(batch, s_max)).astype(np.int32)
    align = np.full((batch, t_max), blank, np.int32)
    for b in range(batch):
        frames = np.sort(rng.choice(ilen[b], size=slen[b], replace=False))
        align[b, frames] = labels[b, :slen[b]]
    return labels, ilen, slen, align


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


@pytest.mark.parametrize("seed", [0, 1])
def test_extend_labels_matches_jax(seed):
    labels, ilen, slen, _ = _case(seed)
    (jl, js), (tl, ts) = _both(labels, slen)
    s1 = labels.shape[1] + 1
    got = thelpers.extend_labels(tl, ts, s1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jhelpers.extend_labels(jl, js, s1)))


@pytest.mark.parametrize("seed,shift", [(0, 0), (1, 1), (2, 3), (3, 20)])
def test_bands_windows_and_masks_match_jax(seed, shift):
    labels, ilen, slen, align = _case(seed)
    t_max, s1 = align.shape[1], labels.shape[1] + 1
    (ja, ji, js), (ta, ti, ts) = _both(align, ilen, slen)
    cases = [
        (jbands.default_bands(ji, js, t_max),
         tbands.default_bands(ti, ts, t_max)),
        (jbands.bands_from_alignment(ja, ji, js, shift, 0),
         tbands.bands_from_alignment(ta, ti, ts, shift, 0)),
    ]
    for jb, tb in cases:
        for j_arr, t_arr in zip(jb, tb):
            assert t_arr.dtype == torch.int32
            np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))
        for j_arr, t_arr in zip(
                jbands._window_bounds(ji, js, jb, t_max, s1),
                tbands._window_bounds(ti, ts, tb, t_max, s1)):
            np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))
        for j_arr, t_arr in zip(jbands.lattice_masks(ji, js, jb, t_max, s1),
                                tbands.lattice_masks(ti, ts, tb, t_max, s1)):
            assert t_arr.dtype == torch.bool
            np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))


def _valid():
    return (np.zeros((2, 5, 3, 7), np.float32), np.ones((2, 2), np.int32),
            np.array([5, 3], np.int32), np.array([2, 1], np.int32))


def _bad_inputs():
    lg, lb, il, sl = _valid()
    yield "logits_3d", (lg[0], lb, il, sl)
    yield "zero_dim", (np.zeros((2, 0, 3, 7), np.float32), lb, il, sl)
    yield "labels_batch", (lg, lb[:1], il, sl)
    yield "labels_narrow", (lg, lb[:, :1], il, sl)
    yield "ilen_shape", (lg, lb, il[:1], sl)
    yield "slen_float", (lg, lb, il, sl.astype(np.float32))
    yield "ilen_zero", (lg, lb, np.array([0, 3], np.int32), sl)
    yield "slen_negative", (lg, lb, il, np.array([-1, 1], np.int32))
    yield "ilen_below_slen", (lg, lb, np.array([5, 1], np.int32),
                              np.array([2, 2], np.int32))
    yield "ilen_above_tmax", (lg, lb, np.array([6, 3], np.int32), sl)
    yield "slen_above_smax", (lg, lb, np.array([5, 3], np.int32),
                              np.array([3, 1], np.int32))


@pytest.mark.parametrize("name,args", list(_bad_inputs()),
                         ids=[n for n, _ in _bad_inputs()])
def test_validate_loss_inputs_raises_like_jax(name, args):
    jargs, targs = _both(*args)
    with pytest.raises(jstatus.RnntError) as jexc:
        jstatus.validate_loss_inputs(*jargs)
    with pytest.raises(tstatus.RnntError) as texc:
        tstatus.validate_loss_inputs(*targs)
    assert texc.value.status.name == jexc.value.status.name
    assert texc.value.status.value == jexc.value.status.value
    assert str(texc.value) == str(jexc.value)


def test_validate_loss_inputs_accepts_valid():
    _, targs = _both(*_valid())
    tstatus.validate_loss_inputs(*targs)
