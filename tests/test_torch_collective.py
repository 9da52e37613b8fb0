"""The vocab-sharded losses' building blocks against the JAX package's.

``softmax_stats_partial``'s plain version against the Pallas kernel in
interpret mode (tests/test_pallas.py's case), its all -inf row convention,
the gradient assemblies with ``v_offset`` against JAX's, ``grad_pass`` on a
vocab shard with relative ids, and the collective statistics on a group of
one process against the unsharded ones. CPU tensors, where the kernel
wrappers take their plain versions. Tolerances: m exactly; se of both
packages against a float64 truth, bounded by the f32 rounding of its
200-term sum (see the test); gradients 1e-6 relative (the same
arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from monotonic_rnnt_tpu.ops.banded import band_gradients as j_band_gradients
from monotonic_rnnt_tpu.ops.pallas.kernels import \
    softmax_stats_partial as j_partial
from monotonic_rnnt_tpu.ops.reference import \
    gradients_from_coefficients as j_gradients
from monotonic_rnnt_tpu_torch.ops import banded as tbanded
from monotonic_rnnt_tpu_torch.ops import collective
from monotonic_rnnt_tpu_torch.ops import reference as tref
from monotonic_rnnt_tpu_torch.ops.cuda import kernels as K
from monotonic_rnnt_tpu_torch.ops.cuda import split_kernels as SK
from monotonic_rnnt_tpu_torch.ops.helpers import extend_labels


def _partial_case():
    rng = np.random.RandomState(2)
    return rng.randn(2, 8, 5, 200).astype(np.float32) * 3


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("tiles", [None, (8, 128)], ids=["auto", "8x128"])
def test_partial_stats_plain_matches_pallas(tiles, bf16):
    x = _partial_case()
    xj = jnp.asarray(x)
    xt = torch.from_numpy(x)
    if bf16:
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    m_j, se_j = j_partial(xj, interpret=True, tiles=tiles)
    m_t, se_t = SK.softmax_stats_partial(xt)       # CPU: the plain version
    assert m_t.dtype == se_t.dtype == torch.float32
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    # Both against a float64 truth on the same (rounded) inputs. An f32 sum
    # of n positive terms rounds by at most (n - 1) half-ulps in all; each
    # term adds exp's own error (an ulp or two) and the rounding of x - m
    # in its exponent (|x - m| <= 2^5 here: 2^5 half-ulps). Two ulps a term,
    # over the n = 200 terms, bounds the lot: 200 * 2 * 2^-23 = 4.8e-5.
    x64 = xt.double().numpy()
    m64 = x64.max(axis=-1)
    se64 = np.exp(x64 - m64[..., None]).sum(axis=-1)
    assert float((m64 - x64.min(axis=-1)).max()) <= 2 ** 5
    bound = x.shape[-1] * 2 * 2.0 ** -23
    for se in (se_t.numpy(), np.asarray(se_j)):
        np.testing.assert_allclose(se, se64, rtol=bound)


def test_partial_stats_all_neg_inf_row():
    """The port's deliberate difference: an all -inf row gives m = -inf and
    se = 0 (the Pallas kernel gives se = NaN: -inf - -inf)."""
    x = _partial_case()[:, :, :, :70]
    x[0, 3, 2] = -np.inf
    x[1, :, 4] = -np.inf
    m, se = SK.softmax_stats_partial_plain(torch.from_numpy(x))
    assert m[0, 3, 2] == -np.inf and se[0, 3, 2] == 0
    assert bool((m[1, :, 4] == -np.inf).all()) and bool((se[1, :, 4] == 0).all())
    m_j, se_j = j_partial(jnp.asarray(x), interpret=True)
    assert np.isnan(np.asarray(se_j)[0, 3, 2])
    finite = np.isfinite(np.asarray(m_j))
    np.testing.assert_array_equal(m.numpy()[finite], np.asarray(m_j)[finite])
    np.testing.assert_allclose(se.numpy()[finite], np.asarray(se_j)[finite],
                               rtol=1e-5)


def _coefficients(seed, shape):
    rng = np.random.RandomState(seed)
    return [np.where(rng.rand(*shape) < 0.3, 0.0,
                     rng.randn(*shape)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("v_offset", [0, 8, 16])
def test_gradients_from_coefficients_v_offset_matches_jax(v_offset):
    rng = np.random.RandomState(5)
    b, t, s, v_local = 2, 6, 3, 8
    logits = rng.randn(b, t, s + 1, v_local).astype(np.float32)
    denom = rng.randn(b, t, s + 1).astype(np.float32)
    labels = rng.randint(1, 24, (b, s)).astype(np.int32)
    slen = np.array([3, 1], np.int32)
    occ, cb, cl = _coefficients(6, (b, t, s + 1))
    got = tref.gradients_from_coefficients(
        *(torch.from_numpy(a) for a in (logits, denom, labels, slen, occ, cb,
                                        cl)), 17, v_offset=v_offset)
    want = j_gradients(*(jnp.asarray(a) for a in (logits, denom, labels, slen,
                                                  occ, cb, cl)), 17,
                       v_offset=v_offset)
    # The port zeroes the gradient where the coefficient is 0 (p * 0 there).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("v_offset", [0, 8, 16])
def test_band_gradients_v_offset_matches_jax(v_offset):
    rng = np.random.RandomState(7)
    b, t, w, v_local = 2, 6, 3, 8
    logits = rng.randn(b, t, w, v_local).astype(np.float32)
    denom = rng.randn(b, t, w).astype(np.float32)
    lab_band = rng.randint(-1, 24, (b, t, w)).astype(np.int32)
    occ, cb, cl = _coefficients(8, (b, t, w))
    got = tbanded.band_gradients(
        *(torch.from_numpy(a) for a in (logits, denom, lab_band, occ, cb,
                                        cl)), 9, v_offset=v_offset)
    want = j_band_gradients(*(jnp.asarray(a) for a in (
        logits, denom, lab_band, occ, cb, cl)), 9, v_offset=v_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("labels_3d", [False, True], ids=["BS1", "BTW"])
@pytest.mark.parametrize("shard", [0, 1, 2, 3])
def test_grad_pass_on_a_vocab_shard_is_the_full_gradient_slice(shard,
                                                               labels_3d):
    """Relative ids: blank 5 lives on shard 0 and is out of range (< 0 or
    >= V_local) elsewhere; the -1 sentinel stays negative."""
    rng = np.random.RandomState(shard)
    b, t, s1, v, n = 2, 5, 4, 24, 4
    vl = v // n
    x = torch.from_numpy(rng.randn(b, t, s1, v).astype(np.float32))
    denom = -torch.logsumexp(x, -1)
    occ, cb, cl = (torch.from_numpy(a) for a in _coefficients(9, (b, t, s1)))
    labels = torch.from_numpy(rng.randint(-1, v, (b, t, s1) if labels_3d
                                          else (b, s1)).astype(np.int32))
    full = K.grad_pass(x, denom, occ, cb, cl, labels, 5)
    off = shard * vl
    got = K.grad_pass(x[..., off:off + vl].contiguous(), denom, occ, cb, cl,
                      labels - off, 5 - off)
    torch.testing.assert_close(got, full[..., off:off + vl], rtol=0, atol=0)


@pytest.fixture(scope="module")
def group_of_one():
    from monotonic_rnnt_tpu_torch.parallel import initialize_multihost

    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    initialize_multihost(world_size=1, rank=0, backend="gloo")
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_sharded_stats_on_one_shard_equal_the_unsharded(group_of_one):
    rng = np.random.RandomState(3)
    b, t, s, v = 3, 7, 4, 30
    x = torch.from_numpy(rng.randn(b, t, s + 1, v).astype(np.float32))
    x[0, 2, 1] = -np.inf                       # an all -inf row: denom +inf
    labels = torch.from_numpy(rng.randint(1, v, (b, s)).astype(np.int32))
    slen = torch.tensor([4, 2, 0], dtype=torch.int32)
    lab = extend_labels(labels, slen, s + 1)
    got, v_offset = collective.sharded_lattice_stats(x, lab, 2, group_of_one)
    assert v_offset == 0 and got.denom[0, 2, 1] == np.inf
    want = tref.compute_stats(x, labels, slen, 2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6,
                                   equal_nan=True)

    lab_band = torch.from_numpy(rng.randint(-1, v, (b, t, s + 1)).astype(
        np.int32))
    band, _ = collective.sharded_band_stats(x, lab_band, 2, group_of_one)
    want = tbanded.band_stats(x, lab_band, 2)
    for g, w in zip(band, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6,
                                   equal_nan=True)
