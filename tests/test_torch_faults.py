"""Three places where the port and the JAX package parted, held together.

* The vocab-sharded losses give a NaN-cost sample NaN on the lattice rows
  whose denominator is not finite, where JAX's backward (XLA's p * coef)
  has NaN: on the ROADMAP's NaN-cost input, one-rank gloo group against
  JAX's ``shard_map`` on a one-device 'model' mesh, the same NaN cells.
* An exported loss at a length past the padded shape costs that sample NaN
  with an all-zero gradient (JAX's gather fills out-of-bounds reads with
  NaN) where the port raised IndexError; the banded artifact costs it +inf,
  as JAX's does. The other samples keep their bits.
* At large logit margins the gradient overflows (0 * inf) while the cost
  stays finite, in the port as in the JAX oracle: the same non-finite
  cells at c = 50, 100 and 1e4, on the oracle and on the plain versions of
  rows 1-2 (the deferred route) and of the split kernels (the vocab-sharded
  loss on a one-rank gloo group: rows 10, 4 and 6).

Tolerances: costs 1e-5 relative and gradients 1e-4 + 1e-6 against the JAX
package (tests/test_torch_reference.py's agreement of the two oracles);
the finite-cost samples bit for bit against the same call on finite
inputs or in-range lengths.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import monotonic_rnnt_tpu_torch as mt
from monotonic_rnnt_tpu import serving as jserving
from monotonic_rnnt_tpu.ops import bands as jbands
from monotonic_rnnt_tpu.ops.reference import rnnt_loss_reference as j_ref
from monotonic_rnnt_tpu.parallel import make_mesh
from monotonic_rnnt_tpu.parallel import sharding as jsharding
from monotonic_rnnt_tpu_torch import serving
from monotonic_rnnt_tpu_torch.ops.cuda import fused
from monotonic_rnnt_tpu_torch.parallel import sharding as tsharding
from monotonic_rnnt_tpu_torch.scripts._cases import (loss_route,
                                                     one_rank_group)
from test_torch_reference import nan_cost_case

T_ = lambda *a: tuple(torch.from_numpy(np.array(x)) for x in a)


@pytest.fixture(scope="module")
def group():
    with one_rank_group() as g:
        yield g


def _jax_sharded(banded, x, labels, ilen, slen, bmin, bmax):
    """JAX's vocab-sharded loss under shard_map on a one-device 'model'
    mesh: (costs, d sum(costs) / d x)."""
    fn = (jsharding.rnnt_loss_banded_vocab_sharded if banded
          else jsharding.rnnt_loss_vocab_sharded)
    spec = P(None, None, None, "model")
    loss = shard_map(partial(fn, blank_id=0, axis_name="model"),
                     mesh=make_mesh(data=1, model=1),
                     in_specs=(spec,) + (P(),) * 5, out_specs=P())
    args = tuple(jnp.asarray(a) for a in (labels, ilen, slen, bmin, bmax))
    costs, vjp = jax.vjp(lambda z: loss(z, *args), jnp.asarray(x))
    return np.asarray(costs), np.asarray(vjp(jnp.ones_like(costs))[0])


def _sharded_case(logits, labels, ilen, slen, banded):
    """(x, band_min, band_max) of the default bands, x packed at W = 4
    with JAX's pack_band for the banded loss."""
    t_max, s1 = logits.shape[1], logits.shape[2]
    jb = jbands.default_bands(jnp.asarray(ilen), jnp.asarray(slen), t_max)
    x = logits
    if banded:
        layout = jbands.compute_band_layout(jnp.asarray(ilen),
                                            jnp.asarray(slen), jb, t_max,
                                            s1, 4)
        x = np.asarray(jbands.pack_band(jnp.asarray(logits), layout))
    return x, np.asarray(jb.min_s), np.asarray(jb.max_s)


def _port_sharded(banded, group, x, labels, ilen, slen, bmin, bmax):
    fn = (tsharding.rnnt_loss_banded_vocab_sharded if banded
          else tsharding.rnnt_loss_vocab_sharded)
    leaf = torch.from_numpy(np.array(x)).requires_grad_(True)
    costs = fn(leaf, *T_(labels, ilen, slen, bmin, bmax), 0, group)
    costs.sum().backward()
    return costs.detach().numpy(), leaf.grad.numpy()


@pytest.mark.parametrize("banded", [False, True], ids=["padded", "banded"])
def test_vocab_sharded_nan_cost_gets_the_jax_nan_gradient(group, banded):
    """Sample 1's row [1, 1, 0, :] at +inf: costs [8.5436, NaN] on both
    sides, NaN on the same 5 cells (the row), none elsewhere; sample 0's
    gradient keeps its bits from the finite input and agrees with JAX's."""
    (logits, labels, ilen, slen), finite = nan_cost_case()
    x, bmin, bmax = _sharded_case(logits, labels, ilen, slen, banded)
    x_fin, _, _ = _sharded_case(finite, labels, ilen, slen, banded)
    want_c, want_g = _jax_sharded(banded, x, labels, ilen, slen, bmin, bmax)
    got_c, got_g = _port_sharded(banded, group, x, labels, ilen, slen, bmin,
                                 bmax)
    _, fin_g = _port_sharded(banded, group, x_fin, labels, ilen, slen, bmin,
                             bmax)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5)
    assert np.isfinite(got_c[0]) and np.isnan(got_c[1])
    assert int(np.isnan(want_g).sum()) == 5
    np.testing.assert_array_equal(np.isnan(got_g), np.isnan(want_g))
    np.testing.assert_array_equal(got_g[0], fin_g[0])
    np.testing.assert_allclose(got_g[0], want_g[0], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got_g[1][~np.isnan(got_g[1])], 0.0)


def test_vocab_sharded_single_inf_logit_nans_its_row_as_jax(group):
    """One +inf logit, not a whole row: JAX's sharded backward forms p from
    the shard's (max, sum-exp), so exp(x - inf) / NaN puts NaN on the whole
    row, and the port's NaN (the row's denominator is not finite) is the
    same row: no superset here, unlike the fused-joint losses against the
    JAX oracle."""
    (_, labels, ilen, slen), finite = nan_cost_case()
    logits = finite.copy()
    logits[1, 1, 0, 2] = np.inf
    x, bmin, bmax = _sharded_case(logits, labels, ilen, slen, False)
    _, want_g = _jax_sharded(False, x, labels, ilen, slen, bmin, bmax)
    got_c, got_g = _port_sharded(False, group, x, labels, ilen, slen, bmin,
                                 bmax)
    assert np.isnan(got_c[1])
    assert np.argwhere(np.isnan(want_g)).tolist() == [
        [1, 1, 0, v] for v in range(logits.shape[3])]
    np.testing.assert_array_equal(np.isnan(got_g), np.isnan(want_g))


def _export_case():
    """The ROADMAP's export input: B=3, T=6, S=3, V=5 from RandomState(0),
    exported at ilen [6, 5, 4], slen [3, 2, 1]."""
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 6, 4, 5).astype(np.float32)
    labels = rng.randint(1, 5, (3, 3)).astype(np.int32)
    return (logits, labels, np.array([6, 5, 4], np.int32),
            np.array([3, 2, 1], np.int32))


@pytest.fixture(scope="module")
def jax_loss_artifact():
    return jserving.import_fn(jserving.export_loss(
        *(jnp.asarray(a) for a in _export_case()), platforms=("cpu",)))


@pytest.mark.parametrize("route", ["reference", "cuda"])
@pytest.mark.parametrize("ilen0,slen0", [(7, 3), (6, 4), (7, 4)],
                         ids=["ilen_T+1", "slen_S+1", "both"])
def test_exported_loss_past_the_padded_shape_matches_jax(
        jax_loss_artifact, route, ilen0, slen0):
    """Sample 0 at T_b = T + 1 and/or S_b = S + 1: the artifact costs it NaN
    with an all-zero gradient, no NaN in it, as JAX's artifact does; samples
    1-2 keep their costs and gradients bit for bit from the in-range call
    and agree with JAX's. The 'cuda' route is the cuda artifact's function
    (rows 1-2, plain versions on the CPU)."""
    logits, labels, ilen, slen = _export_case()
    if route == "reference":
        blob = serving.export_loss(*T_(*_export_case()), device="cpu")
    else:
        blob = serving.export_fn(
            lambda *a: fused.rnnt_loss_cuda(*a, blank_id=0),
            T_(*_export_case()))
    artifact = serving.import_fn(blob)
    ilen2, slen2 = ilen.copy(), slen.copy()
    ilen2[0], slen2[0] = ilen0, slen0
    want_c, want_g = (np.asarray(a) for a in jax_loss_artifact(
        *(jnp.asarray(a) for a in (logits, labels, ilen2, slen2))))
    got_c, got_g = (a.numpy() for a in artifact(*T_(logits, labels, ilen2,
                                                    slen2)))
    in_c, in_g = (a.numpy() for a in artifact(*T_(logits, labels, ilen,
                                                  slen)))
    assert np.isnan(want_c[0]) and np.isnan(got_c[0])
    assert not np.isnan(want_g[0]).any() and not (want_g[0] != 0).any()
    assert not np.isnan(got_g[0]).any() and not (got_g[0] != 0).any()
    np.testing.assert_array_equal(got_c[1:], in_c[1:])
    np.testing.assert_array_equal(got_g[1:], in_g[1:])
    np.testing.assert_allclose(got_c[1:], want_c[1:], rtol=1e-5)
    np.testing.assert_allclose(got_g[1:], want_g[1:], rtol=1e-4, atol=1e-6)


def test_exported_banded_loss_past_the_padded_shape_matches_jax():
    """The banded artifact at T_b = T + 1 costs the sample +inf with a zero
    gradient, as JAX's does (its gather fills the band offset with INT_MIN,
    which puts S_b out of the window); the other sample keeps its bits."""
    rng = np.random.RandomState(2)
    b, t_max, s, v = 2, 9, 3, 9
    logits = rng.randn(b, t_max, s + 1, v).astype(np.float32)
    labels = rng.randint(1, v, (b, s)).astype(np.int32)
    ilen = np.array([t_max, t_max - 3], np.int32)
    slen = np.full((b,), s, np.int32)
    align = np.zeros((b, t_max), np.int32)
    for i in range(b):
        pos = np.sort(rng.choice(int(ilen[i]), size=s, replace=False))
        align[i, pos] = labels[i]
    j = lambda a: jnp.asarray(a)
    bands = jbands.bands_from_alignment(j(align), j(ilen), j(slen), 1, 0)
    w = int(jbands.required_band_width(j(ilen), j(slen), bands, t_max, s + 1))
    lb = np.asarray(jbands.pack_band(j(logits), jbands.compute_band_layout(
        j(ilen), j(slen), bands, t_max, s + 1, w)))
    args = (lb, labels, ilen, slen, np.asarray(bands.min_s),
            np.asarray(bands.max_s))
    jax_fn = jserving.import_fn(jserving.export_banded_loss(
        *(j(a) for a in args), platforms=("cpu",)))
    port_fn = serving.import_fn(serving.export_banded_loss(*T_(*args),
                                                           device="cpu"))
    past = list(args)
    past[2] = np.array([t_max + 1, t_max - 3], np.int32)
    want_c, want_g = (np.asarray(a) for a in jax_fn(*(j(a) for a in past)))
    got_c, got_g = (a.numpy() for a in port_fn(*T_(*past)))
    in_c, in_g = (a.numpy() for a in port_fn(*T_(*args)))
    assert want_c[0] == np.inf and got_c[0] == np.inf
    assert not want_g[0].any() and not got_g[0].any()
    np.testing.assert_array_equal(got_c[1:], in_c[1:])
    np.testing.assert_array_equal(got_g[1:], in_g[1:])
    np.testing.assert_allclose(got_g[1:], want_g[1:], rtol=1e-4, atol=1e-6)


def test_live_loss_still_refuses_a_length_past_the_padded_shape():
    """Only the export route changed: a live call checks the lengths."""
    logits, labels, ilen, slen = _export_case()
    ilen[0] = 7
    with pytest.raises(mt.RnntError, match="exceed padded T_max"):
        mt.monotonic_rnnt_loss(*T_(logits, labels, ilen, slen))


def _overflow_case(scale):
    """The NaN-cost input with every logit finite, scaled by `scale`."""
    (_, labels, ilen, slen), finite = nan_cost_case()
    return (finite * np.float32(scale)).astype(np.float32), labels, ilen, slen


@pytest.mark.parametrize("route", ["oracle", "deferred", "split"])
@pytest.mark.parametrize("scale", [50.0, 100.0, 1e4])
def test_overflow_cells_are_the_jax_oracles(group, route, scale):
    """Costs stay finite; the gradient's non-finite values sit on exactly
    the JAX oracle's cells (3, 11, 20 of them), on the port's oracle and on
    the plain versions of rows 1-2 (deferred) and of the split kernels,
    rows 10, 4 and 6 (the vocab-sharded loss on a one-rank group); the
    finite cells agree. The formula is JAX's, kept: parity, not a fix."""
    case = _overflow_case(scale)
    want_c, want_g = (np.asarray(a) for a in jax.jit(j_ref)(
        *(jnp.asarray(a) for a in case)))
    x = torch.from_numpy(case[0]).requires_grad_(True)
    rest = T_(*case[1:])
    if route == "split":
        got_c, got_g = _port_sharded(False, group, case[0], *case[1:],
                                     *_sharded_case(*case, False)[1:])
    else:
        costs = (mt.monotonic_rnnt_loss(x, *rest, backend="reference")
                 if route == "oracle" else loss_route(x, *rest,
                                                      backend="cuda"))
        costs.sum().backward()
        got_c, got_g = costs.detach().numpy(), x.grad.numpy()
    bad = ~np.isfinite(want_g)
    assert np.isfinite(want_c).all() and np.isfinite(got_c).all()
    assert int(bad.sum()) == {50.0: 3, 100.0: 11, 1e4: 20}[scale]
    np.testing.assert_array_equal(~np.isfinite(got_g), bad)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5)
    np.testing.assert_allclose(got_g[~bad], want_g[~bad], rtol=1e-4,
                               atol=1e-6)
