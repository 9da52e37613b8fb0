"""The port's TF binding against the JAX package's, on the same inputs.

Counterparts of tests/test_tf_interop.py. The packed loss runs the native
engine in both packages (the port's own copy of native_src/mrnnt.cpp), so
its costs and gradients equal JAX's bit for bit. The padded and banded
losses bridge TF onto the port's torch losses (on the CPU here) where JAX
stages its losses with jax2tf: costs within 1e-5 relative and gradients
within 1e-4 (+ 1e-6 absolute) of JAX's. The decoders bridge onto the
port's greedy_decode on the JAX model's converted weights, token for
token. A bridge cannot go into a SavedModel (JAX's
test_tf_saved_model_roundtrip_* have no counterpart), and jax2tf has none
(test_tf_padded_jax2tf_path's counterpart is the padded bridge's test).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import golden  # noqa: E402
from monotonic_rnnt_tpu.interop import tf_binding as jtf  # noqa: E402
from monotonic_rnnt_tpu.ops import bands as jbands  # noqa: E402
from monotonic_rnnt_tpu.ops.packing import pack_acts  # noqa: E402
from monotonic_rnnt_tpu_torch.interop import tf_binding as ttf  # noqa: E402
from monotonic_rnnt_tpu_torch.interop.returnn_op import (  # noqa: E402
    monotonic_rnnt_loss as returnn_loss)

from torch_decode_pair import batch, pair  # noqa: E402

CPU = {"device": "cpu"}


def _packed_readme():
    logits, labels, ilen, slen = golden.readme_batch()
    packed = np.asarray(pack_acts(jnp.asarray(logits), ilen, slen))
    return (tf.constant(packed), tf.constant(labels), tf.constant(ilen),
            tf.constant(slen))


def _tape(loss, x, *args, scale=1.0, **kw):
    with tf.GradientTape() as tape:
        tape.watch(x)
        costs = loss(x, *args, **kw)
        total = scale * tf.reduce_sum(costs)
    return costs, tape.gradient(total, x)


def test_tf_golden_forward_backward():
    acts, labels, ilen, slen = _packed_readme()
    costs, grads = _tape(ttf.monotonic_rnnt_loss, acts, labels, ilen, slen)
    np.testing.assert_allclose(costs.numpy(), [golden.README_LOSS], atol=1e-4)
    np.testing.assert_allclose(grads.numpy().reshape(4, 3, 3),
                               golden.README_GRADS, atol=1e-2)
    j_costs, j_grads = _tape(jtf.monotonic_rnnt_loss, acts, labels, ilen,
                             slen)
    np.testing.assert_array_equal(costs.numpy(), j_costs.numpy())
    np.testing.assert_array_equal(grads.numpy(), j_grads.numpy())


def test_tf_cotangent_scaling():
    acts, labels, ilen, slen = _packed_readme()
    _, grads = _tape(ttf.monotonic_rnnt_loss, acts, labels, ilen, slen,
                     scale=2.5)
    np.testing.assert_allclose(grads.numpy().reshape(4, 3, 3),
                               2.5 * golden.README_GRADS, atol=3e-2)
    _, j_grads = _tape(jtf.monotonic_rnnt_loss, acts, labels, ilen, slen,
                       scale=2.5)
    np.testing.assert_array_equal(grads.numpy(), j_grads.numpy())


def test_tf_align_restrict_golden():
    acts, labels, ilen, slen = _packed_readme()
    for align, dist, want in ((golden.ALIGN_A, 1, 1.22),
                              (golden.ALIGN_B, 0, 2.7)):
        kw = dict(alignment=tf.constant(align[None]),
                  max_distance_from_alignment=dist)
        c = ttf.monotonic_rnnt_loss(acts, labels, ilen, slen, **kw)
        np.testing.assert_allclose(c.numpy(), [want], atol=1e-2)
        np.testing.assert_array_equal(c.numpy(), jtf.monotonic_rnnt_loss(
            acts, labels, ilen, slen, **kw).numpy())


def test_tf_multibatch():
    logits, labels, ilen, slen, exp_losses, _ = golden.multibatch()
    packed = tf.constant(np.asarray(pack_acts(jnp.asarray(logits), ilen,
                                              slen)))
    args = (packed, tf.constant(labels), tf.constant(ilen), tf.constant(slen))
    costs = ttf.monotonic_rnnt_loss(*args)
    np.testing.assert_allclose(costs.numpy(), exp_losses, atol=1e-4)
    np.testing.assert_array_equal(costs.numpy(),
                                  jtf.monotonic_rnnt_loss(*args).numpy())


def test_tf_graph_mode():
    acts, labels, ilen, slen = _packed_readme()

    @tf.function
    def step(a):
        with tf.GradientTape() as tape:
            tape.watch(a)
            total = tf.reduce_sum(ttf.monotonic_rnnt_loss(a, labels, ilen,
                                                          slen))
        return total, tape.gradient(total, a)

    total, grads = step(acts)
    assert float(total) == pytest.approx(golden.README_LOSS, abs=1e-4)
    assert grads.shape == acts.shape


def test_tf_padded_bridge_path():
    """The padded bridge in eager and graph mode against JAX's jax2tf
    loss on the same inputs, and the goldens."""
    logits, labels, ilen, slen = golden.readme_batch()
    x = tf.constant(np.asarray(logits, np.float32))
    rest = (tf.constant(labels), tf.constant(ilen), tf.constant(slen))
    costs, grads = _tape(ttf.monotonic_rnnt_loss_padded, x, *rest,
                         scale=1.5, **CPU)
    np.testing.assert_allclose(costs.numpy(), [golden.README_LOSS], atol=1e-4)
    np.testing.assert_allclose(grads.numpy()[0], 1.5 * golden.README_GRADS,
                               atol=2e-2)
    j_costs, j_grads = _tape(jtf.monotonic_rnnt_loss_padded, x, *rest,
                             scale=1.5)
    np.testing.assert_allclose(costs.numpy(), j_costs.numpy(), rtol=1e-5)
    np.testing.assert_allclose(grads.numpy(), j_grads.numpy(), rtol=1e-4,
                               atol=1e-6)

    @tf.function
    def step(a):
        return _tape(ttf.monotonic_rnnt_loss_padded, a, *rest, scale=1.5,
                     **CPU)

    g_costs, g_grads = step(x)
    np.testing.assert_array_equal(g_costs.numpy(), costs.numpy())
    np.testing.assert_array_equal(g_grads.numpy(), grads.numpy())


def test_returnn_surface():
    acts, labels, ilen, slen = _packed_readme()
    costs = returnn_loss(acts, labels, ilen, slen, blank_label=0)
    np.testing.assert_allclose(costs.numpy(), [golden.README_LOSS], atol=1e-4)
    from monotonic_rnnt_tpu.interop.returnn_op import \
        monotonic_rnnt_loss as j_returnn
    np.testing.assert_array_equal(
        costs.numpy(), j_returnn(acts, labels, ilen, slen).numpy())


def test_tf_no_inf_nan_random():
    # Reference tensorflow_binding/test.py size-test property: finite outputs.
    rng = np.random.RandomState(0)
    B, T, S, V = 2, 20, 5, 11
    logits = rng.randn(B, T, S + 1, V).astype(np.float32)
    labels = rng.randint(1, V, size=(B, S)).astype(np.int32)
    ilen = np.array([T, T - 3], np.int32)
    slen = np.array([S, S - 2], np.int32)
    packed = np.asarray(pack_acts(jnp.asarray(logits), ilen, slen))
    rest = (tf.constant(labels), tf.constant(ilen), tf.constant(slen))
    costs, g = _tape(ttf.monotonic_rnnt_loss, tf.constant(packed), *rest)
    assert np.all(np.isfinite(costs.numpy()))
    assert np.all(np.isfinite(g.numpy()))
    p_costs, p_g = _tape(ttf.monotonic_rnnt_loss_padded,
                         tf.constant(logits), *rest, **CPU)
    np.testing.assert_allclose(p_costs.numpy(), costs.numpy(), rtol=1e-5)
    assert np.all(np.isfinite(p_g.numpy()))


def _banded_case():
    rng = np.random.RandomState(4)
    B, T, S, V = 2, 14, 4, 11
    logits = rng.randn(B, T, S + 1, V).astype(np.float32)
    labels = rng.randint(1, V, (B, S)).astype(np.int32)
    ilen = np.array([14, 10], np.int32)
    slen = np.array([4, 2], np.int32)
    align = np.zeros((B, T), np.int32)
    for b in range(B):
        pos = np.sort(rng.choice(ilen[b], size=slen[b], replace=False))
        align[b, pos] = labels[b, :slen[b]]
    bands = jbands.bands_from_alignment(jnp.asarray(align), jnp.asarray(ilen),
                                        jnp.asarray(slen), 1, 0)
    w = int(jbands.required_band_width(jnp.asarray(ilen), jnp.asarray(slen),
                                       bands, T, S + 1))
    layout = jbands.compute_band_layout(jnp.asarray(ilen), jnp.asarray(slen),
                                        bands, T, S + 1, w)
    lb = np.asarray(jbands.pack_band(jnp.asarray(logits), layout))
    return (lb, labels, ilen, slen, np.asarray(bands.min_s),
            np.asarray(bands.max_s))


def test_tf_banded_padded_matches_jax():
    """Band-layout bridge: costs + tape gradients match JAX's jax2tf
    banded loss."""
    lb, *rest = _banded_case()
    lb_tf = tf.constant(lb)
    costs, g = _tape(ttf.monotonic_rnnt_loss_banded, lb_tf, *rest, **CPU)
    j_costs, j_g = _tape(jtf.monotonic_rnnt_loss_banded, lb_tf, *rest)
    np.testing.assert_allclose(costs.numpy(), j_costs.numpy(), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), j_g.numpy(), rtol=1e-4, atol=1e-6)


def test_tf_loss_module_matches_jax():
    """make_tf_loss_module's tf.functions against JAX's module (no
    SavedModel: the bridges cannot be saved)."""
    logits, labels, ilen, slen = golden.readme_batch()
    args = (tf.constant(np.asarray(logits, np.float32)), tf.constant(labels),
            tf.constant(ilen), tf.constant(slen))
    module, j_module = ttf.make_tf_loss_module(**CPU), jtf.make_tf_loss_module()
    np.testing.assert_allclose(module.padded(*args).numpy(),
                               j_module.padded(*args).numpy(), rtol=1e-5)
    np.testing.assert_allclose(module.padded(*args).numpy(),
                               [golden.README_LOSS], atol=1e-4)
    b_args = [tf.constant(a) for a in _banded_case()]
    np.testing.assert_allclose(module.banded(*b_args).numpy(),
                               j_module.banded(*b_args).numpy(), rtol=1e-5)


def _jax_greedy(jm, params, feats, flen, cap):
    return jax.jit(lambda p, f, fl: jm.apply(
        p, f, fl, cap, method="greedy_decode"))(params, feats, flen)


def test_tf_decoder_module_matches_jax_decode():
    """The decoder module (weights as tf.Variables) == JAX's greedy decode
    on the same weights."""
    jm, params, tm = pair("lstm", "beam")
    feats, flen = batch(seed=2)[:2]
    ref_hyp, ref_n = _jax_greedy(jm, params, feats, flen, 6)
    module = ttf.make_tf_decoder_module(tm, dict(tm.named_parameters()), 6,
                                        **CPU)
    assert len(module.trainable_variables) == 0 and module.variables
    hyp, n = module.decode(feats, flen)
    np.testing.assert_array_equal(hyp.numpy(), np.asarray(ref_hyp))
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))


@pytest.mark.parametrize("kind", ["lstm", "conv"])
def test_tf_greedy_decoder_matches_jax(kind):
    """The TF greedy decoder == JAX greedy decode (eager and tf.function)."""
    jm, params, tm = pair(kind, "beam")
    feats, flen = batch(seed=1)[:2]
    ref_hyp, ref_n = _jax_greedy(jm, params, feats, flen, 6)
    # TF takes the weights as arrays (a tf.function converts its arguments).
    weights = {k: v.detach().numpy() for k, v in tm.named_parameters()}
    decoder = ttf.make_tf_greedy_decoder(tm, 6, **CPU)
    for fn in (decoder, tf.function(decoder)):
        hyp, n = fn(weights, feats, flen)
        np.testing.assert_array_equal(hyp.numpy(), np.asarray(ref_hyp))
        np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))


def test_interop_package_imports_no_tensorflow():
    """tf_binding and returnn_op import TensorFlow when called, and the
    interop package imports neither."""
    code = ("import sys, monotonic_rnnt_tpu_torch.interop as i; "
            "import monotonic_rnnt_tpu_torch.interop.tf_binding, "
            "monotonic_rnnt_tpu_torch.interop.returnn_op; "
            "print('tensorflow' in sys.modules, 'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert out == ["False", "False"]
