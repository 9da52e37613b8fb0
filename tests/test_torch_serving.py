"""The port's torch.export artifacts against the live port and the JAX package.

Counterparts of tests/test_serving.py: each artifact goes through bytes
and back (``serving.export_*`` then ``import_fn``), on the CPU, and must
reproduce the live computation of the port and the JAX package's on the
same numpy inputs. Tolerances: the port's artifact against the port's live
call as the JAX test holds its own (costs 1e-6 relative, gradients 1e-6 +
1e-7 absolute; the same ops run); against the JAX package, the oracles'
agreement of tests/test_torch_reference.py (costs 1e-5 relative,
gradients 1e-4 + 1e-6); decoders token for token, on the JAX model's
weights through ``convert.transducer_params_from_flax``.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monotonic_rnnt_tpu_torch as mt
from monotonic_rnnt_tpu import monotonic_rnnt_loss as jax_loss
from monotonic_rnnt_tpu.models.conformer import \
    streaming_lookback as jax_lookback
from monotonic_rnnt_tpu.ops import bands as jbands
from monotonic_rnnt_tpu.ops.banded import \
    monotonic_rnnt_loss_banded as jax_banded
from monotonic_rnnt_tpu_torch import config_override, serving
from monotonic_rnnt_tpu_torch.ops.cuda import fused
from monotonic_rnnt_tpu_torch.ops.cuda import kernels as tk

from torch_decode_pair import batch, pair, t


def _loss_batch(seed=0, b=3, t=12, s=4, v=11):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, s + 1, v).astype(np.float32)
    labels = rng.randint(1, v, size=(b, s)).astype(np.int32)
    ilen = rng.randint(s + 1, t + 1, (b,)).astype(np.int32)
    slen = rng.randint(1, s + 1, (b,)).astype(np.int32)
    return logits, labels, ilen, slen


def _jax_costs_grads(logits, labels, ilen, slen):
    costs, vjp = jax.vjp(lambda lg: jax_loss(
        lg, jnp.asarray(labels), jnp.asarray(ilen), jnp.asarray(slen),
        backend="reference"), jnp.asarray(logits))
    grads, = vjp(jnp.ones_like(costs))
    return np.asarray(costs), np.asarray(grads)


@pytest.fixture(scope="module")
def loss_artifact():
    case = _loss_batch()
    return case, serving.export_loss(*t(*case), device="cpu")


def test_export_loss_roundtrip(loss_artifact):
    case, blob = loss_artifact
    assert isinstance(blob, bytes) and len(blob) > 0
    fn = serving.import_fn(blob)
    costs, grads = fn(*t(*case))

    x = torch.from_numpy(case[0]).requires_grad_(True)
    live = mt.monotonic_rnnt_loss(x, *t(*case[1:]), backend="reference")
    (live_grads,) = torch.autograd.grad(live.sum(), x)
    np.testing.assert_allclose(costs.numpy(), live.detach().numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(grads.numpy(), live_grads.numpy(), rtol=1e-6,
                               atol=1e-7)
    want_c, want_g = _jax_costs_grads(*case)
    np.testing.assert_allclose(costs.numpy(), want_c, rtol=1e-5)
    np.testing.assert_allclose(grads.numpy(), want_g, rtol=1e-4, atol=1e-6)


def test_export_shape_contract_enforced(loss_artifact):
    (logits, labels, ilen, slen), blob = loss_artifact
    fn = serving.import_fn(blob)
    bad = torch.zeros((2,) + logits.shape[1:])                 # wrong batch
    with pytest.raises(Exception):
        fn(bad, *t(labels[:2], ilen[:2], slen[:2]))


def test_export_loss_refuses_what_it_cannot_hold():
    """backend='cuda' holds the kernels: only for device 'cuda'; a backend
    outside the two is refused."""
    case = t(*_loss_batch())
    with pytest.raises(ValueError, match="device='cuda'"):
        serving.export_loss(*case, device="cpu", backend="cuda")
    with pytest.raises(ValueError, match="backend must be"):
        serving.export_loss(*case, device="cpu", backend="pallas")


def test_cuda_route_exports_rows_1_2_as_operators(monkeypatch):
    """export_loss(backend='cuda'), traced on CPU tensors (export_fn keeps
    them where they lie): the graph holds torch.ops.mrnnt.stats_alpha_fused
    and beta_grad_fused once each, with the glue operators around them
    (loss_prologue, loss_costs, beta_operands), and the artifact equals the
    live route bit for bit (the same plain versions on the CPU, counted as
    no launch)."""
    case = t(*_loss_batch(seed=1))
    export_fn = serving.export_fn
    monkeypatch.setattr(serving, "export_fn",
                        lambda fn, args, device: export_fn(fn, args))
    blob = serving.export_loss(*case, backend="cuda")
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function" and "mrnnt" in str(n.target)]
    assert targets == ["mrnnt.loss_prologue.default",
                       "mrnnt.stats_alpha_fused.default",
                       "mrnnt.loss_costs.default",
                       "mrnnt.beta_operands.default",
                       "mrnnt.beta_grad_fused.default"]
    before = dict(tk.LAUNCHES)
    costs, grads = serving.import_fn(blob)(*case)
    live_c, live_g = fused.rnnt_loss_cuda(*case)
    assert torch.equal(costs, live_c) and torch.equal(grads, live_g)
    assert tk.LAUNCHES == before
    want_c, want_g = _jax_costs_grads(*_loss_batch(seed=1))
    np.testing.assert_allclose(costs.numpy(), want_c, rtol=1e-5)
    np.testing.assert_allclose(grads.numpy(), want_g, rtol=1e-4, atol=1e-6)


def test_public_loss_exports_cost_only():
    """monotonic_rnnt_loss itself traces: its length checks, which copy
    the lengths to the host, are skipped under torch.export, as JAX skips
    them on traced lengths; the shape checks still run."""
    case = t(*_loss_batch(seed=2))
    with torch.no_grad():
        blob = serving.export_fn(
            lambda *a: mt.monotonic_rnnt_loss(*a, backend="reference"), case)
        got = serving.import_fn(blob)(*case)
        want = mt.monotonic_rnnt_loss(*case, backend="reference")
    assert torch.equal(got, want)
    with pytest.raises(mt.RnntError, match="labels must be"):
        serving.export_fn(lambda *a: mt.monotonic_rnnt_loss(*a),
                          (case[0], case[1][:2], case[2], case[3]))


def test_export_banded_loss_roundtrip():
    """Banded-loss artifact == live banded loss (costs + packed grads) ==
    the JAX banded oracle."""
    rng = np.random.RandomState(2)
    b, t_max, s, v = 2, 9, 3, 9           # the export traces T steps
    logits = rng.randn(b, t_max, s + 1, v).astype(np.float32)
    labels = rng.randint(1, v, (b, s)).astype(np.int32)
    ilen = np.array([t_max, t_max - 3], np.int32)
    slen = np.full((b,), s, np.int32)
    align = np.zeros((b, t_max), np.int32)
    for i in range(b):
        pos = np.sort(rng.choice(int(ilen[i]), size=s, replace=False))
        align[i, pos] = labels[i]
    bands = jbands.bands_from_alignment(jnp.asarray(align), jnp.asarray(ilen),
                                        jnp.asarray(slen), 1, 0)
    w = int(jbands.required_band_width(jnp.asarray(ilen), jnp.asarray(slen),
                                       bands, t_max, s + 1))
    lb = np.asarray(jbands.pack_band(jnp.asarray(logits),
                                     jbands.compute_band_layout(
                                         jnp.asarray(ilen), jnp.asarray(slen),
                                         bands, t_max, s + 1, w)))
    bmin, bmax = np.asarray(bands.min_s), np.asarray(bands.max_s)
    args = t(lb, labels, ilen, slen, bmin, bmax)

    blob = serving.export_banded_loss(*args, device="cpu")
    costs, grads = serving.import_fn(blob)(*args)

    x = args[0].clone().requires_grad_(True)
    live = mt.monotonic_rnnt_loss_banded(
        x, *args[1:4], bands=mt.Bands(args[4], args[5]), backend="reference")
    (live_g,) = torch.autograd.grad(live.sum(), x)
    np.testing.assert_allclose(costs.numpy(), live.detach().numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(grads.numpy(), live_g.numpy(), rtol=1e-6,
                               atol=1e-7)
    jax_costs = lambda z: jax_banded(
        z, jnp.asarray(labels), jnp.asarray(ilen), jnp.asarray(slen),
        bands=bands, backend="reference")
    want_c, want_g = jax.jit(lambda z: (jax_costs(z), jax.grad(
        lambda y: jnp.sum(jax_costs(y)))(z)))(jnp.asarray(lb))
    np.testing.assert_allclose(costs.numpy(), np.asarray(want_c), rtol=1e-5)
    np.testing.assert_allclose(grads.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["lstm", "conv"])
def test_export_greedy_decoder_roundtrip(kind):
    """The artifact takes the weights as its first argument: built on the
    JAX model's converted weights, its tokens equal JAX's greedy_decode
    and the live port's; fed other weights, it decodes as the live model
    with those."""
    jm, params, tm = pair(kind, "beam")
    feats, flen = batch(seed=1)[:2]
    weights = dict(tm.named_parameters())
    blob = serving.export_greedy_decoder(tm, weights, *t(feats, flen), 6,
                                         device="cpu")
    decoder = serving.import_fn(blob)
    hyp, n_hyp = decoder(weights, *t(feats, flen))

    ref_hyp, ref_n = jax.jit(lambda p, f, fl: jm.apply(
        p, f, fl, 6, method="greedy_decode"))(params, feats, flen)
    np.testing.assert_array_equal(hyp.numpy(), np.asarray(ref_hyp))
    np.testing.assert_array_equal(n_hyp.numpy(), np.asarray(ref_n))
    live = tm.greedy_decode(*t(feats, flen), 6)
    assert torch.equal(hyp, live[0]) and torch.equal(n_hyp, live[1])

    other = {k: v * 1.5 for k, v in weights.items()}
    got = decoder(other, *t(feats, flen))
    with torch.no_grad():
        want = torch.func.functional_call(
            serving._Method(tm, "greedy_decode"),
            {f"model.{k}": v for k, v in other.items()},
            (*t(feats, flen), 6))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_export_streaming_decoder_roundtrip():
    """Streamed decode through the deserialized artifact == JAX's
    streaming_step and the live port's, chunk by chunk, over 8 chunks of 16
    frames: the 88-frame lookback fills after the sixth, so avail
    saturates and the window's start moves while one artifact serves
    every chunk."""
    jm, params, tm = pair("lstm", "stream")
    b, f, c, cap = 2, 15, 16, 24
    rng = np.random.RandomState(3)
    feats = rng.randn(b, 128, f).astype(np.float32)
    flen = np.array([128, 115], np.int32)
    lookback = jax_lookback(jm.cfg.encoder)
    assert lookback == 88 < feats.shape[1] - c

    weights = dict(tm.named_parameters())
    blob, state = serving.export_streaming_decoder(tm, weights, b, f, c, cap,
                                                   device="cpu")
    step = serving.import_fn(blob)
    live_state = tm.streaming_init(b, f, lookback, cap)
    j_state = jm.apply(params, b, f, lookback, cap, method="streaming_init")
    j_step = jax.jit(lambda p, st, ch, cv: jm.apply(
        p, st, ch, cv, method="streaming_step"))
    for i in range(0, feats.shape[1], c):
        cv = np.clip(flen - i, 0, c).astype(np.int32)
        chunk = feats[:, i:i + c]
        state, emitted = step(weights, state, *t(chunk, cv))
        live_state, live_emitted = tm.streaming_step(live_state,
                                                     *t(chunk, cv))
        j_state, j_emitted = j_step(params, j_state, chunk, cv)
        np.testing.assert_array_equal(emitted.numpy(), np.asarray(j_emitted),
                                      err_msg=f"chunk at frame {i}")
        assert torch.equal(emitted, live_emitted)
        assert int(state["n_seen"]) == int(j_state["n_seen"]) == i + c
    np.testing.assert_array_equal(state["hyp"].numpy(),
                                  np.asarray(j_state["hyp"]))
    assert torch.equal(state["hyp"], live_state["hyp"])
    assert int(state["n_hyp"].sum()) > 0


def test_export_fn_generic_roundtrip_bytes():
    """export_fn artifacts survive a real bytes round-trip (file-style),
    and give what the JAX package's give."""
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    y = np.random.RandomState(1).randn(8, 2).astype(np.float32)
    blob = serving.export_fn(lambda a, b: torch.tanh(a) @ b, t(x, y))
    restored = serving.import_fn(bytes(bytearray(blob)), device="cpu")
    np.testing.assert_allclose(restored(*t(x, y)).numpy(),
                               np.asarray(jnp.tanh(x) @ y), rtol=1e-6)


def test_artifact_holds_no_example_values():
    """The blob holds the graph and the examples' shapes, not their
    values: a 1 MiB example makes no 1 MiB artifact."""
    x = torch.randn(512, 512)
    blob = serving.export_fn(lambda a: a * 2, (x,))
    assert len(blob) < x.numel() * 4 // 4
    y = torch.randn(512, 512)
    assert torch.equal(serving.import_fn(blob)(y), y * 2)


def test_export_space_report_prints_at_trace_time(capsys):
    """debug_space prints its line once, while the graph is traced (as JAX
    prints at trace time); the artifact's calls print nothing, and neither
    do the debug prints that read tensors."""
    case = t(*_loss_batch())
    with config_override(debug_space=True, debug_fwdbwd=True,
                         debug_grads=True, debug_time=True):
        blob = serving.export_fn(lambda *a: fused.rnnt_loss_cuda(*a), case)
        out = capsys.readouterr().out
        assert out.count("mrnnt space: pipeline=dp-fused") == 1
        assert "mrnnt fwdbwd" not in out and "mrnnt grads" not in out
        serving.import_fn(blob)(*case)
        assert capsys.readouterr().out == ""
