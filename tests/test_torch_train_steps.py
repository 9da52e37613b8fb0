"""The port's gradient-accumulation, memory-efficient and banded steps and
its checkpoints, against train_step and JAX's banded oracle step.

The setup and tolerances of tests/test_torch_train.py, whose helpers this
file imports (a second file, so that one test worker does not hold both).
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_train import (_batch, _cfgs, _grads_of, _jax_state,  # noqa
                              _lrs, _named, _padded_grads, _port_state,
                              _steps, _t, _close_metrics, LR, WARMUP)
from torch_train_check import close_params  # noqa: E402

from monotonic_rnnt_tpu.models import transducer as jt  # noqa: E402
from monotonic_rnnt_tpu_torch import convert  # noqa: E402
from monotonic_rnnt_tpu_torch.models import conformer as tc  # noqa: E402
from monotonic_rnnt_tpu_torch.models import train as ttrain  # noqa: E402


# --- gradient accumulation and the memory-efficient steps --------------------------

def test_grad_accum_matches_single_step():
    """tests/test_models.py::test_grad_accum_matches_single_step on the port,
    over two steps (the first has lr 0)."""
    batch = _t(_batch(8))
    single, accum = _port_state(8), _port_state(8)
    start, grads_ref = _named(single.model), _padded_grads(single, batch)
    grads = {n: torch.zeros_like(g) for n, g in grads_ref.items()}
    for i in range(4):      # the four microbatches' gradients, summed
        micro = tuple(x[2 * i:2 * i + 2] for x in batch)
        for n, g in _padded_grads(accum, micro).items():
            grads[n] += g / 4
    want = _steps(single, ttrain.train_step, 2, batch)
    got = _steps(accum, ttrain.make_grad_accum_train_step(4), 2, batch)
    for g, w in zip(got, want, strict=True):
        _close_metrics(g, w)
    close_params(_named(accum.model), _named(single.model), start, grads,
                 grads_ref, _lrs(2))


def test_grad_accum_rejects_a_batch_it_cannot_split():
    step = ttrain.make_grad_accum_train_step(3)
    with pytest.raises(ValueError, match="batch 8 not divisible by "
                                         "n_micro 3"):
        step(_port_state(8), _t(_batch(8)))


def test_memory_efficient_step_matches_train_step():
    """make_memory_efficient_loss (chunk_t 8) stepped three times against
    train_step from the same weights."""
    batch = _t(_batch(4))
    padded, fused = _port_state(), _port_state()
    loss_fn = ttrain.make_memory_efficient_loss(fused.model, chunk_t=8)
    start, grads_ref = _named(padded.model), _padded_grads(padded, batch)
    grads = _grads_of(fused, loss_fn, batch)
    want = _steps(padded, ttrain.train_step, 3, batch)
    got = _steps(fused, lambda s, b: ttrain.train_step_with_loss(
        s, loss_fn, b), 3, batch)
    for g, w in zip(got, want, strict=True):
        _close_metrics(g, w)
    close_params(_named(fused.model), _named(padded.model), start, grads,
                 grads_ref, _lrs(3))


def _alignment(labels, enc_lengths, slen, t_out, seed=5):
    """test_tp_banded_train_step_matches_oracle's synthetic alignment."""
    rng = np.random.RandomState(seed)
    align = np.zeros((len(slen), t_out), np.int32)
    for b in range(len(slen)):
        pos = np.sort(rng.choice(int(enc_lengths[b]), size=int(slen[b]),
                                 replace=False))
        align[b, pos] = labels[b, :int(slen[b])]
    return align


@functools.lru_cache(maxsize=None)
def _jax_banded_oracle(batch=8, steps=2):
    """tests/test_models.py::test_tp_banded_train_step_matches_oracle's
    oracle step (the mean banded loss on the monolithic logits, then the
    state's optimiser), `steps` times; returns (alignment, width,
    [(params, loss, grad_norm, the step's gradients)])."""
    import optax

    from monotonic_rnnt_tpu import monotonic_rnnt_loss
    from monotonic_rnnt_tpu.ops.bands import (bands_from_alignment,
                                              required_band_width)

    jcfg, _ = _cfgs()
    model = jt.MonotonicTransducer(jcfg)
    state = _jax_state(batch)
    feats, flen, labels, slen = (jnp.asarray(a) for a in _batch(batch))
    enc, enc_lengths = model.apply({"params": state.params}, feats, flen,
                                   True, method=lambda m, f, fl, d:
                                   m.encode(f, fl, d))
    t_out = enc.shape[1]
    align = _alignment(np.asarray(labels), np.asarray(enc_lengths),
                       np.asarray(slen), t_out)
    bands = bands_from_alignment(jnp.asarray(align), enc_lengths, slen, 2, 0)
    width = int(required_band_width(enc_lengths, slen, bands, t_out,
                                    labels.shape[1] + 1))

    def oracle_loss(p):
        logits, el = model.apply({"params": p}, feats, flen, labels, True,
                                 method=lambda m, f, fl, la, d:
                                 m.logits(f, fl, la, d))
        return jnp.mean(monotonic_rnnt_loss(
            logits, labels, el, slen, bands=bands, backend="reference"))

    @jax.jit
    def oracle_step(params, opt_state):
        loss, grads = jax.value_and_grad(oracle_loss)(params)
        updates, opt_state = state.tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state, loss,
                optax.global_norm(grads))

    params, opt_state, out = state.params, state.opt_state, []
    for _ in range(steps):
        grads = jax.jit(jax.grad(oracle_loss))(params)
        params, opt_state, loss, norm = oracle_step(params, opt_state)
        out.append((params, float(loss), float(norm), grads))
    return align, width, out


def test_banded_memory_efficient_step_matches_jax_oracle_step():
    """make_banded_memory_efficient_loss (chunk_t 8) on the alignment band
    (+-2 frames) against JAX's oracle step, over two steps."""
    import monotonic_rnnt_tpu_torch as mt

    align, width, want = _jax_banded_oracle()
    state = _port_state(8)
    feats, flen, labels, slen = _t(_batch(8))
    enc_lengths = tc.subsampled_length(state.model.cfg.encoder, flen)
    bands = mt.bands_from_alignment(torch.from_numpy(align), enc_lengths,
                                    slen, 2, 0)
    t_out, s1 = align.shape[1], labels.shape[1] + 1
    assert int(mt.required_band_width(enc_lengths, slen, bands, t_out,
                                      s1)) == width
    loss_fn = ttrain.make_banded_memory_efficient_loss(state.model, width,
                                                       chunk_t=8)
    batch = (feats, flen, labels, slen)
    start, grads = _named(state.model), _grads_of(state, loss_fn, batch,
                                                  bands)
    got = _steps(state, lambda s, b: ttrain.train_step_with_loss(
        s, loss_fn, b, bands), 2, batch)
    for g, (_, loss, norm, _) in zip(got, want, strict=True):
        np.testing.assert_allclose(g["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], norm, rtol=1e-4)
    _, tcfg = _cfgs()
    to_port = lambda tree: convert.transducer_params_from_flax(  # noqa: E731
        tree, tcfg, device="cpu")
    close_params(_named(state.model), to_port(want[-1][0]), start, grads,
                 to_port(want[0][3]), _lrs(2))



# --- checkpoints -----------------------------------------------------------------

def test_checkpoint_save_restore_roundtrip(tmp_path):
    """tests/test_models.py::test_checkpoint_save_restore_roundtrip on the
    port: a state from seed 7 restored from the checkpoint equals the saved
    one, and resuming reproduces the original trajectory."""
    _, tcfg = _cfgs()
    batch = _t(_batch(2))
    make = lambda seed: ttrain.create_train_state(  # noqa: E731
        tcfg, seed, batch, learning_rate=LR, warmup_steps=WARMUP,
        device="cpu")
    state = make(0)
    _steps(state, ttrain.train_step, 2, batch)
    path = tmp_path / "ckpt" / "state.pt"
    ttrain.save_checkpoint(path, state)
    restored = ttrain.restore_checkpoint(path, make(7))
    assert restored.step == state.step == 2
    assert restored.dropout_seed == state.dropout_seed
    assert restored.learning_rate == state.learning_rate
    for (n, p), q in zip(state.model.named_parameters(),
                         restored.model.parameters()):
        assert torch.equal(p, q), n
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state.optimizer.state[p][key],
                               restored.optimizer.state[q][key]), (n, key)
    m_a = _steps(state, ttrain.train_step, 1, batch)
    m_b = _steps(restored, ttrain.train_step, 1, batch)
    np.testing.assert_allclose(m_b[0]["loss"], m_a[0]["loss"], rtol=1e-6)
    for p, q in zip(state.model.parameters(), restored.model.parameters()):
        assert torch.equal(p, q)
