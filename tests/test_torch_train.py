"""The port's training step against the JAX package's.

The tiny config of tests/test_models.py (1 layer, dim 64, V = 32, dropout
0), every dtype float32, on tiny_batch(t=32, feat_dim=16, s=4, vocab=32)
with batch 4 or 8. The JAX state is create_train_state(PRNGKey(0)) with lr
3e-3 and one warmup update, stepped on the CPU; its initial parameters go
through convert.transducer_params_from_flax into the port's state, whose
model runs on the CPU (the loss's oracle, the kernel wrappers' plain
versions). The first update has lr 0, so each comparison takes 2 or 3
steps. Tolerances: losses 1e-5 relative; grad_norm 1e-4; parameters after
the last step rtol 2e-4 / atol 2e-5 (tests/test_models.py's), except the
elements whose gradient is rounding noise on both sides, the attention's
key bias (its true gradient is exactly 0) and a few elements ~1e5 times
smaller than their leaf's largest: Adam scales noise up to steps of about
the lr, so those are held within Adam's drift bound over the steps taken
(tests/torch_train_check.py). The optimiser alone, on identical gradients,
is held to optax's at 1e-6.
"""

import functools
import inspect
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monotonic_rnnt_tpu.data import augment as jaugment
from monotonic_rnnt_tpu.data.synthetic import tiny_batch
from monotonic_rnnt_tpu.models import conformer as jc
from monotonic_rnnt_tpu.models import predictor as jp
from monotonic_rnnt_tpu.models import train as jtrain
from monotonic_rnnt_tpu.models import transducer as jt
from monotonic_rnnt_tpu_torch import convert
from monotonic_rnnt_tpu_torch.data import augment as taugment
from monotonic_rnnt_tpu_torch.models import conformer as tc
from monotonic_rnnt_tpu_torch.models import predictor as tp
from monotonic_rnnt_tpu_torch.models import train as ttrain
from monotonic_rnnt_tpu_torch.models import transducer as tt

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_train_check import close_params  # noqa: E402

LR, WARMUP, WD = 3e-3, 1, 1e-6


def _cfgs(dropout=0.0):
    """tests/test_models.py's _tiny_cfg in both frameworks, all float32."""
    def make(mod_c, mod_p, mod_t, dt):
        return mod_t.TransducerConfig(
            encoder=mod_c.ConformerConfig(num_layers=1, dim=64, num_heads=2,
                                          dropout=dropout, dtype=dt),
            predictor=mod_p.PredictorConfig(vocab_size=32, dim=64,
                                            embed_dim=32, dtype=dt),
            joint_dim=64, vocab_size=32, dtype=dt)
    return (make(jc, jp, jt, jnp.float32), make(tc, tp, tt, torch.float32))


def _batch(batch):
    return tiny_batch(batch=batch, t=32, feat_dim=16, s=4, vocab=32)


def _t(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@functools.lru_cache(maxsize=None)
def _jax_state(batch):
    jcfg, _ = _cfgs()
    return jtrain.create_train_state(
        jcfg, jax.random.PRNGKey(0), tuple(jnp.asarray(a)
                                           for a in _batch(batch)),
        learning_rate=LR, warmup_steps=WARMUP)


@functools.lru_cache(maxsize=None)
def _jax_run(batch=4, steps=3):
    """[(state after step k, metrics of step k)] of JAX's train_step."""
    state = _jax_state(batch)
    data = tuple(jnp.asarray(a) for a in _batch(batch))
    step = jax.jit(jtrain.train_step)
    out = []
    for _ in range(steps):
        state, metrics = step(state, data)
        out.append((state, {k: float(v) for k, v in metrics.items()}))
    return out


def _port_state(batch=4, seed=0, cfg=None, **kw):
    """The port's state on the CPU, with JAX's initial weights."""
    _, tcfg = _cfgs()
    state = ttrain.create_train_state(cfg or tcfg, seed, _t(_batch(batch)),
                                      learning_rate=LR, warmup_steps=WARMUP,
                                      device="cpu", **kw)
    state.model.load_state_dict(convert.transducer_params_from_flax(
        _jax_state(batch).params, tcfg, device="cpu"))
    return state


def _steps(state, step_fn, n, *args):
    metrics = []
    for _ in range(n):
        state, m = step_fn(state, *args)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics


def _lrs(n):
    return [LR * ttrain.warmup_cosine_factor(c, WARMUP, 10_000)
            for c in range(n)]


def _named(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _grads_of(state, loss_fn, *args):
    """The gradients of loss_fn(*args, generator=None) at the state's
    parameters, which stay as they are."""
    state.optimizer.zero_grad(set_to_none=True)
    loss_fn(*args, generator=None).backward()
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    state.optimizer.zero_grad(set_to_none=True)
    return grads


def _padded_grads(state, batch):
    """The gradients of train_step's loss, the mean cost."""
    return _grads_of(state, lambda b, generator=None: state.model(
        *b, deterministic=False, generator=generator).mean(), batch)


@functools.lru_cache(maxsize=None)
def _jax_grads(batch=4):
    """JAX's gradient of the mean cost at its initial parameters (its first
    train_step's), in the port's layout."""
    state = _jax_state(batch)
    data = tuple(jnp.asarray(a) for a in _batch(batch))
    grads = jax.jit(jax.grad(lambda p: jnp.mean(
        state.apply_fn({"params": p}, *data))))(state.params)
    _, tcfg = _cfgs()
    return convert.transducer_params_from_flax(grads, tcfg, device="cpu")


def _jax_params(state):
    _, tcfg = _cfgs()
    return convert.transducer_params_from_flax(state.params, tcfg,
                                               device="cpu")


def _close_metrics(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    assert got["step"] == want["step"]


# --- the single-device step ------------------------------------------------------

def test_train_step_matches_jax_over_three_steps():
    run = _jax_run()
    state = _port_state()
    start, batch = _named(state.model), _t(_batch(4))
    grads = _padded_grads(state, batch)
    got = _steps(state, ttrain.train_step, 3, batch)
    for g, (_, w) in zip(got, run, strict=True):
        _close_metrics(g, w)
    assert state.step == 3 and [m["step"] for m in got] == [0, 1, 2]
    close_params(_named(state.model), _jax_params(run[-1][0]), start, grads,
                 _jax_grads(), _lrs(3))


def test_metrics_are_device_tensors_and_the_step_an_int():
    state = _port_state()
    _, metrics = ttrain.train_step(state, _t(_batch(4)))
    assert isinstance(metrics["loss"], torch.Tensor)
    assert isinstance(metrics["grad_norm"], torch.Tensor)
    assert metrics["loss"].shape == () and metrics["grad_norm"].shape == ()
    assert metrics["step"] == 0 and state.step == 1


@pytest.mark.parametrize("warmup", [1, 5, 1000])
def test_schedule_matches_optax(warmup):
    """The lr at updates 0, 1, warmup, warmup + 1 and decay_steps, from the
    state's LambdaLR, against optax's schedule of create_train_state."""
    import optax

    decay = max(warmup * 10, 10_000)
    want = optax.warmup_cosine_decay_schedule(0.0, LR, warmup, decay)
    _, tcfg = _cfgs()
    state = ttrain.create_train_state(tcfg, 0, _t(_batch(4)),
                                      learning_rate=LR, warmup_steps=warmup,
                                      device="cpu")
    assert state.learning_rate == 0.0            # the first update's lr
    for count in (0, 1, warmup, warmup + 1, decay, decay + 7):
        state.set_update_count(count)
        # optax's warmup is peak - peak * (1 - count / warmup) in f32: its
        # error is ~peak * 1e-7, whatever the value.
        np.testing.assert_allclose(state.learning_rate,
                                   float(want(count)), rtol=1e-6,
                                   atol=LR * 1e-6)


def test_optimizer_is_optax_adamw_on_every_parameter():
    state = _port_state()
    groups = state.optimizer.param_groups
    assert len(groups) == 1
    g = groups[0]
    assert g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8
    assert g["weight_decay"] == WD and not g["amsgrad"]
    assert len(g["params"]) == len(list(state.model.parameters()))


def test_optimizer_matches_optax_on_identical_gradients():
    """The clip, AdamW and schedule alone: the same gradient trees (global
    norm 40, clipped, then 2 and 3, not) through JAX's state.tx and the
    port's update, four updates, the first at lr 0: every parameter within
    1e-6 relative (two f32 implementations of one formula)."""
    import optax

    jstate = _jax_state(4)
    state = _port_state()
    _, tcfg = _cfgs()
    rng = np.random.RandomState(3)
    params, opt_state = jstate.params, jstate.opt_state
    tx_step = jax.jit(lambda g, o, p: jstate.tx.update(g, o, p))
    for norm in (40.0, 2.0, 3.0, 40.0):
        tree = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                            params)
        scale = norm / float(optax.global_norm(tree))
        tree = jax.tree.map(lambda x: x * np.float32(scale), tree)
        updates, opt_state = tx_step(tree, opt_state, params)
        params = optax.apply_updates(params, updates)
        grads = convert.transducer_params_from_flax(tree, tcfg, device="cpu")
        for n, p in state.model.named_parameters():
            p.grad = grads[n].clone()
        _, m = ttrain._update(state, torch.zeros(()))
        np.testing.assert_allclose(float(m["grad_norm"]), norm, rtol=1e-5)
    want = _jax_params(jstate.replace(params=params))
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_train_step_descends():
    """tests/test_models.py::test_train_step_descends on the port."""
    state = _port_state()
    losses = [m["loss"] for m in _steps(state, ttrain.train_step, 5,
                                        _t(_batch(4)))]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], f"loss did not descend: {losses}"


def test_clip_scales_to_the_global_norm():
    """A gradient of global norm above 5 is scaled to norm 5 (optax's
    clip_by_global_norm, no epsilon); grad_norm reports the norm before."""
    state = _port_state()
    params = list(state.model.parameters())
    for p in params:
        p.grad = torch.full_like(p, 0.5)
    norm = math.sqrt(sum(0.25 * p.numel() for p in params))
    assert norm > ttrain.CLIP_NORM
    _, metrics = ttrain._update(state, torch.zeros(()))
    np.testing.assert_allclose(float(metrics["grad_norm"]), norm, rtol=1e-6)
    clipped = math.sqrt(sum(float(p.grad.square().sum()) for p in params))
    np.testing.assert_allclose(clipped, ttrain.CLIP_NORM, rtol=1e-6)


def test_entry_points_take_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.create_train_state(tcfg, 0, _t(_batch(4)))


# --- dropout ---------------------------------------------------------------------

def test_dropout_train_step_uses_only_explicit_generators():
    """Dropout 0.1: two states from one seed take equal steps, a state with
    another dropout seed another step; the global RNG is left as it was."""
    _, tcfg = _cfgs(dropout=0.1)
    batch = _t(_batch(4))
    a, b, c = (ttrain.create_train_state(tcfg, 0, batch, learning_rate=LR,
                                         warmup_steps=WARMUP, device="cpu")
               for _ in range(3))
    c.dropout_seed += 1
    before = torch.random.get_rng_state()
    ma, mb, mc = (_steps(s, ttrain.train_step, 2, batch) for s in (a, b, c))
    assert torch.equal(torch.random.get_rng_state(), before)
    assert ma == mb and ma[0]["loss"] != mc[0]["loss"]
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    # The step seeds the masks: step 1 draws other masks than step 0.
    s0 = ttrain._dropout_generator(a).initial_seed()
    a.step += 1
    assert ttrain._dropout_generator(a).initial_seed() != s0


# --- checkpoints and the state converter -----------------------------------------

def test_train_state_from_optax_continues_jax_run():
    """JAX's state after 2 steps, converted, then one more step on each
    side: the same loss, grad_norm and parameters; the moments and counts
    cross as they are."""
    run = _jax_run()
    jstate = run[1][0]
    _, tcfg = _cfgs()
    state = convert.train_state_from_optax(
        jstate, tcfg, _t(_batch(4)), learning_rate=LR, warmup_steps=WARMUP,
        device="cpu")
    assert state.step == 2
    np.testing.assert_allclose(state.learning_rate, _lrs(3)[2], rtol=1e-6)
    adam = jstate.opt_state[1][0]
    mu = convert.transducer_params_from_flax(adam.mu, tcfg, device="cpu")
    for name, p in state.model.named_parameters():
        moments = state.optimizer.state[p]
        assert float(moments["step"]) == 2.0
        assert torch.equal(moments["exp_avg"], mu[name]), name
    start, batch = _named(state.model), _t(_batch(4))
    grads = _padded_grads(state, batch)
    got = _steps(state, ttrain.train_step, 1, batch)
    _close_metrics(got[0], run[2][1])
    data = tuple(jnp.asarray(a) for a in _batch(4))
    jgrads = jax.jit(jax.grad(lambda p: jnp.mean(jstate.apply_fn(
        {"params": p}, *data))))(jstate.params)
    close_params(_named(state.model), _jax_params(run[2][0]), start, grads,
                 convert.transducer_params_from_flax(jgrads, tcfg,
                                                     device="cpu"),
                 _lrs(3)[2:], first=3)


def test_train_module_has_the_jax_public_names():
    for jmod, tmod in ((jtrain, ttrain), (jaugment, taugment)):
        names = [n for n, obj in inspect.getmembers(jmod)
                 if not n.startswith("_")
                 and getattr(obj, "__module__", None) == jmod.__name__]
        assert names
        for name in names:
            assert hasattr(tmod, name), f"{tmod.__name__} lacks {name}"


# --- SpecAugment -------------------------------------------------------------------

def _augment_inputs():
    rng = np.random.RandomState(1)
    feats = torch.from_numpy(rng.rand(4, 50, 20).astype(np.float32) + 1.0)
    return feats, torch.tensor([50, 30, 10, 50], dtype=torch.int32)


def test_spec_augment_properties():
    """tests/test_metrics_augment.py::test_spec_augment_properties on the
    port: masked cells exactly zero and the rest untouched; time masks
    inside each sample's valid frames; one seed gives one mask, another
    seed another; no masks, no change."""
    feats, flen = _augment_inputs()
    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    out = taugment.spec_augment(gen(0), feats, flen, max_time_width=10,
                                max_freq_width=5)
    changed = out != feats
    assert bool(changed.any()) and bool((out[changed] == 0).all())
    out_t = taugment.spec_augment(gen(0), feats, flen, max_time_width=10,
                                  num_freq_masks=0)
    for b in range(4):
        assert torch.equal(out_t[b, int(flen[b]):], feats[b, int(flen[b]):])
    out2 = taugment.spec_augment(gen(0), feats, flen, max_time_width=10,
                                 max_freq_width=5)
    assert torch.equal(out, out2)
    out3 = taugment.spec_augment(gen(7), feats, flen, max_time_width=10,
                                 max_freq_width=5)
    assert not torch.equal(out, out3)
    ident = taugment.spec_augment(gen(0), feats, flen, num_time_masks=0,
                                  num_freq_masks=0)
    assert torch.equal(ident, feats)


@pytest.mark.parametrize("seed", range(4))
def test_spec_augment_width_caps(seed):
    """Over many draws: a time mask covers at most min(max_time_width,
    max_time_frac * length) frames each (so at most num times that in all),
    a frequency mask at most max_freq_width bins; a masked frame is masked
    across every bin and a masked bin across every frame."""
    feats, flen = _augment_inputs()
    for trial in range(20):
        g = torch.Generator().manual_seed(100 * seed + trial)
        t_only = taugment.spec_augment(g, feats, flen, max_time_width=10,
                                       max_time_frac=0.2, num_freq_masks=0)
        frames = (t_only == 0).all(dim=2)                   # [B, T]
        assert bool(((t_only == 0).any(dim=2) == frames).all())
        for b in range(4):
            cap = min(10, int(0.2 * int(flen[b])))
            assert int(frames[b].sum()) <= 2 * cap
        f_only = taugment.spec_augment(g, feats, flen, num_time_masks=0,
                                       max_freq_width=5)
        bins = (f_only == 0).all(dim=1)                     # [B, F]
        assert bool(((f_only == 0).any(dim=1) == bins).all())
        assert int(bins.sum(dim=1).max()) <= 2 * 5
