"""The port's sharded losses against the JAX package's, over 4 processes.

A module fixture starts ONE launch of 4 CPU processes (this file run with
``--worker``), a gloo group of world size 4; each builds the meshes (4,1),
(1,4) and (2,2), runs every case below on its shard and writes its results
to an .npz file. The worker imports the port only. Each test then runs one
case's JAX function on the fake 8-device mesh (tests/conftest.py), on the
same numpy-seeded inputs (the cases of tests/test_parallel.py), and holds
the port's global loss and the gradient slices of all 4 ranks, put back
together, against it: losses rtol 1e-5, gradients rtol 1e-4 / atol 1e-5
(test_parallel.py's tolerances). On the CPU the port's kernel wrappers take
their plain versions. The launch has its own 300 s timeout, so that a hung
group fails the tests instead of the suite.

The train steps (TRAIN_CASES: make_sharded_train_step and
make_grad_accum_train_step(2, mesh) on (4,1), make_tp_sharded_train_step
on (2,2) and (1,4), full and banded) start from
the initial weights of JAX's create_train_state on the tiny config of
tests/test_models.py (every dtype float32), which the fixture writes before
the launch; each takes two steps (the first at lr 0) on tiny_batch(8), and
each test holds the losses, grad_norms and parameters, put back together,
against JAX's train_step (banded: the oracle step of
test_tp_banded_train_step_matches_oracle) at tests/test_torch_train.py's
tolerances (tests/torch_train_check.py).
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_train_check import close_params  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
LAUNCH_TIMEOUT_S = 300
MESHES = ((4, 1), (1, 4), (2, 2))
# Per gradient: the mesh axis of each dimension (None: whole), as JAX's
# in_specs shard them.
LOGITS = ("data", None, None, "model")
JOINT_SPECS = {"we": (), "wp": (), "wv": (None, "model"), "bv": ("model",)}
FUSED_GRADS = {"enc": ("data", None, None), "pred": ("data", None, None),
               **JOINT_SPECS}


# --- numpy inputs (tests/test_parallel.py's) -------------------------------------

def _case(seed=0, batch=8, t=12, s=4, v=16):
    rng = np.random.RandomState(seed)
    logits = rng.randn(batch, t, s + 1, v).astype(np.float32)
    labels = rng.randint(1, v, size=(batch, s)).astype(np.int32)
    ilen = rng.randint(s + 1, t + 1, size=(batch,)).astype(np.int32)
    slen = rng.randint(0, s + 1, size=(batch,)).astype(np.int32)
    return logits, labels, ilen, slen


def _blank_case():
    rng = np.random.RandomState(4)
    batch, t, s, v = 4, 6, 2, 16
    logits = rng.randn(batch, t, s + 1, v).astype(np.float32)
    labels = rng.randint(0, 8, size=(batch, s)).astype(np.int32)
    return (logits, labels, np.full((batch,), t, np.int32),
            np.full((batch,), s, np.int32))


def _neg_inf_shard_case():
    """_case(2)'s lattice with rows whose columns [8, 16) -- all of shard 1
    on a (1, 4) mesh -- are -inf, and rows all -inf on every shard."""
    logits, labels, ilen, slen = _case(2, batch=8, t=10, s=3, v=32)
    logits[:, ::3, :, 8:16] = -np.inf
    logits[2, 4, 1] = -np.inf
    return logits, labels, ilen, slen


def _banded_case(seed, batch, t, s, v, shift, blank_id=0):
    """(logits, labels, ilen, slen, alignment, shift, blank): the full
    lattice and a random monotonic alignment; each side packs its band."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(batch, t, s + 1, v).astype(np.float32)
    lab_lo, lab_hi = (1, v) if blank_id == 0 else (0, blank_id)
    labels = rng.randint(lab_lo, lab_hi, size=(batch, s)).astype(np.int32)
    ilen = rng.randint(max(s, 1), t + 1, size=(batch,)).astype(np.int32)
    slen = rng.randint(0, np.minimum(s, ilen) + 1, size=(batch,)).astype(
        np.int32)
    align = np.full((batch, t), blank_id, np.int32)
    for b in range(batch):
        pos = np.sort(rng.choice(ilen[b], size=slen[b], replace=False))
        align[b, pos] = labels[b, :slen[b]]
    return logits, labels, ilen, slen, align, shift, blank_id


BANDED = {"banded_2x2": ((2, 2), (5, 4, 14, 5, 32, 2)),
          "banded_1x4": ((1, 4), (5, 4, 14, 5, 32, 2)),
          "banded_blank": ((1, 4), (7, 4, 10, 3, 16, 1, 9))}


def _fused_setup(seed=11, batch=4, t=10, s=3, v=16, de=6, dp_=5, j=8):
    rng = np.random.RandomState(seed)
    enc = rng.randn(batch, t, de).astype(np.float32)
    pred = rng.randn(batch, s + 1, dp_).astype(np.float32)
    labels = rng.randint(1, v, size=(batch, s)).astype(np.int32)
    ilen = rng.randint(s + 1, t + 1, (batch,)).astype(np.int32)
    slen = rng.randint(1, s + 1, (batch,)).astype(np.int32)
    params = {
        "we": rng.randn(de, j).astype(np.float32) * 0.5,
        "wp": rng.randn(dp_, j).astype(np.float32) * 0.5,
        "wv": rng.randn(j, v).astype(np.float32) * 0.5,
        "bv": rng.randn(v).astype(np.float32) * 0.1,
    }
    return enc, pred, labels, ilen, slen, params


# (mesh, band shift or None): the train-step cases.
TRAIN_CASES = {"train_dp_4x1": ((4, 1), None),
               "train_accum_dp_4x1": ((4, 1), None),
               "train_tp_2x2": ((2, 2), None),
               "train_tp_1x4": ((1, 4), None),
               "train_tp_banded_2x2": ((2, 2), 2),
               "train_tp_banded_1x4": ((1, 4), 2)}
TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS = 3e-3, 1, 2
VOCAB_SPECS = {"joint.vocab_proj.weight": ("model", None),
               "joint.vocab_proj.bias": ("model",)}


def _train_batch():
    """tiny_batch(batch=8, t=32, feat_dim=16, s=4, vocab=32), as numpy
    draws it (monotonic_rnnt_tpu/data/synthetic.py)."""
    rng = np.random.RandomState(0)
    feats = rng.randn(8, 32, 16).astype(np.float32)
    labels = rng.randint(1, 32, size=(8, 4)).astype(np.int32)
    return (feats, np.full((8,), 32, np.int32), labels,
            np.full((8,), 4, np.int32))


def _train_alignment(labels, enc_lengths, slen, t_out, seed=5):
    """test_tp_banded_train_step_matches_oracle's synthetic alignment."""
    rng = np.random.RandomState(seed)
    align = np.zeros((len(slen), t_out), np.int32)
    for b in range(len(slen)):
        pos = np.sort(rng.choice(int(enc_lengths[b]), size=int(slen[b]),
                                 replace=False))
        align[b, pos] = labels[b, :int(slen[b])]
    return align


def _fused_alignment(labels, ilen, slen, t, seed):
    rng = np.random.RandomState(seed)
    align = np.zeros((len(ilen), t), np.int32)
    for b in range(len(ilen)):
        pos = np.sort(rng.choice(int(ilen[b]), size=int(slen[b]),
                                 replace=False))
        align[b, pos] = labels[b, :int(slen[b])]
    return align


# --- the worker (imports the port only) -------------------------------------------

def _worker(rank: int, world: int, out_dir: Path) -> None:
    import torch.distributed as dist

    import monotonic_rnnt_tpu_torch as mt
    from monotonic_rnnt_tpu_torch import parallel as par
    from monotonic_rnnt_tpu_torch.ops.collective import sharded_lattice_stats
    from monotonic_rnnt_tpu_torch.ops.helpers import extend_labels

    torch.set_num_threads(1)
    par.initialize_multihost(f"file://{out_dir / 'rendezvous'}", world, rank,
                             backend="gloo", timeout_s=120)
    meshes = {shape: par.make_mesh(*shape, device="cpu") for shape in MESHES}
    out = {}

    def shard(x, spec, mesh, grad=False):
        t = par.local_shard(torch.from_numpy(np.asarray(x)), spec, mesh)
        return t.requires_grad_(True) if grad else t

    def batch_of(mesh, *arrays):
        return [shard(a, ("data",), mesh) for a in arrays]

    def save(case, loss, **grads):
        out[f"{case}.loss"] = float(loss)
        for name, g in grads.items():
            out[f"{case}.{name}"] = g.detach().numpy()

    def logits_case(case, mesh, data, make_fn, **kw):
        logits, labels, ilen, slen = data
        x = shard(logits, LOGITS, mesh, grad=True)
        loss_fn = make_fn(mesh, **kw)
        loss = loss_fn(x, *batch_of(mesh, labels, ilen, slen))
        loss.backward()
        with torch.no_grad():
            cost_only = loss_fn(x, *batch_of(mesh, labels, ilen, slen))
        assert float(cost_only) == float(loss), (case, cost_only, loss)
        save(case, loss, logits=x.grad)

    logits_case("dp", meshes[4, 1], _case(), par.make_data_parallel_loss)
    x = shard(_case(1)[0], LOGITS, meshes[4, 1])
    out["per_sample.costs"] = par.make_per_sample_loss(meshes[4, 1])(
        x, *batch_of(meshes[4, 1], *_case(1)[1:])).numpy()
    for shape in ((1, 4), (2, 2)):
        logits_case(f"tp_{shape[0]}x{shape[1]}", meshes[shape],
                    _case(2, batch=8, t=10, s=3, v=32), par.make_dp_tp_loss)
    logits_case("tp_sum", meshes[2, 2], _case(3, batch=4, t=8, s=3, v=16),
                par.make_dp_tp_loss, mean_over_batch=False)
    logits_case("tp_blank", meshes[1, 4], _blank_case(), par.make_dp_tp_loss,
                blank_id=9, mean_over_batch=False)

    # Per-sample weights on the sharded core: the cotangent folded in.
    mesh = meshes[2, 2]
    logits, labels, ilen, slen = _case(3, batch=4, t=8, s=3, v=16)
    x = shard(logits, LOGITS, mesh, grad=True)
    lb, il, sl = batch_of(mesh, labels, ilen, slen)
    bands = mt.default_bands(il, sl, x.shape[1])
    costs = par.rnnt_loss_vocab_sharded(x, lb, il, sl, bands.min_s,
                                        bands.max_s, 0, mesh.model_group)
    weights = shard(np.linspace(-0.5, 2.0, 4).astype(np.float32), ("data",),
                    mesh)
    (costs * weights).sum().backward()
    out["tp_weighted.costs"] = costs.detach().numpy()
    out["tp_weighted.logits"] = x.grad.numpy()

    mesh = meshes[1, 4]
    logits, labels, ilen, slen = _neg_inf_shard_case()
    lab = extend_labels(torch.from_numpy(labels), torch.from_numpy(slen),
                        logits.shape[2])
    stats, _ = sharded_lattice_stats(shard(logits, LOGITS, mesh), lab, 0,
                                     mesh.model_group)
    for name, value in stats._asdict().items():
        out[f"neg_inf_shard.{name}"] = value.numpy()

    for case, (shape, args) in BANDED.items():
        mesh = meshes[shape]
        logits, labels, ilen, slen, align, shift, blank = _banded_case(*args)
        il, sl = torch.from_numpy(ilen), torch.from_numpy(slen)
        bands = mt.bands_from_alignment(torch.from_numpy(align), il, sl, shift,
                                        blank)
        t, s1 = logits.shape[1], logits.shape[2]
        w = int(mt.required_band_width(il, sl, bands, t, s1))
        layout = mt.compute_band_layout(il, sl, bands, t, s1, w)
        band = mt.pack_band(torch.from_numpy(logits), layout)
        x = shard(band, LOGITS, mesh, grad=True)
        loss = par.make_dp_tp_banded_loss(mesh, blank_id=blank,
                                          mean_over_batch=False)(
            x, *batch_of(mesh, labels, ilen, slen, bands.min_s.numpy(),
                         bands.max_s.numpy()))
        loss.backward()
        save(case, loss, logits=x.grad)
        out[f"{case}.width"] = w

    def joint(params, enc_c, pred):
        e = enc_c.float() @ params["we"]
        p = pred.float() @ params["wp"]
        return torch.tanh(e[:, :, None, :] + p[:, None, :, :]) \
            @ params["wv"] + params["bv"]

    def joint_banded(params, enc_c, pred_band):
        e = enc_c.float() @ params["we"]
        p = pred_band.float() @ params["wp"]
        return torch.tanh(e[:, :, None, :] + p) @ params["wv"] + params["bv"]

    def fused_case(case, seed, chunk_t, make, **kw):
        mesh = meshes[2, 2]
        enc, pred, labels, ilen, slen, params = _fused_setup(seed=seed)
        e = shard(enc, FUSED_GRADS["enc"], mesh, grad=True)
        p = shard(pred, FUSED_GRADS["pred"], mesh, grad=True)
        pr = {k: shard(v, JOINT_SPECS[k], mesh, grad=True)
              for k, v in params.items()}
        band_args = []
        if case != "fused":
            il, sl = torch.from_numpy(ilen), torch.from_numpy(slen)
            bands = mt.bands_from_alignment(
                torch.from_numpy(_fused_alignment(labels, ilen, slen,
                                                  enc.shape[1], seed + 1)),
                il, sl, 1, 0)
            band_args = batch_of(mesh, bands.min_s.numpy(),
                                 bands.max_s.numpy())
            if case == "fused_banded":
                kw["band_width"] = int(mt.required_band_width(
                    il, sl, bands, enc.shape[1], pred.shape[1]))
        loss = make(mesh, joint_banded if case == "fused_banded" else joint,
                    JOINT_SPECS, chunk_t=chunk_t, mean_over_batch=False,
                    **kw)(e, p, *batch_of(mesh, labels, ilen, slen), pr,
                          *band_args)
        loss.backward()
        save(case, loss, enc=e.grad, pred=p.grad,
             **{k: v.grad for k, v in pr.items()})

    fused_case("fused", 11, 4, par.make_dp_tp_fused_loss)
    fused_case("fused_bands", 12, 5, par.make_dp_tp_fused_loss,
               with_bands=True)
    fused_case("fused_banded", 21, 5, par.make_dp_tp_fused_banded_loss)

    from monotonic_rnnt_tpu_torch import models as tm
    from monotonic_rnnt_tpu_torch.models import train as ttrain

    f32 = torch.float32
    tcfg = tm.TransducerConfig(
        encoder=tm.ConformerConfig(num_layers=1, dim=64, num_heads=2,
                                   dropout=0.0, dtype=f32),
        predictor=tm.PredictorConfig(vocab_size=32, dim=64, embed_dim=32,
                                     dtype=f32),
        joint_dim=64, vocab_size=32, dtype=f32)
    batch = tuple(torch.from_numpy(a) for a in _train_batch())
    init = torch.load(out_dir / "train_init.pt", weights_only=True)
    for case, (shape, shift) in TRAIN_CASES.items():
        mesh = meshes[shape]
        state = ttrain.create_train_state(
            tcfg, 0, batch, learning_rate=TRAIN_LR,
            warmup_steps=TRAIN_WARMUP, device="cpu")
        state.model.load_state_dict(init)
        extra = ()
        if case == "train_dp_4x1":
            step = ttrain.make_sharded_train_step(mesh)
        elif case == "train_accum_dp_4x1":    # 2 rows a rank, 1 a micro
            step = ttrain.make_grad_accum_train_step(2, mesh)
        else:
            width = None
            if shift is not None:
                enc_len = tm.conformer.subsampled_length(tcfg.encoder,
                                                         batch[1])
                t_out = int(enc_len.max())
                bands = mt.bands_from_alignment(torch.from_numpy(
                    _train_alignment(_train_batch()[2], enc_len.numpy(),
                                     batch[3].numpy(), t_out)),
                    enc_len, batch[3], shift, 0)
                width = int(mt.required_band_width(enc_len, batch[3], bands,
                                                   t_out, 5))
                extra = (bands,)
                out[f"{case}.width"] = width
            specs = ttrain.transducer_tp_specs(state.model)
            out[f"{case}.n_sharded"] = sum("model" in sp
                                           for sp in specs.values())
            state = ttrain.shard_train_state(state, mesh)
            step = ttrain.make_tp_sharded_train_step(
                mesh, state.model, chunk_t=8, band_width=width)
        for k in range(TRAIN_STEPS):
            state, metrics = step(state, batch, *extra)
            out[f"{case}.loss{k}"] = float(metrics["loss"])
            out[f"{case}.grad_norm{k}"] = float(metrics["grad_norm"])
            if k == 0:   # the first step's gradients, as they were clipped
                scale = max(1.0, float(metrics["grad_norm"])
                            / ttrain.CLIP_NORM)
                for n, p in state.model.named_parameters():
                    out[f"{case}.grad.{n}"] = (p.grad * scale).numpy()
        for n, p in state.model.named_parameters():
            out[f"{case}.param.{n}"] = p.detach().numpy()
        if "_tp_" in case:    # the moments of the sharded leaves
            out[f"{case}.sharded_moments"] = sum(
                state.optimizer.state[p][key].shape == p.shape
                for n, p in state.model.named_parameters()
                if n in VOCAB_SPECS for key in ("exp_avg", "exp_avg_sq"))

    np.savez(out_dir / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


# --- the launch --------------------------------------------------------------------

def _jax_train_state():
    import jax
    import jax.numpy as jnp

    from monotonic_rnnt_tpu.models import train as jtrain

    return jtrain.create_train_state(
        _configs()[0], jax.random.PRNGKey(0),
        tuple(jnp.asarray(a) for a in _train_batch()),
        learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP)


def _configs():
    """The tiny config of tests/test_models.py, every dtype float32: (JAX,
    port)."""
    import jax.numpy as jnp

    from monotonic_rnnt_tpu import models as jm
    from monotonic_rnnt_tpu_torch import models as tm

    def make(mod, dt):
        return mod.TransducerConfig(
            encoder=mod.ConformerConfig(num_layers=1, dim=64, num_heads=2,
                                        dropout=0.0, dtype=dt),
            predictor=mod.PredictorConfig(vocab_size=32, dim=64,
                                          embed_dim=32, dtype=dt),
            joint_dim=64, vocab_size=32, dtype=dt)
    return make(jm, jnp.float32), make(tm, torch.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from monotonic_rnnt_tpu_torch import convert

    out = tmp_path_factory.mktemp("torch_parallel")
    torch.save(convert.transducer_params_from_flax(
        _jax_train_state().params, _configs()[1], device="cpu"),
        out / "train_init.pt")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    logs = [open(out / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r), str(WORLD), str(out)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env)
        for r in range(WORLD)]
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.returncode]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode]
    if bad:
        text = "\n".join(f"--- rank {r} (rc {procs[r].returncode}):\n"
                         + (out / f"rank{r}.log").read_text()[-3000:]
                         for r in bad)
        pytest.fail(f"the 4-rank launch failed or passed {LAUNCH_TIMEOUT_S} s:"
                    f"\n{text}")
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _loss(ranks, case):
    """The global scalar, which every rank must hold."""
    losses = [float(r[f"{case}.loss"]) for r in ranks]
    assert all(x == losses[0] for x in losses), losses
    return losses[0]


def _assemble(ranks, key, spec, mesh_shape):
    """The global tensor from the ranks' shards (rank = d * model + m);
    shards held by several ranks must agree."""
    model = mesh_shape[1]
    index = {"data": lambda r: r // model, "model": lambda r: r % model}
    n = {"data": mesh_shape[0], "model": model}
    first = ranks[0][key]
    shape = [dim * (n[ax] if ax else 1)
             for dim, ax in zip(first.shape, list(spec) + [None] * 8)]
    out = np.full(shape, np.nan, np.float32)
    for r, res in enumerate(ranks):
        sl = tuple(slice(index[ax](r) * d, (index[ax](r) + 1) * d) if ax
                   else slice(None)
                   for d, ax in zip(res[key].shape, list(spec)
                                    + [None] * (res[key].ndim - len(spec))))
        held = out[sl]
        if not np.isnan(held).all():
            np.testing.assert_allclose(res[key], held, rtol=1e-6, atol=1e-7)
        out[sl] = res[key]
    assert not np.isnan(out).any()
    return out


def _close_grads(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


# --- the tests -----------------------------------------------------------------------

@pytest.mark.parametrize("case,data,model,kw", [
    ("dp", 4, 1, {}),
    ("tp_1x4", 1, 4, {}),
    ("tp_2x2", 2, 2, {}),
    ("tp_sum", 2, 2, {"mean_over_batch": False}),
    ("tp_blank", 1, 4, {"blank_id": 9, "mean_over_batch": False}),
])
def test_padded_sharded_loss_matches_jax_mesh(ranks, case, data, model, kw):
    import jax
    import jax.numpy as jnp

    from monotonic_rnnt_tpu.parallel import (make_data_parallel_loss,
                                             make_dp_tp_loss, make_mesh)

    inputs = {"dp": _case(), "tp_sum": _case(3, batch=4, t=8, s=3, v=16),
              "tp_blank": _blank_case()}.get(
        case, _case(2, batch=8, t=10, s=3, v=32))
    mesh = make_mesh(data=data, model=model)
    if case == "dp":
        loss_fn = make_data_parallel_loss(mesh, backend="reference")
    else:
        loss_fn = make_dp_tp_loss(mesh, **kw)
    logits, labels, ilen, slen = (jnp.asarray(a) for a in inputs)
    val, grad = jax.value_and_grad(
        lambda lg: loss_fn(lg, labels, ilen, slen))(logits)
    np.testing.assert_allclose(_loss(ranks, case), float(val), rtol=1e-5)
    _close_grads(_assemble(ranks, f"{case}.logits", LOGITS, (data, model)),
                 grad)


def test_per_sample_loss_matches_jax_mesh(ranks):
    import jax.numpy as jnp

    from monotonic_rnnt_tpu.parallel import make_mesh, make_per_sample_loss

    inputs = [jnp.asarray(a) for a in _case(1)]
    want = make_per_sample_loss(make_mesh(data=4, model=1),
                                backend="reference")(*inputs)
    got = np.concatenate([r["per_sample.costs"] for r in ranks])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_weighted_costs_fold_the_cotangent_per_sample(ranks):
    import jax.numpy as jnp

    from monotonic_rnnt_tpu.ops.reference import rnnt_loss_reference

    logits, labels, ilen, slen = (jnp.asarray(a) for a in _case(
        3, batch=4, t=8, s=3, v=16))
    costs, grads = rnnt_loss_reference(logits, labels, ilen, slen)
    weights = np.linspace(-0.5, 2.0, 4).astype(np.float32)
    got_costs = _assemble(ranks, "tp_weighted.costs", ("data",), (2, 2))
    np.testing.assert_allclose(got_costs, np.asarray(costs), rtol=1e-5)
    _close_grads(_assemble(ranks, "tp_weighted.logits", LOGITS, (2, 2)),
                 np.asarray(grads) * weights[:, None, None, None])


def test_an_all_neg_inf_shard_adds_nothing_to_the_denominator(ranks):
    """The port's deliberate difference from the Pallas partial kernel
    (se = NaN on an all -inf row): a shard whose slice of a row is all -inf
    gives m = -inf, se = 0 and adds nothing, so the combined statistics are
    the unsharded ones -- denom +inf (and lp_blank NaN, as the JAX oracle's
    -inf + inf) only where the row is -inf on every shard."""
    import jax.numpy as jnp

    from monotonic_rnnt_tpu.ops.reference import compute_stats

    logits, labels, ilen, slen = _neg_inf_shard_case()
    want = compute_stats(jnp.asarray(logits), jnp.asarray(labels),
                         jnp.asarray(slen), 0)
    for name in ("denom", "lp_blank", "lp_label"):
        got = [r[f"neg_inf_shard.{name}"] for r in ranks]
        for g in got[1:]:
            np.testing.assert_array_equal(g, got[0])
        np.testing.assert_allclose(got[0], np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6)
    assert got[0].shape == (8, 10, 4) and np.isinf(
        ranks[0]["neg_inf_shard.denom"][2, 4, 1])


@pytest.mark.parametrize("case", sorted(BANDED))
def test_banded_sharded_loss_matches_jax_mesh(ranks, case):
    import jax
    import jax.numpy as jnp

    from monotonic_rnnt_tpu.ops.bands import (bands_from_alignment,
                                              compute_band_layout, pack_band,
                                              required_band_width)
    from monotonic_rnnt_tpu.parallel import make_dp_tp_banded_loss, make_mesh

    (data, model), args = BANDED[case]
    logits, labels, ilen, slen, align, shift, blank = _banded_case(*args)
    labels, ilen, slen = (jnp.asarray(a) for a in (labels, ilen, slen))
    bands = bands_from_alignment(jnp.asarray(align), ilen, slen, shift, blank)
    t, s1 = logits.shape[1], logits.shape[2]
    w = int(required_band_width(ilen, slen, bands, t, s1))
    assert w == int(ranks[0][f"{case}.width"])
    band = pack_band(jnp.asarray(logits),
                     compute_band_layout(ilen, slen, bands, t, s1, w))
    loss_fn = make_dp_tp_banded_loss(make_mesh(data=data, model=model),
                                     blank_id=blank, mean_over_batch=False)
    val, grad = jax.value_and_grad(lambda lb: loss_fn(
        lb, labels, ilen, slen, bands.min_s, bands.max_s))(band)
    np.testing.assert_allclose(_loss(ranks, case), float(val), rtol=1e-5)
    _close_grads(_assemble(ranks, f"{case}.logits", LOGITS, (data, model)),
                 grad)


def _jax_joint(banded):
    import jax.numpy as jnp

    def joint(params, enc_c, pred):
        e = enc_c.astype(jnp.float32) @ params["we"]
        p = pred.astype(jnp.float32) @ params["wp"]
        p = p if banded else p[:, None, :, :]
        return jnp.tanh(e[:, :, None, :] + p) @ params["wv"] + params["bv"]

    return joint


@pytest.mark.parametrize("case,seed,chunk_t", [
    ("fused", 11, 4), ("fused_bands", 12, 5), ("fused_banded", 21, 5)])
def test_fused_sharded_loss_matches_jax_mesh(ranks, case, seed, chunk_t):
    """Value and every leaf's gradient: enc, pred and the joint's weights,
    its output projection sharded over 'model'."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from monotonic_rnnt_tpu.ops.bands import (bands_from_alignment,
                                              required_band_width)
    from monotonic_rnnt_tpu.parallel import (MODEL_AXIS,
                                             make_dp_tp_fused_banded_loss,
                                             make_dp_tp_fused_loss, make_mesh)

    enc, pred, labels, ilen, slen, params = _fused_setup(seed=seed)
    enc, pred, labels, ilen, slen = (jnp.asarray(a) for a in (
        enc, pred, labels, ilen, slen))
    params = {k: jnp.asarray(v) for k, v in params.items()}
    specs = {k: P(*spec) for k, spec in JOINT_SPECS.items()}
    mesh = make_mesh(data=2, model=2)
    band_args = ()
    if case == "fused":
        loss_fn = make_dp_tp_fused_loss(mesh, _jax_joint(False), specs,
                                        chunk_t=chunk_t, mean_over_batch=False)
    else:
        align = _fused_alignment(np.asarray(labels), np.asarray(ilen),
                                 np.asarray(slen), enc.shape[1], seed + 1)
        bands = bands_from_alignment(jnp.asarray(align), ilen, slen, 1, 0)
        band_args = (bands.min_s, bands.max_s)
        if case == "fused_bands":
            loss_fn = make_dp_tp_fused_loss(
                mesh, _jax_joint(False), specs, chunk_t=chunk_t,
                mean_over_batch=False, with_bands=True)
        else:
            width = int(required_band_width(ilen, slen, bands, enc.shape[1],
                                            pred.shape[1]))
            loss_fn = make_dp_tp_fused_banded_loss(
                mesh, _jax_joint(True), specs, band_width=width,
                chunk_t=chunk_t, mean_over_batch=False)
    assert MODEL_AXIS == "model"
    val, (g_enc, g_pred, g_params) = jax.value_and_grad(
        lambda e, p, pr: loss_fn(e, p, labels, ilen, slen, pr, *band_args),
        argnums=(0, 1, 2))(enc, pred, params)
    np.testing.assert_allclose(_loss(ranks, case), float(val), rtol=1e-5)
    want = {"enc": g_enc, "pred": g_pred, **g_params}
    for name, spec in FUSED_GRADS.items():
        _close_grads(_assemble(ranks, f"{case}.{name}", spec, (2, 2)),
                     want[name])


def _jax_train_reference(banded):
    """JAX's two steps from the fixture's initial state: ([(loss,
    grad_norm)], the params after them, the first step's gradients), by
    train_step, or for banded by the oracle step of
    test_tp_banded_train_step_matches_oracle (the mean banded loss on the
    monolithic logits, then the state's optimiser)."""
    import jax
    import jax.numpy as jnp
    import optax

    from monotonic_rnnt_tpu import monotonic_rnnt_loss
    from monotonic_rnnt_tpu.models import train as jtrain
    from monotonic_rnnt_tpu.models.transducer import MonotonicTransducer
    from monotonic_rnnt_tpu.ops.bands import bands_from_alignment

    state = _jax_train_state()
    feats, flen, labels, slen = (jnp.asarray(a) for a in _train_batch())
    if not banded:
        def loss_fn(p):
            return jnp.mean(state.apply_fn({"params": p}, feats, flen, labels,
                                           slen))
    else:
        model = MonotonicTransducer(_configs()[0])
        enc, enc_len = model.apply({"params": state.params}, feats, flen,
                                   True, method=lambda m, f, fl, d:
                                   m.encode(f, fl, d))
        align = _train_alignment(np.asarray(labels), np.asarray(enc_len),
                                 np.asarray(slen), enc.shape[1])
        bands = bands_from_alignment(jnp.asarray(align), enc_len, slen, 2, 0)

        def loss_fn(p):
            logits, el = model.apply({"params": p}, feats, flen, labels, True,
                                     method=lambda m, f, fl, la, d:
                                     m.logits(f, fl, la, d))
            return jnp.mean(monotonic_rnnt_loss(
                logits, labels, el, slen, bands=bands, backend="reference"))

    first = jax.jit(jax.grad(loss_fn))(state.params)
    metrics = []
    if not banded:
        step = jax.jit(jtrain.train_step)
        run = state
        for _ in range(TRAIN_STEPS):
            run, m = step(run, (feats, flen, labels, slen))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return metrics, run.params, first, state.params

    @jax.jit
    def oracle_step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = state.tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state, loss,
                optax.global_norm(grads))

    params, opt_state = state.params, state.opt_state
    for _ in range(TRAIN_STEPS):
        params, opt_state, loss, norm = oracle_step(params, opt_state)
        metrics.append((float(loss), float(norm)))
    return metrics, params, first, state.params


@pytest.fixture(scope="module")
def jax_train():
    return {banded: _jax_train_reference(banded) for banded in (False, True)}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_sharded_train_step_matches_jax(ranks, jax_train, case):
    """make_sharded_train_step, make_grad_accum_train_step with a mesh
    and make_tp_sharded_train_step (full and banded) over two steps: every
    rank's loss and grad_norm, and the
    parameters put back together from the ranks (the replicated ones equal
    on every rank), against JAX's steps on one device."""
    from monotonic_rnnt_tpu_torch import convert

    shape, shift = TRAIN_CASES[case]
    metrics, params, grads0, start = jax_train[shift is not None]
    for k, (loss, norm) in enumerate(metrics):
        for r in ranks:
            np.testing.assert_allclose(float(r[f"{case}.loss{k}"]), loss,
                                       rtol=1e-5)
            np.testing.assert_allclose(float(r[f"{case}.grad_norm{k}"]),
                                       norm, rtol=1e-4)
    tcfg = _configs()[1]
    to_port = lambda tree: convert.transducer_params_from_flax(  # noqa
        tree, tcfg, device="cpu")
    want, want_g = to_port(params), to_port(grads0)
    got, got_g = {}, {}
    for name in want:
        spec = VOCAB_SPECS.get(name, ()) if "_tp_" in case else ()
        got[name] = torch.from_numpy(_assemble(
            ranks, f"{case}.param.{name}", spec, shape))
        got_g[name] = torch.from_numpy(_assemble(
            ranks, f"{case}.grad.{name}", spec, shape))
    close_params(got, want, to_port(start), got_g, want_g,
                 [TRAIN_LR * min(1.0, k / TRAIN_WARMUP)
                  for k in range(TRAIN_STEPS)])


def test_tp_specs_shard_two_parameters_and_their_four_moments(ranks):
    """transducer_tp_specs marks exactly the vocab projection's weight and
    bias; after shard_train_state and the steps, their 4 AdamW moments
    hold the shard's shape on every rank."""
    for case, (shape, _) in TRAIN_CASES.items():
        if "_tp_" not in case:
            continue
        for r in ranks:
            assert int(r[f"{case}.n_sharded"]) == 2
            assert int(r[f"{case}.sharded_moments"]) == 4, case
            assert r[f"{case}.param.joint.vocab_proj.weight"].shape == (
                32 // shape[1], 64)


def test_local_batch_slice_contract(monkeypatch):
    """Shard-assignment arithmetic across the procs/n_data regimes
    (tests/test_multiprocess.py:79-108)."""
    from monotonic_rnnt_tpu_torch.parallel import Mesh, local_batch_slice
    from monotonic_rnnt_tpu_torch.parallel import mesh as mesh_mod

    mesh = Mesh(4, 2, 0, 0, None, None, torch.device("cpu"))

    def fake_counts(idx, procs):
        monkeypatch.setattr(mesh_mod, "_process_index", lambda: idx)
        monkeypatch.setattr(mesh_mod, "_process_count", lambda: procs)

    fake_counts(1, 2)
    assert local_batch_slice(8, mesh) == (4, 4)
    fake_counts(3, 4)
    assert local_batch_slice(8, mesh) == (6, 2)
    fake_counts(5, 8)
    assert local_batch_slice(8, mesh) == (4, 2)
    fake_counts(0, 3)
    with pytest.raises(ValueError):
        local_batch_slice(12, mesh)
    fake_counts(0, 6)
    with pytest.raises(ValueError):
        local_batch_slice(8, mesh)
    fake_counts(0, 1)
    with pytest.raises(ValueError):
        local_batch_slice(7, mesh)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
