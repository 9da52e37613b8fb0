"""The port's torch binding (monotonic_rnnt_tpu_torch/interop) on every case
of tests/test_interop.py, and against the JAX binding's outputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monotonic_rnnt_tpu import monotonic_rnnt_loss as jax_loss
from monotonic_rnnt_tpu.interop import torch_binding as jbind
from monotonic_rnnt_tpu.ops.packing import pack_acts
from monotonic_rnnt_tpu_torch.interop import (MonotonicRNNTLoss,
                                              monotonic_rnnt_loss,
                                              monotonic_rnnt_loss_padded)
from monotonic_rnnt_tpu_torch.ops import loss as tloss
from monotonic_rnnt_tpu_torch.ops.cuda import kernels as tk

import golden

ENGINES = ["native", "torch"]


def _packed_readme():
    logits, labels, ilen, slen = golden.readme_batch()
    packed = np.asarray(pack_acts(jnp.asarray(logits), ilen, slen))
    return (torch.tensor(packed, requires_grad=True),
            torch.tensor(labels), torch.tensor(ilen), torch.tensor(slen))


@pytest.mark.parametrize("engine", ENGINES)
def test_golden_forward_backward(engine):
    acts, labels, ilen, slen = _packed_readme()
    costs = monotonic_rnnt_loss(acts, labels, ilen, slen, engine=engine)
    np.testing.assert_allclose(costs.detach().numpy(), [golden.README_LOSS],
                               atol=1e-4)
    costs.sum().backward()
    np.testing.assert_allclose(acts.grad.numpy().reshape(4, 3, 3),
                               golden.README_GRADS, atol=1e-2)


@pytest.mark.parametrize("engine", ENGINES)
def test_cotangent_scaling(engine):
    acts, labels, ilen, slen = _packed_readme()
    costs = monotonic_rnnt_loss(acts, labels, ilen, slen, engine=engine)
    (2.5 * costs.sum()).backward()
    np.testing.assert_allclose(acts.grad.numpy().reshape(4, 3, 3),
                               2.5 * golden.README_GRADS, atol=3e-2)


@pytest.mark.parametrize("engine", ENGINES)
def test_align_restrict_golden(engine):
    # Reference pytorch_binding/test.py:110 and :128 golden values.
    acts, labels, ilen, slen = _packed_readme()
    c1 = monotonic_rnnt_loss(acts, labels, ilen, slen,
                             alignment=torch.tensor(golden.ALIGN_A[None]),
                             max_distance_from_alignment=1, engine=engine)
    np.testing.assert_allclose(c1.detach().numpy(), [1.22], atol=1e-2)
    c2 = monotonic_rnnt_loss(acts, labels, ilen, slen,
                             alignment=torch.tensor(golden.ALIGN_B[None]),
                             max_distance_from_alignment=0, engine=engine)
    np.testing.assert_allclose(c2.detach().numpy(), [2.7], atol=1e-2)


def test_module_reductions():
    acts, labels, ilen, slen = _packed_readme()
    assert float(MonotonicRNNTLoss(reduction="sum")(
        acts, labels, ilen, slen).detach()) == pytest.approx(
            golden.README_LOSS, abs=1e-4)
    loss = MonotonicRNNTLoss(reduction="mean")(acts, labels, ilen, slen)
    loss.backward()
    assert acts.grad is not None
    costs = MonotonicRNNTLoss(reduction="none")(acts, labels, ilen, slen)
    assert costs.shape == (1,)
    with pytest.raises(ValueError, match="reduction"):
        MonotonicRNNTLoss(reduction="max")


@pytest.mark.parametrize("engine", ENGINES)
def test_multibatch(engine):
    logits, labels, ilen, slen, exp_losses, _ = golden.multibatch()
    packed = np.asarray(pack_acts(jnp.asarray(logits), ilen, slen))
    costs = monotonic_rnnt_loss(torch.tensor(packed), torch.tensor(labels),
                                torch.tensor(ilen), torch.tensor(slen),
                                engine=engine)
    np.testing.assert_allclose(costs.numpy(), exp_losses, atol=1e-4)


@pytest.mark.parametrize("engine", ENGINES)
def test_cost_only_under_no_grad(engine):
    acts, labels, ilen, slen = _packed_readme()
    with torch.no_grad():
        costs = monotonic_rnnt_loss(acts, labels, ilen, slen, engine=engine)
    np.testing.assert_allclose(costs.numpy(), [golden.README_LOSS], atol=1e-4)
    assert costs.grad_fn is None


def test_torch_engine_cost_only_takes_the_alpha_pass(monkeypatch):
    # On the kernel route (plain versions on the CPU), a cost-only call
    # launches stats+alpha and never beta+grad, as on the card.
    monkeypatch.setattr(tloss, "_resolve_backend", lambda b, x: "cuda")
    calls = []
    fused = tloss._LossCore

    class Spy(fused):
        @staticmethod
        def forward(ctx, *args):
            calls.append(ctx.needs_input_grad[0])
            return fused.forward(ctx, *args)

    monkeypatch.setattr(tloss, "_LossCore", Spy)
    acts, labels, ilen, slen = _packed_readme()
    with torch.no_grad():
        monotonic_rnnt_loss(acts, labels, ilen, slen, engine="torch")
    assert calls == [False]


def test_padded_entry_matches_the_jax_vjp():
    rng = np.random.RandomState(3)
    B, T, S, V = 3, 14, 4, 19
    logits = rng.randn(B, T, S + 1, V).astype(np.float32)
    labels = rng.randint(1, V, (B, S)).astype(np.int32)
    ilen = np.array([14, 9, 14], np.int32)
    slen = np.array([4, 2, 0], np.int32)
    cot = np.array([1.5, -2.0, 0.25], np.float32)

    t_logits = torch.tensor(logits, requires_grad=True)
    costs = monotonic_rnnt_loss_padded(
        t_logits, torch.tensor(labels), torch.tensor(ilen),
        torch.tensor(slen))
    (costs * torch.tensor(cot)).sum().backward()

    def f(lg):
        return jnp.sum(jax_loss(lg, jnp.asarray(labels), jnp.asarray(ilen),
                                jnp.asarray(slen)) * jnp.asarray(cot))

    val, g = jax.value_and_grad(f)(jnp.asarray(logits))
    np.testing.assert_allclose(costs.detach().numpy() @ cot, float(val),
                               rtol=1e-5)
    np.testing.assert_allclose(t_logits.grad.numpy(), np.asarray(g),
                               rtol=1e-4, atol=1e-6)


def test_padded_align_restrict_golden():
    logits, labels, ilen, slen = golden.readme_batch()
    for shift, expected in golden.ALIGN_A_LOSSES.items():
        costs = monotonic_rnnt_loss_padded(
            torch.tensor(logits), torch.tensor(labels), torch.tensor(ilen),
            torch.tensor(slen), alignment=torch.tensor(golden.ALIGN_A[None]),
            max_distance_from_alignment=shift)
        np.testing.assert_allclose(costs.numpy(), [expected], rtol=1e-4)


def test_padded_cost_only_no_grad():
    logits, labels, ilen, slen = golden.readme_batch()
    with torch.no_grad():
        costs = monotonic_rnnt_loss_padded(
            torch.tensor(logits), torch.tensor(labels), torch.tensor(ilen),
            torch.tensor(slen))
    np.testing.assert_allclose(costs.numpy(), [golden.README_LOSS], atol=1e-4)


def test_torch_engine_matches_native():
    # Golden values, multibatch offsets with per-sample cotangents.
    logits, labels, ilen, slen, exp_losses, _ = golden.multibatch()
    packed = np.asarray(pack_acts(jnp.asarray(logits), ilen, slen))
    a_nat = torch.tensor(packed, requires_grad=True)
    a_tor = torch.tensor(packed, requires_grad=True)
    args = (torch.tensor(labels), torch.tensor(ilen), torch.tensor(slen))
    c_nat = monotonic_rnnt_loss(a_nat, *args, engine="native")
    c_tor = monotonic_rnnt_loss(a_tor, *args, engine="torch")
    np.testing.assert_allclose(c_tor.detach().numpy(),
                               c_nat.detach().numpy(), atol=1e-4)
    w = torch.tensor([1.0, 0.5])
    (w * c_nat).sum().backward()
    (w * c_tor).sum().backward()
    np.testing.assert_allclose(a_tor.grad.numpy(), a_nat.grad.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("engine", ENGINES)
def test_bucket_padded_metadata(engine):
    """Labels padded wider than max(label_lengths) and an alignment wider
    than max(input_lengths) work on both engines alike."""
    acts, labels, ilen, slen = _packed_readme()
    wide_labels = torch.cat(
        [labels, torch.zeros((labels.shape[0], 3), dtype=labels.dtype)], 1)
    c_nat = monotonic_rnnt_loss(acts.detach().clone(), wide_labels, ilen,
                                slen, engine="native")
    a = acts.detach().clone().requires_grad_(True)
    c = monotonic_rnnt_loss(a, wide_labels, ilen, slen, engine=engine)
    np.testing.assert_allclose(c.detach().numpy(), c_nat.numpy(), atol=1e-4)
    c.sum().backward()
    assert np.isfinite(a.grad.numpy()).all()
    align = torch.tensor(golden.ALIGN_A[None])
    wide_align = torch.cat([align, torch.zeros((1, 2), dtype=align.dtype)], 1)
    c1 = monotonic_rnnt_loss(acts.detach().clone(), wide_labels, ilen, slen,
                             alignment=wide_align,
                             max_distance_from_alignment=1, engine=engine)
    np.testing.assert_allclose(c1.numpy(), [1.22], atol=1e-2)


@pytest.mark.parametrize("restricted", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_matches_the_jax_binding(engine, restricted):
    # The port's engines against the JAX binding's on the same torch
    # inputs: native against its native engine (the same C++ source, bit
    # for bit), torch against its JAX engine (costs 1e-5, grads 1e-4
    # relative).
    rng = np.random.RandomState(31)
    b, t, s, v = 3, 9, 4, 11
    ilen = np.array([9, 6, 8], np.int32)
    slen = np.array([4, 1, 3], np.int32)
    logits = (rng.randn(b, t, s + 1, v) * 2).astype(np.float32)
    labels = rng.randint(1, v, (b, s)).astype(np.int32)
    packed = np.asarray(pack_acts(jnp.asarray(logits), ilen, slen))
    kw = {}
    if restricted:
        align = np.zeros((b, t), np.int32)
        for i in range(b):
            pos = np.sort(rng.choice(ilen[i], size=slen[i], replace=False))
            align[i, pos] = labels[i, :slen[i]]
        kw = dict(alignment=torch.from_numpy(align),
                  max_distance_from_alignment=1)
    w = torch.tensor([1.0, -0.5, 2.0])
    out = {}
    for name, fn, eng in (("port", monotonic_rnnt_loss, engine),
                          ("jax", jbind.monotonic_rnnt_loss,
                           "native" if engine == "native" else "jax")):
        a = torch.tensor(packed, requires_grad=True)
        costs = fn(a, torch.from_numpy(labels), torch.from_numpy(ilen),
                   torch.from_numpy(slen), engine=eng, **kw)
        (costs * w).sum().backward()
        out[name] = (costs.detach().numpy(), a.grad.numpy())
    if engine == "native":
        np.testing.assert_array_equal(out["port"][0], out["jax"][0])
        np.testing.assert_array_equal(out["port"][1], out["jax"][1])
    else:
        np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-5)
        np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=1e-4,
                                   atol=1e-6)


def test_engine_choice_and_its_errors():
    acts, labels, ilen, slen = _packed_readme()
    with pytest.raises(ValueError, match="'native', 'torch'"):
        monotonic_rnnt_loss(acts, labels, ilen, slen, engine="jax")
    meta = torch.empty(acts.shape, device="meta")
    with pytest.raises(ValueError, match="needs CPU tensors"):
        monotonic_rnnt_loss(meta, labels, ilen, slen, engine="native")
    # engine=None on CPU tensors is the native engine: no kernel wrapper runs.
    before = dict(tk.LAUNCHES)
    costs = monotonic_rnnt_loss(acts, labels, ilen, slen)
    np.testing.assert_allclose(costs.detach().numpy(), [golden.README_LOSS],
                               atol=1e-4)
    assert tk.LAUNCHES == before
