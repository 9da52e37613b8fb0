"""The plain reference against the port on the CPU, at tiny sizes."""

import torch

from monotonic_rnnt_tpu_torch import monotonic_rnnt_loss
from monotonic_rnnt_tpu_torch.models import MonotonicTransducer

from h100_bench.entries.train import transducer_config
from h100_bench.reference import conformer
from h100_bench.reference.loss import padded_costs_differentiable, padded_loss
from h100_bench.weights import make_weights


def _lattice(seed=0, batch=3, t=9, s=4, v=7):
    g = torch.Generator().manual_seed(seed)
    logits = 2 * torch.randn(batch, t, s + 1, v, generator=g)
    labels = torch.randint(1, v, (batch, s), generator=g, dtype=torch.int32)
    tprime = torch.tensor([t, t - 2, 5][:batch], dtype=torch.int32)
    slen = torch.tensor([s, 2, 0][:batch], dtype=torch.int32)
    return logits, labels, tprime, slen


def test_padded_loss_matches_the_port():
    logits, labels, tprime, slen = _lattice()
    x = logits.clone().requires_grad_(True)
    costs = monotonic_rnnt_loss(x, labels, tprime, slen)
    (grad,) = torch.autograd.grad(costs.sum(), x)
    ref_costs, ref_grads = padded_loss(logits, labels, tprime, slen, 0,
                                       rows=[0, 1, 2])
    torch.testing.assert_close(costs.double(), ref_costs, rtol=1e-6,
                               atol=1e-5)
    torch.testing.assert_close(grad.double(), ref_grads, rtol=0, atol=1e-5)


def test_differentiable_costs_match_the_port():
    logits, labels, tprime, slen = _lattice(1)
    x = logits.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(
        monotonic_rnnt_loss(x, labels, tprime, slen).sum(), x)
    y = logits.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(
        padded_costs_differentiable(y, labels, tprime, slen).sum(), y)
    torch.testing.assert_close(grad, ref, rtol=0, atol=1e-5)


def test_model_matches_the_port(tiny_model):
    cfg = tiny_model
    weights = make_weights(cfg, 5, "cpu")
    port = MonotonicTransducer(transducer_config(cfg), cfg["feat_dim"],
                               device="cpu")
    ref = conformer.build(cfg).to_empty(device="cpu")
    with torch.no_grad():
        for model in (port, ref):
            for name, p in model.named_parameters():
                p.copy_(weights[name])
    assert sorted(n for n, _ in port.named_parameters()) == sorted(weights)
    g = torch.Generator().manual_seed(3)
    feats = torch.randn(2, 45, cfg["feat_dim"], generator=g)
    frames = torch.tensor([45, 30])
    labels = torch.randint(1, cfg["vocab_size"], (2, 3), generator=g)
    got, got_len = port.logits(feats, frames, labels)
    want, want_len = ref(feats, frames, labels)
    assert torch.equal(got_len, want_len)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
