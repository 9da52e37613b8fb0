"""The port's CUDA kernels on a GPU: each against its plain version, and the
loss through them against the plain-torch oracle.

Every test here is marked ``cuda`` and skips where no GPU is present. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import golden
import monotonic_rnnt_tpu_torch as mt
from monotonic_rnnt_tpu_torch import convert
from monotonic_rnnt_tpu_torch.ops.cuda import fused
from monotonic_rnnt_tpu_torch.ops.cuda import kernels as K

pytestmark = pytest.mark.cuda

# (seed, B, T, S, V, blank): blank != 0 with V = 79; S1 > 1024 threads.
SHAPES = [(1, 3, 17, 6, 79, 5), (2, 2, 40, 12, 1000, 0), (3, 1, 1100, 1030, 8, 2)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _inputs(device, seed, batch, t, s, v, blank, dtype):
    logits, labels, ilen, slen = golden.repeat_label_case(seed, batch, t, s,
                                                          v, blank_id=blank)
    lg, lb, il, sl = convert.loss_inputs_from_numpy(logits, labels, ilen, slen,
                                                    device=device, dtype=dtype)
    ilen, slen, bands, lab = fused._prepare(lg, lb, il, sl, None)
    a_lo, a_hi, bwin = fused._windows(ilen, slen, bands, t, s + 1)
    sa_args = (lg, lab, a_lo, a_hi, blank)
    denom, lpb, lpl, alphas = K.stats_alpha_fused_plain(*sa_args)
    ll = fused._gather_ll(alphas, ilen, slen)
    lpbb, lplb, aprev, llb, bvirt = fused.beta_grad_operands(lpb, lpl, alphas,
                                                             ll, slen, bwin)
    bg_args = (lg, denom, lpbb, lplb, aprev, ilen, llb, bvirt, lab, blank)
    return sa_args, bg_args


def _close(got, ref, atol, rtol):
    got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_stats_alpha_kernel_matches_plain(device, shape, dtype):
    sa_args, _ = _inputs(device, *shape, dtype)
    before = K.LAUNCHES["stats_alpha_fused"]
    got = K.stats_alpha_fused(*sa_args)
    want = K.stats_alpha_fused_plain(*sa_args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["stats_alpha_fused"] == before + 1
    # The kernel sums V in another order than torch.logsumexp; the alphas
    # carry that rounding through T log-space steps.
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, 1e-5, 1e-6)
    _close(got[3], want[3], 1e-4, 1e-5)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_beta_grad_kernel_matches_plain(device, shape, dtype, scaled):
    _, bg_args = _inputs(device, *shape, dtype)
    scale = (torch.linspace(-0.5, 2.0, shape[1], device=device) if scaled
             else None)
    g_k, b_k = K.beta_grad_fused(*bg_args, grad_scale=scale)
    g_p, b_p = K.beta_grad_fused_plain(*bg_args, grad_scale=scale)
    torch.cuda.synchronize()
    assert g_k.dtype == dtype
    _close(b_k, b_p, 1e-4, 1e-5)
    _close(g_k, g_p, 1e-6, 8e-3 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_through_kernels_matches_oracle(device, dtype):
    logits, labels, ilen, slen = golden.repeat_label_case(7, 4, 30, 8, 300)
    lg, lb, il, sl = convert.loss_inputs_from_numpy(logits, labels, ilen, slen,
                                                    device=device, dtype=dtype)
    w = torch.tensor([1.0, -0.5, 2.0, 0.25], device=device)
    out = {}
    for backend in ("cuda", "reference"):
        K.reset_launch_counts()
        x = lg.clone().requires_grad_(True)
        costs = mt.monotonic_rnnt_loss(x, lb, il, sl, backend=backend)
        (costs * w).sum().backward()
        torch.cuda.synchronize()
        out[backend] = (costs.detach(), x.grad, dict(K.LAUNCHES))
    assert out["cuda"][2] == {"stats_alpha_fused": 1, "beta_grad_fused": 1}
    assert out["reference"][2] == {"stats_alpha_fused": 0, "beta_grad_fused": 0}
    assert out["cuda"][1].dtype == dtype
    _close(out["cuda"][0], out["reference"][0], 1e-4, 1e-5)
    _close(out["cuda"][1], out["reference"][1], 1e-6,
           1.6e-2 if dtype == torch.bfloat16 else 1e-4)

    K.reset_launch_counts()
    with torch.no_grad():
        costs = mt.monotonic_rnnt_loss(lg, lb, il, sl)
    assert K.LAUNCHES == {"stats_alpha_fused": 1, "beta_grad_fused": 0}
    assert torch.equal(costs, out["cuda"][0])


def test_strided_logits_reach_the_kernels_contiguous(device):
    logits, labels, ilen, slen = golden.repeat_label_case(8, 3, 12, 4, 50)
    lg, lb, il, sl = convert.loss_inputs_from_numpy(logits, labels, ilen, slen,
                                                    device=device)
    x = lg.transpose(0, 1).contiguous().transpose(0, 1).requires_grad_(True)
    costs = mt.monotonic_rnnt_loss(x, lb, il, sl, backend="cuda")
    costs.sum().backward()
    want_c, want_g = mt.rnnt_loss_reference(lg, lb, il, sl)
    _close(costs.detach(), want_c, 1e-4, 1e-5)
    _close(x.grad, want_g, 1e-6, 1e-4)


def test_readme_golden_on_gpu(device):
    lg, lb, il, sl = convert.loss_inputs_from_numpy(*golden.readme_batch(),
                                                    device=device)
    x = lg.clone().requires_grad_(True)
    costs = mt.monotonic_rnnt_loss(x, lb, il, sl, backend="cuda")
    costs.sum().backward()
    np.testing.assert_allclose(costs.detach().cpu().numpy(), [golden.README_LOSS],
                               atol=1e-4)
    np.testing.assert_allclose(x.grad[0].cpu().numpy(), golden.README_GRADS,
                               atol=1e-2)


def test_wrappers_check_their_operands(device):
    sa_args, bg_args = _inputs(device, *SHAPES[0], torch.float32)
    lg, lab, a_lo, a_hi, blank = sa_args
    with pytest.raises(ValueError, match="labels_ext must be torch.int32"):
        K.stats_alpha_fused(lg, lab.long(), a_lo, a_hi, blank)
    with pytest.raises(ValueError, match="blank_id must be in"):
        K.stats_alpha_fused(lg, lab, a_lo, a_hi, lg.shape[3])
    with pytest.raises(ValueError, match="contiguous"):
        K.stats_alpha_fused(lg.transpose(1, 2), lab, a_lo, a_hi, blank)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K.beta_grad_fused(lg.half(), *bg_args[1:])
    with pytest.raises(ValueError, match="must be on"):
        K.beta_grad_fused(lg, bg_args[1].cpu(), *bg_args[2:])
