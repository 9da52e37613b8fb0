"""The port's CUDA kernels on a GPU: each against its plain version, and the
padded (DP-fused) and banded losses and the fused-joint losses
through them against the plain-torch oracles; the copy-ceiling kernels bit
for bit; the packed binding and Viterbi alignment through the kernels; the
stats kernels (rows 1, 3, 7, 10) against each other bit for bit and against
``stats_model`` (tests/torch_stats_model.py), a torch model of their shared
reduction's order, which tests/test_torch_split.py holds against the JAX
package on the CPU.

Every test here is marked ``cuda`` and skips where no GPU is present. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import golden
import monotonic_rnnt_tpu_torch as mt
from glue_lattices import BAD_LENGTHS, GLUE_LATTICES, glue_case
import torch.distributed as dist
from monotonic_rnnt_tpu_torch import convert
from monotonic_rnnt_tpu_torch.ops import banded as tbanded
from monotonic_rnnt_tpu_torch.ops import bands as tbands
from monotonic_rnnt_tpu_torch.ops.cuda import banded_kernels as BK
from monotonic_rnnt_tpu_torch.ops.cuda import fused
from monotonic_rnnt_tpu_torch.ops.cuda import kernels as K
from monotonic_rnnt_tpu_torch.ops.cuda import split_kernels as SK
from torch_stats_model import NEG_INF, special_rows, stats_model
from monotonic_rnnt_tpu_torch.ops.cuda import stream as ST
from monotonic_rnnt_tpu_torch.interop import torch_binding as binding
from monotonic_rnnt_tpu_torch.parallel import sharding
from monotonic_rnnt_tpu_torch.utils import profiling as tprof
from monotonic_rnnt_tpu_torch.utils import status as tstatus

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
    return _plain_operands(lg, lb, il, sl, tbands.default_bands(il, sl, t),
                           blank)[:2]


def _plain_operands(lg, lb, il, sl, bands, blank):
    """Rows 1-2's arguments, the glue made by its plain versions:
    (stats_alpha_fused's, beta_grad_fused's but grad_scale, ll)."""
    _, t, s1, _ = lg.shape
    il, sl = il.to(torch.int32), sl.to(torch.int32)
    lab, a_lo, a_hi, b_lo, b_hi = K.loss_prologue_plain(
        lb, il, sl, bands.min_s, bands.max_s, t, s1)
    sa_args = (lg, lab, a_lo, a_hi, il, sl, blank)
    denom, lpb, lpl, alphas = K.stats_alpha_fused_plain(*sa_args)
    ll, _ = K.loss_costs_plain(alphas, il, sl)
    lpbb, lplb, aprev, llb, bvirt = K.beta_operands_plain(
        lpb, lpl, alphas, ll, il, sl, b_lo, b_hi)
    bg_args = (lg, denom, lpbb, lplb, aprev, il, llb, bvirt, lab, blank)
    return sa_args, bg_args, ll


# A loss call's launches: with a gradient, rows 1-2 and the glue kernels
# around them (csrc/loss_glue.cu); cost-only, no row 2 and no operands.
LOSS_STEP = {"loss_prologue": 1, "stats_alpha_fused": 1, "loss_costs": 1,
             "beta_operands": 1, "beta_grad_fused": 1}
COST_ONLY = {"loss_prologue": 1, "stats_alpha_fused": 1, "loss_costs": 1}


def _close(got, ref, atol, rtol):
    got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)


def _launched():
    """The wrappers that launched since the last reset, with their counts."""
    return {name: n for name, n in K.LAUNCHES.items() if n}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_stats_alpha_kernel_matches_plain(device, shape, dtype):
    sa_args, _ = _inputs(device, *shape, dtype)
    _hold_stats_alpha(sa_args)


def _hold_stats_alpha(sa_args, valid=None):
    """The kernel against its plain version, one launch; the stats only on
    the `valid` cells where given (a row of +-inf logits has NaN stats in
    the kernel and -inf in torch.logsumexp; no valid cell reads them)."""
    before = K.LAUNCHES["stats_alpha_fused"]
    got = K.stats_alpha_fused(*sa_args)
    want = K.stats_alpha_fused_plain(*sa_args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["stats_alpha_fused"] == before + 1
    # Past the live lattice (t >= T'_b or s > S_b) both write the fill,
    # bit for bit.
    dead = ~K.live_cells(*sa_args[4:6], *sa_args[0].shape[1:3])
    for g, w in zip(got, want):
        assert torch.equal(g[dead].view(torch.int32), w[dead].view(torch.int32))
    # The kernel sums V in another order than torch.logsumexp; the alphas
    # carry that rounding through T log-space steps.
    for g, w in zip(got[:3], want[:3]):
        if valid is not None:
            g, w = g[valid], w[valid]
        _close(g, w, 1e-5, 1e-6)
    assert torch.equal(torch.isfinite(got[3]), torch.isfinite(want[3]))
    _close(got[3], want[3], 1e-4, 1e-5)
    return got


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_beta_grad_kernel_matches_plain(device, shape, dtype, scaled):
    _, bg_args = _inputs(device, *shape, dtype)
    _hold_beta_grad(bg_args, scaled)


def _hold_beta_grad(bg_args, scaled):
    """The kernel against its plain version, one launch; returns its grads."""
    lg = bg_args[0]
    scale = (torch.linspace(-0.5, 2.0, lg.shape[0], device=lg.device)
             if scaled else None)
    before = K.LAUNCHES["beta_grad_fused"]
    g_k, b_k = K.beta_grad_fused(*bg_args, grad_scale=scale)
    g_p, b_p = K.beta_grad_fused_plain(*bg_args, grad_scale=scale)
    torch.cuda.synchronize()
    assert K.LAUNCHES["beta_grad_fused"] == before + 1
    assert g_k.dtype == lg.dtype
    assert torch.equal(torch.isfinite(b_k), torch.isfinite(b_p))
    _close(b_k, b_p, 1e-4, 1e-5)
    assert bool(torch.isfinite(g_k.float()).all())
    _close(g_k, g_p, 1e-6, 8e-3 if lg.dtype == torch.bfloat16 else 1e-4)
    return g_k


# Edge cases of the persistent kernels (csrc/stats_alpha.cu,
# csrc/beta_grad.cu): (kind, seed, B, T, S, V, blank, T_b, S_b). 16-byte
# rows at V = 1000 and 1024; the scalar path at V = 79 and 1030 and on a
# logits view one element off a 16-byte boundary; one-warp chains at
# S1 <= 32, strided ones at S1 = 41 and 1031; B = 2048 past the resident
# grid; T_b = 1 and S_b = 0; an infeasible sample; +-inf padding.
EDGES = [
    ("vec-v1000", 11, 2, 50, 40, 1000, 3, (50, 44), (40, 31)),
    ("vec-v1024", 12, 4, 9, 6, 1024, 0, (9, 9, 7, 6), (6, 4, 6, 0)),
    ("scalar-v79", 13, 3, 17, 6, 79, 5, (17, 1, 12), (6, 0, 3)),
    ("scalar-v1030", 14, 2, 6, 5, 1030, 2, (6, 5), (5, 2)),
    ("misaligned", 15, 2, 8, 10, 1000, 0, (8, 8), (7, 2)),
    ("s1-1031", 16, 1, 1100, 1030, 8, 2, (1100,), (1030,)),
    ("b2048", 17, 2048, 4, 2, 16, 0, None, None),
    ("infeasible", 18, 3, 12, 4, 20, 0, (12, 12, 9), (4, 3, 3)),
    ("inf-padding", 19, 3, 12, 4, 1000, 0, (12, 7, 5), (4, 2, 1)),
]


def _edge_inputs(device, case, dtype):
    """(sa_args, bg_args, padding mask [B, T, S1]) of one edge case."""
    kind, seed, batch, t, s, v, blank, ilen, slen = case
    rng = np.random.RandomState(seed)
    x = (rng.randn(batch, t, s + 1, v) * 2).astype(np.float32)
    labels = rng.randint(0, v - 1, (batch, s))
    labels = np.where(labels >= blank, labels + 1, labels).astype(np.int32)
    if ilen is None:                      # lengths 2..4, S_b 0..2
        ilen = 2 + np.arange(batch) % 3
        slen = np.minimum(np.arange(batch) % 3, ilen)
    as_int = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                       device=device)
    il, sl, lb = as_int(ilen), as_int(slen), as_int(labels)
    lg = torch.from_numpy(x).to(device=device, dtype=dtype)
    t_idx = torch.arange(t, device=device)[None, :, None]
    s_idx = torch.arange(s + 1, device=device)[None, None, :]
    pad = (t_idx >= il[:, None, None]) | (s_idx > sl[:, None, None])
    if kind == "misaligned":
        flat = torch.empty(lg.numel() + 1, dtype=dtype, device=device)
        flat[1:] = lg.reshape(-1)
        lg = flat[1:].view(lg.shape)
        assert lg.is_contiguous() and lg.data_ptr() % 16 != 0
    if kind == "inf-padding":
        lg[..., ::2][pad] = float("inf")
        lg[..., 1::2][pad] = float("-inf")
    bands = tbands.default_bands(il, sl, t)
    if kind == "infeasible":            # sample 2 can never emit label S_b
        bands.max_s[2] = sl[2] - 1
    sa_args, bg_args, ll = _plain_operands(lg, lb, il, sl, bands, blank)
    if kind == "infeasible":
        assert torch.isinf(ll[2]) and bool(torch.isfinite(ll[:2]).all())
    return sa_args, bg_args, pad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", EDGES, ids=lambda c: c[0])
def test_stats_alpha_kernel_edge_cases(device, case, dtype):
    sa_args, _, pad = _edge_inputs(device, case, dtype)
    _hold_stats_alpha(sa_args, ~pad if case[0] == "inf-padding" else None)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", EDGES, ids=lambda c: c[0])
def test_beta_grad_kernel_edge_cases(device, case, dtype, scaled):
    _, bg_args, pad = _edge_inputs(device, case, dtype)
    grads = _hold_beta_grad(bg_args, scaled)
    assert bool((grads[pad] == 0).all())       # padding: exactly zero
    if case[0] == "infeasible":
        assert bool((grads[2] == 0).all())


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
        out[backend] = (costs.detach(), x.grad, _launched())
    assert out["cuda"][2] == LOSS_STEP
    assert out["reference"][2] == {}
    assert out["cuda"][1].dtype == dtype
    _close(out["cuda"][0], out["reference"][0], 1e-4, 1e-5)
    _close(out["cuda"][1], out["reference"][1], 1e-6,
           1.6e-2 if dtype == torch.bfloat16 else 1e-4)

    K.reset_launch_counts()
    with torch.no_grad():
        costs = mt.monotonic_rnnt_loss(lg, lb, il, sl)
    assert _launched() == COST_ONLY
    assert torch.equal(costs, out["cuda"][0])


# The Emformer RNN-T's vocabulary: V = 4097 with blank 4096, the last id. An
# f32 row is 16,388 bytes (a bf16 row 8,194), not a multiple of 16, so rows
# 1-2 take their narrow loads (row 1's walk_rows, row 2's kVec = false), and
# the blank is the row's last element.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", ["cpu", "cuda"])
def test_loss_at_v4097_with_the_last_id_blank(where, dtype):
    """The padded loss on the `cuda` route (on the card its kernels, on CPU
    tensors their plain versions) against the oracle: costs to 1e-4, the
    gradient to the card's tolerances above."""
    if where == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from monotonic_rnnt_tpu_torch.ops import loss as tloss
    v = blank = 4096
    v += 1
    logits, labels, ilen, slen = golden.repeat_label_case(11, 3, 14, 5, v,
                                                          blank_id=blank)
    lg, lb, il, sl = convert.loss_inputs_from_numpy(logits, labels, ilen, slen,
                                                    device=where, dtype=dtype)
    assert int(lb.max()) < blank
    w = torch.tensor([1.0, -0.5, 2.0], device=where)
    out = {}
    for route in ("cuda", "reference"):
        K.reset_launch_counts()
        x = lg.clone().requires_grad_(True)
        if where == "cuda" or route == "reference":
            costs = mt.monotonic_rnnt_loss(x, lb, il, sl, blank_id=blank,
                                           backend=route)
        else:
            costs = tloss.loss_on_route(
                x, lb, il.to(torch.int32), sl.to(torch.int32),
                tbands.default_bands(il, sl, x.shape[1]), blank, route)
        (costs * w).sum().backward()
        out[route] = (costs.detach(), x.grad, _launched())
    if where == "cuda":
        torch.cuda.synchronize()
        assert out["cuda"][2] == LOSS_STEP
    assert out["cuda"][1].dtype == dtype
    assert bool(torch.isfinite(out["cuda"][0]).all())
    _close(out["cuda"][0], out["reference"][0], 1e-4, 1e-5)
    _close(out["cuda"][1], out["reference"][1], 1e-6,
           1.6e-2 if dtype == torch.bfloat16 else 1e-4)


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
    lg, lab, a_lo, a_hi, il, sl, blank = sa_args
    with pytest.raises(ValueError, match="labels_ext must be torch.int32"):
        K.stats_alpha_fused(lg, lab.long(), a_lo, a_hi, il, sl, blank)
    with pytest.raises(ValueError, match="input_lengths must be torch.int32"):
        K.stats_alpha_fused(lg, lab, a_lo, a_hi, il.long(), sl, blank)
    with pytest.raises(ValueError, match="blank_id must be in"):
        K.stats_alpha_fused(lg, lab, a_lo, a_hi, il, sl, lg.shape[3])
    with pytest.raises(ValueError, match="contiguous"):
        K.stats_alpha_fused(lg.transpose(1, 2), lab, a_lo, a_hi, il, sl,
                            blank)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K.beta_grad_fused(lg.half(), *bg_args[1:])
    with pytest.raises(ValueError, match="must be on"):
        K.beta_grad_fused(lg, bg_args[1].cpu(), *bg_args[2:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exported_cuda_loss_equals_the_live_loss(device, dtype):
    """export_loss(backend='cuda') through bytes: the artifact launches rows
    1-2 once each (the torch.library operators) and equals the live
    rnnt_loss_cuda bit for bit; a wrong batch raises."""
    from monotonic_rnnt_tpu_torch import serving

    logits, labels, ilen, slen = golden.repeat_label_case(7, 4, 30, 8, 300)
    args = convert.loss_inputs_from_numpy(logits, labels, ilen, slen,
                                          device=device, dtype=dtype)
    loss_fn = serving.import_fn(serving.export_loss(*args, backend="cuda"))
    want_c, want_g = fused.rnnt_loss_cuda(*args)
    K.reset_launch_counts()
    got_c, got_g = loss_fn(*args)
    torch.cuda.synchronize()
    assert _launched() == LOSS_STEP
    assert torch.equal(got_c, want_c) and torch.equal(got_g, want_g)
    with pytest.raises(Exception):
        loss_fn(*(a[:2] for a in args))


def test_exported_cuda_loss_past_the_padded_shape(device):
    """export_loss(backend='cuda') at T_b = T + 1, S_b = S + 1 and both, on
    the last sample (a live call refuses them): it costs NaN with an
    all-zero gradient, the others keep the in-range call's bits, and the
    card stays usable (no device-side fault). The logits end just before a
    row of NaN sentinels: a read past T_max of the last sample would meet
    them."""
    from monotonic_rnnt_tpu_torch import serving

    logits, labels, ilen, slen = golden.repeat_label_case(7, 3, 12, 4, 37)
    lg, lb, il, sl = convert.loss_inputs_from_numpy(logits, labels, ilen,
                                                    slen, device=device)
    b, t, s1, v = lg.shape
    flat = torch.full((lg.numel() + 2 * s1 * v,), float("nan"),
                      device=device)
    x = flat[:lg.numel()].view(lg.shape)
    x.copy_(lg)
    loss_fn = serving.import_fn(serving.export_loss(x, lb, il, sl,
                                                    backend="cuda"))
    want_c, want_g = loss_fn(x, lb, il, sl)
    for t_b, s_b in ((t + 1, int(sl[-1])), (int(il[-1]), s1), (t + 1, s1)):
        il2, sl2 = il.clone(), sl.clone()
        il2[-1], sl2[-1] = t_b, s_b
        costs, grads = loss_fn(x, lb, il2, sl2)
        torch.cuda.synchronize()
        assert bool(torch.isnan(costs[-1])), costs
        assert bool((grads[-1] == 0).all())
        assert torch.equal(costs[:-1], want_c[:-1])
        assert torch.equal(grads[:-1], want_g[:-1])
    assert bool(torch.isnan(flat[lg.numel():]).all())


@pytest.mark.parametrize("route", ["deferred", "sharded"])
def test_a_nan_cost_stays_nan_through_the_scans(device, group_of_one, route):
    """A row of +inf logits at lattice cell (0, 0) of sample 1: its stats
    are NaN and the scans' first step meets them with -inf, LSE(NaN, -inf),
    which must give NaN as torch's log_sum_exp and the JAX helpers do (the
    kernels' -inf shortcut gave -inf there, and a NaN cost became +inf).
    Costs and the gradient's NaN cells against the same route's plain
    versions on the CPU; sample 0 within the kernel-vs-plain bounds."""
    logits, labels, ilen, slen = golden.repeat_label_case(3, 2, 9, 4, 20)
    logits[1, 0, 0, :] = np.inf

    def run(dev):
        lg, lb, il, sl = convert.loss_inputs_from_numpy(logits, labels, ilen,
                                                        slen, device=dev)
        x = lg.requires_grad_(True)
        if route == "sharded":
            bands = tbands.default_bands(il, sl, lg.shape[1])
            costs = sharding.rnnt_loss_vocab_sharded(
                x, lb, il, sl, bands.min_s, bands.max_s, 0, group_of_one)
        else:
            from monotonic_rnnt_tpu_torch.scripts._cases import loss_route
            costs = loss_route(x, lb, il, sl, backend="cuda")
        costs.sum().backward()
        return costs.detach().cpu(), x.grad.cpu()

    (c_k, g_k), (c_p, g_p) = run(device), run("cpu")
    assert bool(torch.isnan(c_k[1])) and bool(torch.isnan(c_p[1]))
    _close(c_k[:1], c_p[:1], 1e-4, 1e-5)
    assert torch.equal(torch.isnan(g_k), torch.isnan(g_p))
    _close(g_k[0], g_p[0], 1e-6, 1e-3)


# --- the glue kernels around rows 1-2 (csrc/loss_glue.cu) -----------------------

def _glue_inputs(device, case, dtype=torch.float32):
    """(logits, labels, T_b, S_b, bands) of a GLUE_LATTICES case on the card."""
    logits, _, labels, ilen, slen, align = glue_case(case)
    as_int = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    il, sl = as_int(ilen), as_int(slen)
    lg = torch.from_numpy(logits).to(device=device, dtype=dtype)
    lb = torch.from_numpy(labels).to(device)
    if align is None:
        return lg, lb, il, sl, tbands.default_bands(il, sl, logits.shape[1])
    return lg, lb, il, sl, tbands.bands_from_alignment(
        as_int(align), il, sl, case[-1], case[6])


def _same_bits(got, want):
    """Equal bit for bit; a NaN matches any NaN (its payload is no result)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.is_floating_point():
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        bits = {4: torch.int32, 2: torch.int16}[got.element_size()]
        got = got.masked_fill(nan, 0).view(bits)
        want = want.masked_fill(nan, 0).view(bits)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", GLUE_LATTICES, ids=lambda c: c[0])
def test_glue_kernels_equal_their_plain_versions(device, case):
    """loss_prologue, loss_costs and beta_operands on the card against
    their plain versions on the same tensors, bit for bit, one launch
    each."""
    lg, lb, il, sl, bands = _glue_inputs(device, case)
    _, t, s1, _ = lg.shape
    K.reset_launch_counts()
    args = (lb, il, sl, bands.min_s, bands.max_s, t, s1)
    pro = K.loss_prologue_plain(*args)
    for g, w in zip(K.loss_prologue(*args), pro):
        _same_bits(g, w)
    _, lpb, lpl, alphas = K.stats_alpha_fused_plain(lg, *pro[:3], il, sl,
                                                    case[6])
    ll, costs = K.loss_costs_plain(alphas, il, sl)
    for g, w in zip(K.loss_costs(alphas, il, sl), (ll, costs)):
        _same_bits(g, w)
    assert bool(torch.isnan(ll).any()) == (case[0] == "past-shape")
    args = (lpb, lpl, alphas, ll, il, sl, *pro[3:])
    for g, w in zip(K.beta_operands(*args), K.beta_operands_plain(*args)):
        _same_bits(g, w)
    torch.cuda.synchronize()
    assert _launched() == {"loss_prologue": 1, "loss_costs": 1,
                           "beta_operands": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [GLUE_LATTICES[i] for i in (0, 2, 6, 11)],
                         ids=lambda c: c[0])
def test_loss_through_glue_kernels_equals_plain_glue(device, monkeypatch,
                                                     case, dtype):
    """The padded loss (deferred route) with the glue kernels and with
    their plain versions, the torch glue they replace, around the same
    rows 1-2: costs and gradients equal bit for bit; one launch of each
    glue kernel a step, and none of beta_operands on a cost-only call."""
    lg, lb, il, sl, bands = _glue_inputs(device, case, dtype)
    w = torch.linspace(-0.5, 2.0, lg.shape[0], device=device)

    def step():
        x = lg.clone().requires_grad_(True)
        costs = mt.monotonic_rnnt_loss(x, lb, il, sl, bands=bands,
                                       blank_id=case[6])
        grads, = torch.autograd.grad((costs * w).sum(), x)
        torch.cuda.synchronize()
        return costs.detach(), grads

    K.reset_launch_counts()
    got = step()
    assert _launched() == LOSS_STEP
    K.reset_launch_counts()
    with torch.no_grad():
        cost_only = mt.monotonic_rnnt_loss(lg, lb, il, sl, bands=bands,
                                           blank_id=case[6])
    assert _launched() == COST_ONLY
    with monkeypatch.context() as patch:
        for name in ("loss_prologue", "loss_costs", "beta_operands"):
            patch.setattr(fused, name, getattr(K, name + "_plain"))
        K.reset_launch_counts()
        want = step()
        assert _launched() == {"stats_alpha_fused": 1, "beta_grad_fused": 1}
    for g, r in zip((*got, cost_only), (*want, want[0])):
        _same_bits(g, r)


# --- the launch-first order: the forward queued before the lengths' checks -----

def _lattice_2x5x3(device, v=37):
    """The [2, 5, 3, V] lattice of BAD_LENGTHS, its valid lengths and a loss
    step on it: (costs, gradient) of given lengths."""
    gen = torch.Generator(device=device).manual_seed(11)
    x = torch.randn((2, 5, 3, v), generator=gen, device=device) * 2
    labels = torch.randint(1, v, (2, 2), generator=gen, device=device,
                           dtype=torch.int32)
    good = (torch.tensor([5, 3], dtype=torch.int32, device=device),
            torch.tensor([2, 1], dtype=torch.int32, device=device))

    def step(il, sl):
        xg = x.clone().requires_grad_(True)
        costs = mt.monotonic_rnnt_loss(xg, labels, il, sl)
        grads, = torch.autograd.grad(costs.sum(), xg)
        torch.cuda.synchronize()
        return costs.detach(), grads

    return x, labels, good, step


@pytest.mark.parametrize("case", BAD_LENGTHS, ids=lambda c: c[0])
def test_invalid_lengths_raise_with_the_forward_queued(device, case):
    """Each invalid case, int32's extremes in each length among them,
    raises validation's RnntError after row 1 and its glue have run on
    those lengths; the context is unharmed: a valid step afterwards gives
    the costs and gradient of the same step before, bit for bit."""
    _, ilen, slen = case
    x, labels, good, step = _lattice_2x5x3(device)
    before = step(*good)
    bad = tuple(torch.tensor(v, dtype=torch.int32, device=device)
                for v in (ilen, slen))
    with pytest.raises(tstatus.RnntError) as want:
        tstatus.validate_loss_inputs(x.cpu(), labels.cpu(),
                                     *(t.cpu() for t in bad))
    launched, ahead = K.LAUNCHES["stats_alpha_fused"], tprof.AHEAD["validate"]
    with pytest.raises(tstatus.RnntError) as got:
        mt.monotonic_rnnt_loss(x.clone().requires_grad_(True), labels, *bad)
    assert (got.value.status, str(got.value)) == (want.value.status,
                                                  str(want.value))
    assert K.LAUNCHES["stats_alpha_fused"] == launched + 1
    assert tprof.AHEAD["validate"] == ahead + 1
    torch.cuda.synchronize()
    for g, r in zip(step(*good), before):
        _same_bits(g, r)


def test_a_loss_call_waits_once_after_row_1(device):
    """A loss step copies both lengths to pinned host memory in one copy
    and waits for it once, in mrnnt.sync.validate.lengths, which opens
    after row 1's launch span has closed."""
    x, labels, good, step = _lattice_2x5x3(device)
    (ilen, slen), done = tstatus.copy_lengths(*good)
    done.synchronize()
    assert ilen.is_pinned() and ilen.tolist() == [5, 3]
    assert slen.tolist() == [2, 1]
    step(*good)
    tprof.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(*good)
    seen = tprof.counters()
    assert seen["syncs"] == {"validate.lengths": 1}
    assert seen["ahead"] == {"validate": 1}
    (row_1,), (wait,) = ([e for e in prof.events() if e.name == name]
                         for name in ("mrnnt.launch.mrnnt_stats_alpha",
                                      "mrnnt.sync.validate.lengths"))
    assert row_1.time_range.end <= wait.time_range.start


# --- the banded path -------------------------------------------------------------

# (seed, B, T, S, V, shift, blank); shift None = the unrestricted band at
# W = S+1, here above 32 slots and, in the last case, above 1024 threads.
BANDED = [(0, 3, 24, 8, 21, 2, 0), (2, 5, 17, 5, 130, 3, 2),
          (4, 2, 60, 40, 50, None, 1), (5, 1, 1100, 1030, 4, None, 0)]


def _banded(device, seed, batch, t, s, v, shift, blank, dtype=torch.float32):
    """A banded case built with the port's own functions, on `device`."""
    logits, labels, ilen, slen = golden.repeat_label_case(seed, batch, t, s,
                                                          v, blank_id=blank)
    lg, lb, il, sl = convert.loss_inputs_from_numpy(logits, labels, ilen, slen,
                                                    device=device, dtype=dtype)
    if shift is None:
        bands = tbands.default_bands(il, sl, t)
    else:
        rng = np.random.RandomState(seed)
        align = np.full((batch, t), blank, np.int32)
        for b in range(batch):
            pos = np.sort(rng.choice(int(ilen[b]), size=int(slen[b]),
                                     replace=False))
            align[b, pos] = labels[b, :int(slen[b])]
        bands = tbands.bands_from_alignment(
            torch.from_numpy(align).to(device), il, sl, shift, blank)
    w = tbands.suggested_band_width(il, sl, bands, t, s + 1)
    layout = tbands.compute_band_layout(il, sl, bands, t, s + 1, w)
    return tbands.pack_band(lg, layout), lb, il, sl, bands, layout


def _stats_args(device, case, dtype):
    lgb, lb, il, sl, bands, layout = _banded(device, *case, dtype=dtype)
    s1 = lb.shape[1] + 1
    lab = tbanded.band_labels(lb, sl, layout, s1).contiguous()
    rel = tuple(r.contiguous() for r in tbands.band_relative_bounds(
        il, sl, bands, layout, lgb.shape[1], s1))
    return lgb.contiguous(), lab, rel, case[-1]


# Row 7's ring at each of its paths (csrc/banded.cu), as (B, T, W, V,
# offset) on random rows: whole rows a stage (V <= 2048 f32, 4096 bf16),
# half-warp groups (V <= 256 f32, 512 bf16), rows streamed a round a stage
# (V = 8192, and 50000: a row longer than a stage); W = 1, 16, 33, 64; odd
# V (2-byte bf16 loads); row counts that leave the last unit of a stage
# short (1221, 15); `offset` views the band one element past a 16-byte
# boundary. With B, T >= 2 and W >= 3 the rows hold an all -inf row, a NaN
# row and a row with one +inf (special_rows).
STATS_BANDED = [(2, 3, 1, 1, 0), (2, 5, 16, 21, 0), (3, 7, 33, 130, 1),
                (1, 9, 64, 1000, 0), (2, 4, 16, 1024, 1), (1, 37, 33, 1001, 0),
                (2, 3, 16, 8192, 0), (1, 3, 5, 50000, 1)]


def _offset_view(x, offset):
    """x, or a copy of it viewed `offset` elements into a flat buffer."""
    if not offset:
        return x
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    flat[offset:] = x.reshape(-1)
    return flat[offset:].view(x.shape)


def _random_stats_args(device, case, dtype):
    """Random band rows, labels (-1 and ids past V among them) and windows;
    returns the arguments and the +inf row (or None)."""
    batch, t, w, v, offset = case
    rng = np.random.RandomState(batch * 100003 + t * 1009 + w * 101 + v)
    x = torch.from_numpy((rng.randn(batch, t, w, v) * 2).astype(np.float32))
    inf_row = special_rows(x) if batch >= 2 and t >= 2 and w >= 3 else None
    lab = torch.from_numpy(rng.randint(-1, v + 2, (batch, t, w)).astype(
        np.int32))
    lo = rng.randint(-1, w, (2, batch, t))
    hi = lo + rng.randint(0, w + 1, (2, batch, t))
    rel = tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                for a in (lo[0], hi[0], lo[1], hi[1]))
    x = _offset_view(x.to(device=device, dtype=dtype), offset)
    return (x, lab.to(device), rel, (v - 1) // 2), inf_row


@pytest.mark.parametrize("with_beta", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BANDED[:3] + STATS_BANDED)
def test_softmax_stats_banded_kernel_matches_plain(device, case, dtype,
                                                   with_beta):
    """Row 7 against its plain version, and bit for bit against row 3
    (softmax_stats) on the same rows: the denominators everywhere, the
    blank log-probs where the alpha window adds 0."""
    if len(case) == len(STATS_BANDED[0]):
        args, inf_row = _random_stats_args(device, case, dtype)
    else:
        args, inf_row = _stats_args(device, case, dtype), None
    before = K.LAUNCHES["softmax_stats_banded"]
    got = BK.softmax_stats_banded(*args, with_beta=with_beta)
    want = BK.softmax_stats_banded_plain(*args, with_beta=with_beta)
    torch.cuda.synchronize()
    assert K.LAUNCHES["softmax_stats_banded"] == before + 1
    assert len(got) == len(want) == (5 if with_beta else 3)
    keep = torch.ones(got[0].shape, dtype=torch.bool, device=device)
    if inf_row is not None:   # NaN in the kernels, -inf in logsumexp
        assert bool(torch.isnan(got[0][inf_row]))
        keep[inf_row] = False
    for g, w in zip(got, want):   # another V summation order than logsumexp
        assert torch.equal(torch.isfinite(g), torch.isfinite(w))
        _close(g[keep], w[keep], 1e-5, 1e-6)
    x, lab, (ra_lo, ra_hi, _, _), blank = args
    row3 = SK.softmax_stats(x, lab, blank)
    _equal(got[0], row3[0])
    w_idx = torch.arange(x.shape[2], device=device)
    open_ = (w_idx >= ra_lo[..., None]) & (w_idx <= ra_hi[..., None])
    _equal(got[1][open_], row3[1][open_])


def _scan_args(device, seed, batch, t_max, w, shift=None, t_short=None):
    """Random streams, 0/1 shifts that switch along t (all `shift` where
    given), a short sample (T_b = t_short where given, else T - 5)."""
    rng = np.random.RandomState(seed)
    f = lambda a: torch.from_numpy(a).to(device)
    streams = [f((rng.randn(batch, t_max, w) - 1).astype(np.float32))
               for _ in range(4)]
    d, dn = (f(rng.randint(0, 2, (batch, t_max)).astype(np.int32)
               if shift is None else np.full((batch, t_max), shift, np.int32))
             for _ in range(2))
    short = max(1, t_max - 5) if t_short is None else t_short
    ilen = f(np.array([t_max] + [short] * (batch - 1), np.int32))
    bvirt = f(np.where(rng.rand(batch, t_max, w) < 0.2, 0.0,
                       -np.inf).astype(np.float32))
    return (streams[0], streams[1], d, streams[2], streams[3], dn, ilen, bvirt)


def _hold_scans(args):
    """Both scan kernels against the plain versions, one launch each, and
    the alpha halves equal bit for bit."""
    before = {n: K.LAUNCHES[n] for n in ("fwdbwd_scan_banded",
                                         "alpha_scan_banded")}
    alphas, betas = BK.fwdbwd_scan_banded(*args)
    a_only = BK.alpha_scan_banded(*args[:3])
    want_a, want_b = BK.fwdbwd_scan_banded_plain(*args)
    torch.cuda.synchronize()
    assert {n: K.LAUNCHES[n] - b for n, b in before.items()} == {
        "fwdbwd_scan_banded": 1, "alpha_scan_banded": 1}
    # Another exp/log1p rounding, carried through T log-space steps.
    for got, want in ((alphas, want_a), (a_only, want_a), (betas, want_b)):
        assert torch.equal(torch.isfinite(got), torch.isfinite(want))
        _close(got, want, 1e-4, 1e-5)
    assert torch.equal(alphas, a_only)


SCANS = [(2, 300, 16), (3, 40, 1), (2, 33, 40), (1, 70, 1100)]


@pytest.mark.parametrize("shape", SCANS, ids=lambda s: "x".join(map(str, s)))
def test_banded_scan_kernels_match_plain(device, shape):
    _hold_scans(_scan_args(device, sum(shape), *shape))


# The scans' design edges in csrc/banded.cu: (id, B, T, W, shift, T_b of the
# short samples). W <= 32 runs a warp a chain with operands kScanRing = 16
# steps ahead; W > 32 a block a chain through two stages of
# 32768 // (4 * (3W + 3)) steps (80 at W = 33, 66 at W = 40).
SCAN_EDGES = [
    ("w1", 3, 50, 1, None, None), ("w2", 3, 50, 2, None, None),
    ("w31", 2, 50, 31, None, None), ("w32", 2, 50, 32, None, None),
    ("w33", 2, 50, 33, None, None),
    ("t1-w16", 2, 1, 16, None, 1), ("t1-w40", 2, 1, 40, None, 1),
    ("ring-minus-1", 2, 15, 16, None, None), ("ring", 2, 16, 16, None, None),
    ("ring-plus-1", 2, 17, 16, None, None),
    ("stage-minus-1", 2, 79, 33, None, None), ("stage", 2, 80, 33, None, None),
    ("stage-plus-1", 2, 81, 33, None, None),
    ("two-stages-plus-1", 2, 133, 40, None, None),
    ("d-all-0-w16", 2, 60, 16, 0, None), ("d-all-1-w16", 2, 60, 16, 1, None),
    ("d-all-0-w40", 2, 60, 40, 0, None), ("d-all-1-w40", 2, 60, 40, 1, None),
    ("short-sample-w16", 3, 300, 16, None, 7),
    ("short-sample-w40", 3, 300, 40, None, 7),
    ("b64", 64, 100, 16, None, None),
]


@pytest.mark.parametrize("case", SCAN_EDGES, ids=lambda c: c[0])
def test_banded_scan_kernels_at_chain_edges(device, case):
    _, batch, t_max, w, shift, t_short = case
    _hold_scans(_scan_args(device, batch * t_max + w, batch, t_max, w,
                           shift=shift, t_short=t_short))


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("labels_3d", [True, False], ids=["BTW", "BS1"])
def test_grad_pass_kernel_matches_plain(device, labels_3d, dtype, out):
    if labels_3d:
        lgb, lb, il, sl, bands, layout = _banded(device, *BANDED[1],
                                                 dtype=dtype)
        x, lab = lgb, tbanded.band_labels(lb, sl, layout, lb.shape[1] + 1)
    else:
        (x, lab, *_), _ = _inputs(device, *SHAPES[0], dtype)
    rng = np.random.RandomState(3)
    coef = lambda: torch.from_numpy(np.where(
        rng.rand(*x.shape[:3]) < 0.3, 0.0,
        rng.randn(*x.shape[:3])).astype(np.float32)).to(device)
    args = (x, -torch.logsumexp(x.float(), -1), coef(), coef(), coef(),
            lab.contiguous(), 2)
    got = K.grad_pass(*args, out_dtype=out)
    want = K.grad_pass_plain(*args, out_dtype=out)
    torch.cuda.synchronize()
    assert got.dtype == out
    _close(got, want, 1e-6, 8e-3 if out == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BANDED[:3])
def test_banded_loss_through_kernels_matches_oracle(device, case, dtype):
    lgb, lb, il, sl, bands, _ = _banded(device, *case, dtype=dtype)
    w = torch.linspace(-0.5, 2.0, lgb.shape[0], device=device)
    out = {}
    for backend in ("cuda", "reference"):
        K.reset_launch_counts()
        x = lgb.clone().requires_grad_(True)
        costs = mt.monotonic_rnnt_loss_banded(x, lb, il, sl, bands=bands,
                                              blank_id=case[-1],
                                              backend=backend)
        (costs * w).sum().backward()
        torch.cuda.synchronize()
        out[backend] = (costs.detach(), x.grad, _launched())
    assert out["cuda"][2] == {"softmax_stats_banded": 1,
                              "fwdbwd_scan_banded": 1, "grad_pass": 1}
    assert out["reference"][2] == {}
    assert out["cuda"][1].dtype == dtype
    _close(out["cuda"][0], out["reference"][0], 1e-4, 1e-5)
    _close(out["cuda"][1], out["reference"][1], 1e-6,
           1.6e-2 if dtype == torch.bfloat16 else 1e-4)

    K.reset_launch_counts()
    with torch.no_grad():
        costs = mt.monotonic_rnnt_loss_banded(lgb, lb, il, sl, bands=bands,
                                              blank_id=case[-1])
    assert _launched() == {"softmax_stats_banded": 1, "alpha_scan_banded": 1}
    assert torch.equal(costs, out["cuda"][0])


def test_banded_golden_alignment_losses_on_gpu(device):
    lg, lb, il, sl = convert.loss_inputs_from_numpy(*golden.readme_batch(),
                                                    device=device)
    for align, losses in ((golden.ALIGN_A, golden.ALIGN_A_LOSSES),
                          (golden.ALIGN_B, golden.ALIGN_B_LOSSES)):
        for shift, expected in losses.items():
            bands = mt.bands_from_alignment(
                torch.from_numpy(align[None]).to(device), il, sl, shift, 0)
            w = mt.suggested_band_width(il, sl, bands, 4, 3)
            layout = mt.compute_band_layout(il, sl, bands, 4, 3, w)
            costs = mt.monotonic_rnnt_loss_banded(
                mt.pack_band(lg, layout), lb, il, sl, bands=bands,
                backend="cuda")
            np.testing.assert_allclose(costs.cpu().numpy(), [expected],
                                       atol=1e-4)


# --- the stats reduction's order (csrc/common.cuh), as a torch model ------------

def _equal(got, want):
    """Bit for bit, NaN equal to NaN."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


# V = 1 and 7 (one lane holds the row; 4-byte f32 and 2-byte bf16 loads),
# 250 (8-byte f32, 4-byte bf16; half-warps), 500 (8-byte bf16 rows of 1000
# bytes, a rank's shard, half-warps; a whole warp f32), 1000 (two rounds
# f32, one bf16), 1024 and 8192 (16-byte).
STATS_V = [1, 7, 250, 500, 1000, 1024, 8192]


def _stats_inputs(device, v, dtype, seed=0):
    rng = np.random.RandomState(seed + v)
    x = torch.from_numpy((rng.randn(2, 4, 5, v) * 2).astype(np.float32))
    inf_row = special_rows(x)
    lab = torch.from_numpy(rng.randint(0, v, (2, 5)).astype(np.int32))
    lab[:, 1] = 10 * v                         # an id past V selects nothing
    lab[0, 3] = -1
    return x.to(device=device, dtype=dtype), lab.to(device), inf_row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("labels_3d", [False, True], ids=["BS1", "BTS1"])
@pytest.mark.parametrize("v", STATS_V)
def test_softmax_stats_kernel_matches_plain(device, v, labels_3d, dtype):
    lg, lab, inf_row = _stats_inputs(device, v, dtype)
    blank = v // 3
    if labels_3d:
        lab = lab[:, None, :].expand(-1, lg.shape[1], -1).contiguous()
        lab[:, ::2, 2] = -1                    # ids that vary with t
    before = K.LAUNCHES["softmax_stats"]
    got = SK.softmax_stats(lg, lab, blank)
    want = SK.softmax_stats_plain(lg, lab, blank)
    torch.cuda.synchronize()
    assert K.LAUNCHES["softmax_stats"] == before + 1
    # The +inf row: NaN in the kernel, -inf in torch.logsumexp.
    assert bool(torch.isnan(got[0][inf_row]))
    assert want[0][inf_row] == NEG_INF
    keep = torch.ones(lg.shape[:3], dtype=torch.bool, device=device)
    keep[inf_row] = False
    for g, w in zip(got, want):   # another V summation order than logsumexp
        _close(g[keep], w[keep], 1e-5, 1e-6)
    m, s = stats_model(lg)                     # the kernel's own order
    _close(got[0], -(m + torch.log(s)), 1e-6, 1e-6)


def _split_scan_args(device, seed, batch, t_max, s1):
    """Random streams and 0/-inf masks, a short sample, random virtual rows."""
    rng = np.random.RandomState(seed)
    f = lambda a: torch.from_numpy(a).to(device)
    lpb, lpl = (f((rng.randn(batch, t_max, s1) - 1).astype(np.float32))
                for _ in range(2))
    am, bm = (f(np.where(rng.rand(batch, t_max, s1) < 0.8, 0.0,
                         -np.inf).astype(np.float32)) for _ in range(2))
    ilen = f(np.array([t_max] + [max(1, t_max - 5)] * (batch - 1), np.int32))
    bvirt = f(np.where(rng.rand(batch, s1) < 0.3, 0.0,
                       -np.inf).astype(np.float32))
    return lpb, lpl, am, bm, ilen, bvirt


# (B, T, S1): S1 = 1, 51, 201 and above 1024 threads; T up to 1600.
SPLIT_SCANS = [(3, 40, 1), (2, 200, 51), (2, 1600, 201), (1, 70, 1100)]


@pytest.mark.parametrize("shape", SPLIT_SCANS,
                         ids=lambda s: "x".join(map(str, s)))
def test_split_scan_kernels_match_plain(device, shape):
    args = _split_scan_args(device, sum(shape), *shape)
    lpb, lpl, am, bm, ilen, bvirt = args
    alphas, betas = SK.fwdbwd_scan(*args)
    a_only = SK.alpha_scan(lpb, lpl, am)
    b_only = SK.beta_scan(lpb, lpl, bm, ilen, bvirt)
    want_a, want_b = SK.fwdbwd_scan_plain(*args)
    torch.cuda.synchronize()
    # Another exp/log1p rounding, carried through T log-space steps.
    for got, want in ((alphas, want_a), (betas, want_b)):
        assert torch.equal(torch.isfinite(got), torch.isfinite(want))
        _close(got, want, 1e-4, 1e-5)
    assert torch.equal(a_only, alphas) and torch.equal(b_only, betas)


# --- the fused-joint losses --------------------------------------------------------

def _joint(params, enc_c, pred):
    e = enc_c @ params["we"]
    return torch.tanh(e[:, :, None, :] + (pred @ params["wp"])[:, None]) \
        @ params["wv"] + params["bv"]


def _joint_banded(params, enc_c, pred_band):
    e = enc_c @ params["we"]
    return torch.tanh(e[:, :, None, :] + pred_band @ params["wp"]) \
        @ params["wv"] + params["bv"]


def _fused_case(device, seed=0, batch=3, t=37, s=9, v=70, h=16):
    rng = np.random.RandomState(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    enc, pred = f(rng.randn(batch, t, h)), f(rng.randn(batch, s + 1, h))
    labels = torch.from_numpy(rng.randint(1, v, (batch, s)).astype(
        np.int32)).to(device)
    ilen = torch.tensor([t, t - 4, s + 3], dtype=torch.int32, device=device)
    slen = torch.tensor([s, s - 2, 3], dtype=torch.int32, device=device)
    params = convert.joint_params_from_numpy(
        {k: a.astype(np.float32) for k, a in (
            ("we", rng.randn(h, h) * 0.3), ("wp", rng.randn(h, h) * 0.3),
            ("wv", rng.randn(h, v) * 0.3), ("bv", rng.randn(v) * 0.1))},
        device=device)
    return enc, pred, labels, ilen, slen, params


def _grads(fn, enc, pred, params, w):
    leaves = [enc.clone().requires_grad_(True),
              pred.clone().requires_grad_(True)]
    pr = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    costs = fn(leaves[0], leaves[1], pr)
    (costs * w).sum().backward()
    return costs.detach(), [x.grad for x in leaves] + [pr[k].grad for k in pr]


def test_fused_joint_through_kernels_matches_materialised(device):
    enc, pred, labels, ilen, slen, params = _fused_case(device)
    w = torch.tensor([1.0, -0.5, 2.0], device=device)
    K.reset_launch_counts()
    got = _grads(lambda e, p, pr: mt.rnnt_loss_fused_joint(
        e, p, labels, ilen, slen, _joint, pr, chunk_t=8), enc, pred, params, w)
    torch.cuda.synchronize()
    assert _launched() == {"softmax_stats": 10, "grad_pass": 5,
                           "beta_scan": 5, "alpha_scan": 1}
    want = _grads(lambda e, p, pr: mt.monotonic_rnnt_loss(
        _joint(pr, e, p), labels, ilen, slen, backend="reference"), enc, pred,
        params, w)
    _close(got[0], want[0], 1e-4, 1e-5)
    for g, r in zip(got[1], want[1]):
        _close(g, r, 1e-5, 1e-4)


def test_fused_joint_banded_through_kernels_matches_materialised(device):
    enc, pred, labels, ilen, slen, params = _fused_case(device, seed=1)
    t, s1 = enc.shape[1], pred.shape[1]
    rng = np.random.RandomState(1)
    align = np.zeros((3, t), np.int32)
    for b in range(3):
        pos = np.sort(rng.choice(int(ilen[b]), size=int(slen[b]),
                                 replace=False))
        align[b, pos] = labels[b, :int(slen[b])].cpu().numpy()
    bands = mt.bands_from_alignment(torch.from_numpy(align).to(device), ilen,
                                    slen, 3, 0)
    width = mt.suggested_band_width(ilen, slen, bands, t, s1)
    layout = mt.compute_band_layout(ilen, slen, bands, t, s1, width)
    idx = layout.offset.long()[:, :, None] + torch.arange(width, device=device)
    w = torch.tensor([0.5, 1.0, -2.0], device=device)
    K.reset_launch_counts()
    got = _grads(lambda e, p, pr: mt.rnnt_loss_fused_joint_banded(
        e, p, labels, ilen, slen, _joint_banded, pr, bands=bands,
        band_width=width, chunk_t=16), enc, pred, params, w)
    torch.cuda.synchronize()
    assert _launched() == {"softmax_stats": 6, "grad_pass": 3,
                           "alpha_scan_banded": 1, "fwdbwd_scan_banded": 3}
    want = _grads(lambda e, p, pr: mt.monotonic_rnnt_loss_banded(
        _joint_banded(pr, e, p[torch.arange(3, device=device)[:, None, None],
                               idx]), labels, ilen, slen, bands=bands,
        backend="reference"), enc, pred, params, w)
    _close(got[0], want[0], 1e-4, 1e-5)
    for g, r in zip(got[1], want[1]):
        _close(g, r, 1e-5, 1e-4)


# --- the vocab-sharded losses' kernels -----------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v_local", sorted(STATS_V + [4096]))
def test_softmax_stats_partial_kernel_matches_plain(device, v_local, dtype):
    rng = np.random.RandomState(v_local)
    x = torch.from_numpy((rng.randn(3, 7, 5, v_local) * 3).astype(
        np.float32)).to(device=device, dtype=dtype)
    x[0, 2, 3] = float("-inf")                 # an all -inf row
    x[1, :, 1, ::2] = float("-inf")
    special_rows(x)                            # -inf, NaN and +inf rows
    before = K.LAUNCHES["softmax_stats_partial"]
    m, se = SK.softmax_stats_partial(x)
    m_p, se_p = SK.softmax_stats_partial_plain(x)
    torch.cuda.synchronize()
    assert K.LAUNCHES["softmax_stats_partial"] == before + 1
    assert m[0, 2, 3] == float("-inf") and se[0, 2, 3] == 0
    _equal(m, m_p)                             # a max: exact in any order
    _close(se, se_p, 1e-5, 1e-6)               # another summation order
    m_o, s_o = stats_model(x)                  # the kernel's own order
    _equal(m.cpu(), m_o)
    _close(se, s_o, 0.0, 1e-6)                 # a few ulps: the card's expf


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [7, 250, 500, 1000, 1024])
def test_stats_kernels_agree_bit_for_bit(device, v, dtype, offset):
    """Rows 1, 3 and 7 (stats_alpha_fused, softmax_stats and
    softmax_stats_banded on a band of W = S1 whose windows mask nothing)
    give the same stats bits on the same rows, at every load width: the
    misaligned view (one element off) takes 4-byte f32 or 2-byte bf16
    loads, and equals the aligned tensor's stats too."""
    lg, lab, _ = _stats_inputs(device, v, dtype, seed=3)
    aligned = lg
    if offset:
        flat = torch.empty(lg.numel() + 1, dtype=dtype, device=device)
        flat[1:] = lg.reshape(-1)
        lg = flat[1:].view(lg.shape)
    batch, t_max, s1, _ = lg.shape
    blank = (v - 1) // 2
    lab[:, 1] = -1                     # the sentinel; other ids in [0, V)
    lab[lab >= v] = 0
    zeros = torch.zeros((batch, t_max), dtype=torch.int32, device=device)
    full = torch.full_like(zeros, s1)
    # Full lengths: every cell is live, as the other two kernels read all.
    t_b = torch.full((batch,), t_max, dtype=torch.int32, device=device)
    sa = K.stats_alpha_fused(lg, lab, zeros, full - 1, t_b,
                             torch.full_like(t_b, s1 - 1), blank)
    sp = SK.softmax_stats(lg, lab, blank)
    lab3 = lab[:, None, :].expand(-1, t_max, -1).contiguous()
    bd = BK.softmax_stats_banded(lg, lab3, (zeros, full, zeros, full - 1),
                                 blank)
    torch.cuda.synchronize()
    valid = (lab >= 0)[:, None, :].expand(-1, t_max, -1)
    for other in (sp[0], bd[0]):
        _equal(other, sa[0])                   # denom
    for other in (sp[1], bd[1], bd[3]):
        _equal(other, sa[1])                   # lp_blank
    for other in (bd[2], bd[4]):
        _equal(other, sa[2])                   # lp_label, -inf at -1
    _equal(sp[2][valid], sa[2][valid])
    if offset:
        _equal(SK.softmax_stats(aligned, lab, blank)[0], sp[0])


@pytest.mark.parametrize("labels_3d", [False, True], ids=["BS1", "BTW"])
def test_grad_pass_kernel_takes_relative_ids(device, labels_3d):
    """On a vocab shard: label ids and blank relative to the shard's first
    column, the blank outside [0, V_local) on all but one shard."""
    rng = np.random.RandomState(11)
    b, t, s1, v, n = 2, 9, 6, 1000, 4
    vl = v // n
    x = torch.from_numpy(rng.randn(b, t, s1, v).astype(np.float32)).to(device)
    denom = -torch.logsumexp(x, -1)
    occ, cb, cl = (torch.from_numpy(np.where(
        rng.rand(b, t, s1) < 0.3, 0.0, rng.randn(b, t, s1)).astype(
            np.float32)).to(device) for _ in range(3))
    labels = torch.from_numpy(rng.randint(-1, v, (b, t, s1) if labels_3d
                                          else (b, s1)).astype(
        np.int32)).to(device)
    blank = 501
    full = K.grad_pass(x, denom, occ, cb, cl, labels, blank)
    for shard in range(n):
        off = shard * vl
        got = K.grad_pass(x[..., off:off + vl].contiguous(), denom, occ, cb,
                          cl, (labels - off).contiguous(), blank - off)
        want = K.grad_pass_plain(x[..., off:off + vl], denom, occ, cb, cl,
                                 labels - off, blank - off)
        torch.cuda.synchronize()
        assert torch.equal(got, full[..., off:off + vl])
        _close(got, want, 1e-6, 1e-4)


# --- grad_pass (row 6) on the shared gradient row, beta_scan's warp chain ----------

def _grad_edge_args(device, v, dtype, labels_3d, seed=0):
    """grad_pass operands at V = v: rows of zero coefficients holding
    +-inf logits (padding), rows with one or two zero coefficients, the
    blank and label columns, ids outside [0, V) and the -1 sentinel."""
    rng = np.random.RandomState(seed + v)
    b, t, s1 = 2, 5, 7
    x = torch.from_numpy((rng.randn(b, t, s1, v) * 2).astype(np.float32))
    coef = lambda: torch.from_numpy(rng.randn(b, t, s1).astype(np.float32))
    occ, cb, cl = coef(), coef(), coef()
    pad = torch.from_numpy(rng.rand(b, t, s1) < 0.3)
    pad[0, 0] = True                               # a whole lattice row
    for c in (occ, cb, cl):
        c[pad] = 0.0
    x[..., ::2][pad] = float("inf")
    x[..., 1::2][pad] = float("-inf")
    cb[1, 1] = 0.0                                 # live rows, one or two
    cl[1, 2] = 0.0                                 # coefficients zero
    occ[1, 3], cl[1, 3] = 0.0, 0.0
    lab = torch.from_numpy(rng.randint(0, v, (b, t, s1) if labels_3d
                                       else (b, s1)).astype(np.int32))
    lab[..., 1] = -1
    lab[..., 2] = v + 3
    x = x.to(device=device, dtype=dtype)
    denom = -torch.logsumexp(x.float(), -1)
    denom = torch.where(torch.isfinite(denom), denom, 0.0)
    return (x, denom, occ.to(device), cb.to(device), cl.to(device),
            lab.to(device), min(3, v - 1)), pad.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("labels_3d", [False, True], ids=["BS1", "BTS1"])
@pytest.mark.parametrize("v", [1, 7, 1000, 1024, 8192])
def test_grad_pass_kernel_at_row_edges(device, v, labels_3d, dtype):
    """V = 1 and 7 (scalar rows), 1000, 1024 and 8192 (16-byte rows in both
    dtypes): zero rows of +-inf logits write exact zeros, no NaN."""
    args, pad = _grad_edge_args(device, v, dtype, labels_3d)
    before = K.LAUNCHES["grad_pass"]
    got = K.grad_pass(*args, out_dtype=dtype)
    want = K.grad_pass_plain(*args, out_dtype=dtype)
    torch.cuda.synchronize()
    assert K.LAUNCHES["grad_pass"] == before + 1
    assert got.dtype == dtype and not bool(torch.isnan(got.float()).any())
    assert bool((got[pad] == 0).all())
    _close(got, want, 1e-6, 8e-3 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [1000, 1024, 8192])
def test_grad_pass_16_byte_path_equals_scalar_path(device, v, dtype):
    """The 16-byte lanes (an aligned tensor) and the scalar lanes (a view
    of a copy one element off a 16-byte boundary, and the mixed-dtype pair)
    give the same bits."""
    args, _ = _grad_edge_args(device, v, dtype, False, seed=1)
    x = args[0]
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=device)
    flat[1:] = x.reshape(-1)
    off = flat[1:].view(x.shape)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    aligned = K.grad_pass(*args, out_dtype=dtype)
    scalar = K.grad_pass(off, *args[1:], out_dtype=dtype)
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    mixed = K.grad_pass(*args, out_dtype=other)
    torch.cuda.synchronize()
    assert torch.equal(aligned, scalar)
    # The mixed pair rounds the same f32 value to its own output type.
    bf = torch.bfloat16
    assert torch.equal(mixed.to(bf), aligned.to(bf))


# S1 around the chain's warp counts: 1, 31-33 (one or two warps), 51 and
# 64 (the padded lattice, the fused-joint chunk), 65 and 96 (three), 97
# and 128 (four), 129 (five), 257 (the block chain).
BETA_S1 = [1, 31, 32, 33, 51, 64, 65, 96, 97, 128, 129, 257]


@pytest.mark.parametrize("t_max", [37, 200])
@pytest.mark.parametrize("s1", BETA_S1)
def test_beta_scan_warp_chain_matches_plain(device, s1, t_max):
    """Samples at T_b = T, T/2, 0 and T - 5; betas equal fwdbwd_scan's beta
    half bit for bit."""
    lpb, lpl, am, bm, _, bvirt = _split_scan_args(device, s1 + t_max, 4,
                                                  t_max, s1)
    ilen = torch.tensor([t_max, t_max // 2, 0, t_max - 5], dtype=torch.int32,
                        device=device)
    before = K.LAUNCHES["beta_scan"]
    got = SK.beta_scan(lpb, lpl, bm, ilen, bvirt)
    want = SK.beta_scan_plain(lpb, lpl, bm, ilen, bvirt)
    _, betas = SK.fwdbwd_scan(lpb, lpl, am, bm, ilen, bvirt)
    torch.cuda.synchronize()
    assert K.LAUNCHES["beta_scan"] == before + 1
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    _close(got, want, 1e-4, 1e-5)
    assert torch.equal(got, betas)


# The register chains of rows 4, 5 and 11 run at S1 <= CHAIN_CUT
# (csrc/split.cu: kChainWarpsMax warps of 32 slots), the block chains above.
CHAIN_CUT = 256
# S1 around the chains' warp counts and the cut, and 201 (the long-T split
# check and the alignment path's occupancies); T = 1, around the 16-step
# register ring, 37 and 200.
SCAN_S1 = sorted({1, 31, 32, 33, 51, 64, 65, 96, 97, 128, 129, 201,
                  CHAIN_CUT - 1, CHAIN_CUT, CHAIN_CUT + 1})
SCAN_T = [1, 15, 16, 17, 37, 200]


def _chain_scan_args(device, s1, t_max):
    """_split_scan_args at B = 4 with T_b = T, T/2, 0 and T - 5 (at least
    0), and alpha masks all 0 on the first sample so that its alphas climb
    to every slot."""
    lpb, lpl, am, bm, _, bvirt = _split_scan_args(device, s1 * 7 + t_max, 4,
                                                  t_max, s1)
    am[0] = 0.0
    ilen = torch.tensor([t_max, t_max // 2, 0, max(0, t_max - 5)],
                        dtype=torch.int32, device=device)
    return lpb, lpl, am, bm, ilen, bvirt


@pytest.mark.parametrize("t_max", SCAN_T)
@pytest.mark.parametrize("s1", SCAN_S1)
def test_alpha_and_fwdbwd_scans_match_plain(device, s1, t_max):
    """alpha_scan, fwdbwd_scan and beta_scan against their plain versions,
    one launch each; alpha_scan equals fwdbwd_scan's alphas and beta_scan
    its betas bit for bit, on either side of the cut."""
    args = _chain_scan_args(device, s1, t_max)
    lpb, lpl, am, bm, ilen, bvirt = args
    names = ("alpha_scan", "beta_scan", "fwdbwd_scan")
    before = {n: K.LAUNCHES[n] for n in names}
    a_only = SK.alpha_scan(lpb, lpl, am)
    b_only = SK.beta_scan(lpb, lpl, bm, ilen, bvirt)
    alphas, betas = SK.fwdbwd_scan(*args)
    want_a, want_b = SK.fwdbwd_scan_plain(*args)
    torch.cuda.synchronize()
    assert {n: K.LAUNCHES[n] - before[n] for n in names} == dict.fromkeys(
        names, 1)
    for got, want in ((alphas, want_a), (betas, want_b)):
        assert torch.equal(torch.isfinite(got), torch.isfinite(want))
        _close(got, want, 1e-4, 1e-5)
    assert torch.equal(a_only, alphas) and torch.equal(b_only, betas)


@pytest.mark.parametrize("batch,t_max", [(0, 37), (3, 0)],
                         ids=["B0", "T0"])
def test_scans_take_an_empty_lattice(device, batch, t_max):
    """B = 0 or T = 0: empty outputs, no launch error."""
    args = _split_scan_args(device, 5, max(batch, 1), max(t_max, 1), 51)
    args = tuple(a[:batch, :t_max].contiguous() if a.dim() == 3
                 else a[:batch].contiguous() for a in args)
    alphas, betas = SK.fwdbwd_scan(*args)
    a_only = SK.alpha_scan(*args[:3])
    b_only = SK.beta_scan(*args[:2], *args[3:])
    torch.cuda.synchronize()
    for out in (alphas, betas, a_only, b_only):
        assert tuple(out.shape) == (batch, t_max, 51)


def test_chains_equal_the_block_chains_bit_for_bit(device):
    """A lattice past the cut runs the block chains; its first 64 slots,
    as a lattice of their own, the register chains. alpha(t, s) reads
    slots <= s only, so the first 64 alphas agree bit for bit; beta(t, s)
    reads slots >= s, so with the tail slots' mask and virtual row at -inf
    the first 64 betas agree too (slot 63's neighbour is -inf in both)."""
    s1, n = CHAIN_CUT + 73, 64
    lpb, lpl, am, bm, ilen, bvirt = _chain_scan_args(device, s1, 200)
    bm[..., n:] = NEG_INF
    bvirt[:, n:] = NEG_INF
    head = lambda x: x[..., :n].contiguous()
    full = SK.fwdbwd_scan(lpb, lpl, am, bm, ilen, bvirt)
    part = SK.fwdbwd_scan(head(lpb), head(lpl), head(am), head(bm), ilen,
                          head(bvirt))
    a_part = SK.alpha_scan(head(lpb), head(lpl), head(am))
    b_full = SK.beta_scan(lpb, lpl, bm, ilen, bvirt)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(full[0][0, -1, :n]).all())
    assert bool(torch.isfinite(full[1][0, 0, :n]).any())
    for f, p in zip(full, part):
        assert torch.equal(head(f), p)
    assert torch.equal(a_part, part[0])
    assert torch.equal(head(b_full), part[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_beta_grad_kernel_at_the_padded_lattice(device, dtype):
    """Row 2 at the benchmark lattice (B=32, T=200, S=50, V=1000), which
    shares its gradient row with grad_pass."""
    _, bg_args = _inputs(device, 0, 32, 200, 50, 1000, 0, dtype)
    _hold_beta_grad(bg_args, True)


# --- the copy-ceiling kernels --------------------------------------------------------

def _random_bits(shape, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=device) * 3).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,rows,cols,kw", [
    ("vmem", 1024, 256, dict(block_rows=128)),
    ("vmem", 1024, 256, dict(block_rows=1024)),
    ("vmem", 45, 7, dict(block_rows=5)),          # 2- or 4-byte units
    ("dma", 1024, 256, dict(nbuf=1)),
    ("dma", 1024, 256, dict(nbuf=8)),
    ("dma", 96, 40, dict(nbuf=3)),                # slabs of 2-3 chunks' tail
    ("dma", 8192, 1024, dict(nbuf=4)),            # many 16 KB chunks a CTA
], ids=lambda p: str(p))
def test_stream_copy_kernel_is_exact(device, mode, rows, cols, kw, dtype):
    x = _random_bits((rows, cols), dtype, device, rows + cols)
    before = K.LAUNCHES["stream_copy"]
    got = ST.stream_copy(x, mode=mode, **kw)
    want = ST.stream_copy_plain(x, mode=mode, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["stream_copy"] == before + 1
    assert torch.equal(got, want) and torch.equal(got, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,tt", [((3, 8, 5, 7), 2),      # scalar path
                                      ((3, 8, 5, 128), 1),
                                      ((4, 6, 51, 1000), 3)])
def test_blocked_copy_kernels_are_exact(device, shape, tt, dtype):
    x = _random_bits(shape, dtype, device, shape[3])
    got = ST.stream_copy_blocked(x, tt=tt)
    xt = x.transpose(0, 1).contiguous()
    got_t = ST.stream_copy_blocked_tbsv(xt, tt=tt)
    torch.cuda.synchronize()
    assert torch.equal(got, ST.stream_copy_blocked_plain(x, tt=tt))
    assert torch.equal(got, x)
    assert torch.equal(got_t, ST.stream_copy_blocked_tbsv_plain(xt, tt=tt))
    assert torch.equal(got_t, xt)


def test_dma_mode_refuses_what_tma_cannot_move(device):
    x = torch.zeros((6, 5), device=device)       # slabs of 60 bytes
    with pytest.raises(ValueError, match="16-byte"):
        ST.stream_copy(x, mode="dma", nbuf=2)


def test_dma_mode_refuses_a_misaligned_view(device):
    x = torch.zeros(1 + 8 * 64, device=device)[1:].view(8, 64)
    with pytest.raises(ValueError, match="16-byte"):
        ST.stream_copy(x, mode="dma", nbuf=2)


# The redesigned copies (stream_copy's two modes, stream_copy_blocked and
# stream_copy_blocked_tbsv): (id, kernel, shape, arguments, elements the
# view starts past a fresh allocation). The register copy's tiles are 8 KB,
# one CTA each, of which the card holds 528 at once; TMA chunks are 16 KB,
# drawn by 132 CTAs; the blocked copy's tickets are 16 KB pieces of its
# (t-block, sample) tiles, drawn by 1056 CTAs.
COPY_EDGES = [
    ("vmem-more-tiles-than-ctas", "vmem", (8192, 1024), dict(block_rows=8), 0),
    ("vmem-fewer-tiles-than-ctas", "vmem", (64, 256), dict(block_rows=16), 0),
    ("vmem-one-block", "vmem", (3, 1000), dict(block_rows=3), 0),
    ("vmem-tails-under-16-bytes", "vmem", (2, 16385), dict(block_rows=1), 0),
    ("vmem-view-4-bytes-off", "vmem", (1000, 333), dict(block_rows=40), 1),
    ("vmem-view-8-bytes-off", "vmem", (1000, 333), dict(block_rows=40), 2),
    ("dma-more-chunks-than-ctas", "dma", (8192, 1024), dict(nbuf=4), 0),
    ("dma-fewer-chunks-than-ctas", "dma", (64, 256), dict(nbuf=2), 0),
    ("dma-one-chunk", "dma", (1, 64), dict(nbuf=1), 0),
    ("dma-tails-under-one-chunk", "dma", (2, 16392), dict(nbuf=2), 0),
    ("tbsv-fewer-t-blocks-than-ctas", "tbsv", (6, 8, 5, 7), dict(tt=2), 0),
    ("tbsv-more-t-blocks-than-ctas", "tbsv", (1200, 2, 3, 7), dict(tt=1), 0),
    ("tbsv-one-t-block", "tbsv", (4, 8, 51, 1000), dict(tt=4), 0),
    ("tbsv-view-off", "tbsv", (40, 3, 5, 33), dict(tt=4), 1),
    ("blocked-b1", "blocked", (1, 12, 51, 1024), dict(tt=2), 0),
    ("blocked-tt3-rows-not-16-bytes", "blocked", (3, 9, 5, 33), dict(tt=3), 0),
    ("blocked-one-row", "blocked", (1, 1, 1, 8), dict(tt=1), 0),
    ("blocked-fewer-tickets-than-ctas", "blocked", (2, 4, 5, 128),
     dict(tt=2), 0),
    ("blocked-more-tickets-than-ctas", "blocked", (8, 200, 51, 256),
     dict(tt=2), 0),
    ("blocked-view-off", "blocked", (2, 8, 51, 1000), dict(tt=2), 1),
]
_COPIES = {"vmem": (ST.stream_copy, ST.stream_copy_plain, "stream_copy"),
           "dma": (ST.stream_copy, ST.stream_copy_plain, "stream_copy"),
           "tbsv": (ST.stream_copy_blocked_tbsv,
                    ST.stream_copy_blocked_tbsv_plain,
                    "stream_copy_blocked_tbsv"),
           "blocked": (ST.stream_copy_blocked, ST.stream_copy_blocked_plain,
                       "stream_copy_blocked")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", COPY_EDGES, ids=lambda c: c[0])
def test_copy_kernels_are_exact_at_edges(device, case, dtype):
    _, kind, shape, kw, offset = case
    n = int(np.prod(shape))
    gen = torch.Generator(device=device).manual_seed(n)
    itemsize = torch.empty((), dtype=dtype).element_size()
    # Random bytes: every bit pattern of the dtype, NaN payloads included.
    base = torch.randint(0, 256, ((n + offset) * itemsize,), generator=gen,
                         dtype=torch.uint8, device=device).view(dtype)
    x = base[offset:].view(shape)
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
    kernel, plain, name = _COPIES[kind]
    if kind in ("vmem", "dma"):
        kw = dict(kw, mode=kind)
    before = K.LAUNCHES[name]
    got = kernel(x, **kw)
    want = plain(x, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(got.view(torch.uint8), x.view(torch.uint8))


def test_copies_on_two_streams_are_exact(device):
    # Each dma and blocked copy draws its work from a ticket counter of its
    # own, so copies on two streams may overlap, the register copies among
    # them.
    x = _random_bits((4096, 1024), torch.float32, device, 11)
    torch.cuda.synchronize()
    copies = [lambda: ST.stream_copy(x, "vmem", block_rows=64),
              lambda: ST.stream_copy(x, "dma", nbuf=4),
              lambda: ST.stream_copy_blocked_tbsv(x.view(64, 4, 16, 1024)),
              lambda: ST.stream_copy_blocked(x.view(4, 64, 16, 1024), tt=2)]
    streams = [torch.cuda.Stream(device), torch.cuda.Stream(device)]
    outs = []
    for i in range(4 * len(copies)):   # each kind twice on either stream
        with torch.cuda.stream(streams[i % 2]):
            outs.append(copies[(i // 2) % len(copies)]())
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(out.view(x.shape), x)


# --- the packed layout, the binding and alignment on the card ---------------------

def test_packed_binding_equals_the_padded_loss(device):
    logits, labels, ilen, slen = golden.repeat_label_case(9, 4, 30, 8, 300)
    lg, lb, il, sl = convert.loss_inputs_from_numpy(logits, labels, ilen, slen,
                                                    device=device)
    w = torch.tensor([1.0, -0.5, 2.0, 0.25], device=device)
    x = lg.clone().requires_grad_(True)
    ref = mt.monotonic_rnnt_loss(x, lb, il, sl)
    (ref * w).sum().backward()
    acts = mt.pack_acts(lg, il, sl).requires_grad_(True)
    K.reset_launch_counts()
    costs = binding.monotonic_rnnt_loss(acts, lb, il, sl)
    (costs * w).sum().backward()
    torch.cuda.synchronize()
    assert _launched() == LOSS_STEP
    assert torch.equal(costs, ref.detach())
    assert torch.equal(acts.grad, mt.pack_acts(x.grad, il, sl))


def test_viterbi_and_occupancy_kernels_match_the_oracles(device):
    rng = np.random.RandomState(4)
    b, t, s, v = 2, 60, 12, 50
    logits = (rng.randn(b, t, s + 1, v) * 2).astype(np.float32)
    labels = rng.randint(1, v, (b, s)).astype(np.int32)
    ilen, slen = np.array([60, 41], np.int32), np.array([12, 9], np.int32)
    cpu = convert.loss_inputs_from_numpy(logits, labels, ilen, slen,
                                         device="cpu")
    gpu = convert.loss_inputs_from_numpy(logits, labels, ilen, slen,
                                         device=device)
    K.reset_launch_counts()
    got = mt.viterbi_alignment(*gpu)
    occ = mt.occupancy_posteriors(*gpu)
    torch.cuda.synchronize()
    assert _launched() == {"softmax_stats": 2, "fwdbwd_scan": 1}
    want = mt.viterbi_alignment(*cpu)
    assert torch.equal(got.alignment.cpu(), want.alignment)
    _close(got.score, want.score, 1e-4, 1e-5)
    # Two f32 routes: the alphas (~1e2) round otherwise, and their ulp
    # enters the exponent of every occupancy (1.2e-5 seen on the card).
    _close(occ, mt.occupancy_posteriors(*cpu), 1e-4, 0)


# --- the 'reference' backend on the card ----------------------------------------

@pytest.fixture
def group_of_one(device):
    from monotonic_rnnt_tpu_torch.parallel import initialize_multihost

    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    initialize_multihost(world_size=1, rank=0, backend="gloo")
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_reference_backend_launches_no_kernel(device, group_of_one):
    """Under backend='reference' the paths that choose kernels by
    use_kernels (the fused-joint losses, the vocab-sharded losses, alignment)
    run the plain versions on CUDA tensors too, with the same results."""
    enc, pred, labels, ilen, slen, params = _fused_case(device)
    t, s1 = enc.shape[1], pred.shape[1]
    w = torch.tensor([1.0, -0.5, 2.0], device=device)
    bands = tbands.default_bands(ilen, slen, t)
    width = mt.suggested_band_width(ilen, slen, bands, t, s1)
    layout = mt.compute_band_layout(ilen, slen, bands, t, s1, width)
    logits = _joint(params, enc, pred)
    band = mt.pack_band(logits, layout)

    def runs():
        fj = _grads(lambda e, p, pr: mt.rnnt_loss_fused_joint(
            e, p, labels, ilen, slen, _joint, pr, chunk_t=8), enc, pred,
            params, w)
        fjb = _grads(lambda e, p, pr: mt.rnnt_loss_fused_joint_banded(
            e, p, labels, ilen, slen, _joint_banded, pr, bands=bands,
            band_width=width, chunk_t=16), enc, pred, params, w)
        out = {"fused_joint": fj[0], "fused_joint_banded": fjb[0]}
        for name, fn, x in (
                ("vocab_sharded", sharding.rnnt_loss_vocab_sharded, logits),
                ("banded_vocab_sharded",
                 sharding.rnnt_loss_banded_vocab_sharded, band)):
            leaf = x.detach().clone().requires_grad_(True)
            costs = fn(leaf, labels, ilen, slen, bands.min_s, bands.max_s, 0,
                       group_of_one)
            (costs * w).sum().backward()
            out[name], out[name + "_grad"] = costs.detach(), leaf.grad
        out["viterbi"] = mt.viterbi_alignment(logits, labels, ilen, slen).score
        out["viterbi_banded"] = mt.viterbi_alignment_banded(
            band, labels, ilen, slen, bands=bands).score
        out["occupancy"] = mt.occupancy_posteriors(logits, labels, ilen, slen)
        out["occupancy_banded"] = mt.occupancy_posteriors_banded(
            band, labels, ilen, slen, bands=bands)
        torch.cuda.synchronize()
        return out

    K.reset_launch_counts()
    want = runs()
    assert _launched()                      # the kernels ran on 'auto'
    with mt.config_override(backend="reference"):
        K.reset_launch_counts()
        got = runs()
        assert _launched() == {}
    for name in want:
        _close(got[name], want[name], 1e-4, 1e-4)


# --- traced routes: artifacts and compiled losses (rows 1-11 as operators) -----

class _HeldCalls:
    """Counts the calls of each operator's CUDA implementation (the
    <row>_cuda functions that K.OPS names), where every launch of a live,
    exported or compiled route is made."""

    def __enter__(self):
        self.calls, self.saved = {}, []
        for row, (_, module, attr) in K.OPS.items():
            fn = getattr(module, attr)
            self.saved.append((module, attr, fn))

            def shim(*args, row=row, fn=fn):
                self.calls[row] = self.calls.get(row, 0) + 1
                return fn(*args)
            setattr(module, attr, shim)
        return self

    def __exit__(self, *exc):
        for module, attr, fn in self.saved:
            setattr(module, attr, fn)


def _launches_of(fn):
    """fn()'s outputs and launches; every launch one held operator call."""
    K.reset_launch_counts()
    with _HeldCalls() as held:
        out = fn()
        torch.cuda.synchronize()
    assert held.calls == _launched()
    return out, _launched()


def _assert_equal(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _traced_case(device, dtype=torch.float32):
    logits, labels, ilen, slen = golden.repeat_label_case(7, 4, 30, 8, 300)
    return convert.loss_inputs_from_numpy(logits, labels, ilen, slen,
                                          device=device, dtype=dtype)


def _band_case(device):
    rng = np.random.RandomState(8)
    b, t, s, v = 2, 40, 12, 33
    logits = torch.from_numpy(rng.randn(b, t, s + 1, v).astype(np.float32))
    labels = rng.randint(1, v, (b, s)).astype(np.int32)
    ilen, slen = np.array([t, t - 5], np.int32), np.array([s, s - 2], np.int32)
    align = np.zeros((b, t), np.int32)
    for i in range(b):
        pos = np.sort(rng.choice(ilen[i], size=slen[i], replace=False))
        align[i, pos] = labels[i, :slen[i]]
    lg, lb, il, sl = convert.loss_inputs_from_numpy(
        logits.numpy(), labels, ilen, slen, device=device)
    bands = tbands.bands_from_alignment(
        torch.from_numpy(align).to(device), il, sl, 2, 0)
    w = tbands.suggested_band_width(il, sl, bands, t, s + 1)
    layout = tbands.compute_band_layout(il, sl, bands, t, s + 1, w)
    return (tbands.pack_band(lg, layout).contiguous(), lb, il, sl,
            bands.min_s, bands.max_s)


def test_exported_routes_equal_the_live_calls(device):
    """The banded kernel route (costs and grads), the fused-joint loss's
    cost-only forward and Viterbi with the occupancies, each through
    export_fn and import_fn: the live call's launches, each a held
    operator call, and its outputs bit for bit; exporting launches
    nothing."""
    from monotonic_rnnt_tpu_torch import serving
    from monotonic_rnnt_tpu_torch.ops.cuda import banded as cbanded

    band_args = _band_case(device)
    lg, lb, il, sl = _traced_case(device)
    rng = np.random.RandomState(9)
    b, t, s1, v = lg.shape
    joint_args = tuple(torch.from_numpy(rng.randn(*shape).astype(
        np.float32)).to(device) for shape in ((b, t, 16), (b, s1, 16),
                                               (16, v)))

    def banded(x, lab, ilen, slen, lo, hi):
        return cbanded.rnnt_loss_banded_cuda(x, lab, ilen, slen,
                                             tbands.Bands(lo, hi))

    def fused_forward(enc, pred, w, lab, ilen, slen):
        with torch.no_grad():
            return mt.rnnt_loss_fused_joint(
                enc, pred, lab, ilen, slen,
                lambda p, e, q: torch.tanh(e[:, :, None] + q[:, None])
                @ p["w"], {"w": w}, chunk_t=8)

    def alignment(x, lab, ilen, slen):
        vit = mt.viterbi_alignment(x, lab, ilen, slen)
        return (vit.alignment, vit.score,
                mt.occupancy_posteriors(x, lab, ilen, slen))

    for fn, args in ((banded, band_args),
                     (fused_forward, (*joint_args, lb, il, sl)),
                     (alignment, (lg, lb, il, sl))):
        blob, traced = _launches_of(lambda: serving.export_fn(fn, args))
        assert traced == {}
        want, want_launches = _launches_of(lambda: fn(*args))
        got, got_launches = _launches_of(
            lambda: serving.import_fn(blob)(*args))
        assert want_launches and got_launches == want_launches
        _assert_equal(got, want)


@pytest.mark.parametrize("route", ["deferred", "banded"])
def test_compiled_losses_equal_eager(device, route):
    """torch.compile(fullgraph=True, backend='aot_eager') of the public
    losses, forward and backward (a weighted sum of the costs): the first
    call (trace and run) launches what one eager call does, every launch a
    held operator call, and costs and gradients equal eager bit for bit."""
    if route == "banded":
        x, *rest, lo, hi = _band_case(device)
        bands = tbands.Bands(lo, hi)
        fn = lambda z, *a: mt.monotonic_rnnt_loss_banded(z, *a, bands=bands)
    else:
        x, *rest = _traced_case(device)
        fn = mt.monotonic_rnnt_loss
    weights = torch.linspace(-0.5, 2.0, x.shape[0], device=device)

    def step(f):
        leaf = x.detach().requires_grad_(True)
        costs = f(leaf, *rest)
        grads, = torch.autograd.grad((costs * weights).sum(), leaf)
        return costs.detach(), grads

    want, want_launches = _launches_of(lambda: step(fn))
    compiled = torch.compile(fn, fullgraph=True, backend="aot_eager")
    got, got_launches = _launches_of(lambda: step(compiled))
    torch._dynamo.reset()
    assert want_launches and got_launches == want_launches
    _assert_equal(got, want)
