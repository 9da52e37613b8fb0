"""The PyTorch port's helpers, bands and input validation against the JAX
package, and the padded loss's launch-first order: on the card it queues
its forward before it waits for the lengths and checks them."""

import itertools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monotonic_rnnt_tpu.ops import bands as jbands
from monotonic_rnnt_tpu.ops import helpers as jhelpers
from monotonic_rnnt_tpu.utils import status as jstatus
import monotonic_rnnt_tpu_torch as mt
from monotonic_rnnt_tpu_torch.ops import bands as tbands
from monotonic_rnnt_tpu_torch.ops import helpers as thelpers
from monotonic_rnnt_tpu_torch.ops import loss as tloss
from monotonic_rnnt_tpu_torch.ops.cuda import fused
from monotonic_rnnt_tpu_torch.utils import profiling as tprof
from monotonic_rnnt_tpu_torch.utils import status as tstatus
from glue_lattices import BAD_LENGTHS

SPECIALS = [-np.inf, np.inf, 0.0, -1.0, 3.5, -1e30, 88.0]


def _pairs():
    special = np.array(list(itertools.product(SPECIALS, SPECIALS)), np.float32)
    rng = np.random.RandomState(0)
    finite = (rng.randn(200, 2) * 20).astype(np.float32)
    return special[:, 0], special[:, 1], finite[:, 0], finite[:, 1]


@pytest.mark.parametrize("name", ["log_sum_exp", "log_diff_exp"])
def test_log_space_pairs_match_jax(name):
    a_sp, b_sp, a_fin, b_fin = _pairs()
    if name == "log_diff_exp":  # defined for a >= b
        a_fin, b_fin = np.maximum(a_fin, b_fin), np.minimum(a_fin, b_fin)
    jfn, tfn = getattr(jhelpers, name), getattr(thelpers, name)
    with np.errstate(invalid="ignore"):
        # +-inf pairs (and the NaN of an undefined pair) exactly.
        np.testing.assert_array_equal(
            tfn(torch.from_numpy(a_sp), torch.from_numpy(b_sp)).numpy(),
            np.asarray(jfn(jnp.asarray(a_sp), jnp.asarray(b_sp))))
    # Finite pairs to a few ulp: XLA's and torch's CPU exp/log1p may round
    # the last bit differently.
    np.testing.assert_allclose(
        tfn(torch.from_numpy(a_fin), torch.from_numpy(b_fin)).numpy(),
        np.asarray(jfn(jnp.asarray(a_fin), jnp.asarray(b_fin))),
        rtol=1e-6, atol=1e-6)


def test_log_sum_exp_of_two_neg_inf_is_neg_inf():
    out = thelpers.log_sum_exp(torch.tensor([-np.inf]), torch.tensor([-np.inf]))
    assert out.item() == -np.inf


def _case(seed, batch=4, t_max=11, s_max=5, blank=0):
    rng = np.random.RandomState(seed)
    ilen = rng.randint(s_max, t_max + 1, size=batch).astype(np.int32)
    slen = rng.randint(0, s_max + 1, size=batch).astype(np.int32)
    labels = rng.randint(1, 9, size=(batch, s_max)).astype(np.int32)
    align = np.full((batch, t_max), blank, np.int32)
    for b in range(batch):
        frames = np.sort(rng.choice(ilen[b], size=slen[b], replace=False))
        align[b, frames] = labels[b, :slen[b]]
    return labels, ilen, slen, align


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


@pytest.mark.parametrize("seed", [0, 1])
def test_extend_labels_matches_jax(seed):
    labels, ilen, slen, _ = _case(seed)
    (jl, js), (tl, ts) = _both(labels, slen)
    s1 = labels.shape[1] + 1
    got = thelpers.extend_labels(tl, ts, s1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jhelpers.extend_labels(jl, js, s1)))


@pytest.mark.parametrize("seed,shift", [(0, 0), (1, 1), (2, 3), (3, 20)])
def test_bands_windows_and_masks_match_jax(seed, shift):
    labels, ilen, slen, align = _case(seed)
    t_max, s1 = align.shape[1], labels.shape[1] + 1
    (ja, ji, js), (ta, ti, ts) = _both(align, ilen, slen)
    cases = [
        (jbands.default_bands(ji, js, t_max),
         tbands.default_bands(ti, ts, t_max)),
        (jbands.bands_from_alignment(ja, ji, js, shift, 0),
         tbands.bands_from_alignment(ta, ti, ts, shift, 0)),
    ]
    for jb, tb in cases:
        for j_arr, t_arr in zip(jb, tb):
            assert t_arr.dtype == torch.int32
            np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))
        for j_arr, t_arr in zip(
                jbands._window_bounds(ji, js, jb, t_max, s1),
                tbands._window_bounds(ti, ts, tb, t_max, s1)):
            np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))
        for j_arr, t_arr in zip(jbands.lattice_masks(ji, js, jb, t_max, s1),
                                tbands.lattice_masks(ti, ts, tb, t_max, s1)):
            assert t_arr.dtype == torch.bool
            np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))


def _valid():
    return (np.zeros((2, 5, 3, 7), np.float32), np.ones((2, 2), np.int32),
            np.array([5, 3], np.int32), np.array([2, 1], np.int32))


def _bad_inputs():
    lg, lb, il, sl = _valid()
    yield "logits_3d", (lg[0], lb, il, sl)
    yield "zero_dim", (np.zeros((2, 0, 3, 7), np.float32), lb, il, sl)
    yield "labels_batch", (lg, lb[:1], il, sl)
    yield "labels_narrow", (lg, lb[:, :1], il, sl)
    yield "ilen_shape", (lg, lb, il[:1], sl)
    yield "slen_float", (lg, lb, il, sl.astype(np.float32))
    for name, ilen, slen in BAD_LENGTHS:
        yield name, (lg, lb, np.array(ilen, np.int32),
                     np.array(slen, np.int32))


@pytest.mark.parametrize("name,args", list(_bad_inputs()),
                         ids=[n for n, _ in _bad_inputs()])
def test_validate_loss_inputs_raises_like_jax(name, args):
    jargs, targs = _both(*args)
    with pytest.raises(jstatus.RnntError) as jexc:
        jstatus.validate_loss_inputs(*jargs)
    with pytest.raises(tstatus.RnntError) as texc:
        tstatus.validate_loss_inputs(*targs)
    assert texc.value.status.name == jexc.value.status.name
    assert texc.value.status.value == jexc.value.status.value
    assert str(texc.value) == str(jexc.value)


def test_validate_loss_inputs_accepts_valid():
    _, targs = _both(*_valid())
    tstatus.validate_loss_inputs(*targs)


# --- the launch-first order (ops/loss.py loss_ahead) ---------------------------
#
# On the card, a padded loss call with its lengths there copies them to the
# host without waiting, queues its forward and only then waits and checks.
# Here the seam is the 'cuda' route on CPU tensors (the operators' plain
# versions) with a recorder standing in for the copy's CUDA event.

class _Copy:
    """copy_lengths as on the card: the host lengths with an event, whose
    synchronize() (the wait) records what the forward had called by then."""

    def __init__(self, log):
        self.log, self.seen_at_wait = log, None

    def __call__(self, input_lengths, label_lengths):
        (ilen, slen), done = tstatus.copy_lengths(input_lengths,
                                                  label_lengths)
        assert done is None                     # host lengths: no copy
        return (ilen, slen), types.SimpleNamespace(synchronize=self.wait)

    def wait(self):
        self.seen_at_wait = list(self.log)


def _launch_first(monkeypatch, forward=None):
    """Routes monotonic_rnnt_loss through loss_ahead on CPU tensors; logs the
    calls of row 1's and loss_costs' operators, or stands `forward` in for
    the forward's launches. Returns (the copy, the call log)."""
    log = []
    monkeypatch.setattr(tloss, "_queues_ahead", lambda *a: True)
    monkeypatch.setattr(tloss, "_resolve_backend", lambda b, x: "cuda")
    for name in ("stats_alpha_fused", "loss_costs"):
        def logged(*args, _fn=getattr(fused, name), _name=name):
            log.append(_name)
            return _fn(*args)
        monkeypatch.setattr(fused, name, logged)
    if forward is not None:
        def recorder(logits, *args):
            log.append("forward")
            return forward(logits)
        monkeypatch.setattr(tloss, "loss_on_route", recorder)
    copy = _Copy(log)
    monkeypatch.setattr(tloss, "copy_lengths", copy)
    return copy, log


@pytest.mark.parametrize("name,ilen,slen", BAD_LENGTHS,
                         ids=[c[0] for c in BAD_LENGTHS])
def test_launch_first_raises_as_validation_does(monkeypatch, name, ilen,
                                                slen):
    """Every invalid length case raises, after the forward's launches, the
    RnntError that validate_loss_inputs raises, with its status and
    message; its costs never reach the caller."""
    lg, lb, _, _ = (torch.from_numpy(a) for a in _valid())
    il, sl = (torch.tensor(v, dtype=torch.int32) for v in (ilen, slen))
    with pytest.raises(tstatus.RnntError) as want:
        tstatus.validate_loss_inputs(lg, lb, il, sl)
    copy, log = _launch_first(monkeypatch,
                              forward=lambda x: x.new_zeros(x.shape[0]))
    tprof.reset_counters()
    with pytest.raises(tstatus.RnntError) as got:
        mt.monotonic_rnnt_loss(lg, lb, il, sl)
    assert got.value.status is want.value.status
    assert str(got.value) == str(want.value)
    assert copy.seen_at_wait == ["forward"]
    seen = tprof.counters()
    assert seen["syncs"] == {"validate.lengths": 1}
    assert seen["ahead"] == {"validate": 1}
    assert "rows" not in seen               # no rows from invalid lengths


@pytest.mark.parametrize("valid", [True, False], ids=["valid", "invalid"])
def test_launch_first_keeps_the_checks_precedence(monkeypatch, valid):
    """Where a launch refuses its operands, invalid lengths still raise
    their RnntError first, as where the checks come first; valid ones let
    the launch's error through."""
    lg, lb, il, sl = (torch.from_numpy(a) for a in _valid())
    if not valid:
        il = torch.tensor([0, 3], dtype=torch.int32)

    def refused(x):
        raise ValueError("logits must be float32 or bfloat16")

    _launch_first(monkeypatch, forward=refused)
    with pytest.raises(ValueError) as got:
        mt.monotonic_rnnt_loss(lg, lb, il, sl)
    assert isinstance(got.value, tstatus.RnntError) is not valid


def test_launch_first_equals_checks_first(monkeypatch):
    """On valid lengths the launch-first order gives the costs and the
    gradient of the checks-first order bit for bit, waits once, after row 1
    and loss_costs were called, and counts one call queued ahead and row
    1's rows."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.randn(3, 9, 5, 11) * 2).astype(np.float32))
    labels = torch.from_numpy(rng.randint(1, 11, (3, 4)).astype(np.int32))
    il = torch.tensor([9, 7, 4], dtype=torch.int32)
    sl = torch.tensor([4, 2, 0], dtype=torch.int32)
    w = torch.tensor([1.0, -0.5, 2.0])

    def run():
        xg = x.clone().requires_grad_(True)
        costs = mt.monotonic_rnnt_loss(xg, labels, il, sl)
        (grad,) = torch.autograd.grad((costs * w).sum(), xg)
        return costs.detach(), grad

    with monkeypatch.context() as m:
        m.setattr(tloss, "_resolve_backend", lambda b, x: "cuda")
        first = run()
    copy, _ = _launch_first(monkeypatch)
    tprof.reset_counters()
    ahead = run()
    assert torch.equal(ahead[0], first[0]) and torch.equal(ahead[1], first[1])
    assert copy.seen_at_wait == ["stats_alpha_fused", "loss_costs"]
    seen = tprof.counters()
    assert seen["syncs"] == {"validate.lengths": 1}
    assert seen["ahead"] == {"validate": 1}
    assert seen["rows"] == {"stats_alpha_fused.read": 9 * 5 + 7 * 3 + 4,
                            "stats_alpha_fused.padded": 3 * 9 * 5}


def test_reference_route_checks_first():
    """CPU tensors take the reference route, which checks first: nothing is
    queued ahead and host lengths need no sync."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 5, 3, 7).astype(np.float32))
    labels = torch.ones((2, 2), dtype=torch.int32)
    tprof.reset_counters()
    mt.monotonic_rnnt_loss(x, labels, torch.tensor([5, 3]),
                           torch.tensor([2, 1])).sum()
    assert tprof.counters() == {"launches": {}, "syncs": {}}
    with pytest.raises(tstatus.RnntError, match="input_lengths must be"):
        mt.monotonic_rnnt_loss(x, labels, torch.tensor([0, 3]),
                               torch.tensor([2, 1]))


_CARD = types.SimpleNamespace(is_cuda=True)
_HOST = types.SimpleNamespace(is_cuda=False)


@pytest.mark.parametrize("logits,lengths,alignment,backend,traced,ahead", [
    (_CARD, _CARD, None, None, False, True),
    (_CARD, _CARD, None, "cuda", False, True),
    (_CARD, _CARD, None, "reference", False, False),
    (_CARD, _HOST, None, None, False, False),
    (_HOST, _HOST, None, None, False, False),
    (_CARD, _CARD, _CARD, None, False, False),
    (_CARD, _CARD, None, None, True, False),
], ids=["auto", "cuda", "reference", "host-lengths", "host", "alignment",
        "traced"])
def test_which_calls_queue_ahead(monkeypatch, logits, lengths, alignment,
                                 backend, traced, ahead):
    """Only the 'cuda' route with both lengths on the card, no alignment
    and no graph being traced queues its forward before its checks."""
    monkeypatch.setattr(tloss, "tracing", lambda: traced)
    assert tloss._queues_ahead(logits, _CARD, lengths, alignment,
                               backend) is ahead
