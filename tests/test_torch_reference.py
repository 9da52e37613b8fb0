"""The PyTorch port's plain-torch oracle against the JAX oracle and the goldens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
from monotonic_rnnt_tpu.ops.bands import bands_from_alignment as j_bands_from_alignment
from monotonic_rnnt_tpu.ops.reference import rnnt_loss_reference as _j_ref
from monotonic_rnnt_tpu_torch import convert
from monotonic_rnnt_tpu_torch.ops.bands import (bands_from_alignment,
                                                default_bands, lattice_masks)
from monotonic_rnnt_tpu_torch.ops.reference import (compute_stats,
                                                    forward_backward,
                                                    rnnt_loss_reference)

j_ref = jax.jit(_j_ref, static_argnames=("blank_id", "with_grads"))


def _cpu(*arrays):
    return convert.loss_inputs_from_numpy(*arrays, device="cpu")


def _random_case(seed, batch, t, s, v, blank):
    rng = np.random.RandomState(seed + 100)
    logits = (rng.randn(batch, t, s + 1, v) * 2).astype(np.float32)
    labels = rng.randint(0, v - 1, size=(batch, s)).astype(np.int32)
    labels = np.where(labels >= blank, labels + 1, labels)
    ilen = rng.randint(s + 1, t + 1, size=batch).astype(np.int32)
    slen = rng.randint(0, s + 1, size=batch).astype(np.int32)
    return logits, labels, ilen, slen


CASES = {
    "random_b4": lambda: _random_case(0, 4, 13, 5, 21, 0),
    "random_blank7_v50": lambda: _random_case(1, 3, 16, 6, 50, 7),
    "repeat_labels": lambda: golden.repeat_label_case(5, 4, 12, 6, 17),
    "repeat_labels_blank3": lambda: golden.repeat_label_case(6, 3, 10, 4, 9,
                                                             blank_id=3),
}
BLANKS = {"random_b4": 0, "random_blank7_v50": 7, "repeat_labels": 0,
          "repeat_labels_blank3": 3}


@pytest.mark.parametrize("name", sorted(CASES))
def test_oracle_matches_jax_oracle_random(name):
    logits, labels, ilen, slen = CASES[name]()
    blank = BLANKS[name]
    c_j, g_j = j_ref(jnp.asarray(logits), jnp.asarray(labels),
                     jnp.asarray(ilen), jnp.asarray(slen), blank_id=blank)
    c_t, g_t = rnnt_loss_reference(*_cpu(logits, labels, ilen, slen),
                                   blank_id=blank)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-6)
    c_only, none = rnnt_loss_reference(*_cpu(logits, labels, ilen, slen),
                                       blank_id=blank, with_grads=False)
    assert none is None
    np.testing.assert_array_equal(c_only.numpy(), c_t.numpy())


def test_readme_golden():
    costs, grads = rnnt_loss_reference(*_cpu(*golden.readme_batch()))
    np.testing.assert_allclose(costs.numpy(), [golden.README_LOSS], atol=1e-4)
    np.testing.assert_allclose(grads[0].numpy(), golden.README_GRADS,
                               atol=1e-2)


@pytest.mark.parametrize("t_pad,s_pad", [(None, None), (7, 5)])
def test_multibatch_golden(t_pad, s_pad):
    logits, labels, ilen, slen, exp_losses, exp_grads = golden.multibatch(
        t_pad, s_pad)
    costs, grads = rnnt_loss_reference(*_cpu(logits, labels, ilen, slen))
    np.testing.assert_allclose(costs.numpy(), exp_losses, atol=1e-4)
    np.testing.assert_allclose(grads.numpy(), exp_grads, atol=1e-2)


def test_fwd_bwd_likelihoods_agree():
    logits, labels, ilen, slen, _, _ = golden.multibatch()
    lg, lb, il, sl = _cpu(logits, labels, ilen, slen)
    bands = default_bands(il, sl, lg.shape[1])
    masks = lattice_masks(il, sl, bands, lg.shape[1], lg.shape[2])
    _, _, ll_fwd, ll_bwd = forward_backward(compute_stats(lg, lb, sl, 0),
                                            masks, il, sl)
    np.testing.assert_allclose(ll_fwd.numpy(), ll_bwd.numpy(), atol=1e-4)


@pytest.mark.parametrize("align,shift,expected", [
    (golden.ALIGN_A, shift, golden.ALIGN_A_LOSSES[min(shift, 2)])
    for shift in (3, 2, 1, 0)] + [
    (golden.ALIGN_B, shift, golden.ALIGN_B_LOSSES[shift]) for shift in (1, 0)])
def test_restricted_goldens(align, shift, expected):
    lg, lb, il, sl = _cpu(*golden.readme_batch())
    bands = bands_from_alignment(torch.from_numpy(align[None]), il, sl, shift,
                                 blank_id=0)
    costs, grads = rnnt_loss_reference(lg, lb, il, sl, bands=bands)
    np.testing.assert_allclose(costs.numpy(), [expected], rtol=1e-4, atol=1e-4)
    assert torch.isfinite(grads).all()
    jl, jb, ji, js = (jnp.asarray(a) for a in golden.readme_batch())
    c_j, g_j = j_ref(jl, jb, ji, js, bands=j_bands_from_alignment(
        jnp.asarray(align[None]), ji, js, shift, 0))
    np.testing.assert_allclose(costs.numpy(), np.asarray(c_j), rtol=1e-5)
    np.testing.assert_allclose(grads.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-6)


def test_infeasible_lattice_inf_cost_zero_grad():
    # Sample 1 has S_b = 2 but an all-blank exact alignment: zero-width band.
    logits, labels, ilen, slen = golden.repeat_label_case(9, 2, 8, 2, 6)
    slen[:] = 2
    align = np.zeros((2, 8), np.int32)
    align[0, [1, 4]] = labels[0]
    lg, lb, il, sl = _cpu(logits, labels, ilen, slen)
    bands = bands_from_alignment(torch.from_numpy(align), il, sl, 0, 0)
    costs, grads = rnnt_loss_reference(lg, lb, il, sl, bands=bands)
    assert torch.isfinite(costs[0]) and costs[1].item() == np.inf
    assert (grads[1] == 0).all() and torch.isfinite(grads).all()


def test_inf_padding_zero_grad():
    # +-inf in padding rows (t >= T_b) and padding columns (s > S_b) leave
    # the costs unchanged and get exactly zero gradient.
    logits, labels, ilen, slen = _random_case(3, 3, 10, 4, 12, 0)
    ilen[:] = [10, 7, 5]
    slen[:] = [4, 2, 1]
    padded = logits.copy()
    for b in range(3):
        padded[b, ilen[b]:, :, ::2] = np.inf
        padded[b, ilen[b]:, :, 1::2] = -np.inf
        padded[b, :, slen[b] + 1:, 3] = np.inf
        padded[b, :, slen[b] + 1:, 5] = -np.inf
    c_fin, g_fin = rnnt_loss_reference(*_cpu(logits, labels, ilen, slen))
    c_inf, g_inf = rnnt_loss_reference(*_cpu(padded, labels, ilen, slen))
    np.testing.assert_array_equal(c_inf.numpy(), c_fin.numpy())
    t_idx = np.arange(10)[None, :, None]
    s_idx = np.arange(5)[None, None, :]
    pad = (t_idx >= ilen[:, None, None]) | (s_idx > slen[:, None, None])
    assert (g_inf.numpy()[pad] == 0).all()
    np.testing.assert_array_equal(g_inf.numpy()[~pad], g_fin.numpy()[~pad])


def test_bf16_logits_match_jax_oracle():
    logits, labels, ilen, slen = golden.repeat_label_case(11, 3, 9, 4, 23)
    c_j, g_j = j_ref(jnp.asarray(logits).astype(jnp.bfloat16),
                     jnp.asarray(labels), jnp.asarray(ilen), jnp.asarray(slen))
    lg, lb, il, sl = convert.loss_inputs_from_numpy(
        logits, labels, ilen, slen, device="cpu", dtype=torch.bfloat16)
    c_t, g_t = rnnt_loss_reference(lg, lb, il, sl)
    assert g_t.dtype == torch.float32  # the oracle's gradient is f32
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-6)
