"""The port's packed layout (ops/packing.py) against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monotonic_rnnt_tpu as mr
import monotonic_rnnt_tpu_torch as mt
from monotonic_rnnt_tpu.ops import packing as jpack
from monotonic_rnnt_tpu_torch.ops import loss as tloss
from monotonic_rnnt_tpu_torch.ops import packing as tpack
from monotonic_rnnt_tpu_torch.ops.cuda import kernels as tk

WEIGHTS = np.array([1.0, -0.5, 2.0, 0.25], np.float32)


def _case(seed=21):
    """Variable T_b and S_b, one sample with S_b = 0."""
    rng = np.random.RandomState(seed)
    b, t, s, v = 4, 11, 5, 17
    ilen = np.array([11, 7, 9, 4], np.int32)
    slen = np.array([5, 2, 0, 4], np.int32)
    logits = (rng.randn(b, t, s + 1, v) * 2).astype(np.float32)
    labels = rng.randint(1, v, size=(b, s)).astype(np.int32)
    packed = np.asarray(jpack.pack_acts(jnp.asarray(logits), ilen, slen))
    align = np.zeros((b, t), np.int32)
    for i in range(b):
        pos = np.sort(rng.choice(ilen[i], size=slen[i], replace=False))
        align[i, pos] = labels[i, :slen[i]]
    return packed, labels, ilen, slen, align


def test_packed_row_indices_match_jax():
    ilen = np.array([3, 5, 1], np.int64)
    slen = np.array([2, 0, 1], np.int64)
    want = jpack.packed_row_indices(ilen, slen, 6, 4)
    got = tpack.packed_row_indices(ilen, slen, 6, 4)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype and got[1] == want[1] == 9 + 5 + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_and_unpack_match_jax_exactly(dtype):
    packed, _, ilen, slen, _ = _case()
    padded_j = np.asarray(jpack.unpack_acts(jnp.asarray(packed), ilen, slen))
    x = torch.from_numpy(packed).to(dtype)
    padded = tpack.unpack_acts(x, torch.from_numpy(ilen),
                               torch.from_numpy(slen))
    assert padded.dtype == dtype
    np.testing.assert_array_equal(
        padded.float().numpy(),
        torch.from_numpy(padded_j).to(dtype).float().numpy())
    again = tpack.pack_acts(padded, ilen, slen)
    assert torch.equal(again, x)
    # Wider padding than the lengths imply, as the loss's padded inputs.
    wide = tpack.unpack_acts(x, ilen, slen, t_max=13, s_max=7)
    assert wide.shape == (4, 13, 8, 17)
    assert torch.equal(tpack.pack_acts(wide, ilen, slen), x)
    want_wide = np.asarray(jpack.unpack_acts(jnp.asarray(packed), ilen, slen,
                                             t_max=13, s_max=7))
    np.testing.assert_array_equal(
        wide.float().numpy(),
        torch.from_numpy(want_wide).to(dtype).float().numpy())


def _jax_value_and_grad(packed, labels, ilen, slen, **kw):
    def total(a):
        return jnp.sum(jnp.asarray(WEIGHTS) * jpack.monotonic_rnnt_loss_packed(
            a, jnp.asarray(labels), ilen, slen, backend="reference", **kw))

    costs = jpack.monotonic_rnnt_loss_packed(
        jnp.asarray(packed), jnp.asarray(labels), ilen, slen,
        backend="reference", **kw)
    _, g = jax.value_and_grad(total)(jnp.asarray(packed))
    return np.asarray(costs), np.asarray(g)


@pytest.mark.parametrize("route", ["reference", "cuda"])
@pytest.mark.parametrize("restricted", [False, True])
def test_packed_loss_matches_jax_value_and_grad(route, restricted,
                                                monkeypatch):
    packed, labels, ilen, slen, align = _case()
    kw = (dict(alignment=align, max_distance_from_alignment=1)
          if restricted else {})
    want_c, want_g = _jax_value_and_grad(packed, labels, ilen, slen, **kw)
    if route == "cuda":
        # The deferred route (stats+alpha forward, beta+grad backward) on
        # CPU tensors, where the kernel wrappers take their plain versions.
        monkeypatch.setattr(tloss, "_resolve_backend", lambda b, x: "cuda")
    x = torch.from_numpy(packed).requires_grad_(True)
    tkw = dict(kw)
    if restricted:
        tkw["alignment"] = torch.from_numpy(align)
    costs = mt.monotonic_rnnt_loss_packed(x, torch.from_numpy(labels),
                                          torch.from_numpy(ilen),
                                          torch.from_numpy(slen), **tkw)
    (costs * torch.from_numpy(WEIGHTS)).sum().backward()
    assert np.isfinite(want_c).all()
    np.testing.assert_allclose(costs.detach().numpy(), want_c, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=1e-4, atol=1e-6)


def test_packed_gradient_is_the_padded_gradient_packed():
    packed, labels, ilen, slen, _ = _case(3)
    x = torch.from_numpy(packed).requires_grad_(True)
    costs = mt.monotonic_rnnt_loss_packed(x, torch.from_numpy(labels), ilen,
                                          slen)
    (costs * torch.from_numpy(WEIGHTS)).sum().backward()
    padded = tpack.unpack_acts(torch.from_numpy(packed), ilen,
                               slen).requires_grad_(True)
    ref = mt.monotonic_rnnt_loss(padded, torch.from_numpy(labels),
                                 torch.from_numpy(ilen),
                                 torch.from_numpy(slen))
    (ref * torch.from_numpy(WEIGHTS)).sum().backward()
    assert torch.equal(costs.detach(), ref.detach())
    assert torch.equal(x.grad, tpack.pack_acts(padded.grad, ilen, slen))


def test_labels_wider_than_s_max_and_long_alignment_are_sliced():
    packed, labels, ilen, slen, align = _case(5)
    base = mt.monotonic_rnnt_loss_packed(
        torch.from_numpy(packed), torch.from_numpy(labels), ilen, slen,
        alignment=torch.from_numpy(align), max_distance_from_alignment=2)
    wide_lab = np.concatenate([labels, np.full((4, 3), 7, np.int32)], 1)
    wide_al = np.concatenate([align, np.zeros((4, 2), np.int32)], 1)
    got = mt.monotonic_rnnt_loss_packed(
        torch.from_numpy(packed), torch.from_numpy(wide_lab), ilen, slen,
        alignment=torch.from_numpy(wide_al), max_distance_from_alignment=2)
    assert torch.equal(got, base)


def test_the_rnnt_errors_of_jax():
    packed, labels, ilen, slen, _ = _case()
    t_lab = torch.from_numpy(labels)
    with pytest.raises(mt.RnntError, match="lengths imply"):
        mt.monotonic_rnnt_loss_packed(torch.from_numpy(packed[:-1]), t_lab,
                                      ilen, slen)
    with pytest.raises(mt.RnntError, match="< S_max"):
        mt.monotonic_rnnt_loss_packed(torch.from_numpy(packed), t_lab[:, :3],
                                      ilen, slen)
    with pytest.raises(mr.RnntError, match="< S_max"):
        jpack.monotonic_rnnt_loss_packed(jnp.asarray(packed),
                                         jnp.asarray(labels[:, :3]), ilen,
                                         slen)
    # Lengths that cannot reach the host (JAX: a tracer under jit).
    meta = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(mt.RnntError, match="concrete"):
        tpack.unpack_acts(torch.from_numpy(packed), meta, slen)
    with pytest.raises(mr.RnntError, match="concrete"):
        jax.jit(lambda il: jpack.unpack_acts(jnp.asarray(packed), il,
                                             slen))(jnp.asarray(ilen))


def test_pack_and_unpack_launch_nothing_on_the_cpu():
    packed, labels, ilen, slen, _ = _case()
    before = dict(tk.LAUNCHES)
    tpack.pack_acts(tpack.unpack_acts(torch.from_numpy(packed), ilen, slen),
                    ilen, slen)
    assert tk.LAUNCHES == before
