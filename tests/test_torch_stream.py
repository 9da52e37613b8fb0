"""The port's copy-ceiling kernels' plain versions against the JAX package's
Pallas kernels (monotonic_rnnt_tpu/ops/pallas/stream.py) in interpret mode,
as tests/test_pallas.py runs them: exact copies, the same errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monotonic_rnnt_tpu.ops.pallas import stream as jstream
from monotonic_rnnt_tpu_torch.ops.cuda import kernels as tk
from monotonic_rnnt_tpu_torch.ops.cuda import stream as ts


def _flat(seed, rows=1024, cols=256):
    return np.random.RandomState(seed).randn(rows, cols).astype(np.float32)


@pytest.mark.parametrize("mode,kw", [
    ("vmem", dict(block_rows=128)), ("vmem", dict(block_rows=512)),
    ("dma", dict(nbuf=1)), ("dma", dict(nbuf=4))])
def test_stream_copy_matches_pallas_exactly(mode, kw):
    x = _flat(3)
    want = np.asarray(jstream.stream_copy(jnp.asarray(x), mode=mode,
                                          interpret=True, **kw))
    before = dict(tk.LAUNCHES)
    for fn in (ts.stream_copy, ts.stream_copy_plain):
        got = fn(torch.from_numpy(x), mode=mode, **kw)
        assert np.array_equal(got.numpy(), want) and np.array_equal(want, x)
    assert tk.LAUNCHES == before          # CPU: plain versions, no launches


@pytest.mark.parametrize("tt", [1, 2])
def test_blocked_copies_match_pallas_exactly(tt):
    x = np.random.RandomState(4).randn(3, 8, 5, 128).astype(np.float32)
    want = np.asarray(jstream.stream_copy_blocked(jnp.asarray(x), tt=tt,
                                                  interpret=True))
    got = ts.stream_copy_blocked(torch.from_numpy(x), tt=tt)
    assert np.array_equal(got.numpy(), want) and np.array_equal(want, x)
    xt = np.ascontiguousarray(x.transpose(1, 0, 2, 3))
    want_t = np.asarray(jstream.stream_copy_blocked_tbsv(
        jnp.asarray(xt), tt=tt, interpret=True))
    got_t = ts.stream_copy_blocked_tbsv(torch.from_numpy(xt), tt=tt)
    assert np.array_equal(got_t.numpy(), want_t)
    assert np.array_equal(want_t, xt)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64, torch.int32])
def test_plain_copies_are_exact_in_any_dtype(dtype):
    # The copy moves bytes: bf16 and odd row widths (V=7) copy exactly.
    base = torch.from_numpy(np.random.RandomState(5).randn(4, 6, 3, 7) * 100)
    x = base.to(dtype)
    assert torch.equal(ts.stream_copy_blocked(x, tt=3), x)
    assert torch.equal(ts.stream_copy_blocked_tbsv(x.transpose(0, 1)
                                                   .contiguous(), tt=2),
                       x.transpose(0, 1))
    flat = x.reshape(24, 21)
    assert torch.equal(ts.stream_copy(flat, block_rows=8), flat)
    assert torch.equal(ts.stream_copy(flat, mode="dma", nbuf=3), flat)


def _raises_like_pallas(port_fn, jax_fn, x):
    with pytest.raises(ValueError) as want:
        jax_fn(jnp.asarray(x))
    with pytest.raises(ValueError) as got:
        port_fn(torch.from_numpy(x))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["vmem", "dma", "blocked", "tbsv"])
def test_the_same_value_errors_as_pallas(case):
    x = _flat(6, 1024, 128)
    x4 = np.zeros((3, 8, 5, 128), np.float32)
    if case == "vmem":
        _raises_like_pallas(
            lambda t: ts.stream_copy(t, block_rows=100),
            lambda a: jstream.stream_copy(a, block_rows=100, interpret=True),
            x)
    elif case == "dma":
        _raises_like_pallas(
            lambda t: ts.stream_copy(t, mode="dma", nbuf=3),
            lambda a: jstream.stream_copy(a, mode="dma", nbuf=3,
                                          interpret=True), x)
    elif case == "blocked":
        _raises_like_pallas(
            lambda t: ts.stream_copy_blocked(t, tt=3),
            lambda a: jstream.stream_copy_blocked(a, tt=3, interpret=True),
            x4)
    else:
        _raises_like_pallas(
            lambda t: ts.stream_copy_blocked_tbsv(t, tt=3),
            lambda a: jstream.stream_copy_blocked_tbsv(a, tt=3,
                                                       interpret=True),
            x4.transpose(1, 0, 2, 3).copy())


def test_rank_and_mode_are_checked():
    with pytest.raises(ValueError, match="2-D"):
        ts.stream_copy(torch.zeros(4, 4, 4))
    with pytest.raises(ValueError, match="mode"):
        ts.stream_copy(torch.zeros(4, 4), mode="hbm")
    for fn in (ts.stream_copy_blocked, ts.stream_copy_blocked_tbsv):
        with pytest.raises(ValueError, match="4-D"):
            fn(torch.zeros(4, 4))


def test_wrappers_refuse_a_device_they_cannot_launch_on():
    # Off the CPU the wrappers take the kernel path, whose checks refuse a
    # non-CUDA tensor: nothing falls back to the plain version.
    with pytest.raises(ValueError, match="CUDA tensors"):
        ts.stream_copy(torch.empty((8, 4), device="meta"), block_rows=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ts.stream_copy_blocked(torch.empty((2, 4, 3, 4), device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ts.stream_copy_blocked_tbsv(torch.empty((4, 2, 3, 4), device="meta"))
