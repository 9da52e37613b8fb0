"""The port's native engine binding (monotonic_rnnt_tpu_torch/native.py)
against the JAX package's (monotonic_rnnt_tpu/native.py): the same C++
source, so the same bits."""

import jax.numpy as jnp
import numpy as np
import pytest

from monotonic_rnnt_tpu import native as jnative
from monotonic_rnnt_tpu.ops.packing import pack_acts
from monotonic_rnnt_tpu_torch import native as tnative
from monotonic_rnnt_tpu_torch.utils.status import RnntError

import golden


def _random_case(seed, batch=5, t=23, s=7, v=19):
    rng = np.random.RandomState(seed)
    ilen = rng.randint(s + 1, t + 1, size=(batch,)).astype(np.int32)
    slen = rng.randint(0, s + 1, size=(batch,)).astype(np.int32)
    logits = rng.randn(batch, t, s + 1, v).astype(np.float32) * 2
    labels = rng.randint(1, v, size=(batch, s)).astype(np.int32)
    packed = np.asarray(pack_acts(jnp.asarray(logits), ilen, slen))
    align = np.zeros((batch, t), np.int32)
    for b in range(batch):
        pos = np.sort(rng.choice(ilen[b], size=slen[b], replace=False))
        align[b, pos] = labels[b, :slen[b]]
    return packed, labels, ilen, slen, align


def test_native_sources_are_a_verbatim_copy():
    for name in ("mrnnt.cpp", "mrnnt.h"):
        assert ((tnative.NATIVE_DIR / name).read_bytes()
                == (jnative._NATIVE_DIR / name).read_bytes())


@pytest.mark.parametrize("shift", [None, 0, 1, 3])
def test_native_matches_jax_native_bit_for_bit(shift):
    packed, labels, ilen, slen, align = _random_case(11 if shift is None
                                                     else 23 + shift)
    kw = ({} if shift is None else
          dict(alignment=align, max_distance_from_alignment=shift))
    for with_grads in (True, False):
        want_c, want_g = jnative.rnnt_loss_native(packed, labels, ilen, slen,
                                                  with_grads=with_grads, **kw)
        got_c, got_g = tnative.rnnt_loss_native(packed, labels, ilen, slen,
                                                with_grads=with_grads, **kw)
        np.testing.assert_array_equal(got_c, want_c)
        if with_grads:
            np.testing.assert_array_equal(got_g, want_g)
        else:
            assert got_g is None and want_g is None


def test_native_goldens():
    logits, labels, ilen, slen = golden.readme_batch()
    packed = np.asarray(pack_acts(jnp.asarray(logits), ilen, slen))
    costs, grads = tnative.rnnt_loss_native(packed, labels, ilen, slen)
    np.testing.assert_allclose(costs, [golden.README_LOSS], atol=1e-4)
    np.testing.assert_allclose(grads.reshape(4, 3, 3), golden.README_GRADS,
                               atol=1e-2)
    for align, losses in ((golden.ALIGN_A, golden.ALIGN_A_LOSSES),
                          (golden.ALIGN_B, golden.ALIGN_B_LOSSES)):
        for shift, expected in losses.items():
            costs, _ = tnative.rnnt_loss_native(
                packed, labels, ilen, slen, alignment=align[None],
                max_distance_from_alignment=shift)
            np.testing.assert_allclose(costs, [expected], rtol=1e-4,
                                       atol=1e-4)


def _bad_inputs():
    packed, labels, ilen, slen, align = _random_case(2, batch=3)
    return {
        "acts 3-D": (packed[None], labels, ilen, slen, {}),
        "batch disagrees": (packed, labels, ilen, slen[:2], {}),
        "row count": (packed[:-1], labels, ilen, slen, {}),
        "labels narrow": (packed, labels[:, :max(int(slen.max()) - 1, 0)],
                          ilen, slen, {}),
        "alignment narrow": (packed, labels, ilen, slen,
                             dict(alignment=align[:, :3])),
        "engine refuses T_b = 0": (packed, labels, np.array(
            [0, ilen[1], ilen[2] + ilen[0]], np.int32), slen, {}),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_the_same_validation_errors_as_jax(case):
    acts, labels, ilen, slen, kw = _bad_inputs()[case]
    with pytest.raises(Exception) as want:
        jnative.rnnt_loss_native(acts, labels, ilen, slen, **kw)
    with pytest.raises(RnntError) as got:
        tnative.rnnt_loss_native(acts, labels, ilen, slen, **kw)
    assert type(want.value).__name__ == "RnntError"
    assert str(got.value) == str(want.value)


def test_the_library_is_built_once_into_the_package_build_dir():
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR
    assert path.name.startswith("libmrnnt_native-")
    lib = tnative.load_library()
    assert path.exists() and tnative.load_library() is lib
