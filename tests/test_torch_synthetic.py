"""The port's synthetic data pipeline against the JAX package's.

``monotonic_rnnt_tpu_torch/data/synthetic.py`` is the port's own numpy copy
of ``monotonic_rnnt_tpu/data/synthetic.py``: the same seed gives the same
batches, byte for byte (tiny_batch, and the bucketed stream of
SyntheticDataset.batches), the same bucket bounds and label bounds.
"""

import itertools

import numpy as np
import pytest

from monotonic_rnnt_tpu.data import synthetic as jsyn
from monotonic_rnnt_tpu_torch.data import synthetic as tsyn


def _assert_same_batch(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("kw", [{}, {"batch": 3, "t": 31, "feat_dim": 16,
                                     "s": 4, "vocab": 32, "seed": 5}])
def test_tiny_batch_is_byte_equal(kw):
    _assert_same_batch(tsyn.tiny_batch(**kw), jsyn.tiny_batch(**kw))


@pytest.mark.parametrize("seed", [0, 3])
def test_bucketed_batches_are_byte_equal(seed):
    def stream(mod):
        ds = mod.SyntheticDataset(mod.SyntheticConfig(max_frames=400,
                                                      seed=seed),
                                  batch_size=3, num_buckets=3)
        return list(itertools.islice(ds.batches(), 12))

    for got, want in zip(stream(tsyn), stream(jsyn), strict=True):
        _assert_same_batch(got, want)


@pytest.mark.parametrize("min_len,max_len,n", [(80, 1600, 4), (80, 400, 3),
                                               (10, 11, 5)])
def test_bucket_bounds_and_labels_match(min_len, max_len, n):
    bounds = tsyn.bucket_boundaries(min_len, max_len, n)
    assert bounds == jsyn.bucket_boundaries(min_len, max_len, n)
    for length in range(min_len - 2, max_len + 3, 7):
        assert (tsyn.assign_bucket(length, bounds)
                == jsyn.assign_bucket(length, bounds))
    t_ds = tsyn.SyntheticDataset(tsyn.SyntheticConfig(), 2)
    j_ds = jsyn.SyntheticDataset(jsyn.SyntheticConfig(), 2)
    for t_bound in bounds:
        for factor in (1, 4, 8):
            assert (t_ds.label_bound(t_bound, factor)
                    == j_ds.label_bound(t_bound, factor))


def test_synthetic_bucketing():
    """tests/test_models.py::test_synthetic_bucketing on the port's copy."""
    ds = tsyn.SyntheticDataset(tsyn.SyntheticConfig(max_frames=400),
                               batch_size=3, num_buckets=3)
    it = ds.batches()
    shapes = set()
    for _ in range(30):
        feats, flen, labels, slen = next(it)
        assert feats.shape[0] == 3
        assert np.all(flen <= feats.shape[1])
        assert np.all(slen <= labels.shape[1])
        assert np.all(slen >= 1)
        shapes.add((feats.shape, labels.shape))
    # Static shapes per bucket: both the feature AND label paddings are
    # bucket constants.
    assert len(shapes) <= 3, shapes
    t_bounds = {s[0][1] for s in shapes}
    assert len(t_bounds) == len(shapes), shapes  # one label pad per bucket
