"""Every traffic file yields its stated buckets, budgets and label rates
from a seed, and only the order and the label ids change with the seed."""

import json
from collections import Counter

import numpy as np
import pytest

from h100_bench.run import HERE
from h100_bench.traffic import (FRAME_S, LengthLaw, frames_per_token,
                                load_mix, make_cycle, subsampled)

MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))
SEEDS = (2 ** 31 + 11, 7)


CONFIGS = sorted(p.stem for p in (HERE / "configs").glob("*.json"))


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("name", MIXES)
def test_cycle_holds_the_stated_mix(name, config):
    mix = load_mix(name)
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    sub, vocab = cfg["subsample_factor"], cfg["vocab_size"]
    cycles = [make_cycle(mix, s, sub, vocab) for s in SEEDS]
    spec = mix["lengths"]
    lo, hi = (round(spec[k] / FRAME_S) for k in ("min_s", "max_s"))
    law = LengthLaw(spec["min_s"], spec["max_s"], spec.get("mean_s"))
    fpt = frames_per_token(mix, sub)
    for cyc in cycles:
        assert cyc.bounds[-1] == hi and cyc.bounds == sorted(cyc.bounds)
        assert Counter(b.bucket for b in cyc.batches) == {
            k: mix["batches_per_bucket"] for k in range(mix["buckets"])}
        for b in cyc.batches:
            k = b.bucket
            floor = lo if k == 0 else cyc.bounds[k - 1] + 1
            assert floor <= b.frames.min() and b.frames.max() <= cyc.bounds[k]
            if "audio_budget_s" in mix:
                mean = law.mean(floor * FRAME_S, cyc.bounds[k] * FRAME_S)
                assert b.size == int(mix["audio_budget_s"] // mean)
            else:
                assert b.size == mix["batch_size"]
            assert np.array_equal(b.tprime, subsampled(b.frames, sub))
            rate = b.label_lengths / (b.tprime / fpt)
            jitter = mix["label_jitter"]
            assert (rate >= (1 - jitter) - 0.5 * fpt / b.tprime).all()
            assert (rate <= (1 + jitter) + 0.5 * fpt / b.tprime).all()
            assert (b.label_lengths <= b.tprime).all()
            assert b.labels.shape == (b.size, cyc.label_pad[k])
            s_idx = np.arange(cyc.label_pad[k])[None, :]
            live = s_idx < b.label_lengths[:, None]
            assert ((b.labels >= 1) & (b.labels < vocab))[live].all()
            assert (b.labels[~live] == 0).all()
            assert b.tprime.max() <= cyc.tprime_pad[k]
    mean_rate = np.mean([(b.label_lengths / (b.tprime * sub * FRAME_S)).mean()
                         for b in cycles[0].batches])
    assert mean_rate == pytest.approx(mix["tokens_per_s"], rel=0.03)
    shapes = [sorted((b.bucket, b.frames.tolist(), b.label_lengths.tolist())
                     for b in c.batches) for c in cycles]
    assert shapes[0] == shapes[1]
    assert [b.frames.tolist() for b in cycles[0].batches] != [
        b.frames.tolist() for b in cycles[1].batches]
    again = make_cycle(mix, SEEDS[0], sub, vocab)
    assert all(np.array_equal(a.labels, b.labels)
               for a, b in zip(again.batches, cycles[0].batches))


def test_libri_buckets_and_batches():
    mix = load_mix("train.libri")
    cyc = make_cycle(mix, 3, 4, 1024)
    assert cyc.bounds == [1196, 1560, 1808, 2000]
    assert cyc.batch_sizes == [72, 36, 30, 26]
    assert len(cyc.batches) == 20
    frames = np.concatenate([b.frames for b in cyc.batches])
    assert frames.mean() * FRAME_S == pytest.approx(12.3, rel=0.02)
    audio = [b.frames.sum() * FRAME_S for b in cyc.batches]
    assert np.mean(audio) == pytest.approx(512, rel=0.03)
    assert min(audio) > 0.85 * 512 and max(audio) < 1.15 * 512


@pytest.mark.parametrize("lo,hi,mean", [(1.0, 20.0, 12.3), (1.0, 20.0, 6.0),
                                        (30.0, 60.0, None)])
def test_the_length_law_has_its_range_and_mean(lo, hi, mean):
    law = LengthLaw(lo, hi, mean)
    x = law.draw(np.random.default_rng(1), lo, hi, 400_000)
    assert lo <= x.min() and x.max() <= hi
    assert x.mean() == pytest.approx(mean or 0.5 * (lo + hi), rel=2e-3)
    assert law.mean(lo, hi) == pytest.approx(x.mean(), rel=2e-3)
    # Equal shares of audio: the bounds split sum(x) into quarters.
    cuts = [law.audio_quantile(q) for q in (0.25, 0.5, 0.75)]
    shares = np.histogram(x, [lo] + cuts + [hi], weights=x)[0] / x.sum()
    assert shares == pytest.approx([0.25] * 4, abs=5e-3)
