"""The one traffic generator: a mix's parameters come from
``h100_bench/traffic/<mix>.json``; this module turns them and a seed into
one cycle of batches.

A mix names the timed entry that serves it (``loss``, ``banded`` or ``train``)
and describes utterances:

* ``lengths``: ``min_s`` and ``max_s``, the range of an utterance's
  duration, and optionally ``mean_s``; durations follow the
  maximum-entropy law on that range with that mean (``LengthLaw``: a
  density proportional to exp(lambda x), uniform where no mean is given);
* ``buckets``: how many length buckets; their bounds split the law's
  audio into equal shares (each bucket holds the same seconds of audio,
  as lhotse's DynamicBucketingSampler estimates its buckets), so every
  bucket gets the same number of batches;
* ``audio_budget_s`` (a batch holds that much audio on average:
  B = budget // the bucket's mean duration) or ``batch_size`` (a fixed B);
* ``batches_per_bucket``: one cycle's batches of each bucket; the seed
  shuffles their order, so every window sees the same mix;
* ``sizes_seed``: the seed of the lengths, label counts and alignment
  positions, the same for every run, so that every run has the same set
  of shapes and only their order and the label ids change with its seed;
* ``tokens_per_s`` and ``label_jitter``: labels per utterance,
  S = round(T' / frames_per_token * (1 + U(-jitter, jitter))), at most T';
  ids uniform in [1, vocab_size);
* ``align_shift`` (optional): a random monotonic alignment per utterance
  and a band of that many lattice frames around it;
* ``sources`` and ``assumed``: where each number comes from (not read).

Sizes that depend on the model (the subsampling factor, the vocabulary)
come from the configuration.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
FRAME_S = 0.01          # one input frame: a 10 ms hop


def load_mix(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _bisect(f, lo: float, hi: float) -> float:
    """The root of increasing f on [lo, hi]."""
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if f(mid) < 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


class LengthLaw:
    """Utterance durations in seconds on [a, b]: the maximum-entropy law
    with the given mean, density proportional to exp(lam x) (lam = 0, the
    uniform law, without a mean)."""

    def __init__(self, min_s: float, max_s: float, mean_s=None):
        self.a, self.b = float(min_s), float(max_s)
        self.lam = 0.0
        if mean_s is not None:
            assert self.a < mean_s < self.b
            self.lam = _bisect(lambda lam: self.mean(self.a, self.b, lam)
                               - mean_s, -50.0 / self.b, 50.0 / self.b)

    def _audio_raw(self, x):
        """The unnormalised audio (duration-weighted mass) on [a, x]."""
        lam = self.lam
        if abs(lam) < 1e-12:
            return 0.5 * (x * x - self.a * self.a)
        e = np.exp(lam * (x - self.a))
        return ((x / lam - 1 / lam ** 2) * e
                - (self.a / lam - 1 / lam ** 2))

    def mean(self, lo: float, hi: float, lam=None) -> float:
        """The mean duration of the law restricted to [lo, hi]."""
        lam = self.lam if lam is None else lam
        if abs(lam) < 1e-12:
            return 0.5 * (lo + hi)
        # E[x | lo <= x <= hi] for a density exp(lam x).
        d = hi - lo
        return lo + (d / -np.expm1(-lam * d) - 1 / lam)

    def audio_quantile(self, q: float) -> float:
        """The duration below which a share q of the law's audio lies."""
        total = self._audio_raw(self.b)
        return _bisect(lambda x: self._audio_raw(x) / total - q,
                       self.a, self.b)

    def draw(self, rng, lo: float, hi: float, n: int) -> np.ndarray:
        """n durations from the law restricted to [lo, hi] (inverse CDF)."""
        u = rng.uniform(size=n)
        if abs(self.lam) < 1e-12:
            return lo + u * (hi - lo)
        d = hi - lo
        return lo + np.log1p(u * np.expm1(self.lam * d)) / self.lam


def bucket_bounds(law: LengthLaw, n: int) -> List[int]:
    """Each bucket's upper bound in input frames: the law's audio split
    into n equal shares."""
    bounds = [int(math.ceil(law.audio_quantile((k + 1) / n) / FRAME_S
                            - 1e-6)) for k in range(n - 1)]
    return bounds + [int(round(law.b / FRAME_S))]


def subsampled(frames, factor: int):
    """Encoder frames after log2(factor) stride-2 stages ((n-1)//2+1 each),
    the length rule of a Conformer's convolutional subsampler."""
    for _ in range(int(math.log2(factor))):
        frames = (frames - 1) // 2 + 1
    return frames


@dataclasses.dataclass
class Batch:
    bucket: int
    frames: np.ndarray          # [B] input frames
    tprime: np.ndarray          # [B] lattice frames after subsampling
    label_lengths: np.ndarray   # [B]
    labels: np.ndarray          # [B, label_pad] int32, 0 past each length
    alignment: Optional[np.ndarray] = None   # [B, tprime_pad] int32

    @property
    def size(self) -> int:
        return len(self.frames)


@dataclasses.dataclass
class Cycle:
    """One cycle of a mix: its batches in order, and each bucket's static
    paddings (the largest lengths the mix can draw in it)."""

    batches: List[Batch]
    bounds: List[int]              # input-frame bound of each bucket
    batch_sizes: List[int]
    tprime_pad: List[int]          # per bucket
    label_pad: List[int]           # per bucket
    subsample: int


def frames_per_token(mix: dict, subsample: int) -> float:
    return 1.0 / (FRAME_S * subsample * mix["tokens_per_s"])


def make_cycle(mix: dict, seed: int, subsample: int,
               vocab_size: int) -> Cycle:
    """One cycle of the mix. Its batches (lengths, label counts, alignment
    positions) come from the mix's own ``sizes_seed``, so every run works
    through the same set of shapes; the run's seed orders them and draws
    the label ids."""
    sizes_rng = np.random.default_rng([int(mix["sizes_seed"]), 0x5175])
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x7AFF1C])
    spec = mix["lengths"]
    law = LengthLaw(spec["min_s"], spec["max_s"], spec.get("mean_s"))
    lo = int(round(law.a / FRAME_S))
    bounds = bucket_bounds(law, mix["buckets"])
    floors = [lo] + [b + 1 for b in bounds[:-1]]
    if "batch_size" in mix:
        sizes = [int(mix["batch_size"])] * len(bounds)
    else:
        sizes = [int(mix["audio_budget_s"]
                     // law.mean(f * FRAME_S, b * FRAME_S))
                 for f, b in zip(floors, bounds)]
    fpt = frames_per_token(mix, subsample)
    jitter = float(mix["label_jitter"])
    tpad = [int(subsampled(b, subsample)) for b in bounds]
    lpad = [min(t, int(math.floor(t / fpt * (1 + jitter) + 0.5)))
            for t in tpad]
    shift = mix.get("align_shift")
    batches = []
    for k in range(len(bounds)):
        for _ in range(int(mix["batches_per_bucket"])):
            seconds = law.draw(sizes_rng, floors[k] * FRAME_S,
                               (bounds[k] + 1) * FRAME_S, sizes[k])
            frames = np.clip(np.floor(seconds / FRAME_S).astype(np.int64),
                             floors[k], bounds[k])
            tprime = subsampled(frames, subsample)
            scale = 1.0 + sizes_rng.uniform(-jitter, jitter, size=sizes[k])
            slen = np.minimum(np.floor(tprime / fpt * scale + 0.5), tprime)
            slen = np.maximum(slen, 1).astype(np.int64)
            emit_at = None
            if shift is not None:
                emit_at = [np.sort(sizes_rng.choice(int(t), size=int(n),
                                                    replace=False))
                           for t, n in zip(tprime, slen)]
            batches.append((k, frames, tprime, slen, emit_at))
    order = rng.permutation(len(batches))
    out = []
    for i in order:
        k, frames, tprime, slen, emit_at = batches[i]
        labels = rng.integers(1, vocab_size, size=(sizes[k], lpad[k]))
        labels = np.where(np.arange(lpad[k])[None, :] < slen[:, None],
                          labels, 0).astype(np.int32)
        alignment = None
        if emit_at is not None:
            alignment = np.zeros((sizes[k], tpad[k]), np.int32)
            for row, at in enumerate(emit_at):
                alignment[row, at] = labels[row, :len(at)]
        out.append(Batch(int(k), frames.astype(np.int64),
                         tprime.astype(np.int64), slen, labels, alignment))
    return Cycle(out, bounds, sizes, tpad, lpad, subsample)
