"""Synthetic LibriSpeech-like data pipeline with length bucketing.

The port's own copy of ``monotonic_rnnt_tpu/data/synthetic.py`` (numpy
only; the port imports nothing of the JAX package): the same
(features, feature_lengths, labels, label_lengths) batches, byte for byte,
for the same seed. Bucketing groups utterances of similar length so padded
lattices stay dense; each bucket has static feature and label paddings.
Batches are numpy arrays: move them to the card with ``torch.from_numpy``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    feat_dim: int = 80
    min_frames: int = 80
    max_frames: int = 1600           # ~16 s at 10 ms hop
    frames_per_label: float = 8.0    # speech-like label rate
    vocab_size: int = 1024
    blank_id: int = 0
    seed: int = 0


Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def bucket_boundaries(min_len: int, max_len: int, num_buckets: int) -> List[int]:
    """Geometric bucket upper bounds (static shapes per bucket)."""
    ratio = (max_len / min_len) ** (1.0 / num_buckets)
    bounds, cur = [], float(min_len)
    for _ in range(num_buckets):
        cur *= ratio
        bounds.append(int(np.ceil(cur)))
    bounds[-1] = max_len
    return bounds


def assign_bucket(length: int, bounds: Sequence[int]) -> int:
    for i, b in enumerate(bounds):
        if length <= b:
            return i
    return len(bounds) - 1


class SyntheticDataset:
    """Infinite iterator of bucketed synthetic batches."""

    def __init__(self, cfg: SyntheticConfig, batch_size: int,
                 num_buckets: int = 4):
        self.cfg = cfg
        self.batch_size = batch_size
        self.bounds = bucket_boundaries(cfg.min_frames, cfg.max_frames,
                                        num_buckets)
        self._rng = np.random.RandomState(cfg.seed)

    def sample_utterance(self) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        t = int(self._rng.randint(cfg.min_frames, cfg.max_frames + 1))
        feats = self._rng.randn(t, cfg.feat_dim).astype(np.float32)
        n_labels = max(1, int(t / cfg.frames_per_label))
        labels = self._rng.randint(1, cfg.vocab_size,
                                   size=(n_labels,)).astype(np.int32)
        return feats, labels

    def label_bound(self, t_bound: int, subsample_factor: int = 4) -> int:
        """Static label-dim padding for a bucket with frame bound t_bound.

        The per-utterance label count is at most t / frames_per_label, and is
        further clipped so that after encoder subsampling T' >= S holds; both
        bounds are monotone in t, so evaluating them at the bucket's frame
        bound gives a per-bucket constant. Batch shapes are then fully
        static: one shape per bucket, never per batch.
        """
        by_rate = int(t_bound / self.cfg.frames_per_label)
        by_subsample = max(1, t_bound // subsample_factor - 1)
        return max(1, min(by_rate, by_subsample))

    def batches(self, subsample_factor: int = 4) -> Iterator[Batch]:
        """Yield bucketed batches; label padding sized so that after encoder
        subsampling T' >= S always holds."""
        pools: List[List[Tuple[np.ndarray, np.ndarray]]] = [
            [] for _ in self.bounds]
        while True:
            feats, labels = self.sample_utterance()
            b = assign_bucket(len(feats), self.bounds)
            # Clip with the same (monotone) bound that sizes the bucket's
            # static label padding, so len(labels) <= s_pad structurally.
            max_labels = self.label_bound(len(feats), subsample_factor)
            pools[b].append((feats, labels[:max_labels]))
            if len(pools[b]) == self.batch_size:
                yield self._collate(pools[b], self.bounds[b],
                                    self.label_bound(self.bounds[b],
                                                     subsample_factor))
                pools[b] = []

    def _collate(self, utts, t_pad: int, s_pad: int) -> Batch:
        batch = len(utts)
        feats = np.zeros((batch, t_pad, self.cfg.feat_dim), np.float32)
        labels = np.zeros((batch, s_pad), np.int32)
        flen = np.zeros((batch,), np.int32)
        slen = np.zeros((batch,), np.int32)
        for i, (f, l) in enumerate(utts):
            feats[i, :len(f)] = f
            labels[i, :len(l)] = l
            flen[i] = len(f)
            slen[i] = len(l)
        return feats, flen, labels, slen


def tiny_batch(batch: int = 2, t: int = 64, feat_dim: int = 80,
               s: int = 6, vocab: int = 64, seed: int = 0) -> Batch:
    """Small fixed-shape batch for tests and compile checks."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(batch, t, feat_dim).astype(np.float32)
    flen = np.full((batch,), t, np.int32)
    labels = rng.randint(1, vocab, size=(batch, s)).astype(np.int32)
    slen = np.full((batch,), s, np.int32)
    return feats, flen, labels, slen
