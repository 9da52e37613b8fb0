"""Shared tiny configurations for the benchmark's CPU tests."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MODEL = dict(num_layers=1, dim=16, num_heads=2, ff_expansion=2,
                  conv_kernel=4, subsample_factor=4, feat_dim=20,
                  dropout=0.0, predictor_dim=8, embed_dim=8, joint_dim=8,
                  vocab_size=16, blank_id=0, dtype="float32", tf32=False,
                  learning_rate=1e-3, weight_decay=1e-6, warmup_steps=1000)


def tiny_mix(entry: str) -> dict:
    if entry == "banded":
        return dict(entry=entry, lengths=dict(min_s=3.0, max_s=6.0),
                    buckets=1, batch_size=3, batches_per_bucket=2,
                    tokens_per_s=4.0, label_jitter=0.1, align_shift=4,
                    logit_scale=2.0, sizes_seed=3)
    return dict(entry=entry, lengths=dict(min_s=0.4, max_s=0.8, mean_s=0.65),
                buckets=2, audio_budget_s=2.0, batches_per_bucket=2,
                tokens_per_s=4.0, label_jitter=0.1, logit_scale=2.0,
                feature_scale=1.0, sizes_seed=3)


@pytest.fixture
def tiny_model():
    return dict(TINY_MODEL)
