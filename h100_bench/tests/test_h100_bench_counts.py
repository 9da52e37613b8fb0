"""The benchmark's counts against hand-worked cases and a FLOP counter."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import counts
from h100_bench.reference import conformer
from h100_bench.run import HERE
from h100_bench.weights import make_weights


def test_padded_loss_work_by_hand():
    # Valid lattices 3 x 2 and 2 x 1 cells of V=4 logits read; the whole
    # [2, 3, 2, 4] gradient written; labels [2, 1], two length vectors and
    # the costs at 4 bytes.
    bytes_, flops = counts.padded_loss_work([3, 2], [1, 0], 3, 1, 4)
    assert bytes_ == 4 * (8 * 4 + 48) + 4 * (2 + 4 + 2)
    assert flops == 8 * 8 * 4


def test_banded_loss_work_by_hand():
    bytes_, flops = counts.banded_loss_work(band_cells=10, batch=2,
                                            tprime_pad=5, width=3,
                                            label_pad=4, vocab=8)
    grad = 2 * 5 * 3 * 8
    assert bytes_ == 4 * (10 * 8 + grad) + 4 * (2 * 4 + 6 + 2 * 2 * 5)
    assert flops == 8 * 10 * 8


def test_least_seconds_takes_the_larger_bound():
    assert counts.loss_least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert counts.loss_least_seconds(0, 67e12) == pytest.approx(1.0)
    assert counts.loss_least_seconds(3.35e12, 2 * 67e12) == pytest.approx(2)


TINY = dict(dim=4, ff_expansion=2, num_layers=1, num_heads=1, conv_kernel=2,
            subsample_factor=4, feat_dim=4, predictor_dim=2, embed_dim=2,
            joint_dim=2, vocab_size=3)


def test_utterance_flops_by_hand():
    # 8 frames x 4 features: stage 1 gives 4 x 2 (1 channel in, 1 out,
    # 3x3): 144; stage 2 gives 2 x 1: 36; projection 2 x 1 -> 4: 16. One
    # block at n = 2, d = 4: FFNs 512, projections 256, products 64,
    # pointwise in 128, depthwise 32, pointwise out 64. LSTM over 2
    # positions: 144. Joint: 32 + 16 + 48.
    total = 144 + 36 + 16 + 1056 + 144 + 96
    assert counts.utterance_forward_flops(TINY, 8, 1) == total
    assert counts.train_step_flops(TINY, [8, 8], [1, 1]) == 6 * total


@pytest.mark.parametrize("config", ["conformer_m", "conformer_l"])
def test_model_flops_match_a_flop_counter(config):
    """The count equals torch's FLOP counter on the reference model's
    forward of one unpadded utterance, at the configuration's widths and
    two blocks."""
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    cfg["num_layers"] = 2
    model = conformer.build(cfg).to_empty(device="cpu")
    weights = make_weights(cfg, 1, "cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    frames, labels = 37, 3
    feats = torch.randn(1, frames, cfg["feat_dim"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(feats, torch.tensor([frames]),
              torch.randint(1, cfg["vocab_size"], (1, labels)))
    assert counter.get_total_flops() == counts.utterance_forward_flops(
        cfg, frames, labels)
