"""Work counted from shapes alone: the loss's bytes and operations and the
Conformer transducer's model FLOPs, with the card's published peaks.

Nothing here looks at which kernels the program launches: the same shapes
give the same count whatever implements the loss or the model, so a later
change that fuses passes or drops a kernel reads as a gain, and one that
reads more than the count is visible as a share below the peak.
"""

from __future__ import annotations

from typing import Iterable, Sequence

# NVIDIA H100 SXM5 80 GB data sheet, dense rates at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12           # float32 outside the tensor cores

# Operations a loss does for each logit of a valid lattice cell: the
# forward's max, subtract, exponential and sum, and the backward's
# exponential, subtract, multiply and fused add.
LOSS_FLOPS_PER_LOGIT = 8


def loss_least_seconds(bytes_: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the float32 peak."""
    return max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def padded_loss_work(tprime: Sequence[int], label_lengths: Sequence[int],
                     tprime_pad: int, label_pad: int, vocab: int,
                     logit_bytes: int = 4):
    """(bytes, flops) of one padded loss call, forward and backward.

    Reads each utterance's valid lattice, T'_b x (S_b + 1) x V logits, once;
    writes the whole [B, T'_pad, S_pad + 1, V] gradient once; reads the
    labels and the two length vectors and writes the costs (4 bytes each).
    """
    batch = len(tprime)
    valid = sum(int(t) * (int(s) + 1) for t, s in zip(tprime, label_lengths))
    grad = batch * tprime_pad * (label_pad + 1) * vocab
    small = 4 * (batch * label_pad + 2 * batch + batch)
    bytes_ = logit_bytes * (valid * vocab + grad) + small
    return bytes_, LOSS_FLOPS_PER_LOGIT * valid * vocab


def banded_loss_work(band_cells: int, batch: int, tprime_pad: int,
                     width: int, label_pad: int, vocab: int,
                     logit_bytes: int = 4):
    """(bytes, flops) of one banded loss call, forward and backward.

    Reads the valid band cells' logits once (band_cells counts the (b, t, w)
    slots inside each utterance's frames and inside its lattice), writes
    the whole [B, T'_pad, W, V] band gradient once, and reads labels,
    lengths and the two [B, T'_pad] band bounds.
    """
    grad = batch * tprime_pad * width * vocab
    small = 4 * (batch * label_pad + 3 * batch + 2 * batch * tprime_pad)
    bytes_ = logit_bytes * (band_cells * vocab + grad) + small
    return bytes_, LOSS_FLOPS_PER_LOGIT * band_cells * vocab


def _stage(n: int) -> int:
    return (n - 1) // 2 + 1


def utterance_forward_flops(cfg: dict, frames: int, labels: int) -> int:
    """Forward FLOPs (2 per multiply-add) of one utterance through the
    Conformer transducer at its own lengths: the two stride-2 3x3
    subsampler convolutions and their projection, every block's two
    feed-forward modules, attention projections and products, and
    convolution module, the LSTM predictor over S + 1 positions and its
    projection, and the joint's encoder, predictor and vocabulary
    projections (the last over T' x (S + 1) rows). Norms, activations and
    the loss are left out."""
    d, dff = cfg["dim"], cfg["dim"] * cfg["ff_expansion"]
    ch = d // 4
    t, f = frames, cfg["feat_dim"]
    flops = 0
    stages = cfg["subsample_factor"].bit_length() - 1
    for stage in range(stages):
        t, f = _stage(t), _stage(f)
        flops += 2 * ch * (1 if stage == 0 else ch) * 9 * t * f
    n = t                                  # T' lattice frames
    flops += 2 * n * (f * ch) * d           # subsampler projection
    block = (2 * (2 * n * d * dff * 2)      # two feed-forward modules
             + 4 * 2 * n * d * d            # q, k, v and out projections
             + 2 * 2 * n * n * d            # q k^T and w v
             + 2 * n * d * 2 * d            # pointwise conv in (GLU)
             + 2 * n * d * cfg["conv_kernel"]   # depthwise conv
             + 2 * n * d * d)               # pointwise conv out
    flops += cfg["num_layers"] * block
    s1, h, e = labels + 1, cfg["predictor_dim"], cfg["embed_dim"]
    flops += s1 * (2 * e * 4 * h + 2 * h * 4 * h + 2 * h * h)
    j, v = cfg["joint_dim"], cfg["vocab_size"]
    flops += 2 * n * d * j + 2 * s1 * h * j + 2 * n * s1 * j * v
    return flops


def train_step_flops(cfg: dict, frames: Iterable[int],
                     labels: Iterable[int]) -> int:
    """Model FLOPs of one training step: each utterance's forward at its own
    lengths, and the backward as twice the forward."""
    return 3 * sum(utterance_forward_flops(cfg, int(t), int(s))
                   for t, s in zip(frames, labels))
