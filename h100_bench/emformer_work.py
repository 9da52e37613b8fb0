"""The Emformer RNN-T's seeded weights and model FLOPs.

Weights: one flat float32 buffer drawn from the seed, scaled leaf by leaf:
a matrix takes a normal of variance 1 / fan_in, layer i's query and
key-value matrices that times 1 / sqrt(i + 1) (torchaudio's "depthwise"
weight_init_scale_strategy), a LayerNorm scale 1 + 0.1 z, any other
vector (a bias, a LayerNorm shift) 0.1 z, the embedding N(0, 1) (as
``nn.Embedding``). Names and shapes come from the reference model, which
has the port's.

FLOPs (2 a multiply-add), each utterance at its own lengths: the input
linear over the (T' + R) stride frames the time reduction keeps; in every
layer the four projections and the feed-forward over the n R + T' rows
(right-context copies included) and the attention's two products over
the score cells the block mask keeps, not the dense product a masked
implementation computes; the output linear over T'; the LSTM layers and
the predictor's projection over S + 1 positions; the joint's vocabulary
projection over T' x (S + 1). A training step is three forwards.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

from .reference import emformer
from .weights import generator


def _leaves(cfg: dict):
    """(name, shape, std, offset) of every parameter."""
    model = emformer.build(cfg)
    out = []
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            shape = tuple(p.shape)
            if isinstance(m, emformer.LayerNorm):
                std, offset = 0.1, (1.0 if pname == "weight" else 0.0)
            elif isinstance(m, emformer.Embedding):
                std, offset = 1.0, 0.0
            elif len(shape) >= 2:
                std, offset = shape[1] ** -0.5, 0.0
                parts = mname.split(".")
                if parts[-1] in ("query", "key_value"):
                    std /= math.sqrt(int(parts[-2]) + 1)
            else:
                std, offset = 0.1, 0.0
            out.append((f"{mname}.{pname}", shape, std, offset))
    return out


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} views into one float32 buffer on `device`."""
    leaves = _leaves(cfg)
    numels = [torch.Size(s).numel() for _, s, _, _ in leaves]
    flat = torch.empty(sum(numels), device=device)
    flat.normal_(generator=generator(seed, 1, device))
    counts = torch.tensor(numels, device=device)
    std = torch.tensor([lf[2] for lf in leaves], device=device)
    offset = torch.tensor([lf[3] for lf in leaves], device=device)
    flat.mul_(std.repeat_interleave(counts))
    flat.add_(offset.repeat_interleave(counts))
    out, at = {}, 0
    for (name, shape, _, _), n in zip(leaves, numels):
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def tprime(cfg: dict, frames: int) -> int:
    """Input frames -> encoder output frames (the lattice's T')."""
    return frames // cfg["time_reduction_stride"]


def kept_cells(cfg: dict, t: int) -> int:
    """Score cells the block mask keeps over T' = t utterance frames (one
    head, one layer), counted segment by segment."""
    z = emformer.sizes(cfg)
    seg, rc, lc = z["seg"], z["rc"], z["lc"]
    kept = 0
    for i in range(-(-t // seg)):
        end = min((i + 1) * seg, t)
        kept += (rc + end - i * seg) * (rc + end - max(i * seg - lc, 0))
    return kept


def attention_flops(cfg: dict, frames: int) -> int:
    """Q K^T and A V over the kept score cells, every head and layer."""
    d = emformer.sizes(cfg)["d"]
    return (cfg["transformer_num_layers"] * 2 * 2 * d
            * kept_cells(cfg, tprime(cfg, frames)))


def matmul_flops(cfg: dict, frames: int, labels: int) -> int:
    """Every other matmul of one utterance's forward."""
    z = emformer.sizes(cfg)
    d, rc, stride = z["d"], z["rc"], z["stride"]
    t = tprime(cfg, frames)
    rows = -(-t // z["seg"]) * rc + t
    flops = 2 * (t + rc) * stride * cfg["feat_dim"] * z["red"]
    layer = 2 * rows * d * 4 * d + 2 * 2 * rows * d * cfg[
        "transformer_ffn_dim"]
    enc = cfg["encoding_dim"]
    flops += cfg["transformer_num_layers"] * layer + 2 * t * d * enc
    s1, e = labels + 1, cfg["symbol_embedding_dim"]
    flops += cfg["num_lstm_layers"] * 2 * s1 * (e * 4 * e + e * 4 * e)
    flops += 2 * s1 * e * enc + 2 * t * s1 * enc * cfg["vocab_size"]
    return flops


def utterance_forward_flops(cfg: dict, frames: int, labels: int) -> int:
    return matmul_flops(cfg, frames, labels) + attention_flops(cfg, frames)


def train_step_flops(cfg: dict, frames: Iterable[int],
                     labels: Iterable[int]) -> int:
    """Model FLOPs of one training step: each utterance's forward at its own
    lengths, and the backward as twice the forward."""
    return 3 * sum(utterance_forward_flops(cfg, int(t), int(s))
                   for t, s in zip(frames, labels))
