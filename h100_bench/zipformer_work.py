"""The Zipformer transducer's seeded weights and model FLOPs.

Weights: one flat float32 buffer drawn from the seed, scaled leaf by leaf
as icefall initialises the large recipe: a linear or convolution kernel
takes a normal of variance 1 / fan_in times its layer's ``initial_scale``
(``ScaledLinear`` / ``ScaledConv2d``), its bias 0.1 z times the same; the
layers with a scale are the attention weights' ``in_proj``
(query_head_dim^-0.25), ``linear_pos`` and every attention and
convolution module's ``out_proj`` (0.05), the feed-forward ``out_proj``
(0.1), the ConvNeXt's last 1x1 convolution (0.01) and the joint's encoder
and decoder projections (0.25). The decoder's embedding is N(0, 1)
(``nn.Embedding``), BiasNorm's log scale 1 and bias 1e-4 z, the bypass
scales 0.5, the downsample weights 0. Names and shapes come from the
reference model, which has the port's.

FLOPs: every matmul and convolution of one utterance's forward at its own
lengths at each rate (2 a multiply-add), the T^2 attention products
included, and a training step as three forwards.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from .reference import zipformer
from .weights import generator

# (module name suffix, initial_scale) of icefall's scaled layers.
_SCALED = ((".linear_pos", 0.05), (".nla.out_proj", 0.05),
           (".sa1.out_proj", 0.05), (".sa2.out_proj", 0.05),
           (".conv1.out_proj", 0.05), (".conv2.out_proj", 0.05),
           (".ff1.out_proj", 0.1), (".ff2.out_proj", 0.1),
           (".ff3.out_proj", 0.1), ("embed.convnext_pw2", 0.01),
           ("joint.enc_proj", 0.25), ("joint.pred_proj", 0.25))


def _layer_scale(cfg: dict, module: str) -> float:
    if module.endswith(".attn_weights.in_proj"):
        return cfg["query_head_dim"] ** -0.25
    for suffix, scale in _SCALED:
        if module.endswith(suffix):
            return scale
    return 1.0


def _leaves(cfg: dict):
    """(name, shape, std, offset) of every parameter."""
    model = zipformer.build(cfg)
    out = []
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}"
            shape = tuple(p.shape)
            if isinstance(m, zipformer.BiasNorm):
                std, offset = (0.0, 1.0) if pname == "log_scale" else (
                    1e-4, 0.0)
            elif isinstance(m, (zipformer.Bypass, zipformer.Downsample)):
                std, offset = 0.0, (0.5 if pname == "scale" else 0.0)
            elif isinstance(m, zipformer.Embedding):
                std, offset = 1.0, 0.0
            else:
                scale = _layer_scale(cfg, mname)
                fan_in = torch.Size(shape[1:]).numel()
                std = scale * (fan_in ** -0.5 if pname == "weight" else 0.1)
                offset = 0.0
            out.append((name, shape, std, offset))
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


def embed_frames(frames: int) -> int:
    """Input frames -> the embed's 50 Hz frames."""
    return (frames - 7) // 2


def tprime(cfg: dict, frames: int) -> int:
    """Input frames -> encoder output frames (the lattice's T')."""
    ds = cfg["output_downsampling_factor"]
    return -(-embed_frames(frames) // ds)


def _layer_flops(cfg: dict, i: int, n: int) -> int:
    d, ff = cfg["encoder_dim"][i], cfg["feedforward_dim"][i]
    h, k = cfg["num_heads"][i], cfg["cnn_module_kernel"][i]
    qd, pd, vd = (cfg["query_head_dim"], cfg["pos_head_dim"],
                  cfg["value_head_dim"])
    hid = 3 * d // 4
    weights = (2 * n * d * (2 * qd + pd) * h            # q, k, p
               + 2 * (2 * n - 1) * cfg["pos_dim"] * pd * h   # linear_pos
               + 2 * h * n * n * (qd + pd))             # q.k and p.pos
    ffs = 2 * 2 * n * d * (3 * ff // 4 + ff + 5 * ff // 4)
    nla = 2 * n * d * 3 * hid + 2 * n * n * hid + 2 * n * hid * d
    sa = 2 * (2 * n * d * h * vd + 2 * h * n * n * vd + 2 * n * h * vd * d)
    conv = 2 * (2 * n * d * 2 * d + 2 * n * d * k + 2 * n * d * d)
    return weights + ffs + nla + sa + conv


def utterance_forward_flops(cfg: dict, frames: int, labels: int) -> int:
    """Forward FLOPs of one utterance: the embed's convolutions and
    projection, every layer of every stack at its own rate, the decoder's
    grouped convolution over S + 1 positions, and the joint's encoder,
    decoder and vocabulary projections (the last over T' x (S + 1))."""
    c1, c2, c3 = cfg["embed_channels"]
    hid = c3 * cfg["convnext_hidden_ratio"]
    f = cfg["feat_dim"]
    t1 = frames - 2
    t2, f2 = (t1 - 3) // 2 + 1, (f - 3) // 2 + 1
    t3, f3 = t2 - 2, (f2 - 3) // 2 + 1
    flops = (2 * c1 * 9 * t1 * f + 2 * c2 * c1 * 9 * t2 * f2
             + 2 * c3 * c2 * 9 * t3 * f3
             + 2 * c3 * 49 * t3 * f3 + 2 * 2 * hid * c3 * t3 * f3
             + 2 * t3 * c3 * f3 * cfg["encoder_dim"][0])
    for i, ds in enumerate(cfg["downsampling_factor"]):
        n = -(-t3 // ds)
        flops += cfg["num_encoder_layers"][i] * _layer_flops(cfg, i, n)
    s1, dd, j = labels + 1, cfg["decoder_dim"], cfg["joiner_dim"]
    n = tprime(cfg, frames)
    flops += 2 * s1 * dd * 4 * cfg["context_size"]     # groups of 4
    flops += (2 * n * max(cfg["encoder_dim"]) * j + 2 * s1 * dd * j
              + 2 * n * s1 * j * cfg["vocab_size"])
    return flops


def train_step_flops(cfg: dict, frames: Iterable[int],
                     labels: Iterable[int]) -> int:
    """Model FLOPs of one training step: each utterance's forward at its own
    lengths, and the backward as twice the forward."""
    return 3 * sum(utterance_forward_flops(cfg, int(t), int(s))
                   for t, s in zip(frames, labels))
