"""Seeded inputs made on the device in a few large calls: the model's
weights, and standard-normal tensors for features and logits.

The weights are drawn into one flat buffer and scaled leaf by leaf in two
more whole-buffer calls: a matrix or convolution kernel takes a normal of
variance 1 / fan_in, a LayerNorm scale 1 + 0.1 z, any other vector (a
bias) 0.1 z. Names and shapes come from the reference model, which has the
port's, so one set loads into both.
"""

from __future__ import annotations

from typing import Dict

import torch

from .reference import conformer

_MASK63 = (1 << 63) - 1


def derive(seed: int, stream: int) -> int:
    """A 63-bit generator seed for `stream` of a run's `seed` (splitmix64)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9 + 1)
    z &= (1 << 64) - 1
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK63


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, stream))


def _leaf_scale(name: str, shape) -> tuple:
    if name.split(".")[-2].startswith("norm"):
        return 0.1, 1.0
    if len(shape) >= 2:
        fan_in = 1
        for n in shape[1:]:
            fan_in *= n
        return fan_in ** -0.5, 0.0
    return 0.1, 0.0


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} views into one float32 buffer on `device`."""
    specs = [(n, tuple(p.shape))
             for n, p in conformer.build(cfg).named_parameters()]
    numels = [torch.Size(s).numel() for _, s in specs]
    flat = torch.empty(sum(numels), device=device)
    flat.normal_(generator=generator(seed, 1, device))
    scale, offset = zip(*(_leaf_scale(n, s) for n, s in specs))
    counts = torch.tensor(numels, device=device)
    flat.mul_(torch.tensor(scale, device=device).repeat_interleave(counts))
    flat.add_(torch.tensor(offset, device=device).repeat_interleave(counts))
    out, at = {}, 0
    for (name, shape), n in zip(specs, numels):
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def normal(shape, std: float, seed: int, stream: int,
           device) -> torch.Tensor:
    return torch.empty(shape, device=device).normal_(
        0.0, std, generator=generator(seed, stream, device))
