"""SpecAugment: time/frequency masking for acoustic features.

PyTorch counterpart of ``monotonic_rnnt_tpu/data/augment.py``, with its
defaults and mask rules (Park et al., 2019): per-sample masks from one
``torch.Generator`` on the features' device, time masks drawn inside each
sample's valid frames, frequency masks over the whole band, masked cells
zero (the encoder's padding convention). The draws differ from JAX's (other
PRNGs): the masks agree in law, not in bits.
"""

from __future__ import annotations

import torch


def _masks(generator: torch.Generator, batch: int, num: int,
           bound: torch.Tensor, width_cap: torch.Tensor,
           size: int) -> torch.Tensor:
    """[B, size] bool: the union of `num` random [start, start + width)
    bands per sample, width ~ U{0..width_cap[b]}, start ~ U{0..bound[b] -
    width} (masks stay inside [0, bound[b]))."""
    dev = bound.device
    draw = lambda: torch.randint(0, 1 << 30, (batch, num),  # noqa: E731
                                 generator=generator, device=dev)
    widths = draw() % (width_cap[:, None] + 1)
    span = torch.clamp(bound[:, None] - widths + 1, min=1)
    starts = draw() % span
    idx = torch.arange(size, device=dev)[None, None, :]
    band = ((idx >= starts[..., None])
            & (idx < (starts + widths)[..., None]))
    return band.any(dim=1)


def spec_augment(generator: torch.Generator, feats: torch.Tensor,
                 feat_lengths: torch.Tensor, *, num_time_masks: int = 2,
                 max_time_width: int = 40, max_time_frac: float = 0.2,
                 num_freq_masks: int = 2,
                 max_freq_width: int = 27) -> torch.Tensor:
    """SpecAugment on feats [B, T, F]; returns the masked features.

    Each sample gets `num_time_masks` zero bands of width
    U{0..min(max_time_width, max_time_frac * valid_frames)} inside its valid
    frames (the proportional cap keeps short utterances from being masked
    away) and `num_freq_masks` bands of width U{0..max_freq_width} over the
    feature axis. Identity when both counts are 0. `generator` lives on
    feats' device; seed a fresh one per step.
    """
    batch, t_max, feat_dim = feats.shape
    dev = feats.device
    out = feats
    if num_time_masks > 0:
        flen = feat_lengths.to(device=dev, dtype=torch.int64)
        cap = torch.clamp((max_time_frac * flen).to(torch.int64),
                          max=max_time_width)
        tmask = _masks(generator, batch, num_time_masks, flen, cap, t_max)
        out = out * (~tmask)[:, :, None].to(feats.dtype)
    if num_freq_masks > 0:
        fdim = torch.full((batch,), feat_dim, dtype=torch.int64, device=dev)
        cap = torch.clamp(fdim, max=max_freq_width)
        fmask = _masks(generator, batch, num_freq_masks, fdim, cap, feat_dim)
        out = out * (~fmask)[:, None, :].to(feats.dtype)
    return out
