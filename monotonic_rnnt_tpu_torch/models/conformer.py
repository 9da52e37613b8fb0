"""Conformer encoder, the PyTorch counterpart of the JAX package's.

``monotonic_rnnt_tpu/models/conformer.py`` is a flax module; this one gives
its numbers on the same weights (``convert.transducer_params_from_flax``).
Parameters stay float32 and each layer computes in ``cfg.dtype``, as flax's
``param_dtype`` / ``dtype`` do: a layer casts its input and its parameters
to the compute dtype, and the encoder returns float32. The torch layers
(``nn.Linear``, ``nn.Conv1d``, ``nn.Conv2d``, ``nn.LayerNorm``) hold the
parameters in torch's layouts; the functions below apply them the way flax
does:

  * convolutions pad by XLA's rules, not torch's symmetric ``padding=``:
    "SAME" with stride 2 and a 3-wide kernel pads (0, 1) on an even length
    and (1, 1) on an odd one; causal mode pads time (2, 0) and frequency
    (1, 1), and the depthwise conv (k-1, 0);
  * the subsampler's [B, C, T, F] output is laid out [B, T, F*C] with C
    fastest, as flax's NHWC reshape;
  * LayerNorm takes epsilon 1e-6 and float32 statistics;
  * attention scales q by 1/sqrt(Dh) and fills masked logits with the
    compute dtype's finfo.min (not -inf: a row whose keys are all masked
    then averages, as flax's does);
  * the masks stay where flax applies them (input frames, after every
    strided stage, after the positions, before the depthwise conv), so the
    output does not depend on padding;
  * dropout draws its masks from a ``torch.Generator`` that the caller
    passes (flax's ``rngs={"dropout": key}``), never from the global RNG,
    and keeps x / (1 - rate) where it keeps, as flax's ``nn.Dropout``. The
    streams differ from JAX's (another PRNG, and flax folds each call
    site's path into its key), so masks agree in law, not in bits.

The encoder needs the feature width at construction (``feat_dim``), where
flax infers it from the first call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .init import finish_init

LAYER_NORM_EPS = 1e-6  # flax's LayerNorm default


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    num_layers: int = 4
    dim: int = 256
    num_heads: int = 4
    ff_expansion: int = 4
    conv_kernel: int = 15
    subsample_factor: int = 4       # two stride-2 convs
    dropout: float = 0.1
    causal: bool = False            # streaming mode: no future context
    attn_left_context: int = -1     # causal attention window (-1 = all past)
    remat: bool = False             # recompute blocks in the backward
    dtype: torch.dtype = torch.bfloat16  # compute dtype; params stay f32


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    """flax Dense: input, kernel and bias in the compute dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype):
    """flax LayerNorm: statistics and affine map in float32, out in dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(dtype)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]):
    """flax's nn.Dropout, its mask drawn from `generator` (on x's device):
    x where deterministic or rate is 0 (nothing drawn), else x / (1 - rate)
    where a uniform draw is >= rate and 0 elsewhere."""
    if deterministic or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a "
                         "torch.Generator (flax's rngs={'dropout': key})")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _replay_draws(generator: Optional[torch.Generator]):
    """torch.utils.checkpoint's context_fn for a block that draws from
    `generator`: the forward remembers the generator's state, and the
    recompute in the backward starts from it (so it draws the forward's
    masks) and hands the generator back as it found it. checkpoint's own
    RNG handling covers only the global CPU and CUDA states."""
    if generator is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    saved = []

    @contextlib.contextmanager
    def forward():
        saved.append(generator.get_state())
        yield

    @contextlib.contextmanager
    def recompute():
        now = generator.get_state()
        generator.set_state(saved[0])
        try:
            yield
        finally:
            generator.set_state(now)

    return forward(), recompute()


def same_padding(n: int, kernel: int, stride: int):
    """XLA's "SAME" padding (lo, hi) of one spatial axis of length n."""
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class FeedForward(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        self.norm = nn.LayerNorm(cfg.dim, eps=LAYER_NORM_EPS)
        self.dense1 = nn.Linear(cfg.dim, cfg.dim * cfg.ff_expansion)
        self.dense2 = nn.Linear(cfg.dim * cfg.ff_expansion, cfg.dim)

    def forward(self, x, deterministic: bool, generator=None):
        cfg, dt = self.cfg, self.cfg.dtype
        y = F.silu(dense(self.dense1, layer_norm(self.norm, x, dt), dt))
        y = dropout(y, cfg.dropout, deterministic, generator)
        y = dense(self.dense2, y, dt)
        return dropout(y, cfg.dropout, deterministic, generator)


class ConvModule(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(cfg.dim, eps=LAYER_NORM_EPS)
        self.pointwise1 = nn.Linear(cfg.dim, 2 * cfg.dim)
        self.depthwise = nn.Conv1d(cfg.dim, cfg.dim, cfg.conv_kernel,
                                   groups=cfg.dim)
        self.norm2 = nn.LayerNorm(cfg.dim, eps=LAYER_NORM_EPS)
        self.pointwise2 = nn.Linear(cfg.dim, cfg.dim)

    def forward(self, x, pad_mask, deterministic: bool, generator=None):
        cfg, dt = self.cfg, self.cfg.dtype
        y = dense(self.pointwise1, layer_norm(self.norm1, x, dt), dt)
        y = F.glu(y, dim=-1)
        # Mask padding immediately before the depthwise conv: Dense biases
        # re-populate padded frames, and the conv would leak them into
        # valid frames (encoder output must be padding-independent).
        y = y * pad_mask[..., None].to(y.dtype)
        k = cfg.conv_kernel
        # Streaming mode: left-only padding so frame t never sees t+1..
        pad = (k - 1, 0) if cfg.causal else same_padding(y.shape[1], k, 1)
        y = F.conv1d(F.pad(y.transpose(1, 2), pad),
                     self.depthwise.weight.to(dt), self.depthwise.bias.to(dt),
                     groups=cfg.dim).transpose(1, 2)
        y = F.silu(layer_norm(self.norm2, y, dt))  # stands in for batchnorm
        y = dense(self.pointwise2, y, dt)
        return dropout(y, cfg.dropout, deterministic, generator)


class MHSA(nn.Module):
    """LayerNorm, then flax's MultiHeadDotProductAttention (q, k, v and out
    projections over all heads; [D, H*Dh] weights, head-major)."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        self.norm = nn.LayerNorm(cfg.dim, eps=LAYER_NORM_EPS)
        self.query = nn.Linear(cfg.dim, cfg.dim)
        self.key = nn.Linear(cfg.dim, cfg.dim)
        self.value = nn.Linear(cfg.dim, cfg.dim)
        self.out = nn.Linear(cfg.dim, cfg.dim)

    def forward(self, x, pad_mask, deterministic: bool, generator=None):
        cfg, dt = self.cfg, self.cfg.dtype
        y = layer_norm(self.norm, x, dt)
        b, t, d = y.shape
        heads = cfg.num_heads
        split = lambda z: z.view(b, t, heads, d // heads).transpose(1, 2)
        q = split(dense(self.query, y, dt)) / math.sqrt(d // heads)
        k = split(dense(self.key, y, dt))
        v = split(dense(self.value, y, dt))
        mask = pad_mask[:, None, None, :]                    # [B, 1, 1, T]
        if cfg.causal:
            q_idx = torch.arange(t, device=y.device)[:, None]
            k_idx = torch.arange(t, device=y.device)[None, :]
            causal_ok = k_idx <= q_idx
            if cfg.attn_left_context >= 0:
                causal_ok &= (q_idx - k_idx) <= cfg.attn_left_context
            mask = mask & causal_ok                          # [B, 1, T, T]
        w = (q @ k.transpose(-1, -2)).masked_fill(~mask,
                                                  torch.finfo(dt).min)
        w = dropout(torch.softmax(w, dim=-1), cfg.dropout, deterministic,
                    generator)
        o = (w @ v).transpose(1, 2).reshape(b, t, d)
        return dropout(dense(self.out, o, dt), cfg.dropout, deterministic,
                       generator)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        self.ff1 = FeedForward(cfg)
        self.mhsa = MHSA(cfg)
        self.conv = ConvModule(cfg)
        self.ff2 = FeedForward(cfg)
        self.norm = nn.LayerNorm(cfg.dim, eps=LAYER_NORM_EPS)

    def forward(self, x, pad_mask, deterministic: bool, generator=None):
        x = x + 0.5 * self.ff1(x, deterministic, generator)
        x = x + self.mhsa(x, pad_mask, deterministic, generator)
        x = x + self.conv(x, pad_mask, deterministic, generator)
        x = x + 0.5 * self.ff2(x, deterministic, generator)
        return layer_norm(self.norm, x, self.cfg.dtype)


def _subsample_stages(factor: int) -> int:
    if factor < 1 or 2 ** (int(factor).bit_length() - 1) != factor:
        raise ValueError(f"subsample_factor must be a power of 2, got {factor}")
    return int(factor).bit_length() - 1


def _stage_length(n):
    """Frame count after ONE stride-2 subsampler stage (an int or an int
    tensor): subsampled_length and ConvSubsampler's per-stage re-masking
    both consume it."""
    return (n - 1) // 2 + 1


def subsampled_length(cfg: ConformerConfig, n):
    """Input-frame count -> encoder output-frame count ((n-1)//2+1 per stage).

    THE length contract of the strided subsampler: the encoder's pad masks
    and the streaming emit gate must use this exact formula.
    """
    for _ in range(_subsample_stages(cfg.subsample_factor)):
        n = _stage_length(n)
    return n


class ConvSubsampler(nn.Module):
    """log2(subsample_factor) stride-2 3x3 convs over (time, freq), then a
    Dense over the [freq, channel] features of each frame."""

    def __init__(self, cfg: ConformerConfig, feat_dim: int):
        super().__init__()
        self.cfg = cfg
        stages = _subsample_stages(cfg.subsample_factor)
        ch = cfg.dim // 4
        self.convs = nn.ModuleList(
            [nn.Conv2d(1 if i == 0 else ch, ch, 3, stride=2)
             for i in range(stages)])
        f_out = feat_dim
        for _ in range(stages):
            f_out = _stage_length(f_out)
        self.dense = nn.Linear(f_out * ch, cfg.dim)

    def forward(self, feats, feat_lengths):
        dt = self.cfg.dtype
        x = feats[:, None].to(dt)                            # [B, 1, T, F]
        lengths = feat_lengths
        for conv in self.convs:
            t, f = x.shape[2], x.shape[3]
            # F.pad takes the last axis first: (freq lo, hi, time lo, hi).
            # Streaming mode pads time on the left only.
            if self.cfg.causal:
                pad = (1, 1, 2, 0)
            else:
                pad = same_padding(f, 3, 2) + same_padding(t, 3, 2)
            x = F.relu(F.conv2d(F.pad(x, pad), conv.weight.to(dt),
                                conv.bias.to(dt), stride=2))
            # Re-mask after every strided stage: conv bias + ReLU re-populate
            # padded frames and the next stage's boundary would read them.
            lengths = _stage_length(lengths)
            stage_mask = (torch.arange(x.shape[2], device=x.device)[None, :]
                          < lengths[:, None])
            x = x * stage_mask[:, None, :, None].to(x.dtype)
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)       # c fastest
        return dense(self.dense, x, dt)


def streaming_lookback(cfg: ConformerConfig) -> int:
    """Input-frame history needed for exact chunked streaming inference.

    One emitted output frame's receptive field: each of the L blocks adds
    attn_left_context (masked attention) + conv_kernel-1 (causal depthwise
    conv) output frames; the strided subsampler multiplies by
    subsample_factor and adds its own kernel context (<= 2*factor input
    frames). Requires a bounded attention window (attn_left_context >= 0):
    with unbounded causal attention the exact receptive field is the whole
    stream. Returned value is a multiple of subsample_factor.
    """
    if not cfg.causal:
        raise ValueError("streaming requires causal=True")
    if cfg.attn_left_context < 0:
        raise ValueError("exact streaming requires a bounded "
                         "attn_left_context (>= 0)")
    rf_out = cfg.num_layers * (cfg.attn_left_context + cfg.conv_kernel - 1)
    return (rf_out + 2) * cfg.subsample_factor


def sinusoidal_positions(t: int, dim: int, offset=0,
                         device=None) -> torch.Tensor:
    """[t, dim] fixed sinusoidal position encodings (f32), from `offset`.

    `offset` may be a 0-d tensor on `device`: chunked streaming recomputes
    a sliding window whose absolute start moves with the stream.
    """
    pos = (torch.arange(t, dtype=torch.float32, device=device)
           + offset)[:, None]
    half = dim // 2
    inv_freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / half)
    angles = pos * inv_freq[None, :]
    pe = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
    return F.pad(pe, (0, dim - pe.shape[-1]))          # odd dim: zero column


class ConformerEncoder(nn.Module):
    """feats [B, T, feat_dim] + frame lengths -> (encodings [B, T', D] f32,
    lengths')."""

    def __init__(self, cfg: ConformerConfig, feat_dim: int = 80, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.subsampler = ConvSubsampler(cfg, feat_dim)
        self.blocks = nn.ModuleList([ConformerBlock(cfg)
                                     for _ in range(cfg.num_layers)])
        finish_init(self, generator, device)

    def forward(self, feats, feat_lengths, deterministic: bool = True,
                pos_offset=0, generator: Optional[torch.Generator] = None):
        """pos_offset: absolute output-frame index of feats' first frame
        (in subsampled time; an int or a 0-d tensor), nonzero only for
        chunked streaming windows.
        generator: dropout's (on feats' device), needed when
        deterministic=False and cfg.dropout > 0."""
        cfg = self.cfg
        dev = feats.device
        # Zero out padded input frames first: the strided subsampling convs
        # would otherwise leak arbitrary padding values into the last valid
        # frames (the loss layer promises padding-independence).
        in_mask = (torch.arange(feats.shape[1], device=dev)[None, :]
                   < feat_lengths[:, None])
        feats = feats * in_mask[..., None].to(feats.dtype)
        x = self.subsampler(feats, feat_lengths)
        # Inject position: self-attention is otherwise permutation-invariant.
        x = x + sinusoidal_positions(x.shape[1], cfg.dim, pos_offset,
                                     dev).to(x.dtype)
        out_lengths = subsampled_length(cfg, feat_lengths)
        pad_mask = (torch.arange(x.shape[1], device=dev)[None, :]
                    < out_lengths[:, None])
        x = x * pad_mask[..., None].to(x.dtype)
        for block in self.blocks:
            if cfg.remat and torch.is_grad_enabled():
                # Recompute the block in the backward instead of keeping its
                # activations; the recompute redraws the forward's dropout
                # masks from the generator's saved state.
                x = checkpoint(block, x, pad_mask, deterministic, generator,
                               use_reentrant=False,
                               context_fn=lambda: _replay_draws(generator))
            else:
                x = block(x, pad_mask, deterministic, generator)
        return x.float(), out_lengths
