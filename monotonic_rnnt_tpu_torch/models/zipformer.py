"""Zipformer encoder (Yao et al. 2023, arXiv:2310.11230), the port's second
acoustic encoder family.

It follows icefall's LibriSpeech recipe (``egs/librispeech/ASR/zipformer``:
``zipformer.py``, ``subsampling.py``); the defaults are its "large" model,
Zipformer-L. Notation: x is [B, T, d]. Parameters stay float32 and each
layer computes in ``cfg.dtype``, as the Conformer's do; BiasNorm takes its
statistics in float32.

  * Embed, to 50 Hz: Conv2d(1->8, 3, pad (0, 1)), SwooshR;
    Conv2d(8->32, 3, stride 2), SwooshR; Conv2d(32->128, 3, stride (1, 2)),
    SwooshR; one ConvNeXt (depthwise 7x7, 1x1 to 384, SwooshL, 1x1 back,
    plus the input); each frame read as 128 x 19 with frequency fastest;
    Linear to the first stack's width, BiasNorm. Lengths (T - 7) // 2.
  * Six stacks at 50, 25, 12.5, 6.25, 12.5 and 25 Hz. Stack i takes the
    first d_i channels of the 50 Hz stream (or pads it with zeros); where
    its factor ds_i > 1 it averages each ds_i frames with softmax(w),
    runs its layers, repeats each frame ds_i times, crops, and mixes with
    its input by a learned per-channel bypass. A frame j at rate ds is
    valid where j < ceil(len / ds).
  * Each layer computes one set of attention weights A [H, B, T, T]
    (q . k + p . W_pos pe(key - query), keys past the end at -1000,
    softmax over keys) and uses it three times: in the non-linear
    attention (head 0 only) and in two self-attention modules. Around them
    three feed-forward modules (widths 3/4, 1 and 5/4 of the stack's),
    two convolution modules, a bypass in the middle and one at the end,
    and BiasNorm before the last bypass.
  * The output takes the last stack's channels, then the further channels
    of the most recent stack that has them (stack 5's 256:512, stack 4's
    512:768), and averages frame pairs as a downsample does: 25 Hz, the
    40 ms lattice frame, of length ceil(len / 2).

Departures from icefall:

  * Padding independence: where a downsample groups frames past an
    utterance's end, they are replaced by the utterance's own last valid
    frame (icefall repeats the batch's last frame), and frames past the
    end are zeroed before the ConvNeXt's depthwise convolution (in icefall
    a shorter utterance's last 3 frames see padding). An utterance's output
    does not depend on its batch.
  * Left out, being the identity in the forward or changing only
    gradients and training-time schedules: Balancer, Whiten, ScaleGrad,
    penalize_abs_values_gt, limit_param_value, the feature masks of
    encoder_unmasked_dim, and every dropout and skip rate (layer, module,
    bypass and positional-encoding dropout, const_attention_rate).
  * Not causal: the port's chunked streaming needs a causal encoder.

Spans, inside ``mrnnt.encode``: ``mrnnt.zipformer.embed``,
``mrnnt.zipformer.stack<i>`` (i = 1..6), ``mrnnt.zipformer.attn_weights``
(the shared softmax) and ``mrnnt.zipformer.attend`` (each module that
reads it). Nothing here reads device data on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..convert import _device
from ..utils.profiling import span
from .conformer import dense
from .init import init_like_flax

MASKED_SCORE = -1000.0   # icefall's fill for masked keys: exp() is 0


@dataclasses.dataclass(frozen=True)
class ZipformerConfig:
    num_layers: Tuple[int, ...] = (2, 2, 4, 5, 4, 2)
    downsampling: Tuple[int, ...] = (1, 2, 4, 8, 4, 2)
    encoder_dims: Tuple[int, ...] = (192, 256, 512, 768, 512, 256)
    feedforward_dims: Tuple[int, ...] = (512, 768, 1536, 2048, 1536, 768)
    num_heads: Tuple[int, ...] = (4, 4, 4, 8, 4, 4)
    conv_kernels: Tuple[int, ...] = (31, 31, 15, 15, 15, 31)
    query_head_dim: int = 32
    pos_head_dim: int = 4
    value_head_dim: int = 12
    pos_dim: int = 48
    output_downsampling: int = 2
    embed_channels: Tuple[int, int, int] = (8, 32, 128)
    convnext_expansion: int = 3
    dtype: torch.dtype = torch.bfloat16  # compute dtype; params stay f32

    @property
    def dim(self) -> int:
        """The encoder's output width, the joint's input."""
        return max(self.encoder_dims)


def swoosh_l(x):
    return F.softplus(x - 4.0) - 0.08 * x - 0.035


def swoosh_r(x):
    return F.softplus(x - 1.0) - 0.08 * x - 0.313261687


def embed_length(n):
    """Input frames -> 50 Hz frames of the embed."""
    return (n - 7) // 2


class BiasNorm(nn.Module):
    """x exp(log_scale) / rms(x - bias) over channels; no epsilon."""

    def __init__(self, dim: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.empty(()))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x, dtype):
        xf = x.float()
        scale = ((xf - self.bias).square().mean(-1, keepdim=True).rsqrt()
                 * self.log_scale.exp())
        return (xf * scale).to(dtype)


class Bypass(nn.Module):
    """x0 + c (x - x0), c per channel."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim))

    def forward(self, x0, x):
        return x0 + self.scale.to(x.dtype) * (x - x0)


class Downsample(nn.Module):
    """Averages each `factor` frames with softmax(weight); frames past an
    utterance's end are replaced by its last valid frame first."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor
        self.weight = nn.Parameter(torch.empty(factor))

    def forward(self, x, lengths):
        b, t, d = x.shape
        ds = self.factor
        n = -(-t // ds)
        idx = torch.minimum(
            torch.arange(n * ds, device=x.device)[None, :],
            (lengths - 1).clamp(min=0)[:, None])
        x = x.gather(1, idx[..., None].expand(b, n * ds, d))
        w = self.weight.softmax(0).to(x.dtype)
        return (x.view(b, n, ds, d) * w[:, None]).sum(2)


def _valid(t: int, lengths) -> torch.Tensor:
    """[B, t] bool: the frames inside each utterance."""
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


class ConvEmbed(nn.Module):
    """icefall's Conv2dSubsampling with its one ConvNeXt layer."""

    def __init__(self, cfg: ZipformerConfig, feat_dim: int):
        super().__init__()
        self.cfg = cfg
        c1, c2, c3 = cfg.embed_channels
        hidden = c3 * cfg.convnext_expansion
        self.conv1 = nn.Conv2d(1, c1, 3)
        self.conv2 = nn.Conv2d(c1, c2, 3)
        self.conv3 = nn.Conv2d(c2, c3, 3)
        self.convnext_dw = nn.Conv2d(c3, c3, 7, groups=c3)
        self.convnext_pw1 = nn.Conv2d(c3, hidden, 1)
        self.convnext_pw2 = nn.Conv2d(hidden, c3, 1)
        self.out = nn.Linear(c3 * (((feat_dim - 1) // 2 - 1) // 2),
                             cfg.encoder_dims[0])
        self.out_norm = BiasNorm(cfg.encoder_dims[0])

    def forward(self, feats, feat_lengths):
        dt = self.cfg.dtype

        def conv(layer, x, **kw):
            return F.conv2d(x, layer.weight.to(dt), layer.bias.to(dt), **kw)

        x = feats[:, None].to(dt)                        # [B, 1, T, F]
        x = swoosh_r(conv(self.conv1, x, padding=(0, 1)))
        x = swoosh_r(conv(self.conv2, x, stride=2))
        x = swoosh_r(conv(self.conv3, x, stride=(1, 2)))
        lengths = embed_length(feat_lengths)
        x = x * _valid(x.shape[2], lengths)[:, None, :, None].to(dt)
        y = conv(self.convnext_dw, x, padding=3, groups=x.shape[1])
        y = conv(self.convnext_pw2, swoosh_l(conv(self.convnext_pw1, y)))
        x = x + y
        b, c, t, f = x.shape
        x = x.transpose(1, 2).reshape(b, t, c * f)       # f fastest
        return self.out_norm(dense(self.out, x, dt), dt), lengths


def compact_rel_positions(t: int, dim: int, device) -> torch.Tensor:
    """[2t - 1, dim] float32 encodings of the offsets -(t-1) .. t-1:
    x_c = c sign(x) (ln(|x| + c) - ln c) with c = sqrt(dim), theta =
    atan(x_c / (dim / 2 pi)), then cos and sin of (k + 1) theta
    interleaved for k < dim / 2, and the last entry 1."""
    x = torch.arange(-(t - 1), t, device=device, dtype=torch.float32)
    c = math.sqrt(dim)
    xc = c * x.sign() * (torch.log(x.abs() + c) - math.log(c))
    theta = torch.atan(xc / (dim / (2 * math.pi)))
    k = torch.arange(1, dim // 2 + 1, device=device, dtype=torch.float32)
    angle = theta[:, None] * k
    pe = torch.stack([angle.cos(), angle.sin()], dim=-1).reshape(2 * t - 1,
                                                                dim)
    return torch.cat([pe[:, :-1], torch.ones_like(pe[:, :1])], dim=1)


def rel_shift(scores: torch.Tensor) -> torch.Tensor:
    """[..., T, 2T - 1] scores by offset -> [..., T, T] by key: entry
    (i, j) is column T - 1 + j - i, the offset key minus query (icefall's
    as_strided). `scores` must be contiguous."""
    t = scores.shape[-2]
    *lead, s2, s3 = scores.stride()
    return scores.as_strided(
        scores.shape[:-1] + (t,), tuple(lead) + (s2 - s3, s3),
        scores.storage_offset() + (t - 1) * s3)


class AttentionWeights(nn.Module):
    def __init__(self, cfg: ZipformerConfig, dim: int, heads: int):
        super().__init__()
        self.cfg, self.heads = cfg, heads
        self.in_proj = nn.Linear(
            dim, (2 * cfg.query_head_dim + cfg.pos_head_dim) * heads)
        self.linear_pos = nn.Linear(cfg.pos_dim, cfg.pos_head_dim * heads,
                                    bias=False)

    def forward(self, x, pe, valid):
        """x [B, T, d], pe [2T - 1, pos_dim], valid [B, T] -> A [H, B, T, T]
        in the compute dtype."""
        cfg, dt, h = self.cfg, self.cfg.dtype, self.heads
        b, t, _ = x.shape
        qd, pd = cfg.query_head_dim, cfg.pos_head_dim
        q, k, p = dense(self.in_proj, x, dt).split([qd * h, qd * h, pd * h],
                                                   dim=-1)
        q = q.reshape(b, t, h, qd).permute(2, 0, 1, 3)
        k = k.reshape(b, t, h, qd).permute(2, 0, 3, 1)
        p = p.reshape(b, t, h, pd).permute(2, 0, 1, 3)
        pos = F.linear(pe.to(dt), self.linear_pos.weight.to(dt))
        pos = pos.view(2 * t - 1, h, pd).permute(1, 2, 0)[:, None]
        scores = q @ k + rel_shift(p @ pos)
        scores = scores.masked_fill(~valid[None, :, None, :], MASKED_SCORE)
        return scores.softmax(-1)


class NonlinAttention(nn.Module):
    def __init__(self, cfg: ZipformerConfig, dim: int):
        super().__init__()
        self.cfg = cfg
        hidden = 3 * dim // 4
        self.in_proj = nn.Linear(dim, 3 * hidden)
        self.out_proj = nn.Linear(hidden, dim)

    def forward(self, x, a0):
        """a0 [B, T, T]: head 0 of the layer's attention weights."""
        dt = self.cfg.dtype
        s, v, y = dense(self.in_proj, x, dt).chunk(3, dim=-1)
        return dense(self.out_proj, (a0 @ (v * torch.tanh(s))) * y, dt)


class SelfAttention(nn.Module):
    def __init__(self, cfg: ZipformerConfig, dim: int, heads: int):
        super().__init__()
        self.cfg, self.heads = cfg, heads
        self.in_proj = nn.Linear(dim, heads * cfg.value_head_dim)
        self.out_proj = nn.Linear(heads * cfg.value_head_dim, dim)

    def forward(self, x, a):
        dt, h = self.cfg.dtype, self.heads
        b, t, _ = x.shape
        v = dense(self.in_proj, x, dt).view(b, t, h, -1).permute(2, 0, 1, 3)
        o = (a @ v).permute(1, 2, 0, 3).reshape(b, t, -1)
        return dense(self.out_proj, o, dt)


class FeedForward(nn.Module):
    def __init__(self, cfg: ZipformerConfig, dim: int, hidden: int):
        super().__init__()
        self.cfg = cfg
        self.in_proj = nn.Linear(dim, hidden)
        self.out_proj = nn.Linear(hidden, dim)

    def forward(self, x):
        dt = self.cfg.dtype
        return dense(self.out_proj, swoosh_l(dense(self.in_proj, x, dt)), dt)


class ConvModule(nn.Module):
    def __init__(self, cfg: ZipformerConfig, dim: int, kernel: int):
        super().__init__()
        self.cfg, self.kernel = cfg, kernel
        self.in_proj = nn.Linear(dim, 2 * dim)
        self.depthwise = nn.Conv1d(dim, dim, kernel, groups=dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, valid):
        dt = self.cfg.dtype
        y, s = dense(self.in_proj, x, dt).chunk(2, dim=-1)
        y = y * torch.sigmoid(s) * valid[..., None].to(dt)
        y = F.conv1d(y.transpose(1, 2), self.depthwise.weight.to(dt),
                     self.depthwise.bias.to(dt), padding=self.kernel // 2,
                     groups=y.shape[-1]).transpose(1, 2)
        return dense(self.out_proj, swoosh_r(y), dt)


class ZipformerLayer(nn.Module):
    def __init__(self, cfg: ZipformerConfig, i: int):
        super().__init__()
        self.cfg = cfg
        d, ff, h = (cfg.encoder_dims[i], cfg.feedforward_dims[i],
                    cfg.num_heads[i])
        self.attn_weights = AttentionWeights(cfg, d, h)
        self.ff1 = FeedForward(cfg, d, 3 * ff // 4)
        self.nla = NonlinAttention(cfg, d)
        self.sa1 = SelfAttention(cfg, d, h)
        self.conv1 = ConvModule(cfg, d, cfg.conv_kernels[i])
        self.ff2 = FeedForward(cfg, d, ff)
        self.bypass_mid = Bypass(d)
        self.sa2 = SelfAttention(cfg, d, h)
        self.conv2 = ConvModule(cfg, d, cfg.conv_kernels[i])
        self.ff3 = FeedForward(cfg, d, 5 * ff // 4)
        self.norm = BiasNorm(d)
        self.bypass = Bypass(d)

    def forward(self, x, pe, valid):
        x0 = x
        with span("mrnnt.zipformer.attn_weights"):
            a = self.attn_weights(x0, pe, valid)
        x = x + self.ff1(x)
        with span("mrnnt.zipformer.attend"):
            x = x + self.nla(x, a[0])
        with span("mrnnt.zipformer.attend"):
            x = x + self.sa1(x, a)
        x = x + self.conv1(x, valid)
        x = x + self.ff2(x)
        x = self.bypass_mid(x0, x)
        with span("mrnnt.zipformer.attend"):
            x = x + self.sa2(x, a)
        x = x + self.conv2(x, valid)
        x = x + self.ff3(x)
        return self.bypass(x0, self.norm(x, self.cfg.dtype))


def convert_channels(x, dim: int):
    """The first `dim` channels of x, or x padded with zero channels."""
    if dim <= x.shape[-1]:
        return x[..., :dim]
    return F.pad(x, (0, dim - x.shape[-1]))


class Stack(nn.Module):
    def __init__(self, cfg: ZipformerConfig, i: int):
        super().__init__()
        self.cfg, self.index = cfg, i
        self.dim, self.factor = cfg.encoder_dims[i], cfg.downsampling[i]
        if self.factor > 1:
            self.downsample = Downsample(self.factor)
        self.layers = nn.ModuleList([ZipformerLayer(cfg, i)
                                     for _ in range(cfg.num_layers[i])])
        if self.factor > 1:
            self.out_combiner = Bypass(self.dim)

    def forward(self, x, lengths):
        """x [B, T, *] at 50 Hz, lengths [B] its valid frames."""
        ds = self.factor
        x0 = x = convert_channels(x, self.dim)
        if ds > 1:
            x = self.downsample(x, lengths)
        valid = _valid(x.shape[1], (lengths + ds - 1) // ds)
        pe = compact_rel_positions(x.shape[1], self.cfg.pos_dim, x.device)
        for layer in self.layers:
            x = layer(x, pe, valid)
        if ds > 1:
            b, n, d = x.shape
            x = x[:, :, None].expand(b, n, ds, d).reshape(b, n * ds, d)
            x = self.out_combiner(x0, x[:, :x0.shape[1]])
        return x


class ZipformerEncoder(nn.Module):
    """feats [B, T, feat_dim] + frame lengths -> (encodings [B, T', D] f32,
    lengths'), D = cfg.dim."""

    def __init__(self, cfg: ZipformerConfig, feat_dim: int = 80, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.embed = ConvEmbed(cfg, feat_dim)
        self.stacks = nn.ModuleList([Stack(cfg, i)
                                     for i in range(len(cfg.num_layers))])
        self.downsample_output = Downsample(cfg.output_downsampling)
        init_like_flax(self, generator)
        init_extras(self, generator)
        self.to(_device(device))

    def forward(self, feats, feat_lengths, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """deterministic and generator are the Conformer's; nothing here
        draws."""
        cfg = self.cfg
        with span("mrnnt.zipformer.embed"):
            x, lengths = self.embed(feats, feat_lengths)
        outputs = []
        for i, stack in enumerate(self.stacks):
            with span(f"mrnnt.zipformer.stack{i + 1}"):
                x = stack(x, lengths)
            outputs.append(x)
        x = self._full_width(outputs)
        x = self.downsample_output(x, lengths)
        ds = cfg.output_downsampling
        return x.float(), (lengths + ds - 1) // ds

    def _full_width(self, outputs):
        """The last stack's channels, then each further channel from the
        most recent stack that has it."""
        dims = self.cfg.encoder_dims
        pieces, have = [outputs[-1]], dims[-1]
        for i in range(len(dims) - 2, -1, -1):
            if dims[i] > have:
                pieces.append(outputs[i][..., have:dims[i]])
                have = dims[i]
        return torch.cat(pieces, dim=-1)


@torch.no_grad()
def init_extras(module: nn.Module,
                generator: Optional[torch.Generator] = None) -> None:
    """icefall's initial values over flax's initialisers: the initial_scale
    of its ScaledLinear / ScaledConv2d layers on their weights and biases
    (the attention weights' in_proj query_head_dim^-0.25, linear_pos and
    every attention and convolution module's out_proj 0.05, the
    feed-forward out_proj 0.1, the ConvNeXt's last 1x1 conv 0.01);
    BiasNorm's log scale 1 and bias N(0, 1e-4^2); the bypass scales 0.5 and
    the downsample weights 0."""
    def scale(layer: nn.Module, factor: float) -> None:
        for p in layer.parameters():
            p.mul_(factor)

    for m in module.modules():
        if isinstance(m, AttentionWeights):
            scale(m.in_proj, m.cfg.query_head_dim ** -0.25)
            scale(m.linear_pos, 0.05)
        elif isinstance(m, (NonlinAttention, SelfAttention, ConvModule)):
            scale(m.out_proj, 0.05)
        elif isinstance(m, FeedForward):
            scale(m.out_proj, 0.1)
        elif isinstance(m, ConvEmbed):
            scale(m.convnext_pw2, 0.01)
        elif isinstance(m, BiasNorm):
            m.log_scale.fill_(1.0)
            m.bias.normal_(0.0, 1e-4, generator=generator)
        elif isinstance(m, Bypass):
            m.scale.fill_(0.5)
        elif isinstance(m, Downsample):
            m.weight.zero_()

