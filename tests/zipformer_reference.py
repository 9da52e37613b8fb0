"""A plain-PyTorch Zipformer transducer: the reference that the tests hold
the port's Zipformer against on the CPU (the benchmark keeps its own copy
under h100_bench/reference/, so that neither moves with the other).

The model of Yao et al. 2023 (arXiv:2310.11230) as icefall's LibriSpeech
recipe builds it (``egs/librispeech/ASR/zipformer``), written out here from
its equations, everything in float32 (the caller sets TF32 off):

* SwooshL(x) = log(1 + e^(x-4)) - 0.08 x - 0.035 and SwooshR(x) =
  log(1 + e^(x-1)) - 0.08 x - 0.313261687; BiasNorm(x) = x exp(g) /
  sqrt(mean_c (x - b)^2), no epsilon;
* the embed: 3x3 convolutions 1 -> 8 (frequency padded by 1), 8 -> 32
  (stride 2), 32 -> 128 (stride 1 in time, 2 in frequency), each followed
  by SwooshR; the frames past each utterance's (T - 7) // 2 set to zero;
  a ConvNeXt (depthwise 7x7 padded by 3, 1x1 to 384, SwooshL, 1x1 back,
  plus its input); each frame's [channel, frequency] features in that
  order; a linear map and BiasNorm;
* six stacks. Stack i takes the first d_i channels of the 50 Hz stream or
  pads them with zeros. With a factor ds > 1 it averages each ds frames
  with softmax(w) after replacing every frame past the utterance's end by
  its last valid frame, runs its layers at that rate, repeats each frame
  ds times, keeps the first T frames and returns x0 + c (x - x0). Frame j
  at rate ds is valid where j < ceil(len / ds);
* a layer: A = softmax over keys of q_i . k_j + p_i . W_pos e(j - i), keys
  past the end at -1000, q, k (32 a head) and p (4 a head) from one linear
  map, e the compact relative encoding of the offset (c = sqrt(48), x_c =
  c sign(x) (ln(|x| + c) - ln c), theta = atan(x_c 2 pi / 48), cos and sin
  of (k + 1) theta interleaved, the last entry 1). Then x0 = x and, in
  order: x += FF1(x); x += NLA(x, A_0); x += SA1(x, A); x += Conv1(x);
  x += FF2(x); x = x0 + c_mid (x - x0); x += SA2(x, A); x += Conv2(x);
  x += FF3(x); x = BiasNorm(x); x = x0 + c (x - x0). FF(h): linear to h,
  SwooshL, linear back (h = 3/4, 1, 5/4 of the stack's feed-forward
  width). NLA: a linear map to three parts (s, v, y) of 3d/4 each;
  ((A_0 (v tanh s)) y) mapped back. SA: a linear map to 12 channels a
  head, each head's A_h times its values, a linear map back. Conv: a
  linear map to (v, s), v sigmoid(s), the padded frames set to zero, a
  depthwise convolution padded by k // 2, SwooshR, a linear map;
* the output: the last stack's channels, then 256:512 of stack 5's and
  512:768 of stack 4's, averaged in frame pairs as above; ceil(len / 2)
  frames;
* the predictor (icefall's stateless decoder): an embedding of
  [blank = 0, y_1 .. y_S], a causal convolution over the last
  context_size positions in groups of 4 channels, without a bias, and
  ReLU;
* the joint: tanh(W_e enc_t + W_p pred_s) projected to the vocabulary.

Parameter names and shapes are the port's, so one set of seeded weights
loads into both. Nothing is dropped or skipped: the cell runs without
dropout and skip rates.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def swoosh_l(x):
    return torch.logaddexp(x - 4.0, x.new_zeros(())) - 0.08 * x - 0.035


def swoosh_r(x):
    return torch.logaddexp(x - 1.0, x.new_zeros(())) - 0.08 * x - 0.313261687


def frames_valid(t: int, lengths):
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def ceil_div(n, d: int):
    return (n + d - 1) // d


class Linear(nn.Module):
    def __init__(self, inp: int, out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out, inp))
        self.bias = nn.Parameter(torch.empty(out)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv(nn.Module):
    """A convolution's parameters: weight [out, in / groups, *kernel]."""

    def __init__(self, inp: int, out: int, kernel, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out, inp // groups, *kernel))
        self.bias = nn.Parameter(torch.empty(out)) if bias else None


class BiasNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.empty(()))
        self.bias = nn.Parameter(torch.empty(d))

    def forward(self, x):
        rms = torch.sqrt(torch.mean((x - self.bias) ** 2, dim=-1,
                                    keepdim=True))
        return x * torch.exp(self.log_scale) / rms


class Bypass(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d))

    def forward(self, x0, x):
        return x0 + self.scale * (x - x0)


class Downsample(nn.Module):
    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor
        self.weight = nn.Parameter(torch.empty(factor))

    def forward(self, x, lengths):
        b, t, d = x.shape
        ds = self.factor
        n = ceil_div(t, ds)
        rows = []
        for u in range(b):
            last = max(int(lengths[u]) - 1, 0)
            src = torch.arange(n * ds, device=x.device).clamp(max=last)
            rows.append(x[u, src])
        grouped = torch.stack(rows).view(b, n, ds, d)
        w = torch.softmax(self.weight, dim=0)
        return (grouped * w[None, None, :, None]).sum(dim=2)


class Embed(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        c1, c2, c3 = cfg["embed_channels"]
        hidden = c3 * cfg["convnext_hidden_ratio"]
        f = ((cfg["feat_dim"] - 1) // 2 - 1) // 2
        self.conv1 = Conv(1, c1, (3, 3))
        self.conv2 = Conv(c1, c2, (3, 3))
        self.conv3 = Conv(c2, c3, (3, 3))
        self.convnext_dw = Conv(c3, c3, (7, 7), groups=c3)
        self.convnext_pw1 = Conv(c3, hidden, (1, 1))
        self.convnext_pw2 = Conv(hidden, c3, (1, 1))
        self.out = Linear(c3 * f, cfg["encoder_dim"][0])
        self.out_norm = BiasNorm(cfg["encoder_dim"][0])

    def forward(self, feats, lengths):
        x = F.pad(feats[:, None], (1, 1, 0, 0))
        x = swoosh_r(F.conv2d(x, self.conv1.weight, self.conv1.bias))
        x = swoosh_r(F.conv2d(x, self.conv2.weight, self.conv2.bias,
                              stride=2))
        x = swoosh_r(F.conv2d(x, self.conv3.weight, self.conv3.bias,
                              stride=(1, 2)))
        lengths = (lengths - 7) // 2
        x = x * frames_valid(x.shape[2], lengths)[:, None, :, None]
        y = F.conv2d(F.pad(x, (3, 3, 3, 3)), self.convnext_dw.weight,
                     self.convnext_dw.bias, groups=x.shape[1])
        y = swoosh_l(F.conv2d(y, self.convnext_pw1.weight,
                              self.convnext_pw1.bias))
        x = x + F.conv2d(y, self.convnext_pw2.weight, self.convnext_pw2.bias)
        b, c, t, f = x.shape
        x = x.permute(0, 2, 1, 3).reshape(b, t, c * f)
        return self.out_norm(self.out(x)), lengths


def relative_encoding(offsets: torch.Tensor, dim: int) -> torch.Tensor:
    """[n, dim] compact encodings of integer offsets [n]."""
    x = offsets.to(torch.float32)
    c = math.sqrt(dim)
    xc = c * torch.sign(x) * (torch.log(torch.abs(x) + c) - math.log(c))
    theta = torch.atan(xc * 2 * math.pi / dim)
    pe = torch.empty(len(x), dim, device=x.device)
    for k in range(dim // 2):
        pe[:, 2 * k] = torch.cos((k + 1) * theta)
        pe[:, 2 * k + 1] = torch.sin((k + 1) * theta)
    pe[:, dim - 1] = 1.0
    return pe


class AttentionWeights(nn.Module):
    def __init__(self, cfg: dict, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qd, self.pd = cfg["query_head_dim"], cfg["pos_head_dim"]
        self.pos_dim = cfg["pos_dim"]
        self.in_proj = Linear(d, (2 * self.qd + self.pd) * heads)
        self.linear_pos = Linear(self.pos_dim, self.pd * heads, bias=False)

    def forward(self, x, valid):
        b, t, _ = x.shape
        h, qd, pd = self.heads, self.qd, self.pd
        proj = self.in_proj(x)
        q = proj[..., :qd * h].reshape(b, t, h, qd)
        k = proj[..., qd * h:2 * qd * h].reshape(b, t, h, qd)
        p = proj[..., 2 * qd * h:].reshape(b, t, h, pd)
        offsets = torch.arange(-(t - 1), t, device=x.device)
        table = self.linear_pos(relative_encoding(offsets, self.pos_dim))
        i = torch.arange(t, device=x.device)
        rel = table[i[None, :] - i[:, None] + t - 1].view(t, t, h, pd)
        scores = (torch.einsum("bihd,bjhd->hbij", q, k)
                  + torch.einsum("bihd,ijhd->hbij", p, rel))
        scores = scores.masked_fill(~valid[None, :, None, :], -1000.0)
        return torch.softmax(scores, dim=-1)


class NonlinAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.hidden = 3 * d // 4
        self.in_proj = Linear(d, 3 * self.hidden)
        self.out_proj = Linear(self.hidden, d)

    def forward(self, x, a0):
        h = self.hidden
        proj = self.in_proj(x)
        s, v, y = proj[..., :h], proj[..., h:2 * h], proj[..., 2 * h:]
        mixed = torch.einsum("bij,bjc->bic", a0, v * torch.tanh(s))
        return self.out_proj(mixed * y)


class SelfAttention(nn.Module):
    def __init__(self, cfg: dict, d: int, heads: int):
        super().__init__()
        self.heads, self.vd = heads, cfg["value_head_dim"]
        self.in_proj = Linear(d, heads * self.vd)
        self.out_proj = Linear(heads * self.vd, d)

    def forward(self, x, a):
        b, t, _ = x.shape
        v = self.in_proj(x).view(b, t, self.heads, self.vd)
        o = torch.einsum("hbij,bjhc->bihc", a, v).reshape(b, t, -1)
        return self.out_proj(o)


class FeedForward(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.in_proj = Linear(d, hidden)
        self.out_proj = Linear(hidden, d)

    def forward(self, x):
        return self.out_proj(swoosh_l(self.in_proj(x)))


class ConvModule(nn.Module):
    def __init__(self, d: int, kernel: int):
        super().__init__()
        self.kernel = kernel
        self.in_proj = Linear(d, 2 * d)
        self.depthwise = Conv(d, d, (kernel,), groups=d)
        self.out_proj = Linear(d, d)

    def forward(self, x, valid):
        d = x.shape[-1]
        proj = self.in_proj(x)
        v = proj[..., :d] * torch.sigmoid(proj[..., d:])
        v = v * valid[..., None]
        pad = self.kernel // 2
        y = F.conv1d(F.pad(v.transpose(1, 2), (pad, pad)),
                     self.depthwise.weight, self.depthwise.bias, groups=d)
        return self.out_proj(swoosh_r(y.transpose(1, 2)))


class Layer(nn.Module):
    def __init__(self, cfg: dict, i: int):
        super().__init__()
        d, ff = cfg["encoder_dim"][i], cfg["feedforward_dim"][i]
        heads, kernel = cfg["num_heads"][i], cfg["cnn_module_kernel"][i]
        self.attn_weights = AttentionWeights(cfg, d, heads)
        self.ff1 = FeedForward(d, 3 * ff // 4)
        self.nla = NonlinAttention(d)
        self.sa1 = SelfAttention(cfg, d, heads)
        self.conv1 = ConvModule(d, kernel)
        self.ff2 = FeedForward(d, ff)
        self.bypass_mid = Bypass(d)
        self.sa2 = SelfAttention(cfg, d, heads)
        self.conv2 = ConvModule(d, kernel)
        self.ff3 = FeedForward(d, 5 * ff // 4)
        self.norm = BiasNorm(d)
        self.bypass = Bypass(d)

    def forward(self, x, valid):
        x0 = x
        a = self.attn_weights(x0, valid)
        x = x + self.ff1(x)
        x = x + self.nla(x, a[0])
        x = x + self.sa1(x, a)
        x = x + self.conv1(x, valid)
        x = x + self.ff2(x)
        x = self.bypass_mid(x0, x)
        x = x + self.sa2(x, a)
        x = x + self.conv2(x, valid)
        x = x + self.ff3(x)
        return self.bypass(x0, self.norm(x))


class Stack(nn.Module):
    def __init__(self, cfg: dict, i: int):
        super().__init__()
        self.dim, self.factor = (cfg["encoder_dim"][i],
                                 cfg["downsampling_factor"][i])
        if self.factor > 1:
            self.downsample = Downsample(self.factor)
            self.out_combiner = Bypass(self.dim)
        self.layers = nn.ModuleList([Layer(cfg, i) for _ in
                                     range(cfg["num_encoder_layers"][i])])

    def forward(self, x, lengths):
        b, t, have = x.shape
        if have >= self.dim:
            x = x[..., :self.dim]
        else:
            x = torch.cat([x, x.new_zeros(b, t, self.dim - have)], dim=-1)
        x0 = x
        if self.factor > 1:
            x = self.downsample(x, lengths)
        valid = frames_valid(x.shape[1], ceil_div(lengths, self.factor))
        for layer in self.layers:
            x = layer(x, valid)
        if self.factor > 1:
            x = torch.repeat_interleave(x, self.factor, dim=1)[:, :t]
            x = self.out_combiner(x0, x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.dims = cfg["encoder_dim"]
        self.embed = Embed(cfg)
        self.stacks = nn.ModuleList([Stack(cfg, i)
                                     for i in range(len(self.dims))])
        self.downsample_output = Downsample(cfg["output_downsampling_factor"])

    def forward(self, feats, lengths):
        x, lengths = self.embed(feats, lengths)
        outputs = []
        for stack in self.stacks:
            x = stack(x, lengths)
            outputs.append(x)
        pieces, have = [outputs[-1]], self.dims[-1]
        for i in reversed(range(len(self.dims) - 1)):
            if self.dims[i] > have:
                pieces.append(outputs[i][..., have:self.dims[i]])
                have = self.dims[i]
        x = self.downsample_output(torch.cat(pieces, dim=-1), lengths)
        return x, ceil_div(lengths, self.downsample_output.factor)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, dim))


class Predictor(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["decoder_dim"]
        # icefall's decoder convolves in groups of 4 channels.
        self.context, self.groups = cfg["context_size"], d // 4
        self.embed = Embedding(cfg["vocab_size"], d)
        self.conv = Conv(d, d, (self.context,), groups=self.groups,
                         bias=False)

    def forward(self, labels):
        start = torch.full_like(labels[:, :1], 0)
        e = F.embedding(torch.cat([start, labels], dim=1).long(),
                        self.embed.weight)
        e = F.pad(e.transpose(1, 2), (self.context - 1, 0))
        y = F.conv1d(e, self.conv.weight, groups=self.groups)
        return torch.relu(y.transpose(1, 2))


class Joint(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.enc_proj = Linear(max(cfg["encoder_dim"]), cfg["joiner_dim"])
        self.pred_proj = Linear(cfg["decoder_dim"], cfg["joiner_dim"])
        self.vocab_proj = Linear(cfg["joiner_dim"], cfg["vocab_size"])

    def forward(self, enc, pred):
        h = torch.tanh(self.enc_proj(enc)[:, :, None, :]
                       + self.pred_proj(pred)[:, None, :, :])
        return self.vocab_proj(h)


class Transducer(nn.Module):
    """feats [B, T, F], frames [B], labels [B, S] -> (logits [B, T', S+1,
    V], T' [B])."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.predictor = Predictor(cfg)
        self.joint = Joint(cfg)

    def forward(self, feats, frames, labels):
        enc, tprime = self.encoder(feats, frames)
        return self.joint(enc, self.predictor(labels)), tprime


def build(cfg: dict, device="meta") -> Transducer:
    """The reference model with uninitialised parameters on `device`."""
    with torch.device(device):
        return Transducer(cfg)
