"""A frozen plain-PyTorch copy of the Conformer transducer the benchmark
trains: the reference its training cells are held against.

The model of Gulati et al. 2020 (arXiv:2005.08100) as the port builds it,
written out here from the equations so that the benchmark owns it:

* two stride-2 3x3 convolutions over (time, frequency) with ReLU, padded
  as XLA's "SAME" pads (the smaller half before), the padded frames zeroed
  after each; the [C, T, F] output read per frame with C fastest, then a
  linear projection to the model width;
* absolute sinusoidal positions (sines then cosines) added;
* each block: x + FFN/2, x + MHSA, x + Conv, x + FFN/2, then LayerNorm.
  FFN is LayerNorm, linear to 4d, SiLU, linear back; MHSA is LayerNorm
  and full multi-head attention over the valid frames (masked scores take
  the dtype's most negative number); Conv is LayerNorm, a pointwise
  linear to 2d, GLU, the padded frames zeroed, a depthwise convolution
  padded "SAME", LayerNorm (in place of the paper's BatchNorm), SiLU and
  a pointwise linear. LayerNorms take epsilon 1e-6;
* the predictor: an embedding of [BOS=0, y_1 .. y_S], one LSTM layer
  (input weights without a bias, recurrent weights with one; gates i, f,
  g, o) and a linear projection;
* the joint: tanh(W_e enc_t + W_p pred_s) projected to the vocabulary.

Parameter names and shapes are the port's, so that one set of weights
made by the benchmark loads into both. Dropout is not modelled: the cells
that use this reference run without it. Everything computes in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-6


def _same(n: int, kernel: int, stride: int):
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def _ln(norm: nn.LayerNorm, x):
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, EPS)


class FeedForward(nn.Module):
    def __init__(self, d: int, expansion: int):
        super().__init__()
        self.norm = nn.LayerNorm(d)
        self.dense1 = nn.Linear(d, d * expansion)
        self.dense2 = nn.Linear(d * expansion, d)

    def forward(self, x):
        return self.dense2(F.silu(self.dense1(_ln(self.norm, x))))


class MHSA(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm = nn.LayerNorm(d)
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)
        self.out = nn.Linear(d, d)

    def forward(self, x, pad_mask):
        y = _ln(self.norm, x)
        b, t, d = y.shape
        dh = d // self.heads

        def split(z):
            return z.view(b, t, self.heads, dh).transpose(1, 2)

        q = split(self.query(y)) / math.sqrt(dh)
        k, v = split(self.key(y)), split(self.value(y))
        w = (q @ k.transpose(-1, -2)).masked_fill(
            ~pad_mask[:, None, None, :], torch.finfo(y.dtype).min)
        o = (torch.softmax(w, dim=-1) @ v).transpose(1, 2).reshape(b, t, d)
        return self.out(o)


class ConvModule(nn.Module):
    def __init__(self, d: int, kernel: int):
        super().__init__()
        self.kernel = kernel
        self.norm1 = nn.LayerNorm(d)
        self.pointwise1 = nn.Linear(d, 2 * d)
        self.depthwise = nn.Conv1d(d, d, kernel, groups=d)
        self.norm2 = nn.LayerNorm(d)
        self.pointwise2 = nn.Linear(d, d)

    def forward(self, x, pad_mask):
        y = F.glu(self.pointwise1(_ln(self.norm1, x)), dim=-1)
        y = y * pad_mask[..., None].to(y.dtype)
        y = F.pad(y.transpose(1, 2), _same(y.shape[1], self.kernel, 1))
        y = F.conv1d(y, self.depthwise.weight, self.depthwise.bias,
                     groups=y.shape[1]).transpose(1, 2)
        return self.pointwise2(F.silu(_ln(self.norm2, y)))


class Block(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["dim"]
        self.ff1 = FeedForward(d, cfg["ff_expansion"])
        self.mhsa = MHSA(d, cfg["num_heads"])
        self.conv = ConvModule(d, cfg["conv_kernel"])
        self.ff2 = FeedForward(d, cfg["ff_expansion"])
        self.norm = nn.LayerNorm(d)

    def forward(self, x, pad_mask):
        x = x + 0.5 * self.ff1(x)
        x = x + self.mhsa(x, pad_mask)
        x = x + self.conv(x, pad_mask)
        x = x + 0.5 * self.ff2(x)
        return _ln(self.norm, x)


def _halve(n):
    return (n - 1) // 2 + 1


class Subsampler(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch = cfg["dim"] // 4
        stages = cfg["subsample_factor"].bit_length() - 1
        self.convs = nn.ModuleList(
            [nn.Conv2d(1 if i == 0 else ch, ch, 3, stride=2)
             for i in range(stages)])
        f = cfg["feat_dim"]
        for _ in range(stages):
            f = _halve(f)
        self.dense = nn.Linear(f * ch, cfg["dim"])

    def forward(self, feats, lengths):
        x = feats[:, None]
        for conv in self.convs:
            pad = _same(x.shape[3], 3, 2) + _same(x.shape[2], 3, 2)
            x = F.relu(F.conv2d(F.pad(x, pad), conv.weight, conv.bias,
                                stride=2))
            lengths = _halve(lengths)
            keep = (torch.arange(x.shape[2], device=x.device)[None, :]
                    < lengths[:, None])
            x = x * keep[:, None, :, None].to(x.dtype)
        b, c, t, f = x.shape
        return self.dense(x.permute(0, 2, 3, 1).reshape(b, t, f * c)), lengths


def positions(t: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    half = d // 2
    inv = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / half)
    pe = torch.cat([torch.sin(pos * inv), torch.cos(pos * inv)], dim=-1)
    return F.pad(pe, (0, d - pe.shape[-1]))


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.subsampler = Subsampler(cfg)
        self.blocks = nn.ModuleList([Block(cfg)
                                     for _ in range(cfg["num_layers"])])

    def forward(self, feats, lengths):
        t_idx = torch.arange(feats.shape[1], device=feats.device)
        feats = feats * (t_idx[None, :] < lengths[:, None])[..., None].to(
            feats.dtype)
        x, out_lengths = self.subsampler(feats, lengths)
        x = x + positions(x.shape[1], x.shape[2], x.device)
        pad_mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                    < out_lengths[:, None])
        x = x * pad_mask[..., None].to(x.dtype)
        for block in self.blocks:
            x = block(x, pad_mask)
        return x, out_lengths


class Cell(nn.Module):
    def __init__(self, inp: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, inp))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_hh = nn.Parameter(torch.empty(4 * hidden))


class Embed(nn.Module):
    """An embedding table (nn.Embedding's parameter, without its
    initialiser, whose meta-device path imports torch._dynamo)."""

    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, dim))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class Predictor(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        h = cfg["predictor_dim"]
        self.embed = Embed(cfg["vocab_size"], cfg["embed_dim"])
        self.cell = Cell(cfg["embed_dim"], h)
        self.out = nn.Linear(h, h)

    def forward(self, labels):
        bos = torch.zeros_like(labels[:, :1])
        gates_in = F.linear(self.embed(torch.cat([bos, labels], 1).long()),
                            self.cell.weight_ih)
        b, h = labels.shape[0], self.cell.weight_hh.shape[1]
        c = torch.zeros((b, h), device=labels.device)
        hid = torch.zeros_like(c)
        outs = []
        for k in range(gates_in.shape[1]):
            g = gates_in[:, k] + F.linear(hid, self.cell.weight_hh,
                                          self.cell.bias_hh)
            i, f, gg, o = g.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            hid = torch.sigmoid(o) * torch.tanh(c)
            outs.append(hid)
        return self.out(torch.stack(outs, dim=1))


class Joint(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.enc_proj = nn.Linear(cfg["dim"], cfg["joint_dim"])
        self.pred_proj = nn.Linear(cfg["predictor_dim"], cfg["joint_dim"])
        self.vocab_proj = nn.Linear(cfg["joint_dim"], cfg["vocab_size"])

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
