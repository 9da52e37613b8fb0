"""A frozen plain-PyTorch Emformer RNN-T: the reference that the Emformer
training cell is held against.

The model of Shi et al. 2021 (arXiv:2010.10759) as torchaudio's
``emformer_rnnt_base`` builds it (``torchaudio/models/rnnt.py`` and
``torchaudio/models/emformer.py``), written out here from its equations,
everything in float32 (the caller sets TF32 off). Sizes come from the
configuration's torchaudio names; L, R and the stride are in reduced
frames below (segment_length and right_context_length over the stride).

* LN(x) = (x - mean) / sqrt(var + eps) g + b over the last axis, eps 1e-5
  unless said; GELU(x) = x (1 + erf(x / sqrt 2)) / 2.
* The input: features zeroed past each utterance's n frames, R stride zero
  frames appended, times W_in (80 -> 128, no bias); each `stride` frames
  side by side (a partial group at the end dropped). T' = n // stride;
  the batch's stack has T = frames // stride utterance frames and R more.
* The right context: for segments i = 0 .. ceil(T / L) - 1, the R frames of
  each utterance's stack that start at min((i + 1) L, T'_b); the rows
  [RC; U] go through every layer.
* The mask: query row q of segment i keeps key k where k is one of
  segment i's R right-context rows, or an utterance frame u with
  max(i L - LC, 0) <= u < min((i + 1) L, T) and u < T'_b.
* A layer: Z = LN(X); Q = Z W_q + b_q; K, V the two halves of Z W_kv + b_kv;
  per head of 64, A = softmax(Q K^T / 8, the dropped scores at -1e8);
  Y = X + (A V) W_o + b_o; Y = Y + W_2 GELU(W_1 LN(Y) + b_1) + b_2;
  out = LN(Y). The output: the utterance rows, W_o' (512 -> 1024) + b,
  LN.
* The predictor: [blank, y_1 .. y_S] through an embedding, LN; each LSTM
  layer, from h = c = 0: g = LN_1e-3(W_x x_t + W_h h), (i, f, c~, o) its
  quarters, c = LN_1e-3(sigmoid(f) c + sigmoid(i) tanh(c~)),
  h = sigmoid(o) tanh(c); then W (512 -> 1024) + b, LN.
* The joint: W_j ReLU(enc_t + pred_s) + b_j.

Parameter names and shapes are the port's, so one set of seeded weights
loads into both. Nothing is dropped: the cell runs without dropout.
"""

from __future__ import annotations

import math

import torch
from torch import nn

MASKED = -1e8


def frames_valid(t: int, lengths):
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


class Linear(nn.Module):
    def __init__(self, inp: int, out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out, inp))
        self.bias = nn.Parameter(torch.empty(out)) if bias else None

    def forward(self, x):
        y = x @ self.weight.T
        return y if self.bias is None else y + self.bias


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(d))
        self.bias = nn.Parameter(torch.empty(d))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + \
            self.bias


def sizes(cfg: dict) -> dict:
    stride = cfg["time_reduction_stride"]
    return dict(stride=stride, red=cfg["time_reduction_input_dim"],
                d=cfg["time_reduction_input_dim"] * stride,
                heads=cfg["transformer_num_heads"],
                seg=cfg["segment_length"] // stride,
                rc=cfg["right_context_length"] // stride,
                lc=cfg["transformer_left_context_length"])


def block_mask(t: int, cfg: dict) -> torch.Tensor:
    """[n R + T, n R + T] bool, True where a row keeps a key, before key
    padding, set segment by segment."""
    z = sizes(cfg)
    seg, rc, lc = z["seg"], z["rc"], z["lc"]
    n = -(-t // seg)
    mask = torch.zeros(n * rc + t, n * rc + t, dtype=torch.bool)
    for i in range(n):
        rows = list(range(i * rc, (i + 1) * rc)) + [
            n * rc + u for u in range(i * seg, min((i + 1) * seg, t))]
        keys = list(range(i * rc, (i + 1) * rc)) + [
            n * rc + u for u in range(max(i * seg - lc, 0),
                                      min((i + 1) * seg, t))]
        for r in rows:
            mask[r, keys] = True
    return mask


class Layer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = sizes(cfg)["d"]
        self.heads = cfg["transformer_num_heads"]
        self.norm_in = LayerNorm(d)
        self.query = Linear(d, d)
        self.key_value = Linear(d, 2 * d)
        self.out = Linear(d, d)
        self.norm_ff = LayerNorm(d)
        self.ff_in = Linear(d, cfg["transformer_ffn_dim"])
        self.ff_out = Linear(cfg["transformer_ffn_dim"], d)
        self.norm_out = LayerNorm(d)

    def forward(self, x, keep):
        b, n, d = x.shape
        h = self.heads
        z = self.norm_in(x)
        q = self.query(z).reshape(b, n, h, d // h)
        kv = self.key_value(z)
        k = kv[..., :d].reshape(b, n, h, d // h)
        v = kv[..., d:].reshape(b, n, h, d // h)
        scores = torch.einsum("bqhc,bkhc->bhqk", q, k) / math.sqrt(d // h)
        scores = torch.where(keep[:, None], scores, MASKED)
        a = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqk,bkhc->bqhc", a, v).reshape(b, n, d)
        y = x + self.out(o)
        y = y + self.ff_out(gelu(self.ff_in(self.norm_ff(y))))
        return self.norm_out(y)


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        z = sizes(cfg)
        self.input_linear = Linear(cfg["feat_dim"], z["red"], bias=False)
        self.layers = nn.ModuleList([Layer(cfg) for _ in range(
            cfg["transformer_num_layers"])])
        self.output_linear = Linear(z["d"], cfg["encoding_dim"])
        self.output_norm = LayerNorm(cfg["encoding_dim"])

    def forward(self, feats, lengths):
        z = sizes(self.cfg)
        stride, seg, rc = z["stride"], z["seg"], z["rc"]
        b, frames, f = feats.shape
        x = feats * frames_valid(frames, lengths)[..., None]
        x = torch.cat([x, x.new_zeros(b, rc * stride, f)], dim=1)
        x = self.input_linear(x)
        t_all = x.shape[1] // stride
        x = x[:, :t_all * stride].reshape(b, t_all, z["d"])
        tprime = lengths // stride
        t = t_all - rc
        n = -(-t // seg)
        rows = torch.arange(b, device=x.device)
        blocks = []
        for i in range(n):
            start = torch.clamp(tprime, max=(i + 1) * seg)
            for r in range(rc):
                blocks.append(x[rows, start + r])
        x = torch.cat([torch.stack(blocks, dim=1), x[:, :t]], dim=1)
        key_ok = torch.cat([torch.ones(b, n * rc, dtype=torch.bool,
                                       device=x.device),
                            frames_valid(t, tprime)], dim=1)
        keep = block_mask(t, self.cfg).to(x.device)[None] & key_ok[:, None]
        for layer in self.layers:
            x = layer(x, keep)
        return self.output_norm(self.output_linear(x[:, n * rc:])), tprime


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, dim))


class Cell(nn.Module):
    def __init__(self, inp: int, hidden: int, eps: float):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, inp))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.g_norm = LayerNorm(4 * hidden, eps)
        self.c_norm = LayerNorm(hidden, eps)

    def forward(self, x):
        """x [B, S1, inp] -> every step's h [B, S1, hidden]."""
        hidden = self.weight_hh.shape[1]
        h = c = x.new_zeros(x.shape[0], hidden)
        gx = x @ self.weight_ih.T
        out = []
        for s in range(x.shape[1]):
            g = self.g_norm(gx[:, s] + h @ self.weight_hh.T)
            i, f, cand, o = g.split(hidden, dim=-1)
            c = self.c_norm(torch.sigmoid(f) * c
                            + torch.sigmoid(i) * torch.tanh(cand))
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class Predictor(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.blank = cfg["blank_id"]
        e = cfg["symbol_embedding_dim"]
        eps = cfg["lstm_layer_norm_epsilon"]
        self.embed = Embedding(cfg["vocab_size"], e)
        self.embed_norm = LayerNorm(e)
        self.cells = nn.ModuleList([Cell(e, e, eps) for _ in range(
            cfg["num_lstm_layers"])])
        self.out = Linear(e, cfg["encoding_dim"])
        self.out_norm = LayerNorm(cfg["encoding_dim"])

    def forward(self, labels):
        first = torch.full((labels.shape[0], 1), self.blank,
                           dtype=torch.long, device=labels.device)
        x = self.embed.weight[torch.cat([first, labels.long()], dim=1)]
        x = self.embed_norm(x)
        for cell in self.cells:
            x = cell(x)
        return self.out_norm(self.out(x))


class Joint(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.vocab_proj = Linear(cfg["encoding_dim"], cfg["vocab_size"])

    def forward(self, enc, pred):
        return self.vocab_proj(torch.relu(enc[:, :, None] + pred[:, None]))


class Transducer(nn.Module):
    """feats [B, T, F], frames [B], labels [B, S] -> (logits
    [B, T'_max, S + 1, V], T' [B])."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.predictor = Predictor(cfg)
        self.joint = Joint(cfg)

    def forward(self, feats, frames, labels):
        enc, tprime = self.encoder(feats, frames)
        return self.joint(enc, self.predictor(labels)), tprime


def build(cfg: dict, device="meta") -> Transducer:
    """The model with uninitialised parameters (load weights into it)."""
    with torch.device(device):
        return Transducer(cfg)
