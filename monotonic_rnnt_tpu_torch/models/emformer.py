"""Emformer encoder (Shi et al. 2021, arXiv:2010.10759), the port's third
acoustic encoder family, in its training form: block processing.

It follows torchaudio's ``emformer_rnnt_base`` (``torchaudio/models/rnnt.py``
``_EmformerEncoder`` and ``torchaudio/models/emformer.py``); the defaults
are that model's. Notation: x is [B, T, d]. Parameters stay float32 and
each layer computes in ``cfg.dtype``, as the Conformer's do; LayerNorm and
the softmax take their statistics in float32.

  * Embed (``mrnnt.emformer.embed``): the 10 ms features, zero past each
    utterance's end, right-padded with R * stride zero frames;
    ``Linear(80 -> 128, no bias)``; each 4 frames stacked to 512, a trailing
    partial group dropped. An utterance of n frames has T' = n // 4 frames
    at 40 ms; the stack gets T = (padded frames) // 4 of them, plus R.
  * Right-context blocks (``mrnnt.emformer.rc_blocks``), segment L = 4 and
    right context R = 1 reduced frames, n = ceil(T / L) segments: block i
    copies R frames of the reduced input, from (i + 1) L for i < n - 1 and
    from T for the last (torchaudio's ``_gen_right_context``). The layer
    input is [RC; U], n R rows then the T utterance rows, and every layer
    carries both on.
  * Layer (``mrnnt.emformer.layer<i>``; no memory bank): Z = LN_in(X);
    Q = Z W_q + b_q, [K | V] = Z W_kv + b_kv; each of 8 heads of 64 takes
    softmax(Q K^T / 8 + M) V (``mrnnt.emformer.attend``), masked scores at
    -1e8; Y = X + (A V) W_o + b_o; Y += W_2 GELU(W_1 LN_ff(Y) + b_1) + b_2;
    out = LN_out(Y).
  * Mask M (``attention_mask``): a query row of segment i (one of its R
    right-context rows or its utterance rows iL .. min((i + 1) L, T) - 1)
    keeps the right-context keys [iR, (i + 1) R) and the utterance keys
    [max(iL - LC, 0), min((i + 1) L, T)), LC = 30, less the utterance keys
    at or past the utterance's T' (key padding). Every row keeps its own
    right-context key.
  * Output: the last layer's utterance rows, ``Linear(512 -> 1024)``,
    LayerNorm(1024); the lengths T'.

The attention is one dense masked product over all n R + T keys of every
row; the mask keeps ~35 of them (``counters()["emformer"]``: ``attn_cells``
the score cells computed, ``attn_kept`` those the block mask keeps at the
padded length, ``rc_rows`` the right-context rows carried, all counted
from shapes on the host).

Departures from torchaudio:

  * Padding independence: block i of an utterance copies from
    min((i + 1) L, T'_b), so its last segment's block, and every block
    past its end, read what a batch of one reads (its own frames, then
    zeros); torchaudio's batched blocks let a shorter utterance's last
    segment see the batch's padding. An utterance's output does not depend
    on its batch.
  * No dropout (torchaudio's 0.1 in the layers): the benchmark's
    configuration runs without it.
  * Initialisation: flax's defaults (models/init.py), then layer i's query
    and key-value weights times 1 / sqrt(i + 1), torchaudio's
    ``weight_init_scale_strategy="depthwise"`` gain.
  * Not the port's chunked streaming: that recomputes a causal Conformer
    over a window; the Emformer's own streaming inference (cached
    left-context keys) is not implemented.

Nothing here reads device data on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..convert import _device
from ..utils.profiling import EMFORMER, span
from .conformer import dense, layer_norm
from .init import init_like_flax

MASKED_SCORE = -1e8      # torchaudio's fill for masked scores


@dataclasses.dataclass(frozen=True)
class EmformerConfig:
    num_layers: int = 20
    reduction_dim: int = 128         # input_linear's width
    stride: int = 4                  # frames stacked by the time reduction
    num_heads: int = 8
    ffn_dim: int = 2048
    segment_length: int = 4          # reduced frames (16 input frames)
    right_context: int = 1           # reduced frames (4 input frames)
    left_context: int = 30           # reduced frames
    output_dim: int = 1024
    dtype: torch.dtype = torch.bfloat16  # compute dtype; params stay f32

    @property
    def model_dim(self) -> int:
        """The layers' width: stride frames of reduction_dim."""
        return self.reduction_dim * self.stride

    @property
    def dim(self) -> int:
        """The encoder's output width, the joint's input."""
        return self.output_dim


def attention_mask(t: int, cfg: EmformerConfig, device=None) -> torch.Tensor:
    """[n R + T, n R + T] bool on `device`, True where a query row (first
    axis) keeps a key, before key padding; rows and keys are [RC; U]. Made
    there, so that no copy waits for the device's queue."""
    seg_len, rc, lc = cfg.segment_length, cfg.right_context, cfg.left_context
    n = -(-t // seg_len)
    rows = torch.arange(n * rc + t, device=device)
    seg = torch.where(rows < n * rc, rows // rc, (rows - n * rc) // seg_len)
    is_rc = rows < n * rc
    u = rows - n * rc                                  # utterance index
    seg_q, seg_k = seg[:, None], seg[None, :]
    keep_u = (u[None, :] >= seg_q * seg_len - lc) & (
        u[None, :] < (seg_q + 1) * seg_len)
    return torch.where(is_rc[None, :], seg_k == seg_q, keep_u)


def dropped_scores(t: int, lengths, cfg: EmformerConfig) -> torch.Tensor:
    """[B, 1, n R + T, n R + T] bool on the lengths' device, True where the
    block mask or the key padding (utterance keys at or past T'_b) drops a
    score."""
    n_rc = -(-t // cfg.segment_length) * cfg.right_context
    keys = torch.arange(n_rc + t, device=lengths.device)
    key_valid = (keys[None, :] < n_rc) | (keys[None, :] - n_rc
                                          < lengths[:, None])
    return ~(attention_mask(t, cfg, lengths.device)[None]
             & key_valid[:, None, :])[:, None]


def kept_cells(t: int, cfg: EmformerConfig) -> int:
    """The cells attention_mask(t, cfg) keeps, counted from its segments."""
    seg_len, rc, lc = cfg.segment_length, cfg.right_context, cfg.left_context
    kept = 0
    for i in range(-(-t // seg_len)):
        end = min((i + 1) * seg_len, t)
        kept += (rc + end - i * seg_len) * (rc + end - max(i * seg_len - lc,
                                                           0))
    return kept


class EmformerLayer(nn.Module):
    def __init__(self, cfg: EmformerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.model_dim
        self.norm_in = nn.LayerNorm(d)
        self.query = nn.Linear(d, d)
        self.key_value = nn.Linear(d, 2 * d)
        self.out = nn.Linear(d, d)
        self.norm_ff = nn.LayerNorm(d)
        self.ff_in = nn.Linear(d, cfg.ffn_dim)
        self.ff_out = nn.Linear(cfg.ffn_dim, d)
        self.norm_out = nn.LayerNorm(d)

    def _attend(self, z, masked):
        """z [B, N, d], masked [B, 1, N, N] (True: a score the mask drops)
        -> the attention's output."""
        dt, h = self.cfg.dtype, self.cfg.num_heads
        b, n, d = z.shape
        heads = lambda x: x.view(b, n, h, d // h).transpose(1, 2)
        q = heads(dense(self.query, z, dt)) * (d // h) ** -0.5
        k, v = dense(self.key_value, z, dt).chunk(2, dim=-1)
        scores = (q @ heads(k).transpose(-1, -2)).masked_fill(masked,
                                                               MASKED_SCORE)
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        o = (probs @ heads(v)).transpose(1, 2).reshape(b, n, d)
        return dense(self.out, o, dt)

    def forward(self, x, masked):
        dt = self.cfg.dtype
        with span("mrnnt.emformer.attend"):
            y = x + self._attend(layer_norm(self.norm_in, x, dt), masked)
        f = F.gelu(dense(self.ff_in, layer_norm(self.norm_ff, y, dt), dt))
        return layer_norm(self.norm_out, y + dense(self.ff_out, f, dt), dt)


class EmformerEncoder(nn.Module):
    """feats [B, T, feat_dim] + frame lengths -> (encodings [B, T', D] f32,
    lengths'), D = cfg.dim."""

    def __init__(self, cfg: EmformerConfig, feat_dim: int = 80, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.input_linear = nn.Linear(feat_dim, cfg.reduction_dim,
                                      bias=False)
        self.layers = nn.ModuleList([EmformerLayer(cfg)
                                     for _ in range(cfg.num_layers)])
        self.output_linear = nn.Linear(cfg.model_dim, cfg.output_dim)
        self.output_norm = nn.LayerNorm(cfg.output_dim)
        init_like_flax(self, generator)
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                layer.query.weight.mul_(1 / math.sqrt(i + 1))
                layer.key_value.weight.mul_(1 / math.sqrt(i + 1))
        self.to(_device(device))

    def _embed(self, feats, feat_lengths):
        """The reduced input [B, T + R, d] and the lengths T'."""
        cfg, dt = self.cfg, self.cfg.dtype
        b, frames, _ = feats.shape
        valid = (torch.arange(frames, device=feats.device)[None, :]
                 < feat_lengths[:, None])
        x = F.pad(feats * valid[..., None].to(feats.dtype),
                  (0, 0, 0, cfg.right_context * cfg.stride))
        x = F.linear(x.to(dt), self.input_linear.weight.to(dt))
        t_all = x.shape[1] // cfg.stride
        x = x[:, :t_all * cfg.stride].reshape(b, t_all, cfg.model_dim)
        return x, feat_lengths // cfg.stride

    def _right_context(self, x, lengths, n: int):
        """[B, n R, d]: block i of each utterance copies R frames from
        min((i + 1) L, T'_b)."""
        cfg = self.cfg
        b, _, d = x.shape
        dev = x.device
        starts = torch.minimum(
            (torch.arange(n, device=dev) + 1) * cfg.segment_length,
            lengths[:, None].to(torch.long))
        idx = (starts[:, :, None] + torch.arange(cfg.right_context,
                                                 device=dev)).reshape(b, -1)
        return x.gather(1, idx[..., None].expand(b, idx.shape[1], d))

    def forward(self, feats, feat_lengths, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """deterministic and generator are the Conformer's; nothing here
        draws."""
        cfg, dt = self.cfg, self.cfg.dtype
        with span("mrnnt.emformer.embed"):
            x, lengths = self._embed(feats, feat_lengths)
        b, t = x.shape[0], x.shape[1] - cfg.right_context
        n = -(-t // cfg.segment_length)
        rows = n * cfg.right_context
        with span("mrnnt.emformer.rc_blocks"):
            x = torch.cat([self._right_context(x, lengths, n), x[:, :t]],
                          dim=1)
        masked = dropped_scores(t, lengths, cfg)
        maps = b * cfg.num_heads * cfg.num_layers     # attention maps
        EMFORMER["attn_cells"] += maps * (rows + t) ** 2
        EMFORMER["attn_kept"] += maps * kept_cells(t, cfg)
        EMFORMER["rc_rows"] += b * rows
        for i, layer in enumerate(self.layers):
            with span(f"mrnnt.emformer.layer{i}"):
                x = layer(x, masked)
        out = dense(self.output_linear, x[:, rows:], dt)
        return layer_norm(self.output_norm, out, dt).float(), lengths
