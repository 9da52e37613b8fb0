"""Label-context prediction networks for the transducer.

PyTorch counterpart of ``monotonic_rnnt_tpu/models/predictor.py``. One
context vector per label position s in [0, S]; position 0 is the empty
history (the lattice's s=0 row). Two families:

  * LstmPredictor: embedding + unidirectional LSTM over the label sequence;
    with ``layer_norm`` and ``num_layers`` it is torchaudio's ``_Predictor``
    of the Emformer RNN-T (a LayerNorm on the embedding, stacked
    ``_CustomLSTM`` layers that normalise their gates and their cell and
    have no gate biases, a projection to ``out_dim`` and a LayerNorm);
  * ConvPredictor: stateless limited-context predictor (embedding + causal
    conv). With ``stateless`` it is icefall's stateless decoder (a conv in
    ``dim // 4`` groups without a bias, then ReLU, and no output layer: the
    joint projects), which the Zipformer transducer takes.

Both expose, besides the batched training ``forward``, a stepwise decoding
interface, so frame-synchronous decoders advance in O(1) work per emitted
label (position 0's input is ``bos_id``, 0 unless the model's blank is
given there):

    state = predictor.init_state(batch)          # context for empty history
    state, ctx = predictor.step(state, tokens)   # advance with emitted token

For the LSTM the state is flax's carry ``(c, h)``, in float32 whatever the
compute dtype (flax's carry starts in the parameter dtype, and ``f * c``
promotes), one a layer in a tuple where there are several; for the conv
predictor it is a ring of the last ``context``
token ids with a validity mask. The LSTM's parameters are flax's
``OptimizedLSTMCell``'s and no more (``LstmCell``): input kernels without a
bias and hidden kernels with one, gates i, f, g, o stacked as
``nn.LSTMCell`` stacks them. ``nn.LSTMCell`` carries a second bias, which
would take its own optimiser step; the gates are formed here, as flax
forms them, so that each matmul runs in the compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .conformer import dense, layer_norm
from .init import finish_init

# torchaudio's emformer_rnnt_base: lstm_layer_norm_epsilon.
LSTM_LAYER_NORM_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    vocab_size: int = 1024           # includes blank
    dim: int = 256
    embed_dim: int = 128
    context: int = 2                 # ConvPredictor history length
    stateless: bool = False          # ConvPredictor as icefall's decoder
    dtype: torch.dtype = torch.bfloat16
    bos_id: int = 0                  # position 0's input id
    num_layers: int = 1              # stacked LSTM layers
    layer_norm: bool = False         # torchaudio's LN-LSTM predictor
    out_dim: int = 0                 # the output projection's width (0: dim)

    @property
    def output_dim(self) -> int:
        """The width of the context vectors, the joint's input."""
        return self.out_dim or self.dim


def _shift_with_bos(labels: torch.Tensor, bos_id: int = 0) -> torch.Tensor:
    """[B, S] labels -> [B, S+1] history inputs (position 0 = bos_id)."""
    bos = torch.full((labels.shape[0], 1), bos_id, dtype=labels.dtype,
                     device=labels.device)
    return torch.cat([bos, labels], dim=1)


def _embed(table: nn.Embedding, tokens, dtype):
    return F.embedding(tokens.long(), table.weight.to(dtype))


class LstmCell(nn.Module):
    """flax's OptimizedLSTMCell parameters: weight_ih [4*hidden, input] (no
    bias), weight_hh [4*hidden, hidden] and bias_hh [4*hidden], gates i, f,
    g, o along the first axis. With ``layer_norm`` it is torchaudio's
    ``_CustomLSTM(layer_norm=True)``: no bias_hh; the gates' pre-activations
    normalised by g_norm (LayerNorm over 4*hidden) and the new cell by
    c_norm (LayerNorm over hidden), which is the cell carried on; both
    with the Emformer RNN-T's epsilon, LSTM_LAYER_NORM_EPS."""

    def __init__(self, input_size: int, hidden_size: int,
                 layer_norm: bool = False):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_size,
                                                  hidden_size))
        if layer_norm:
            self.bias_hh = None
            self.g_norm = nn.LayerNorm(4 * hidden_size,
                                       eps=LSTM_LAYER_NORM_EPS)
            self.c_norm = nn.LayerNorm(hidden_size, eps=LSTM_LAYER_NORM_EPS)
        else:
            self.bias_hh = nn.Parameter(torch.empty(4 * hidden_size))
            self.g_norm = self.c_norm = None

    def zero_state(self, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """flax's initial carry (c, h): zeros, float32."""
        zeros = torch.zeros((batch, self.hidden_size), dtype=torch.float32,
                            device=self.weight_hh.device)
        return zeros, zeros

    def input_gates(self, emb, dtype):
        """The input's gate pre-activations [..., 4*hidden] (no bias)."""
        return F.linear(emb.to(dtype), self.weight_ih.to(dtype))

    def advance(self, state, input_gates, dtype):
        """One LSTM step from the input's gate pre-activations."""
        c, h = state
        if self.g_norm is None:
            gates = input_gates + F.linear(h.to(dtype),
                                           self.weight_hh.to(dtype),
                                           self.bias_hh.to(dtype))
        else:
            gates = layer_norm(self.g_norm, input_gates + F.linear(
                h.to(dtype), self.weight_hh.to(dtype)), dtype)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        if self.c_norm is not None:
            c = F.layer_norm(c.float(), self.c_norm.normalized_shape,
                             self.c_norm.weight, self.c_norm.bias,
                             self.c_norm.eps)
        return c, torch.sigmoid(o) * torch.tanh(c)


class LstmPredictor(nn.Module):
    """One LSTM layer (``cell``, flax's parameters), or with ``num_layers``
    > 1 a stack (``cells``); with ``layer_norm`` the embedding's LayerNorm
    (``embed_norm``), LN-LSTM cells and the output's LayerNorm
    (``out_norm``). ``layers`` holds the cells in both cases.

    The decoding state of one layer stays flax's bare carry (c, h), not a
    one-element tuple: the streaming state's ``pstate`` holds JAX's carry,
    which the parity tests compare and ``serving.py``'s artifacts export.
    A stack's state is a tuple of its layers' carries; ``init_state`` and
    ``step`` are the only places that tell the two apart."""

    def __init__(self, cfg: PredictorConfig, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        if cfg.layer_norm:
            self.embed_norm = nn.LayerNorm(cfg.embed_dim)
        cells = [LstmCell(cfg.dim if k else cfg.embed_dim, cfg.dim,
                          cfg.layer_norm)
                 for k in range(cfg.num_layers)]
        if cfg.num_layers == 1:
            self.cell = cells[0]
        else:
            self.cells = nn.ModuleList(cells)
        self.layers = tuple(cells)
        self.out = nn.Linear(cfg.dim, cfg.output_dim)
        if cfg.layer_norm:
            self.out_norm = nn.LayerNorm(cfg.output_dim)
        finish_init(self, generator, device)

    def _embedded(self, tokens):
        dt = self.cfg.dtype
        x = _embed(self.embed, tokens, dt)
        return layer_norm(self.embed_norm, x, dt) if self.cfg.layer_norm else x

    def _out(self, h):
        dt = self.cfg.dtype
        y = dense(self.out, h, dt)
        if self.cfg.layer_norm:
            y = layer_norm(self.out_norm, y, dt)
        return y.float()

    def forward(self, labels, deterministic: bool = True):
        dt = self.cfg.dtype
        x = self._embedded(_shift_with_bos(labels, self.cfg.bos_id))
        for cell in self.layers:
            gates = cell.input_gates(x, dt)                  # [B, S+1, 4D]
            state = cell.zero_state(labels.shape[0])
            hs = []
            for k in range(gates.shape[1]):
                state = cell.advance(state, gates[:, k], dt)
                hs.append(state[1])
            x = torch.stack(hs, dim=1)
        return self._out(x)

    def init_state(self, batch: int):
        """(c, h) of the one layer, or a tuple of each layer's."""
        states = tuple(cell.zero_state(batch) for cell in self.layers)
        return states[0] if len(states) == 1 else states

    def step(self, state, tokens: torch.Tensor):
        """Advance with one token per sample. tokens [B] int (bos_id = BOS).

        Returns (new_state, ctx [B, output_dim] f32): ctx is the context
        vector *after* consuming `tokens` (position len(history) in forward
        terms).
        """
        dt = self.cfg.dtype
        layered = len(self.layers) > 1
        x = self._embedded(tokens)
        new = []
        for cell, s in zip(self.layers, state if layered else (state,)):
            s = cell.advance(s, cell.input_gates(x, dt), dt)
            new.append(s)
            x = s[1]
        return (tuple(new) if layered else new[0]), self._out(x)


class ConvPredictor(nn.Module):
    def __init__(self, cfg: PredictorConfig, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.groups = cfg.dim // 4 if cfg.stateless else 1
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.conv = nn.Conv1d(cfg.embed_dim, cfg.dim, cfg.context,
                              groups=self.groups, bias=not cfg.stateless)
        self.out = None if cfg.stateless else nn.Linear(cfg.dim, cfg.dim)
        finish_init(self, generator, device)

    def _conv(self, emb):
        """VALID conv over [B, L, E] -> relu'd [B, L - context + 1, dim]."""
        dt = self.cfg.dtype
        bias = self.conv.bias
        y = F.conv1d(emb.transpose(1, 2), self.conv.weight.to(dt),
                     None if bias is None else bias.to(dt),
                     groups=self.groups)
        return F.relu(y.transpose(1, 2))

    def _out(self, y):
        if self.out is None:
            return y.float()
        return dense(self.out, y, self.cfg.dtype).float()

    def forward(self, labels, deterministic: bool = True):
        cfg = self.cfg
        emb = _embed(self.embed, _shift_with_bos(labels, cfg.bos_id),
                     cfg.dtype)
        # Causal conv: pad left so position s sees only labels < s.
        return self._out(self._conv(F.pad(emb, (0, 0, cfg.context - 1, 0))))

    def init_state(self, batch: int):
        # Ring of the last `context` tokens with a validity mask: unfilled
        # slots enter the conv as zero VECTORS, matching the training path's
        # zero left-padding (embed(bos_id) is the BOS embedding, distinct
        # from padding). The decoder's first step pushes BOS (bos_id).
        dev = self.embed.weight.device
        ctx = self.cfg.context
        return (torch.zeros((batch, ctx), dtype=torch.int32, device=dev),
                torch.zeros((batch, ctx), dtype=torch.bool, device=dev))

    def step(self, state, tokens: torch.Tensor):
        """Push one token per sample; returns ctx after consuming it."""
        ring, filled = state
        ring = torch.cat([ring[:, 1:], tokens[:, None].to(ring.dtype)], dim=1)
        filled = torch.cat([filled[:, 1:], torch.ones_like(filled[:, :1])],
                           dim=1)
        emb = _embed(self.embed, ring, self.cfg.dtype)
        emb = emb * filled[..., None].to(emb.dtype)
        return (ring, filled), self._out(self._conv(emb)[:, 0])
