"""Label-context prediction networks for the transducer.

PyTorch counterpart of ``monotonic_rnnt_tpu/models/predictor.py``. One
context vector per label position s in [0, S]; position 0 is the empty
history (the lattice's s=0 row). Two families:

  * LstmPredictor: embedding + unidirectional LSTM over the label sequence;
  * ConvPredictor: stateless limited-context predictor (embedding + causal
    conv).

Both expose, besides the batched training ``forward``, a stepwise decoding
interface, so frame-synchronous decoders advance in O(1) work per emitted
label:

    state = predictor.init_state(batch)          # context for empty history
    state, ctx = predictor.step(state, tokens)   # advance with emitted token

For the LSTM the state is flax's carry ``(c, h)``, in float32 whatever the
compute dtype (flax's carry starts in the parameter dtype, and ``f * c``
promotes); for the conv predictor it is a ring of the last ``context``
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

from .conformer import dense
from .init import finish_init


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    vocab_size: int = 1024           # includes blank
    dim: int = 256
    embed_dim: int = 128
    context: int = 2                 # ConvPredictor history length
    dtype: torch.dtype = torch.bfloat16


def _shift_with_bos(labels: torch.Tensor) -> torch.Tensor:
    """[B, S] labels -> [B, S+1] history inputs (position 0 = BOS=0)."""
    bos = torch.zeros((labels.shape[0], 1), dtype=labels.dtype,
                      device=labels.device)
    return torch.cat([bos, labels], dim=1)


def _embed(table: nn.Embedding, tokens, dtype):
    return F.embedding(tokens.long(), table.weight.to(dtype))


class LstmCell(nn.Module):
    """flax's OptimizedLSTMCell parameters: weight_ih [4*hidden, input] (no
    bias), weight_hh [4*hidden, hidden] and bias_hh [4*hidden], gates i, f,
    g, o along the first axis."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_size,
                                                  hidden_size))
        self.bias_hh = nn.Parameter(torch.empty(4 * hidden_size))

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
        gates = input_gates + F.linear(h.to(dtype), self.weight_hh.to(dtype),
                                       self.bias_hh.to(dtype))
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


class LstmPredictor(nn.Module):
    def __init__(self, cfg: PredictorConfig, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.cell = LstmCell(cfg.embed_dim, cfg.dim)
        self.out = nn.Linear(cfg.dim, cfg.dim)
        finish_init(self, generator, device)

    def _input_gates(self, tokens):
        dt = self.cfg.dtype
        return self.cell.input_gates(_embed(self.embed, tokens, dt), dt)

    def forward(self, labels, deterministic: bool = True):
        gates = self._input_gates(_shift_with_bos(labels))   # [B, S+1, 4D]
        state = self.init_state(labels.shape[0])
        hs = []
        for k in range(gates.shape[1]):
            state = self.cell.advance(state, gates[:, k], self.cfg.dtype)
            hs.append(state[1])
        return dense(self.out, torch.stack(hs, dim=1), self.cfg.dtype).float()

    def init_state(self, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cell.zero_state(batch)

    def step(self, state, tokens: torch.Tensor):
        """Advance with one token per sample. tokens [B] int (0 = BOS).

        Returns (new_state, ctx [B, dim] f32): ctx is the context vector
        *after* consuming `tokens` (position len(history) in forward terms).
        """
        state = self.cell.advance(state, self._input_gates(tokens),
                                  self.cfg.dtype)
        return state, dense(self.out, state[1], self.cfg.dtype).float()


class ConvPredictor(nn.Module):
    def __init__(self, cfg: PredictorConfig, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.conv = nn.Conv1d(cfg.embed_dim, cfg.dim, cfg.context)
        self.out = nn.Linear(cfg.dim, cfg.dim)
        finish_init(self, generator, device)

    def _conv(self, emb):
        """VALID conv over [B, L, E] -> relu'd [B, L - context + 1, dim]."""
        dt = self.cfg.dtype
        y = F.conv1d(emb.transpose(1, 2), self.conv.weight.to(dt),
                     self.conv.bias.to(dt))
        return F.relu(y.transpose(1, 2))

    def forward(self, labels, deterministic: bool = True):
        cfg = self.cfg
        emb = _embed(self.embed, _shift_with_bos(labels), cfg.dtype)
        # Causal conv: pad left so position s sees only labels < s.
        y = self._conv(F.pad(emb, (0, 0, cfg.context - 1, 0)))
        return dense(self.out, y, cfg.dtype).float()

    def init_state(self, batch: int):
        # Ring of the last `context` tokens with a validity mask: unfilled
        # slots enter the conv as zero VECTORS, matching the training path's
        # zero left-padding (embed(0) is the BOS embedding, distinct from
        # padding). The decoder's first step pushes BOS (token 0).
        dev = self.out.weight.device
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
        y = self._conv(emb)[:, 0]
        return (ring, filled), dense(self.out, y, self.cfg.dtype).float()
