"""External language models for shallow fusion in beam search.

PyTorch counterpart of ``monotonic_rnnt_tpu/models/lm.py``. The
decoder-side LM protocol mirrors the predictor's stepwise interface so
per-hypothesis states ride the same beam machinery (gather by parent,
advance on emission):

    state = lm.init_state(n)                 # n parallel hypotheses
    state, logp = lm.step(state, tokens)     # consume tokens [n] (0 = BOS),
                                             # return log P(next | history) [n, V]

A state is a tensor or a tuple of tensors, each with the hypotheses on its
first axis; ``logp`` is float32. Fusion (``models/transducer.py``
``beam_search_decode``): label candidates score ``logp_am + lm_weight *
logp_lm``; blank is never LM-scored (the LM models the label sequence, not
the frame alignment). Any stateful model fits the protocol:
``ModuleLmAdapter`` binds an ``nn.Module`` with ``init_state``/``step``;
``BigramLm`` is the minimal reference implementation (and the test
vehicle); ``LstmLm`` a trainable neural LM, whose flax twin's parameters
``convert.lstm_lm_params_from_flax`` loads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import _device
from .conformer import dense
from .init import finish_init
from .predictor import LstmCell, _embed


class BigramLm:
    """Table-lookup bigram LM: log P(next | prev) from a [V, V] matrix.

    Row i is the next-token log-distribution after token i; row 0 doubles
    as the BOS distribution (token 0 = BOS, matching the predictor's
    convention). The state is the last token, a bare [n] int32 tensor. The
    table is float32 on `device` (the card unless the caller names another).
    """

    def __init__(self, log_probs, device="cuda"):
        table = (log_probs if isinstance(log_probs, torch.Tensor)
                 else torch.from_numpy(np.array(log_probs, np.float32)))
        if table.dim() != 2 or table.shape[0] != table.shape[1]:
            raise ValueError(f"expected square [V, V] matrix, got "
                             f"{tuple(table.shape)}")
        self.log_probs = table.to(_device(device), torch.float32)

    def init_state(self, n: int) -> torch.Tensor:
        return torch.zeros((n,), dtype=torch.int32,
                           device=self.log_probs.device)

    def step(self, state, tokens):
        tokens = tokens.to(torch.int32)
        return tokens, self.log_probs[tokens.long()]


@dataclasses.dataclass(frozen=True)
class LstmLmConfig:
    vocab_size: int = 1024
    dim: int = 256
    embed_dim: int = 128
    dtype: torch.dtype = torch.bfloat16


class LstmLm(nn.Module):
    """Embedding + LSTM + vocab projection: a trainable neural LM.

    ``forward`` gives teacher-forced next-token log-probs for training
    (position i predicts tokens[:, i] from tokens[:, :i], BOS-shifted like
    the transducer predictor); ``init_state``/``step`` give the stepwise
    form. The cell is the predictor's flax-equal ``LstmCell`` (one bias a
    gate, float32 carry); parameters are drawn on the CPU from `generator`
    with flax's initialisers, then moved to `device`.
    """

    def __init__(self, cfg: LstmLmConfig, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.cell = LstmCell(cfg.embed_dim, cfg.dim)
        self.out = nn.Linear(cfg.dim, cfg.vocab_size)
        finish_init(self, generator, device)

    def _log_probs(self, h):
        return F.log_softmax(dense(self.out, h, self.cfg.dtype).float(),
                             dim=-1)

    def _input_gates(self, tokens):
        dt = self.cfg.dtype
        return self.cell.input_gates(_embed(self.embed, tokens, dt), dt)

    def forward(self, tokens):
        """tokens [B, S] -> next-token log-probs [B, S, V] f32 (BOS-shifted)."""
        tokens = tokens.to(self.out.weight.device)
        hist = torch.cat([torch.zeros_like(tokens[:, :1]), tokens[:, :-1]],
                         dim=1)
        gates = self._input_gates(hist)                    # [B, S, 4D]
        state = self.init_state(tokens.shape[0])
        hs = []
        for k in range(gates.shape[1]):
            state = self.cell.advance(state, gates[:, k], self.cfg.dtype)
            hs.append(state[1])
        return self._log_probs(torch.stack(hs, dim=1))

    def init_state(self, batch: int):
        return self.cell.zero_state(batch)

    def step(self, state, tokens):
        """Consume tokens [n] (0 = BOS); returns (state, logp [n, V] f32)."""
        state = self.cell.advance(state, self._input_gates(tokens),
                                  self.cfg.dtype)
        return state, self._log_probs(state[1])


class ModuleLmAdapter:
    """Bind an ``nn.Module`` with ``init_state``/``step`` methods into the
    fusion protocol, in eval mode and without autograd: the bridge from any
    trained torch LM to ``beam_search_decode(lm=...)`` (the counterpart of
    the JAX package's ``FlaxLmAdapter``)."""

    def __init__(self, module: nn.Module):
        for name in ("init_state", "step"):
            if not callable(getattr(module, name, None)):
                raise TypeError(f"{type(module).__name__} has no {name}(); "
                                "the LM protocol needs init_state and step")
        self.module = module.eval()

    @torch.no_grad()
    def init_state(self, n: int):
        return self.module.init_state(n)

    @torch.no_grad()
    def step(self, state, tokens):
        return self.module.step(state, tokens)
