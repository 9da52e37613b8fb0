"""Conformer-transducer: encoder + predictor + joint -> monotonic RNN-T loss.

PyTorch counterpart of ``monotonic_rnnt_tpu/models/transducer.py``. The
joint network produces the per-(t, s) logits the loss consumes
([B, T', S+1, V], float32 whatever the compute dtype), so the loss runs the
port's float32 kernels: on the card ``stats_alpha_fused`` in the forward
and ``beta_grad_fused`` in the backward (the deferred route of
``ops/loss.py``). The joint also runs as the ``joint_fn`` of the
fused-joint losses (``Joint.joint_fn``, ``Joint.banded_fn`` and
``Joint.joint_params``), which never hold the whole logits tensor.

Greedy decoding: monotonic RNN-T makes exactly one decision per frame (emit
a label or blank), so decoding is one loop over the encoder frames, on the
device, with no copy to the host inside it.

Eager validation differs from the JAX model under ``jit``: there a sample
with fewer encoder frames than labels (T'_b < S_b) costs +inf, because the
length check is skipped on traced lengths; here the loss checks the
lengths and raises ``RnntError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..convert import _device
from ..ops.loss import monotonic_rnnt_loss
from .conformer import ConformerConfig, ConformerEncoder
from .init import finish_init
from .predictor import ConvPredictor, LstmPredictor, PredictorConfig


@dataclasses.dataclass(frozen=True)
class TransducerConfig:
    encoder: ConformerConfig = ConformerConfig()
    predictor: PredictorConfig = PredictorConfig()
    joint_dim: int = 256
    vocab_size: int = 1024           # includes blank at index blank_id
    blank_id: int = 0
    predictor_kind: str = "lstm"     # 'lstm' | 'conv'
    dtype: torch.dtype = torch.bfloat16


class Joint(nn.Module):
    """Additive joint: tanh(W_e enc[t] + W_p pred[s]) -> vocab logits."""

    def __init__(self, cfg: TransducerConfig, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.enc_proj = nn.Linear(cfg.encoder.dim, cfg.joint_dim)
        self.pred_proj = nn.Linear(cfg.predictor.dim, cfg.joint_dim)
        self.vocab_proj = nn.Linear(cfg.joint_dim, cfg.vocab_size)
        finish_init(self, generator, device)

    def joint_params(self) -> Dict[str, torch.Tensor]:
        """The parameters, by name, as the fused-joint losses take them."""
        return dict(self.named_parameters())

    def _project(self, params, name, x):
        dt = self.cfg.dtype
        return torch.nn.functional.linear(
            x.to(dt), params[f"{name}.weight"].to(dt),
            params[f"{name}.bias"].to(dt))

    def _head(self, params, enc, p):
        """enc [B, Tc, De], projected pred p [B, 1 or Tc, W, J]."""
        e = self._project(params, "enc_proj", enc)
        h = torch.tanh(e[:, :, None, :] + p)
        return self._project(params, "vocab_proj", h).float()

    def joint_fn(self, params, enc, pred):
        """enc [B, Tc, De], pred [B, S+1, Dp] -> [B, Tc, S+1, V] f32 logits:
        the full-lattice joint_fn of ``rnnt_loss_fused_joint``."""
        return self._head(params, enc,
                          self._project(params, "pred_proj", pred)[:, None])

    def banded_fn(self, params, enc, pred_band):
        """enc [B, Tc, De], pred rows gathered per band cell [B, Tc, W, Dp]
        -> [B, Tc, W, V]: the joint_fn of ``rnnt_loss_fused_joint_banded``
        (enc is projected once per (b, t) and broadcast over the band)."""
        return self._head(params, enc,
                          self._project(params, "pred_proj", pred_band))

    def forward(self, enc, pred):
        return self.joint_fn(self.joint_params(), enc, pred)

    def banded(self, enc, pred_band):
        return self.banded_fn(self.joint_params(), enc, pred_band)


class MonotonicTransducer(nn.Module):
    """The model. Its parameters are drawn on the CPU from `generator` with
    flax's default distributions (models/init.py), then moved to `device`;
    inputs are moved to the parameters' device."""

    def __init__(self, cfg: TransducerConfig, feat_dim: int = 80, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        if cfg.predictor_kind not in ("lstm", "conv"):
            raise ValueError("predictor_kind must be 'lstm' or 'conv', got "
                             f"{cfg.predictor_kind!r}")
        self.cfg = cfg
        kw = {"generator": generator, "device": "cpu"}
        self.encoder = ConformerEncoder(cfg.encoder, feat_dim, **kw)
        predictor = (LstmPredictor if cfg.predictor_kind == "lstm"
                     else ConvPredictor)
        self.predictor = predictor(cfg.predictor, **kw)
        self.joint = Joint(cfg, **kw)
        self.to(_device(device))

    def _inputs(self, *xs):
        dev = self.joint.vocab_proj.weight.device
        return [x.to(dev) for x in xs]

    def forward(self, feats, feat_lengths, labels, label_lengths,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Returns per-sample monotonic RNN-T costs [B]. generator: the
        dropout masks' (on the parameters' device), needed when
        deterministic=False and the encoder's dropout is not 0 (flax's
        rngs={"dropout": key})."""
        feats, feat_lengths, labels, label_lengths = self._inputs(
            feats, feat_lengths, labels, label_lengths)
        logits, enc_lengths = self.logits(feats, feat_lengths, labels,
                                          deterministic, generator)
        # No silent clamping: if subsampling leaves fewer frames than labels
        # (T'_b < S_b) the loss raises (the module docstring).
        return monotonic_rnnt_loss(logits, labels, enc_lengths,
                                   label_lengths, blank_id=self.cfg.blank_id)

    def logits(self, feats, feat_lengths, labels, deterministic: bool = True,
               generator: Optional[torch.Generator] = None):
        feats, feat_lengths, labels = self._inputs(feats, feat_lengths, labels)
        enc, enc_lengths = self.encoder(feats, feat_lengths, deterministic,
                                        generator=generator)
        pred = self.predictor(labels, deterministic)
        return self.joint(enc, pred), enc_lengths

    def encode(self, feats, feat_lengths, deterministic: bool = True,
               generator: Optional[torch.Generator] = None):
        feats, feat_lengths = self._inputs(feats, feat_lengths)
        return self.encoder(feats, feat_lengths, deterministic,
                            generator=generator)

    @staticmethod
    def _select_state(emit, new_state, old_state):
        """Per-sample select over a predictor state (a tuple of [B, ...])."""
        return tuple(
            torch.where(emit.view((-1,) + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(new_state, old_state))

    @torch.no_grad()
    def greedy_decode(self, feats, feat_lengths, max_labels: int,
                      deterministic: bool = True):
        """Frame-synchronous greedy decoding.

        Returns (hyp_labels [B, max_labels] int32, hyp_lengths [B] int32).
        The predictor advances statefully (LSTM carry / conv token ring), so
        decoding is O(T') whatever max_labels. A frame emits where its
        argmax (the first maximum) is not blank, the frame is inside the
        sample and the hypothesis has room; the predictor state moves on
        only where a frame emits.
        """
        enc, enc_lengths = self.encode(feats, feat_lengths, deterministic)
        batch, t_out, _ = enc.shape
        dev = enc.device
        pstate = self.predictor.init_state(batch)
        pstate, ctx = self.predictor.step(               # consume BOS
            pstate, torch.zeros((batch,), dtype=torch.int32, device=dev))
        hyp = torch.zeros((batch, max_labels), dtype=torch.int32, device=dev)
        n_hyp = torch.zeros((batch,), dtype=torch.int32, device=dev)
        slots = torch.arange(max_labels, device=dev)[None, :]
        for t in range(t_out):
            logit = self.joint(enc[:, t:t + 1], ctx[:, None, :])[:, 0, 0, :]
            tok = torch.argmax(logit, dim=-1).to(torch.int32)
            emit = ((tok != self.cfg.blank_id) & (t < enc_lengths)
                    & (n_hyp < max_labels))
            hyp = torch.where(emit[:, None] & (slots == n_hyp[:, None]),
                              tok[:, None], hyp)
            n_hyp = n_hyp + emit.to(torch.int32)
            new_pstate, new_ctx = self.predictor.step(pstate, tok)
            pstate = self._select_state(emit, new_pstate, pstate)
            ctx = torch.where(emit[:, None], new_ctx, ctx)
        return hyp, n_hyp
