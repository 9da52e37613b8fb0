"""Conformer-transducer: encoder + predictor + joint -> monotonic RNN-T loss.

PyTorch counterpart of ``monotonic_rnnt_tpu/models/transducer.py``. The
joint network produces the per-(t, s) logits the loss consumes
([B, T', S+1, V], float32 whatever the compute dtype), so the loss runs the
port's float32 kernels: on the card ``stats_alpha_fused`` in the forward
and ``beta_grad_fused`` in the backward (the deferred route of
``ops/loss.py``). The joint also runs as the ``joint_fn`` of the
fused-joint losses (``Joint.joint_fn``, ``Joint.banded_fn`` and
``Joint.joint_params``), which never hold the whole logits tensor.

Decoding: monotonic RNN-T makes exactly one decision per frame (emit a
label or blank), so greedy and beam search are one loop over the encoder
frames, on the device, with no copy to the host inside it; the beam keeps
the JAX model's carry, tie order and rolling hash, so its beams equal
JAX's. Chunked streaming (greedy and beam) recomputes a causal encoder over
a window of history plus the new chunk. No decoder launches a kernel of
the port: they run the joint, the predictor's step and torch ops.

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
from ..ops.helpers import NEG_INF
from ..ops.loss import monotonic_rnnt_loss
from .conformer import ConformerConfig, ConformerEncoder, subsampled_length
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
        """Per-sample select over a state (a tensor or a tuple of [B, ...]
        tensors: a predictor's or an LM's)."""
        return _map_state(
            lambda a, b: torch.where(emit.view((-1,) + (1,) * (a.dim() - 1)),
                                     a, b), new_state, old_state)

    def _greedy_frame_step(self, carry, enc_t, active, slots):
        """Advance greedy decoding by one encoder frame, enc_t [B, 1, D];
        active [B] bool (the frame is inside the sample), slots [1, cap] the
        hypothesis positions. Returns (carry, tok [B], emit [B]); shared by
        greedy_decode and streaming_step."""
        hyp, n_hyp, pstate, ctx = carry
        logit = self.joint(enc_t, ctx[:, None, :])[:, 0, 0, :]
        tok = torch.argmax(logit, dim=-1).to(torch.int32)
        emit = ((tok != self.cfg.blank_id) & active
                & (n_hyp < hyp.shape[1]))
        hyp = torch.where(emit[:, None] & (slots == n_hyp[:, None]),
                          tok[:, None], hyp)
        n_hyp = n_hyp + emit.to(torch.int32)
        new_pstate, new_ctx = self.predictor.step(pstate, tok)
        pstate = self._select_state(emit, new_pstate, pstate)
        ctx = torch.where(emit[:, None], new_ctx, ctx)
        return (hyp, n_hyp, pstate, ctx), tok, emit

    def _bos_context(self, n: int):
        """(predictor state, ctx) of n fresh hypotheses after BOS."""
        dev = self.joint.vocab_proj.weight.device
        return self.predictor.step(
            self.predictor.init_state(n),
            torch.zeros((n,), dtype=torch.int32, device=dev))

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
        carry = (torch.zeros((batch, max_labels), dtype=torch.int32,
                             device=dev),
                 torch.zeros((batch,), dtype=torch.int32, device=dev),
                 *self._bos_context(batch))
        slots = torch.arange(max_labels, device=dev)[None, :]
        for t in range(t_out):
            carry, _, _ = self._greedy_frame_step(
                carry, enc[:, t:t + 1], t < enc_lengths, slots)
        return carry[0], carry[1]

    # ------------------------------------------------------------------
    # Chunked streaming inference (causal encoder + stateful decoding)
    # ------------------------------------------------------------------

    def _stream_state_base(self, batch: int, feat_dim: int, lookback: int):
        """Shared frame-window state (buffer / n_seen / valid) + validation.

        n_seen (input frames pushed, the same for every stream) is a 0-d
        int32 tensor on the model's device, as in JAX: a chunk's window
        and emitted slice are index arithmetic on it, so one exported
        streaming_step serves every chunk, and no chunk copies it to the
        host."""
        sub = self.cfg.encoder.subsample_factor
        if lookback % sub:
            raise ValueError(f"lookback {lookback} not a multiple of the "
                             f"subsample factor {sub}")
        dev = self.joint.vocab_proj.weight.device
        return {"buffer": torch.zeros((batch, lookback, feat_dim),
                                      dtype=torch.float32, device=dev),
                "n_seen": torch.zeros((), dtype=torch.int32, device=dev),
                "valid": torch.zeros((batch,), dtype=torch.int32,
                                     device=dev)}

    def _stream_window(self, state, feat_chunk, chunk_valid):
        """Chunked exact recompute shared by greedy and beam streaming.

        Window = [history | chunk], content left-aligned: early in the
        stream only `avail` history frames exist, and start-of-stream must
        look like start-of-utterance (left zero-pad + masks), not like
        attended-to zero frames. Returns (emit_enc [B, C', D], abs_out0,
        out_total [B], updates) where `updates` holds the new buffer /
        n_seen / valid entries.
        """
        enc_cfg = self.cfg.encoder
        sub = enc_cfg.subsample_factor
        (feat_chunk,) = self._inputs(feat_chunk)
        batch, chunk_t, _ = feat_chunk.shape
        if chunk_t % sub:
            raise ValueError(f"chunk frames {chunk_t} not a multiple of the "
                             f"subsample factor {sub}")
        if chunk_valid is None:
            chunk_valid = torch.full((batch,), chunk_t, dtype=torch.int32,
                                     device=feat_chunk.device)
        else:
            (chunk_valid,) = self._inputs(chunk_valid)
        lookback = state["buffer"].shape[1]
        n_seen = state["n_seen"]
        dev = n_seen.device

        avail = torch.clamp(n_seen, max=lookback)       # multiple of sub
        history = torch.cat([state["buffer"], feat_chunk.float()], dim=1)
        # JAX's roll by -(lookback - avail), as a gather by index.
        rolled = ((torch.arange(lookback + chunk_t, device=dev)
                   + (lookback - avail)) % (lookback + chunk_t))
        window = history.index_select(1, rolled)
        s0 = n_seen - avail                              # abs frame of w[0]
        valid_new = state["valid"] + chunk_valid.to(torch.int32)
        win_lengths = torch.minimum(torch.clamp(valid_new - s0, min=0),
                                    avail + chunk_t)

        enc_win, _ = self.encoder(window, win_lengths, True,
                                  pos_offset=s0 // sub)
        emit = avail // sub + torch.arange(chunk_t // sub, device=dev)
        emit_enc = enc_win.index_select(1, emit)
        out_total = subsampled_length(enc_cfg, valid_new)   # [B]
        updates = {"buffer": history[:, chunk_t:],
                   "n_seen": n_seen + chunk_t, "valid": valid_new}
        return emit_enc, n_seen // sub, out_total, updates

    @torch.no_grad()
    def streaming_init(self, batch: int, feat_dim: int, lookback: int,
                       max_labels: int):
        """Fresh streaming state for a batch of audio streams.

        lookback: input-frame history kept for exact recompute; size it
        with conformer.streaming_lookback(cfg.encoder); it must be a
        multiple of the subsample factor. The state is a dict with JAX's
        keys (buffer, n_seen, valid, pstate, ctx, hyp, n_hyp), n_seen a
        0-d int32 tensor.
        """
        dev = self.joint.vocab_proj.weight.device
        pstate, ctx = self._bos_context(batch)
        return dict(
            self._stream_state_base(batch, feat_dim, lookback),
            pstate=pstate, ctx=ctx,
            hyp=torch.zeros((batch, max_labels), dtype=torch.int32,
                            device=dev),
            n_hyp=torch.zeros((batch,), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def streaming_step(self, state, feat_chunk, chunk_valid=None):
        """Push one chunk of frames; returns (state, emitted [B, C'] ids).

        feat_chunk [B, C, F] with C a multiple of the subsample factor;
        chunk_valid [B] true frames in this chunk (default: all C; pad a
        stream that ended with zero-valid chunks). Exactness: with the
        causal encoder, bounded attn_left_context, and lookback >=
        streaming_lookback(cfg), the emitted hypothesis equals greedy_decode
        on the full utterance (on the card, up to the rounding of a
        window's matmuls). Emitted ids are blank_id where nothing was
        emitted in that output frame. The state passed in is not modified.
        """
        emit_enc, abs_out0, out_total, updates = self._stream_window(
            state, feat_chunk, chunk_valid)
        carry = (state["hyp"], state["n_hyp"], state["pstate"], state["ctx"])
        slots = torch.arange(carry[0].shape[1], device=emit_enc.device)[None]
        emitted = []
        for k in range(emit_enc.shape[1]):
            carry, tok, emit = self._greedy_frame_step(
                carry, emit_enc[:, k:k + 1], abs_out0 + k < out_total, slots)
            emitted.append(torch.where(emit, tok, self.cfg.blank_id))
        hyp, n_hyp, pstate, ctx = carry
        emitted = (torch.stack(emitted, dim=1) if emitted
                   else hyp.new_zeros((hyp.shape[0], 0)))
        return dict(updates, pstate=pstate, ctx=ctx, hyp=hyp,
                    n_hyp=n_hyp), emitted

    @torch.no_grad()
    def streaming_beam_init(self, batch: int, feat_dim: int, lookback: int,
                            max_labels: int, beam_size: int, lm=None):
        """Fresh streaming *beam* state (see streaming_init for sizing).

        With lm set (models/lm.py protocol), the state carries
        per-hypothesis LM states for shallow fusion; pass the same lm to
        every streaming_beam_step.
        """
        return dict(
            self._stream_state_base(batch, feat_dim, lookback),
            beam=self._beam_init_carry(batch, beam_size, max_labels, lm))

    @torch.no_grad()
    def streaming_beam_step(self, state, feat_chunk, chunk_valid=None,
                            lm=None, lm_weight: float = 0.0,
                            merge_paths: bool = False):
        """Push one chunk through streaming *beam search* (+ LM fusion).

        Returns (state, (tokens [B, K, cap], lengths [B, K],
        scores [B, K])): the live beam after this chunk, unsorted (sort by
        score for display; with merge_paths the dead duplicate slots score
        -inf). The carried beam advances with the same frame step as
        beam_search_decode, so the final beam equals the full-utterance
        beam search (same caveat as streaming_step: causal encoder,
        bounded attention, sufficient lookback).
        """
        emit_enc, abs_out0, out_total, updates = self._stream_window(
            state, feat_chunk, chunk_valid)
        beam = state["beam"]
        for k in range(emit_enc.shape[1]):
            beam = self._beam_frame_step(
                beam, emit_enc[:, k], abs_out0 + k < out_total,
                merge_paths=merge_paths, lm=lm, lm_weight=lm_weight)
        return dict(updates, beam=beam), beam[:3]

    # ------------------------------------------------------------------
    # Beam search
    # ------------------------------------------------------------------

    @torch.no_grad()
    def beam_search_decode(self, feats, feat_lengths, max_labels: int,
                           beam_size: int, deterministic: bool = True,
                           merge_paths: bool = False, lm=None,
                           lm_weight: float = 0.0):
        """Frame-synchronous beam search.

        Monotonic RNN-T emits exactly one decision per frame, so the beam
        advances in lockstep over t: each live hypothesis expands into V
        candidates (blank keeps the hypothesis, a label appends), and the
        top beam_size by path score survive, ties to the lower flat index
        (the order of jax.lax.top_k).

        merge_paths=False keeps duplicate label sequences (reached via
        different emission timings) as distinct hypotheses; the score is a
        single best path's log-probability. merge_paths=True LSE-merges
        duplicates each frame (sound within the beam: at frame t a
        hypothesis's model state is fully determined by its label
        sequence), so the score approaches the sequence's marginal
        log-probability (-loss) as the beam widens. Duplicates are found by
        a 64-bit rolling sequence fingerprint: a collision falsely merging
        two distinct sequences has probability ~beam^2 / 2^64 per frame.

        lm/lm_weight: shallow fusion with an external language model
        following the models/lm.py protocol. Label candidates score
        logp_am + lm_weight * logp_lm; blank is never LM-scored; weight 0
        skips fusion entirely. Per-hypothesis LM states ride the beam like
        predictor states (gathered by parent, advanced on emission). The
        reported scores include the LM terms.

        Returns (tokens [B, beam, max_labels] int32, lengths [B, beam]
        int32, scores [B, beam] f32 log-probs), beams sorted best-first;
        beam_size=1 with merge_paths=False reproduces greedy_decode.
        """
        enc, enc_lengths = self.encode(feats, feat_lengths, deterministic)
        carry = self._beam_init_carry(enc.shape[0], beam_size, max_labels,
                                      lm)
        for t in range(enc.shape[1]):
            carry = self._beam_frame_step(
                carry, enc[:, t], t < enc_lengths, merge_paths=merge_paths,
                lm=lm, lm_weight=lm_weight)
        return self._beam_result(carry, merge_paths)

    @staticmethod
    def _beam_result(carry, merge_paths: bool):
        """(tokens, lengths, scores) of a final beam carry, best-first."""
        tokens, n_hyp, score = carry[:3]
        if merge_paths:
            # Merging leaves dead slots interleaved; return best-first
            # (jnp.argsort's stable order).
            order = torch.argsort(-score, dim=1, stable=True)
            rows = torch.arange(score.shape[0], device=score.device)[:, None]
            tokens, n_hyp, score = (tokens[rows, order], n_hyp[rows, order],
                                    score[rows, order])
        return tokens, n_hyp, score

    # Per-lane multipliers of the beam's rolling sequence hash (two
    # independent 32-bit multiplicative hashes = one 64-bit fingerprint).
    _HASH_MULTS = (2654435761, 2246822507)

    def _beam_init_carry(self, batch: int, beam: int, cap: int, lm):
        """Fresh beam carry: (tokens [B, K, cap] int32, n_hyp [B, K] int32,
        score [B, K] f32, hseq [B, K, 2] int64, pstate, ctx[, lm_state,
        lm_logp]); hseq holds the two uint32 hash lanes' exact values."""
        if not 1 <= beam <= self.cfg.vocab_size:
            raise ValueError(f"beam_size {beam} must be in [1, vocab_size "
                             f"{self.cfg.vocab_size}]")
        dev = self.joint.vocab_proj.weight.device
        n = batch * beam
        score = torch.full((batch, beam), NEG_INF, dtype=torch.float32,
                           device=dev)
        score[:, 0] = 0.0
        init = (torch.zeros((batch, beam, cap), dtype=torch.int32,
                            device=dev),
                torch.zeros((batch, beam), dtype=torch.int32, device=dev),
                score,
                torch.zeros((batch, beam, 2), dtype=torch.int64, device=dev),
                *self._bos_context(n))
        if lm is not None:
            init = init + tuple(lm.step(                 # consume BOS
                lm.init_state(n),
                torch.zeros((n,), dtype=torch.int32, device=dev)))
            if init[-1].shape != (n, self.cfg.vocab_size):
                raise ValueError(f"the LM's log-probs have shape "
                                 f"{tuple(init[-1].shape)}, not [{n}, "
                                 f"{self.cfg.vocab_size}]: its vocabulary "
                                 "must be the transducer's")
        return init

    def _beam_candidates(self, carry, enc_t, active_b, *, lm, lm_weight):
        """[B, K, V] candidate path scores of one frame: each hypothesis's
        score plus the log-probability of each token (LM-fused on labels
        where lm_weight != 0); an inactive sample is frozen (blank at 0,
        every label -inf), a full hypothesis takes blank only."""
        if len(carry) != (8 if lm is not None else 6):
            raise ValueError(
                f"beam carry has {len(carry)} elements but lm is "
                f"{'set' if lm is not None else 'None'}: pass the same "
                f"`lm` to the init and to every step")
        tokens, n_hyp, score, _, _, ctx = carry[:6]
        batch, beam, cap = tokens.shape
        vocab, blank = self.cfg.vocab_size, self.cfg.blank_id
        is_blank = torch.arange(vocab, device=score.device) == blank
        enc_bk = enc_t[:, None, None, :].expand(
            batch, beam, 1, enc_t.shape[-1]).reshape(batch * beam, 1, -1)
        logits = self.joint(enc_bk, ctx[:, None, :])[:, 0, 0, :]
        logp = torch.log_softmax(logits.float(), dim=-1).view(batch, beam,
                                                              vocab)
        if lm is not None and lm_weight != 0.0:
            # Shallow fusion on label candidates only. Skipped entirely at
            # weight 0: lm_logp may hold -inf (forbidden continuations), and
            # 0 * -inf is NaN.
            logp = logp + torch.where(
                is_blank, 0.0, lm_weight * carry[7].view(batch, beam, vocab))
        logp = torch.where(active_b[:, None, None], logp,
                           torch.where(is_blank, 0.0, NEG_INF))
        cand = score[:, :, None] + logp
        full = (n_hyp >= cap)[:, :, None] & ~is_blank
        return cand.masked_fill(full, NEG_INF)

    def _beam_frame_step(self, carry, enc_t, active_b, *, merge_paths, lm,
                         lm_weight):
        """Advance the beam by one encoder frame.

        carry: as built by _beam_init_carry; enc_t [B, D] this frame's
        encodings; active_b [B] bool (inactive samples are frozen, so the
        hypothesis set is unchanged). Shared by beam_search_decode and
        streaming_beam_step.
        """
        cand = self._beam_candidates(carry, enc_t, active_b, lm=lm,
                                     lm_weight=lm_weight)
        tokens, n_hyp, _, hseq, pstate, ctx = carry[:6]
        batch, beam, cap = tokens.shape
        vocab, blank = self.cfg.vocab_size, self.cfg.blank_id
        dev = tokens.device
        top_scores, top_idx = _top_k(cand.view(batch, beam * vocab), beam)
        parent = top_idx // vocab                    # [B, K]
        tok = (top_idx % vocab).to(torch.int32)
        rows = torch.arange(batch, device=dev)[:, None]

        par_tokens, par_n = tokens[rows, parent], n_hyp[rows, parent]
        # Dead beams (score -inf, e.g. fewer finite candidates than
        # beam_size) must not fabricate tokens: only finite-scoring
        # non-blank selections emit.
        emit = (tok != blank) & (top_scores > NEG_INF)
        slot = torch.arange(cap, device=dev)
        new_tokens = torch.where(
            emit[:, :, None] & (slot == par_n[:, :, None]), tok[:, :, None],
            par_tokens)
        new_n = par_n + emit.to(torch.int32)

        # Rolling sequence hash riding the beam: each lane h <- h * M +
        # (tok + 1) mod 2^32 on emission.
        par_h = hseq[rows, parent]
        new_h = torch.where(emit[:, :, None],
                            _hash_step(par_h, tok.long() + 1), par_h)

        if merge_paths:
            # Hypotheses with identical label sequences are in identical
            # model state: merge by summing probabilities into the
            # lowest-index representative and killing the duplicates.
            alive = top_scores > NEG_INF
            dup = ((new_n[:, :, None] == new_n[:, None, :])
                   & (new_h[:, :, None] == new_h[:, None, :]).all(-1)
                   & alive[:, :, None] & alive[:, None, :])
            merged = torch.logsumexp(
                torch.where(dup, top_scores[:, None, :], NEG_INF), dim=-1)
            k_idx = torch.arange(beam, device=dev)
            has_earlier = (dup & (k_idx[:, None] > k_idx[None, :])).any(-1)
            top_scores = torch.where(alive & ~has_earlier, merged, NEG_INF)

        def gather_parents(x):
            """Reorder [B*K, ...] rows by the beam's parent indices."""
            rest = x.shape[1:]
            return x.reshape(batch, beam, *rest)[rows, parent].reshape(
                batch * beam, *rest)

        # Reorder predictor state by parent, then advance where emitted.
        tok_flat, emit_flat = tok.reshape(-1), emit.reshape(-1)
        par_state = _map_state(gather_parents, pstate)
        par_ctx = gather_parents(ctx)
        stepped, stepped_ctx = self.predictor.step(par_state, tok_flat)
        out = (new_tokens, new_n, top_scores, new_h,
               self._select_state(emit_flat, stepped, par_state),
               torch.where(emit_flat[:, None], stepped_ctx, par_ctx))
        if lm is None:
            return out
        # LM states ride the beam exactly like predictor states.
        lm_state, lm_logp = carry[6:]
        par_lm = _map_state(gather_parents, lm_state)
        par_lm_logp = gather_parents(lm_logp)
        stepped_lm, stepped_logp = lm.step(par_lm, tok_flat)
        return out + (self._select_state(emit_flat, stepped_lm, par_lm),
                      torch.where(emit_flat[:, None], stepped_logp,
                                  par_lm_logp))


def _top_k(x, k: int):
    """The k largest entries of each row of x and their indices, best
    first, equal values in index order: jax.lax.top_k's order. Ties are
    common in the beam (every dead slot's -inf candidates; a frozen frame's)
    and decide which parent a dead slot copies; torch.topk does not promise
    this order, a stable descending sort does."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _map_state(fn, *states):
    """fn over states that are each a tensor or a (nested) tuple of
    tensors, keeping the structure."""
    if isinstance(states[0], torch.Tensor):
        return fn(*states)
    return tuple(_map_state(fn, *parts) for parts in zip(*states))


def _hash_step(h, tok1):
    """h * M + tok1 mod 2^32 per lane of h [..., 2] (exact values in int64,
    M = MonotonicTransducer._HASH_MULTS): M splits into 16-bit halves, so
    no product reaches 2^63."""
    lanes = []
    for lane, mult in enumerate(MonotonicTransducer._HASH_MULTS):
        x = h[..., lane]
        prod = (((x * (mult >> 16)) & 0xFFFF) << 16) + x * (mult & 0xFFFF)
        lanes.append((prod + tok1) & 0xFFFFFFFF)
    return torch.stack(lanes, dim=-1)
