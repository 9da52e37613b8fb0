"""Timed entry: the port's ``train_step`` of the Emformer RNN-T base.

The Zipformer entry's cycle and comparison (entries/zipformer_train.py)
with the Emformer's model: set-up builds one TrainState with
``create_train_state``, loads the seeded weights (emformer_work.py) into
it and drives it through the cycle's batches once with the window's own
call; the window goes on training the same state. The start's and the
window's three steps are held against the plain reference
(reference/emformer.py), which runs in REFERENCE_BLOCKS blocks of
utterances: its float32 log-softmax of the [B, T', S + 1, 4097] logits
doubles the up to 19 GB that the program holds.

The lattice has T' = frames // 4 frames; the mix's label counts follow the
40 ms lattice frame it shares with the Conformer. The mix draws label ids
in [1, V), which assumes blank 0: each id y becomes y - 1 (``remap``), so
the labels lie in [0, 4096) and never equal the configuration's blank,
4096. A traced step reports its model FLOPs, that it is one step, and the
Emformer's attention counters over the step (``attn_cells``,
``attn_kept``) where the program keeps them.

The window's losses are read but not compared (``NOT_COMPARED``). Rows
1-2 run alpha and beta in float32 (the reference in float64), which at
these 600-4,300-nat costs scales each utterance's gradient by up to a few
thousandths; the global-norm clip spreads that over every leaf, and
twenty updates into the warm-up the loss falls fast enough that the
window's second and third losses carry it: 3.6e-5 on a sound seed, more
than TF32 matmuls move them (2.1e-6 to 2.1e-5). The window's gradient and
change are compared, and so are the start's losses.

The card's caching allocator grows expandable segments for this entry
(``expandable_segments``): the four buckets' logits and logit gradients
(up to 17.4 GiB each at 512 s a batch) differ in size, and in fixed
segments the blocks cached for one bucket's shapes left the next bucket's
gradient no room in the first warm cycle, with ~21 GiB reserved and free.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from monotonic_rnnt_tpu_torch.models import PredictorConfig, TransducerConfig
from monotonic_rnnt_tpu_torch.models.emformer import EmformerConfig
from monotonic_rnnt_tpu_torch.models.train import (create_train_state,
                                                   train_step)

from .. import emformer_work
from ..reference import emformer
from ..reference.loss import padded_costs_differentiable
from ..reference.optim import B1, AdamW, clip
from ..traffic import FRAME_S, make_cycle
from ..weights import derive, normal
from . import zipformer_train
from .train import COMPARED_STEPS, DTYPES, _norms

REFERENCE_BLOCKS = 8
ATTENTION = ("attn_cells", "attn_kept")
NOT_COMPARED = ("window_loss_rel",)


def step_fn(state, batch):
    """The program's call that the window times (a seam for the tests)."""
    return train_step(state, batch)


def transducer_config(cfg: dict) -> TransducerConfig:
    dt = DTYPES[cfg["dtype"]]
    stride = cfg["time_reduction_stride"]
    encoder = EmformerConfig(
        num_layers=cfg["transformer_num_layers"],
        reduction_dim=cfg["time_reduction_input_dim"], stride=stride,
        num_heads=cfg["transformer_num_heads"],
        ffn_dim=cfg["transformer_ffn_dim"],
        segment_length=cfg["segment_length"] // stride,
        right_context=cfg["right_context_length"] // stride,
        left_context=cfg["transformer_left_context_length"],
        output_dim=cfg["encoding_dim"], dtype=dt)
    dim = cfg["symbol_embedding_dim"]
    predictor = PredictorConfig(
        vocab_size=cfg["vocab_size"], dim=dim, embed_dim=dim, dtype=dt,
        bos_id=cfg["blank_id"], num_layers=cfg["num_lstm_layers"],
        layer_norm=cfg["lstm_layer_norm"], out_dim=cfg["encoding_dim"])
    return TransducerConfig(encoder, predictor, joint_dim=cfg["encoding_dim"],
                            vocab_size=cfg["vocab_size"],
                            blank_id=cfg["blank_id"], predictor_kind="lstm",
                            dtype=dt, joint_activation="relu")


def remap(labels: np.ndarray, label_lengths: np.ndarray) -> np.ndarray:
    """The mix's ids in [1, V) as ids in [0, V - 1), 0 past each length."""
    inside = np.arange(labels.shape[1])[None, :] < label_lengths[:, None]
    return np.where(inside, labels - 1, 0).astype(np.int32)


def _attention_counts() -> dict:
    """The program's Emformer attention counters; {} where it keeps
    none."""
    try:
        from monotonic_rnnt_tpu_torch.utils.profiling import counters
    except ImportError:
        return {}
    seen = counters().get("emformer", {})
    return {k: seen[k] for k in ATTENTION if k in seen}


def _compared(numbers: dict) -> dict:
    """The numbers that decide `correct`: all but the window's losses
    (``NOT_COMPARED``)."""
    return {k: v for k, v in numbers.items() if k not in NOT_COMPARED}


def expandable_segments(device) -> None:
    """Let the caching allocator map one growing segment where it would
    cut fixed ones; takes effect for the segments mapped after it."""
    if str(device).startswith("cuda"):
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")


class Entry(zipformer_train.Entry):
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        expandable_segments(device)
        self.cfg, self.seed, self.device = cfg, seed, device
        self.cycle = cyc = make_cycle(mix, seed, cfg["subsample_factor"],
                                      cfg["vocab_size"])
        shapes = [(b.size, int(b.frames.max()), cfg["feat_dim"])
                  for b in cyc.batches]
        sizes = [int(np.prod(s)) for s in shapes]
        flat = normal((sum(sizes),), mix["feature_scale"], seed, 20, device)
        self.batches, self.work, at = [], [], 0
        for b, shape, size in zip(cyc.batches, shapes, sizes):
            s_max = int(b.label_lengths.max())
            labels = remap(b.labels[:, :s_max], b.label_lengths)
            self.batches.append((
                flat[at:at + size].view(shape),
                torch.from_numpy(b.frames.astype(np.int32)).to(device),
                torch.from_numpy(labels).to(device),
                torch.from_numpy(b.label_lengths.astype(np.int32)).to(
                    device)))
            at += size
            self.work.append({
                "train_audio_s": float(b.frames.sum()) * FRAME_S,
                "model_flops": emformer_work.train_step_flops(
                    cfg, b.frames, b.label_lengths)})
        t = time.perf_counter()
        weights = emformer_work.make_weights(cfg, seed, device)
        self.parts = {"weights_s": time.perf_counter() - t}
        t = time.perf_counter()
        self.state = create_train_state(
            transducer_config(cfg), derive(seed, 3), self.batches[0],
            cfg["learning_rate"], cfg["weight_decay"], cfg["warmup_steps"],
            device=device)
        self.parts["create_train_state_s"] = time.perf_counter() - t
        with torch.no_grad():
            for name, p in self.state.model.named_parameters():
                p.copy_(weights[name])
        self._initial = weights
        self.losses = []
        self._ref = None

    def warm(self, steps=None) -> None:
        """The whole cycle through train_step, whatever `steps` asks (a run
        warms every shape); the first three steps' readings are kept for
        the comparison, and the state the window takes over is copied to
        the host."""
        params = dict(self.state.model.named_parameters())
        losses = []
        for j in range(len(self.batches)):
            self.state, metrics = step_fn(self.state, self.batches[j])
            if j < COMPARED_STEPS:
                losses.append(metrics["loss"])
            if j == 0:
                grad = _norms(self._moments("exp_avg"))
                grad = {n: g / (1 - B1) for n, g in grad.items()}
            if j == COMPARED_STEPS - 1:
                change = _norms({n: p - self._initial[n]
                                 for n, p in params.items()})
                self._initial = None
        self.first = {"loss": [float(x) for x in losses], "grad": grad,
                      "change": change}
        self._take_over()

    def step(self, i: int) -> dict:
        j = i % len(self.batches)
        self.state, metrics = step_fn(self.state, self.batches[j])
        self.losses.append(metrics["loss"])
        if i == 0:
            for n, p in self.state.model.named_parameters():
                if p.grad is None:      # a step that computed no gradient
                    self._window_grad[n].zero_()
                else:
                    self._window_grad[n].copy_(p.grad, non_blocking=True)
        if i == COMPARED_STEPS - 1:
            for n, t in self.state.model.named_parameters():
                self._window_p3[n].copy_(t.detach(), non_blocking=True)
        return self.work[j]

    def _grouped(self, norms: dict) -> dict:
        """Every leaf on its own: the Emformer has no 0-d leaves."""
        return norms

    def check(self, limits: dict):
        numbers, attempted, failed = super().check(limits)
        return _compared(numbers), attempted, failed

    def control(self):
        return _compared(super().control())

    def traced_step(self, j: int) -> dict:
        before = _attention_counts()
        self.state, _ = step_fn(self.state, self.batches[j])
        after = _attention_counts()
        seen = {k: after[k] - before.get(k, 0) for k in after}
        return dict(self.work[j], trace_steps=1, **seen)

    def reference_steps(self, tf32: bool, start=None) -> dict:
        """The reference's readings of three steps, matmuls in TF32 where
        asked: from the seeded weights on the first three batches, or from
        `start` (the program's state as the window took it over) on the
        window's first three batches."""
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            if start is None:
                initial = emformer_work.make_weights(self.cfg, self.seed,
                                                     self.device)
                moments, batches = {}, range(COMPARED_STEPS)
            else:
                initial = {n: t.to(self.device)
                           for n, t in start["params"].items()}
                moments = dict(m=start["exp_avg"], v=start["exp_avg_sq"],
                               count=start["count"])
                batches = start["batches"]
            model = emformer.build(self.cfg).to_empty(device=self.device)
            params = dict(model.named_parameters())
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(initial[n])
            opt = AdamW({n: p.data for n, p in params.items()},
                        self.cfg["learning_rate"], self.cfg["weight_decay"],
                        self.cfg["warmup_steps"], **moments)
            losses = []
            for k, j in enumerate(batches):
                loss, grads = self._reference_gradient(model, params, j)
                clip(grads)
                if k == 0:
                    grad = _norms(grads)
                opt.step(grads)
                losses.append(loss)
                del grads
            change = _norms({n: p - initial[n] for n, p in params.items()})
            return {"loss": losses, "grad": grad, "change": change}
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags

    def _reference_gradient(self, model, params: dict, j: int):
        """(the mean cost, {name: its gradient}) of batch j by the
        reference, in REFERENCE_BLOCKS blocks of utterances; the model is
        padding independent, so a block's utterances read as in the whole
        batch."""
        feats, frames, labels, slen = self.batches[j]
        size = feats.shape[0]
        loss, grads = 0.0, None
        for rows in torch.arange(size).chunk(REFERENCE_BLOCKS):
            block = slice(int(rows[0]), int(rows[-1]) + 1)
            logits, tprime = model(feats[block], frames[block],
                                   labels[block])
            part = padded_costs_differentiable(
                logits, labels[block], tprime, slen[block],
                self.cfg["blank_id"]).sum() / size
            del logits
            got = torch.autograd.grad(part, list(params.values()))
            grads = got if grads is None else [a + b for a, b in
                                               zip(grads, got)]
            loss += float(part.detach())
            del part, got
        return loss, dict(zip(params, grads))
