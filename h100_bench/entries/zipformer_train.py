"""Timed entry: the port's ``train_step`` of the Zipformer-L transducer.

The training entry's cycle and comparison (entries/train.py) with the
Zipformer's model: set-up builds one TrainState with
``create_train_state``, loads the seeded weights (zipformer_work.py) into
it and drives it through the cycle's batches once with the window's own
call, whatever number of steps is asked (every batch shape is then warm);
the window goes on training the same state. The start's and the window's
three steps are held against the plain reference
(reference/zipformer.py) as the training entry holds the Conformer's:
each step's loss, the first gradient leaf by leaf, each parameter's change;
the window's first gradient is read from the parameters' gradients, not
from AdamW's first moment (``window_readings``), and the 0-d leaves are
held as one (``_grouped``).

The lattice has T' = ceil(((T - 7) // 2) / 2) frames, the Zipformer's
rule; the mix's label counts follow the 40 ms lattice frame it shares with
the Conformer. A traced step reports its model FLOPs and that it is one
step (``trace_steps``), which device_ops.train divides by.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from monotonic_rnnt_tpu_torch.models import PredictorConfig, TransducerConfig
from monotonic_rnnt_tpu_torch.models.train import (create_train_state,
                                                   train_step)
from monotonic_rnnt_tpu_torch.models.zipformer import ZipformerConfig

from .. import zipformer_work
from ..reference import zipformer
from ..reference.loss import padded_costs_differentiable
from ..reference.optim import B1, AdamW, clip
from ..traffic import FRAME_S, make_cycle
from ..weights import derive, normal
from . import train
from .train import COMPARED_STEPS, DTYPES, _norms

REFERENCE_BLOCKS = 2
SCALARS = "0-d leaves"


def step_fn(state, batch):
    """The program's call that the window times (a seam for the tests)."""
    return train_step(state, batch)


def transducer_config(cfg: dict) -> TransducerConfig:
    dt = DTYPES[cfg["dtype"]]
    encoder = ZipformerConfig(
        num_layers=tuple(cfg["num_encoder_layers"]),
        downsampling=tuple(cfg["downsampling_factor"]),
        encoder_dims=tuple(cfg["encoder_dim"]),
        feedforward_dims=tuple(cfg["feedforward_dim"]),
        num_heads=tuple(cfg["num_heads"]),
        conv_kernels=tuple(cfg["cnn_module_kernel"]),
        query_head_dim=cfg["query_head_dim"],
        pos_head_dim=cfg["pos_head_dim"],
        value_head_dim=cfg["value_head_dim"], pos_dim=cfg["pos_dim"],
        output_downsampling=cfg["output_downsampling_factor"],
        embed_channels=tuple(cfg["embed_channels"]),
        convnext_expansion=cfg["convnext_hidden_ratio"], dtype=dt)
    dim = cfg["decoder_dim"]
    predictor = PredictorConfig(
        vocab_size=cfg["vocab_size"], dim=dim, embed_dim=dim,
        context=cfg["context_size"], stateless=True, dtype=dt)
    return TransducerConfig(encoder, predictor, joint_dim=cfg["joiner_dim"],
                            vocab_size=cfg["vocab_size"],
                            blank_id=cfg["blank_id"], predictor_kind="conv",
                            dtype=dt)


class Entry(train.Entry):
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
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
            self.batches.append((
                flat[at:at + size].view(shape),
                torch.from_numpy(b.frames.astype(np.int32)).to(device),
                torch.from_numpy(b.labels[:, :s_max]).to(device),
                torch.from_numpy(b.label_lengths.astype(np.int32)).to(
                    device)))
            at += size
            self.work.append({
                "train_audio_s": float(b.frames.sum()) * FRAME_S,
                "model_flops": zipformer_work.train_step_flops(
                    cfg, b.frames, b.label_lengths)})
        t = time.perf_counter()
        weights = zipformer_work.make_weights(cfg, seed, device)
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
        self._scalars = {n for n, w in weights.items() if w.dim() == 0}
        self.losses = []
        self._ref = None

    def warm(self, steps=None) -> None:
        """The whole cycle through train_step, whatever `steps` asks (a run
        warms every shape; the control tool asks an entry not named
        ``train`` for a few steps); the first three steps' readings are
        kept for the comparison, and the state the window takes over is
        copied to the host."""
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
        self.first = {"loss": [float(x) for x in losses],
                      "grad": self._grouped(grad),
                      "change": self._grouped(change)}
        self._take_over()

    def _take_over(self) -> None:
        super()._take_over()
        # The first moment's host buffer holds the window's first gradient.
        self._window_grad = self._window_m1

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

    def window_readings(self) -> dict:
        """The program's readings of the window's first three steps. The
        first gradient is the one AdamW took, as the parameters' .grad
        holds it after the step (clipped, as the reference's): recovered
        from the first moment, (m1 - b1 m0) / (1 - b1) loses a leaf's
        digits where m0 is much larger than its gradient, which reads up
        to 9e-5 of the leaf's norm in float32 at this cell's 20th step."""
        p0 = self.start["params"]
        change = _norms({n: p3 - p0[n] for n, p3 in self._window_p3.items()})
        return {"loss": [float(x) for x in self.losses[:COMPARED_STEPS]],
                "grad": self._grouped(_norms(self._window_grad)),
                "change": self._grouped(change)}

    def _grouped(self, norms: dict) -> dict:
        """Leaf norms with the 0-d leaves (BiasNorm's log scales) held as
        one leaf, the norm of their vector. Each is one sum over its
        layer's B x T x d activations, with terms of both signs: its
        float32 rounding, the program's and the reference's alike, read up
        to 1.6e-4 of the median leaf's norm in a sound run once the
        window's state had trained, and the TF32 reference 1.7e-3."""
        out = {n: v for n, v in norms.items() if n not in self._scalars}
        out[SCALARS] = sum(norms[n] ** 2 for n in self._scalars) ** 0.5
        return out

    def traced_step(self, j: int) -> dict:
        self.state, _ = step_fn(self.state, self.batches[j])
        return dict(self.work[j], trace_steps=1)

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
                initial = zipformer_work.make_weights(self.cfg, self.seed,
                                                      self.device)
                moments, batches = {}, range(COMPARED_STEPS)
            else:
                initial = {n: t.to(self.device)
                           for n, t in start["params"].items()}
                moments = dict(m=start["exp_avg"], v=start["exp_avg_sq"],
                               count=start["count"])
                batches = start["batches"]
            model = zipformer.build(self.cfg).to_empty(device=self.device)
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
            return {"loss": losses, "grad": self._grouped(grad),
                    "change": self._grouped(change)}
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags

    def _reference_gradient(self, model, params: dict, j: int):
        """(the mean cost, {name: its gradient}) of batch j by the
        reference, in REFERENCE_BLOCKS blocks of utterances: the reference
        keeps more activations than the program (its gathered positional
        table, its float32 log-softmax of the logits), and a whole
        1000 s batch does not fit beside them on one card. Each block's
        cost sum over the batch size is differentiated and the gradients
        added; the model is padding independent, so a block's utterances
        read as in the whole batch."""
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
