"""Timed entry: the port's ``train_step`` of a Conformer transducer.

Set-up builds one TrainState with ``create_train_state``, loads the
benchmark's seeded weights into it, and drives it through the cycle's
batches once with the window's own call (``train_step(state, batch)``):
every batch shape is then warm, and the first three steps, on three
different batches, are the ones the reference follows from the seed. The
window goes on training the same state, batch after batch of the cycle.

Two stretches are compared, each against the plain reference on the same
batches:

* the start: the first three steps of set-up, the reference run from the
  same seeded weights;
* the window: its first three steps, the reference run from the program's
  own state as the window took it over (its parameters, AdamW's moments
  and count, copied to the host at the end of set-up), so that a step that
  behaves otherwise once set-up is over is caught too.

Of each: every step's loss; the first gradient as AdamW received it (read
back from its first moment: m1 = b1 m0 + (1 - b1) g), leaf by leaf; and
the change of every parameter over the three steps, leaf by leaf. A
leaf's gap is |norm(program) - norm(reference)| over the larger of the
reference's norm of that leaf and of the median leaf; a leaf whose
reference gradient is under a thousandth of the median leaf's (an
attention key bias, whose gradient is zero under the softmax) moves by
round-off alone and is left out of the change. The window's readings are
copied to pinned host buffers as the steps run, without a sync.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from monotonic_rnnt_tpu_torch.models import (ConformerConfig,
                                             PredictorConfig,
                                             TransducerConfig)
from monotonic_rnnt_tpu_torch.models.train import (create_train_state,
                                                   train_step)

from .. import counts
from ..reference import conformer
from ..reference.loss import padded_costs_differentiable
from ..reference.optim import B1, AdamW, clip
from ..traffic import FRAME_S, make_cycle
from ..weights import derive, make_weights, normal

COMPARED_STEPS = 3
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
QUIET_LEAF = 1e-3


def step_fn(state, batch):
    """The program's call that the window times (a seam for the tests)."""
    return train_step(state, batch)


def transducer_config(cfg: dict) -> TransducerConfig:
    dt = DTYPES[cfg["dtype"]]
    encoder = ConformerConfig(
        num_layers=cfg["num_layers"], dim=cfg["dim"],
        num_heads=cfg["num_heads"], ff_expansion=cfg["ff_expansion"],
        conv_kernel=cfg["conv_kernel"],
        subsample_factor=cfg["subsample_factor"], dropout=cfg["dropout"],
        dtype=dt)
    predictor = PredictorConfig(vocab_size=cfg["vocab_size"],
                                dim=cfg["predictor_dim"],
                                embed_dim=cfg["embed_dim"], dtype=dt)
    return TransducerConfig(encoder, predictor, joint_dim=cfg["joint_dim"],
                            vocab_size=cfg["vocab_size"],
                            blank_id=cfg["blank_id"], predictor_kind="lstm",
                            dtype=dt)


def _norms(tensors: dict) -> dict:
    names = list(tensors)
    values = torch.stack([tensors[n].detach().double().norm()
                          for n in names]).tolist()
    return dict(zip(names, values))


def leaf_gap(got: dict, ref: dict, names) -> float:
    """The worst leaf's |norm gap| over max(its reference norm, the median
    leaf's)."""
    med = statistics.median(ref[n] for n in names)
    return max(abs(got[n] - ref[n]) / max(ref[n], med) for n in names)


def compare(got: dict, ref: dict, prefix: str = "") -> dict:
    """The three numbers compared, from two readings of three steps."""
    med = statistics.median(ref["grad"].values())
    moved = [n for n, g in ref["grad"].items() if g >= QUIET_LEAF * med]
    return {
        prefix + "loss_rel": max(abs(a - b) / abs(b)
                                 for a, b in zip(got["loss"], ref["loss"])),
        prefix + "grad_leaf": leaf_gap(got["grad"], ref["grad"],
                                       list(ref["grad"])),
        prefix + "change_leaf": leaf_gap(got["change"], ref["change"],
                                         moved)}


def _host_copy(tensors: dict, pinned: bool) -> dict:
    """{name: an empty host tensor like each}, in one (pinned) buffer."""
    numels = [t.numel() for t in tensors.values()]
    flat = torch.empty(sum(numels), dtype=torch.float32,
                       pin_memory=pinned)
    out, at = {}, 0
    for (name, t), n in zip(tensors.items(), numels):
        out[name] = flat[at:at + n].view(t.shape)
        at += n
    return out


class Entry:
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
                "model_flops": counts.train_step_flops(
                    cfg, b.frames, b.label_lengths)})
        t = time.perf_counter()
        weights = make_weights(cfg, seed, device)
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
        """The cycle once through train_step (or its first `steps`); the
        first three steps' readings are kept for the comparison, and the
        state the window takes over is copied to the host."""
        params = dict(self.state.model.named_parameters())
        losses = []
        for j in range(steps or len(self.batches)):
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

    def _moments(self, key: str) -> dict:
        """{name: AdamW's `key` moment of each parameter} (zeros before its
        first update)."""
        moments = self.state.optimizer.state
        return {n: moments[p][key] if p in moments else torch.zeros_like(p)
                for n, p in self.state.model.named_parameters()}

    def _take_over(self) -> None:
        """The state as the window takes it over, on the host; and pinned
        buffers for the window's readings."""
        params = dict(self.state.model.named_parameters())
        pinned = torch.device(self.device).type == "cuda"
        self.start = {"count": self.state.step}
        for key, tensors in (("params", params),
                             ("exp_avg", self._moments("exp_avg")),
                             ("exp_avg_sq", self._moments("exp_avg_sq"))):
            host = _host_copy(tensors, False)
            for n, t in tensors.items():
                host[n].copy_(t.detach())
            self.start[key] = host
        self._window_m1 = _host_copy(params, pinned)
        self._window_p3 = _host_copy(params, pinned)
        self.start["batches"] = [j % len(self.batches)
                                 for j in range(COMPARED_STEPS)]

    def step(self, i: int) -> dict:
        j = i % len(self.batches)
        self.state, metrics = step_fn(self.state, self.batches[j])
        self.losses.append(metrics["loss"])
        if i == 0:
            for n, t in self._moments("exp_avg").items():
                self._window_m1[n].copy_(t.detach(), non_blocking=True)
        if i == COMPARED_STEPS - 1:
            for n, t in self.state.model.named_parameters():
                self._window_p3[n].copy_(t.detach(), non_blocking=True)
        return self.work[j]

    def traced_step(self, j: int) -> dict:
        self.state, _ = step_fn(self.state, self.batches[j])
        return self.work[j]

    def trace_batches(self):
        first = {}
        for j, b in enumerate(self.cycle.batches):
            first.setdefault(b.bucket, j)
        return sorted(first.values())

    # --- the comparison ---------------------------------------------------

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
                initial = make_weights(self.cfg, self.seed, self.device)
                moments, batches = {}, range(COMPARED_STEPS)
            else:
                initial = {n: t.to(self.device)
                           for n, t in start["params"].items()}
                moments = dict(m=start["exp_avg"], v=start["exp_avg_sq"],
                               count=start["count"])
                batches = start["batches"]
            model = conformer.build(self.cfg).to_empty(device=self.device)
            params = dict(model.named_parameters())
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(initial[n])
            opt = AdamW({n: p.data for n, p in params.items()},
                        self.cfg["learning_rate"], self.cfg["weight_decay"],
                        self.cfg["warmup_steps"], **moments)
            losses = []
            for k, j in enumerate(batches):
                feats, frames, labels, slen = self.batches[j]
                logits, tprime = model(feats, frames, labels)
                loss = padded_costs_differentiable(
                    logits, labels, tprime, slen, self.cfg["blank_id"]).mean()
                grads = dict(zip(params, torch.autograd.grad(
                    loss, list(params.values()))))
                del logits
                clip(grads)
                if k == 0:
                    grad = _norms(grads)
                opt.step(grads)
                losses.append(float(loss.detach()))
                del grads, loss
            change = _norms({n: p - initial[n] for n, p in params.items()})
            return {"loss": losses, "grad": grad, "change": change}
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags

    def window_readings(self) -> dict:
        """The program's readings of the window's first three steps."""
        m0, p0 = self.start["exp_avg"], self.start["params"]
        grad = _norms({n: (m1 - B1 * m0[n]) / (1 - B1)
                       for n, m1 in self._window_m1.items()})
        change = _norms({n: p3 - p0[n] for n, p3 in self._window_p3.items()})
        return {"loss": [float(x) for x in self.losses[:COMPARED_STEPS]],
                "grad": grad, "change": change}

    def _reference(self) -> dict:
        """The reference's readings of both stretches, float32 with TF32
        off, once the program's state is freed."""
        if self._ref is None:
            self.state = None
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            self._ref = (self.reference_steps(tf32=False),
                         self.reference_steps(tf32=False, start=self.start))
        return self._ref

    def check(self, limits: dict):
        finite = torch.isfinite(torch.stack(self.losses)) if self.losses \
            else torch.ones(0, dtype=torch.bool)
        failed = int((~finite).sum())
        if len(self.losses) < COMPARED_STEPS:
            raise RuntimeError(f"the window ran {len(self.losses)} steps; "
                               f"the comparison reads {COMPARED_STEPS}")
        start, window = self._reference()
        numbers = compare(self.first, start)
        numbers.update(compare(self.window_readings(), window, "window_"))
        return numbers, len(self.losses), failed

    def control(self):
        """The same numbers for the reference with TF32 matmuls, the
        precision below the cell's float32 with TF32 off."""
        start, window = self._reference()
        numbers = compare(self.reference_steps(tf32=True), start)
        numbers.update(compare(self.reference_steps(
            tf32=True, start=self.start), window, "window_"))
        return numbers
