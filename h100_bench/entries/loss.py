"""Timed entry: ``monotonic_rnnt_loss`` forward and backward on held logits.

The library's main path as its users call it on their own joint's output:
costs = monotonic_rnnt_loss(logits, labels, T', S), then
d sum(costs) / d logits. One float32 logits tensor per bucket shape
[B, T'_pad, S_pad + 1, V], scale x N(0, 1), is made on the device at
set-up and held; each batch of the cycle brings its own labels and
lengths.

What is compared (after the window, against the float64 plain reference):
every step's costs, relatively (``cost_rel``), and the whole gradient of a
few utterances of the longest bucket at a few steps that the seed draws,
row by row (``grad_dir``): each lattice cell's row g[t, s, :] scaled to
unit norm, the program's against the reference's. A row is the cell's
occupancy times its softmax, less its blank and label shares, so its
direction holds the softmax and how the occupancy splits between blank
and label (the backward scan's betas at the two neighbours), while the
float32 rounding that the scans accumulate over T' cancels in it. (The
relative L2 gap of the whole gradient reads that rounding: up to 3.8e-3
in float32 at T' = 500, as much as the bfloat16 control.)
"""

from __future__ import annotations

import numpy as np
import torch

from monotonic_rnnt_tpu_torch import monotonic_rnnt_loss

from .. import counts
from ..reference.loss import padded_loss
from ..traffic import FRAME_S, make_cycle
from ..weights import derive, normal

SAMPLED_STEPS = 2
SAMPLED_ROWS = 2
TRACE_CYCLES = 4      # ~0.5 s: long enough for the host clock
ROW_FLOOR = 1e-12     # rows under this share of the largest row norm: left out


def loss_fn(logits, labels, tprime, label_lengths, blank_id):
    """The program's call that the window times (a seam for the tests)."""
    return monotonic_rnnt_loss(logits, labels, tprime, label_lengths,
                               blank_id=blank_id)


def row_direction_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest gap between the unit-norm gradient rows g[t, s, :] of
    the program and of the reference, over the rows whose reference norm
    is at least ROW_FLOOR of the largest (the others carry no weight and
    sit near float32's underflow). A NaN counts as infinite."""
    got, ref = got.double(), ref.double()
    n_ref = ref.norm(dim=-1)
    keep = n_ref > ROW_FLOOR * n_ref.max()
    tiny = torch.finfo(torch.float64).tiny
    gap = (got / got.norm(dim=-1, keepdim=True).clamp_min(tiny)
           - ref / n_ref[..., None].clamp_min(tiny)).norm(dim=-1)
    return float(torch.nan_to_num(gap[keep], nan=float("inf")).max())


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.blank = cfg["blank_id"]
        vocab = cfg["vocab_size"]
        self.cycle = cyc = make_cycle(mix, seed, cfg["subsample_factor"],
                                      vocab)
        self.logits = [
            normal((cyc.batch_sizes[k], cyc.tprime_pad[k],
                    cyc.label_pad[k] + 1, vocab), mix["logit_scale"], seed,
                   10 + k, device).requires_grad_(True)
            for k in range(len(cyc.bounds))]
        lattice_s = FRAME_S * cyc.subsample
        self.inputs, self.work = [], []
        for b in cyc.batches:
            self.inputs.append((
                torch.from_numpy(b.labels).to(device),
                torch.from_numpy(b.tprime.astype(np.int32)).to(device),
                torch.from_numpy(b.label_lengths.astype(np.int32)).to(
                    device)))
            bytes_, flops = counts.padded_loss_work(
                b.tprime, b.label_lengths, cyc.tprime_pad[b.bucket],
                cyc.label_pad[b.bucket], vocab)
            self.work.append({
                "loss_audio_s": float(b.tprime.sum()) * lattice_s,
                "least_s": counts.loss_least_seconds(bytes_, flops)})
        self._sample(seed)
        self.costs, self.kept = [], {}

    def _sample(self, seed: int) -> None:
        """The steps of the first cycle, and the utterances of each, whose
        gradient rows the comparison reads, drawn from the seed among the
        batches of the longest bucket: those rows are the largest, and
        keeping them costs every seed the same memory."""
        cyc = self.cycle
        rng = np.random.default_rng([derive(seed, 2), 1])
        longest = max(range(len(cyc.bounds)), key=lambda k: cyc.bounds[k])
        pool = [i for i, b in enumerate(cyc.batches) if b.bucket == longest]
        steps = rng.choice(pool, min(SAMPLED_STEPS, len(pool)),
                           replace=False)
        self.sampled = {
            int(i): sorted(rng.choice(cyc.batch_sizes[longest], SAMPLED_ROWS,
                                      replace=False).tolist())
            for i in steps}

    def _call(self, i: int):
        j = i % len(self.cycle.batches)
        x = self.logits[self.cycle.batches[j].bucket]
        labels, tprime, slen = self.inputs[j]
        costs = loss_fn(x, labels, tprime, slen, self.blank)
        (grad,) = torch.autograd.grad(costs.sum(), x)
        return costs.detach(), grad

    def warm(self, steps=None) -> None:
        for i in range(steps or len(self.cycle.batches)):
            self._call(i)

    def step(self, i: int) -> dict:
        costs, grad = self._call(i)
        self.costs.append(costs)
        rows = self.sampled.get(i)
        if rows is not None:
            self.kept[i] = grad[rows]
        return self.work[i % len(self.work)]

    def traced_step(self, j: int) -> dict:
        self._call(j)
        return self.work[j]

    def trace_batches(self):
        return list(range(len(self.cycle.batches))) * TRACE_CYCLES

    # --- the comparison ---------------------------------------------------

    def _reference(self, j: int, rows=None, transform=None):
        b = self.cycle.batches[j]
        x = self.logits[b.bucket].detach()
        if transform is not None:
            x = transform(x)
        labels, tprime, slen = self.inputs[j][:3]
        return padded_loss(x, labels, tprime, slen, self.blank, rows)

    def _readings(self, costs_of, grads_of, limits):
        """Numbers compared: cost_rel (the largest relative cost gap over
        every step) and grad_dir (the largest gap of a sampled utterance's
        unit-norm gradient rows); a step fails where either passes its
        limit."""
        n = len(self.cycle.batches)
        steps = len(costs_of)
        failed = set()
        cost_rel = 0.0
        for j in range(min(n, steps)):
            ref, _ = self._reference(j)
            got = torch.stack(costs_of[j::n]).double()
            rel = ((got - ref).abs() / ref.abs()).amax(dim=1)
            cost_rel = max(cost_rel, float(rel.max()))
            for k, r in enumerate(rel.tolist()):
                if not r <= limits.get("cost_rel", float("inf")):
                    failed.add(j + k * n)
        grad_dir = 0.0
        for i, rows in sorted(self.sampled.items()):
            if i not in grads_of:
                continue
            _, ref = self._reference(i % n, rows)
            for g, r in zip(grads_of[i], ref):
                gap = row_direction_gap(g, r)
                grad_dir = max(grad_dir, gap)
                if not gap <= limits.get("grad_dir", float("inf")):
                    failed.add(i)
        return {"cost_rel": cost_rel, "grad_dir": grad_dir}, steps, len(
            failed)

    def check(self, limits: dict):
        return self._readings(self.costs, self.kept, limits)

    def control(self):
        """The same numbers for the reference computed on logits rounded
        to bfloat16, the precision below the cell's float32."""
        n = len(self.cycle.batches)

        def bf16(x):
            return x.to(torch.bfloat16).float()

        costs = [self._reference(j, transform=bf16)[0].float()
                 for j in range(n)]
        grads = {i: self._reference(i % n, rows, transform=bf16)[1]
                 for i, rows in self.sampled.items()}
        return self._readings(costs, grads, {})[0]
