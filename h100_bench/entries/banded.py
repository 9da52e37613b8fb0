"""Timed entry: ``monotonic_rnnt_loss_banded`` forward and backward on a
held band of logits, the alignment-restricted route of long-form training.

Each batch carries a monotonic alignment; a step turns it into the band
with the port's ``bands_from_alignment`` (half-width ``align_shift``
lattice frames), then runs the banded loss on packed [B, T'_pad, W, V]
float32 logits and takes d sum(costs) / d logits. W is the port's
``suggested_band_width`` over the cycle's batches, asked once at set-up,
as a user sizes the band; one band tensor of that width is made on the
device and held.

What is compared is the loss entry's: every step's costs and a few
sampled utterances' gradient rows, against the float64 plain reference of
the banded loss, which derives the band and its packed layout itself.
"""

from __future__ import annotations

import numpy as np
import torch

from monotonic_rnnt_tpu_torch import monotonic_rnnt_loss_banded
from monotonic_rnnt_tpu_torch.ops.bands import (bands_from_alignment,
                                                suggested_band_width)

from .. import counts
from ..reference.loss import alignment_bands, band_slots, banded_loss
from ..traffic import FRAME_S, make_cycle
from ..weights import normal
from . import loss


def loss_fn(logits, labels, tprime, label_lengths, alignment, shift,
            blank_id):
    """The program's call that the window times (a seam for the tests)."""
    bands = bands_from_alignment(alignment, tprime, label_lengths, shift,
                                 blank_id)
    return monotonic_rnnt_loss_banded(logits, labels, tprime, label_lengths,
                                      bands=bands, blank_id=blank_id)


class Entry(loss.Entry):
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.blank = cfg["blank_id"]
        vocab = cfg["vocab_size"]
        self.cycle = cyc = make_cycle(mix, seed, cfg["subsample_factor"],
                                      vocab)
        self.shift = int(mix["align_shift"])
        tpad, s1 = cyc.tprime_pad[0], cyc.label_pad[0] + 1
        self.inputs = []
        width = 1
        for b in cyc.batches:
            labels = torch.from_numpy(b.labels).to(device)
            tprime = torch.from_numpy(b.tprime.astype(np.int32)).to(device)
            slen = torch.from_numpy(b.label_lengths.astype(np.int32)).to(
                device)
            alignment = torch.from_numpy(b.alignment).to(device)
            self.inputs.append((labels, tprime, slen, alignment))
            bands = bands_from_alignment(alignment, tprime, slen, self.shift,
                                         self.blank)
            width = max(width, suggested_band_width(tprime, slen, bands,
                                                    tpad, s1))
        self.logits = [normal((cyc.batch_sizes[0], tpad, width, vocab),
                              mix["logit_scale"], seed, 10,
                              device).requires_grad_(True)]
        lattice_s = FRAME_S * cyc.subsample
        self.work = []
        for b, (_, tprime, slen, alignment) in zip(cyc.batches, self.inputs):
            min_s, _ = alignment_bands(alignment, tprime, slen, self.shift,
                                       self.blank)
            slots = band_slots(tprime, slen, min_s, s1, width)
            t = torch.arange(tpad, device=device)
            inside = ((t[None, :, None] < tprime.long()[:, None, None])
                      & (slots <= slen.long()[:, None, None]))
            bytes_, flops = counts.banded_loss_work(
                int(inside.sum()), b.size, tpad, width, cyc.label_pad[0],
                vocab)
            self.work.append({
                "loss_audio_s": float(b.tprime.sum()) * lattice_s,
                "least_s": counts.loss_least_seconds(bytes_, flops)})
        self._sample(seed)
        self.costs, self.kept = [], {}

    def _call(self, i: int):
        j = i % len(self.cycle.batches)
        x = self.logits[0]
        labels, tprime, slen, alignment = self.inputs[j]
        costs = loss_fn(x, labels, tprime, slen, alignment, self.shift,
                        self.blank)
        (grad,) = torch.autograd.grad(costs.sum(), x)
        return costs.detach(), grad

    def _reference(self, j: int, rows=None, transform=None):
        x = self.logits[0].detach()
        if transform is not None:
            x = transform(x)
        labels, tprime, slen, alignment = self.inputs[j]
        min_s, max_s = alignment_bands(alignment, tprime, slen, self.shift,
                                       self.blank)
        return banded_loss(x, labels, tprime, slen, min_s, max_s, self.blank,
                           rows)
