"""The training step's optimiser in plain PyTorch: the benchmark's
reference for the global-norm clip, AdamW and the learning-rate schedule.

* the clip: every gradient times 5 / ||g|| where the global norm ||g|| is
  5 or more, unchanged below;
* AdamW (Loshchilov and Hutter): m = b1 m + (1 - b1) g,
  v = b2 v + (1 - b2) g^2, p -= lr (m_hat / (sqrt(v_hat) + eps) + wd p),
  with bias-corrected m_hat, v_hat, b1 0.9, b2 0.999, eps 1e-8;
* the schedule: lr x count / warmup over the warm-up, then a cosine from
  lr to 0 over max(10 warmup, 10000) - warmup updates, evaluated at the
  update count before the update (so the first update has lr 0).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

CLIP = 5.0
B1, B2, EPS = 0.9, 0.999, 1e-8


def learning_rate(count: int, peak: float, warmup: int) -> float:
    if count < warmup:
        return peak * count / warmup
    span = max(10 * warmup, 10_000) - warmup
    done = min(count - warmup, span)
    return peak * 0.5 * (1.0 + math.cos(math.pi * done / span))


def clip(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Clips in place; returns the global norm before clipping."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    if norm >= CLIP:
        for g in grads.values():
            g.mul_(float(CLIP / norm))
    return norm


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], peak_lr: float,
                 weight_decay: float, warmup: int, m=None, v=None,
                 count: int = 0):
        """Fresh moments and count, or the given ones (copied)."""
        self.params = params
        self.peak, self.wd, self.warmup = peak_lr, weight_decay, warmup
        self.m = {k: torch.zeros_like(p) if m is None else
                  m[k].to(p.device, copy=True) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) if v is None else
                  v[k].to(p.device, copy=True) for k, p in params.items()}
        self.count = count

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        lr = learning_rate(self.count, self.peak, self.warmup)
        self.count += 1
        t = self.count
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(B1).add_(g, alpha=1 - B1)
            self.v[k].mul_(B2).addcmul_(g, g, value=1 - B2)
            m_hat = self.m[k] / (1 - B1 ** t)
            v_hat = self.v[k] / (1 - B2 ** t)
            p.sub_(lr * (m_hat / (v_hat.sqrt() + EPS) + self.wd * p))
