"""The monotonic RNN-T loss in plain PyTorch: the benchmark's reference.

One decision per lattice frame: at frame t in state s (labels emitted so
far) the model emits blank and stays, or emits label s + 1 and moves on:

    alpha(t, s) = logaddexp(alpha(t-1, s) + log p(blank | t, s),
                            alpha(t-1, s-1) + log p(y_s | t, s-1)),
    alpha(-1, s) = [s == 0],      cost_b = -alpha(T_b - 1, S_b),

with log p(v | t, s) the log-softmax of the logits over the vocabulary.
The recursion runs in float64 on a finite stand-in for minus infinity, so
that autograd through it stays finite; the gradient with respect to the
logits follows from the gradients with respect to the two log-probability
tables by the log-softmax's chain rule.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

NEG = -1e30


def label_index(labels: torch.Tensor, s1: int) -> torch.Tensor:
    """[B, S1] label id taken from each lattice state (0 past the labels)."""
    out = torch.zeros((labels.shape[0], s1), dtype=torch.int64,
                      device=labels.device)
    n = min(labels.shape[1], s1)
    out[:, :n] = labels[:, :n].long()
    return out


def emit_mask(label_lengths: torch.Tensor, s1: int) -> torch.Tensor:
    """[B, S1] True where state s may emit a label (s < S_b)."""
    s = torch.arange(s1, device=label_lengths.device)
    return s[None, :] < label_lengths.long()[:, None]


def alpha_costs(lp_blank: torch.Tensor, lp_label: torch.Tensor,
                tprime: torch.Tensor, label_lengths: torch.Tensor
                ) -> torch.Tensor:
    """Costs [B] from the [B, T, S1] log-probability tables; lp_label holds
    NEG where a state cannot emit. Differentiable."""
    batch, t_max, s1 = lp_blank.shape
    dev = lp_blank.device
    alpha = torch.full((batch, s1), NEG, dtype=lp_blank.dtype, device=dev)
    alpha[:, 0] = 0.0
    pad = torch.full((batch, 1), NEG, dtype=lp_blank.dtype, device=dev)
    tprime = tprime.to(dev).long()
    for t in range(t_max):
        stay = alpha + lp_blank[:, t]
        move = torch.cat([pad, (alpha + lp_label[:, t])[:, :-1]], dim=1)
        alpha = torch.where((t < tprime)[:, None],
                            torch.logaddexp(stay, move), alpha)
    return -alpha.gather(1, label_lengths.to(dev).long()[:, None])[:, 0]


def logprob_tables(logits: torch.Tensor, labels: torch.Tensor,
                   label_lengths: torch.Tensor, blank_id: int,
                   block: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """float64 log p(blank) and log p(label) tables [B, T, S1] of [B, T,
    S1, V] logits, computed `block` utterances at a time (no gradient)."""
    batch, _, s1, _ = logits.shape
    idx = label_index(labels.to(logits.device), s1)
    can_emit = emit_mask(label_lengths.to(logits.device), s1)
    blanks, emits = [], []
    with torch.no_grad():
        for b0 in range(0, batch, block):
            x = logits[b0:b0 + block].double()
            lse = torch.logsumexp(x, dim=-1)
            blanks.append(x[..., blank_id] - lse)
            lab = idx[b0:b0 + block, None, :, None].expand(
                -1, x.shape[1], -1, 1)
            lp = torch.gather(x, 3, lab)[..., 0] - lse
            emits.append(torch.where(can_emit[b0:b0 + block, None, :], lp,
                                     NEG))
            del x, lse
    return torch.cat(blanks), torch.cat(emits)


def padded_loss(logits: torch.Tensor, labels: torch.Tensor,
                tprime: torch.Tensor, label_lengths: torch.Tensor,
                blank_id: int = 0, rows: Optional[Sequence[int]] = None):
    """Costs [B] (float64) of the padded monotonic RNN-T loss and, for the
    batch rows in `rows`, d sum(costs) / d logits as float64 [len(rows),
    T, S1, V] (zero outside each utterance's lattice)."""
    lp_blank, lp_label = logprob_tables(logits, labels, label_lengths,
                                        blank_id)
    if rows is None:
        return alpha_costs(lp_blank, lp_label, tprime, label_lengths), None
    lp_blank.requires_grad_(True)
    lp_label.requires_grad_(True)
    with torch.enable_grad():
        costs = alpha_costs(lp_blank, lp_label, tprime, label_lengths)
        g_blank, g_label = torch.autograd.grad(costs.sum(),
                                               (lp_blank, lp_label))
    idx = label_index(labels.to(logits.device), logits.shape[2])
    grads = []
    for r in rows:
        p = torch.softmax(logits[r].double(), dim=-1)
        g = -(g_blank[r] + g_label[r])[..., None] * p
        g[..., blank_id] += g_blank[r]
        lab = idx[r][None, :, None].expand(p.shape[0], -1, 1)
        g.scatter_add_(2, lab, g_label[r][..., None])
        grads.append(g)
        del p
    return costs.detach(), torch.stack(grads)


def padded_costs_differentiable(logits: torch.Tensor, labels: torch.Tensor,
                                tprime: torch.Tensor,
                                label_lengths: torch.Tensor,
                                blank_id: int = 0) -> torch.Tensor:
    """Costs [B] differentiable with respect to the logits (float32
    log-softmax, float64 recursion): the loss inside a training step."""
    s1 = logits.shape[2]
    logp = torch.log_softmax(logits.float(), dim=-1)
    idx = label_index(labels.to(logits.device), s1)
    lp_blank = logp[..., blank_id].double()
    lab = idx[:, None, :, None].expand(-1, logits.shape[1], -1, 1)
    lp_label = torch.gather(logp, 3, lab)[..., 0].double()
    can_emit = emit_mask(label_lengths.to(logits.device), s1)
    lp_label = torch.where(can_emit[:, None, :], lp_label, NEG)
    return alpha_costs(lp_blank, lp_label, tprime, label_lengths)


# --- the alignment-restricted (banded) loss ----------------------------------
#
# The same lattice, with alpha(t, s) allowed only inside a band around a
# reference alignment (the restriction of the original monotonic RNN-T's
# align-restrict op): with mapping[k] the number of labels the alignment
# emits in its first k frames and `shift` the band's half-width in frames,
#     min_s[t] = mapping[max(0, t + 1 - shift)],
#     max_s[t] = mapping[min(T_b, t + 1 + shift)],
# both at most S_b, and alpha(t, s) is kept where
#     max(min_s[t], t - (T_b - 1 - S_b)) <= s <= min(max_s[t], t + 1, S_b).
# The logits come packed [B, T, W, V]: slot (t, w) holds lattice state
# offset[t] + w, where offset[t] is the lower end of the band's window at
# t - 1 (so the window at t holds the states alpha(t - 1, .) leaves from),
# raised at most one state a frame and capped at S1 - W; the loss is that
# of the band clipped to the window (max_s[t] <= offset[t] + W - 1).


def alignment_bands(alignment: torch.Tensor, tprime: torch.Tensor,
                    label_lengths: torch.Tensor, shift: int, blank_id: int):
    """(min_s, max_s) [B, T] of the band of half-width `shift` frames."""
    batch, t_max = alignment.shape
    dev = alignment.device
    tlen = tprime.long().to(dev)[:, None]
    t = torch.arange(t_max, device=dev)[None, :]
    emits = ((alignment != blank_id) & (t < tlen)).long()
    mapping = torch.cat([torch.zeros((batch, 1), dtype=torch.long,
                                     device=dev), emits.cumsum(1)], dim=1)
    lo = torch.minimum((t + 1 - shift).clamp(min=0), tlen)
    hi = torch.minimum((t + 1 + shift).clamp(min=0), tlen)
    slen = label_lengths.long().to(dev)[:, None]
    return (torch.minimum(mapping.gather(1, lo), slen),
            torch.minimum(mapping.gather(1, hi), slen))


def _lag(x: torch.Tensor, first: int) -> torch.Tensor:
    return torch.cat([torch.full_like(x[:, :1], first), x[:, :-1]], dim=1)


def band_offsets(tprime, label_lengths, min_s, s1: int, width: int):
    """offset [B, T] of the packed window (see above)."""
    t_max = min_s.shape[1]
    dev = min_s.device
    t = torch.arange(t_max, device=dev)[None, :]
    tlen = tprime.long().to(dev)[:, None]
    slen = label_lengths.long().to(dev)[:, None]
    beta_lo = torch.maximum(_lag(min_s.long(), 0), t - (tlen - slen))
    low = torch.minimum(beta_lo.clamp(min=0), slen)
    raw = (low - _lag(low, 0)).clamp(0, 1).cumsum(1)
    return _lag(raw, 0).clamp(max=s1 - width)


def band_slots(tprime, label_lengths, min_s, s1: int, width: int):
    """[B, T, W] lattice state of each packed slot."""
    offset = band_offsets(tprime, label_lengths, min_s, s1, width)
    return offset[:, :, None] + torch.arange(width, device=offset.device)


def banded_loss(band_logits: torch.Tensor, labels: torch.Tensor,
                tprime: torch.Tensor, label_lengths: torch.Tensor,
                min_s: torch.Tensor, max_s: torch.Tensor,
                blank_id: int = 0, rows: Optional[Sequence[int]] = None,
                block: int = 2):
    """Costs [B] (float64) of the banded loss on packed [B, T, W, V] logits
    and, for the rows in `rows`, d sum(costs) / d band_logits as float64
    [len(rows), T, W, V]."""
    batch, t_max, width, _ = band_logits.shape
    s1 = labels.shape[1] + 1
    dev = band_logits.device
    tprime = tprime.long().to(dev)
    slen = label_lengths.long().to(dev)
    slots = band_slots(tprime, slen, min_s.to(dev), s1, width)
    offset = slots[:, :, 0]
    max_s = torch.minimum(max_s.long().to(dev), offset + width - 1)
    idx = label_index(labels.to(dev), s1)
    slot_label = idx.gather(1, slots.reshape(batch, -1)).view_as(slots)
    can_emit = slots < slen[:, None, None]
    blanks, emits = [], []
    with torch.no_grad():
        for b0 in range(0, batch, block):
            x = band_logits[b0:b0 + block].double()
            lse = torch.logsumexp(x, dim=-1)
            blanks.append(x[..., blank_id] - lse)
            lp = torch.gather(x, 3, slot_label[b0:b0 + block, ..., None])
            emits.append(torch.where(can_emit[b0:b0 + block],
                                     lp[..., 0] - lse, NEG))
            del x, lse
    band_blank = torch.cat(blanks).requires_grad_(rows is not None)
    band_emit = torch.cat(emits).requires_grad_(rows is not None)
    t = torch.arange(t_max, device=dev)[None, :]
    a_lo = torch.maximum(min_s.long().to(dev), t - (tprime[:, None] - 1
                                                    - slen[:, None]))
    a_hi = torch.minimum(torch.minimum(max_s, t + 1), slen[:, None])
    s = torch.arange(s1, device=dev)[None, None, :]
    keep = (s >= a_lo[:, :, None]) & (s <= a_hi[:, :, None])
    with torch.enable_grad():
        full = torch.full((batch, t_max, s1), NEG, dtype=torch.float64,
                          device=dev)
        lp_blank = full.scatter(2, slots, band_blank)
        lp_label = full.scatter(2, slots, band_emit)
        costs = _masked_alpha_costs(lp_blank, lp_label, keep, tprime, slen)
        if rows is None:
            return costs.detach(), None
        g_blank, g_label = torch.autograd.grad(costs.sum(),
                                               (band_blank, band_emit))
    grads = []
    for r in rows:
        p = torch.softmax(band_logits[r].double(), dim=-1)
        g = -(g_blank[r] + g_label[r])[..., None] * p
        g[..., blank_id] += g_blank[r]
        g.scatter_add_(2, slot_label[r][..., None], g_label[r][..., None])
        grads.append(g)
        del p
    return costs.detach(), torch.stack(grads)


def _masked_alpha_costs(lp_blank, lp_label, keep, tprime, label_lengths):
    """alpha_costs with alpha(t, s) held at NEG outside `keep` [B, T, S1]."""
    batch, t_max, s1 = lp_blank.shape
    dev = lp_blank.device
    alpha = torch.full((batch, s1), NEG, dtype=lp_blank.dtype, device=dev)
    alpha[:, 0] = 0.0
    pad = torch.full((batch, 1), NEG, dtype=lp_blank.dtype, device=dev)
    for t in range(t_max):
        stay = alpha + lp_blank[:, t]
        move = torch.cat([pad, (alpha + lp_label[:, t])[:, :-1]], dim=1)
        new = torch.where(keep[:, t], torch.logaddexp(stay, move), NEG)
        alpha = torch.where((t < tprime)[:, None], new, alpha)
    return -alpha.gather(1, label_lengths[:, None])[:, 0]
