"""Recognition-quality metrics: batched edit distance, WER/CER.

PyTorch counterpart of ``monotonic_rnnt_tpu/utils/metrics.py``. Levenshtein
distance as a DP over the reference axis carrying one row of the distance
matrix. The row's insertion chain (D[i][j-1] + 1) would serialize the row;
instead the row updates with the exact prefix-min identity

    D[i][j] = j + cummin_k<=j ( cand[k] - k ),   cand[k] = best non-insertion
                                                 value at column k,

so each of the M steps is one vectorized [B, N+1] ``torch.cummin`` on the
inputs' device, with no copy to the host. Scores greedy decodes against
target label sequences.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ErrorStats(NamedTuple):
    errors: torch.Tensor    # [B] edit distance per sequence
    lengths: torch.Tensor   # [B] reference lengths
    rate: torch.Tensor      # scalar: sum(errors) / max(1, sum(lengths))


def _int32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def _device(hyp):
    """hyp's device; an array goes to the card, as the port's entry points
    default to."""
    return hyp.device if isinstance(hyp, torch.Tensor) else torch.device("cuda")


def edit_distance(hyp, hyp_lengths, ref, ref_lengths) -> torch.Tensor:
    """Batched Levenshtein distance between padded id sequences.

    hyp [B, N], ref [B, M] int tensors (or arrays) with per-sample valid
    lengths; padding never matches (masked). Returns [B] int32 distances on
    hyp's device (the card for an array).
    """
    dev = _device(hyp)
    hyp, ref = _int32(hyp, dev), _int32(ref, dev)
    hlen, rlen = _int32(hyp_lengths, dev), _int32(ref_lengths, dev)
    batch, n = hyp.shape
    m = ref.shape[1]

    col = torch.arange(n + 1, dtype=torch.int32, device=dev)[None, :]
    row = col.expand(batch, n + 1)                          # D[0][j] = j
    hyp_valid = col[:, 1:] <= hlen[:, None]                 # [B, N]
    for i in range(1, m + 1):
        sub_hit = (hyp == ref[:, i - 1:i]) & hyp_valid      # [B, N]
        sub = row[:, :-1] + (~sub_hit).to(torch.int32)      # diagonal
        dele = row[:, 1:] + 1                               # skip ref[i-1]
        cand = torch.cat([row[:, :1] + 1, torch.minimum(sub, dele)], dim=1)
        new_row = torch.cummin(cand - col, dim=1).values + col  # + insertions
        # Rows past a sample's reference length keep the previous row, so
        # the final row is row[rlen] for every sample.
        row = torch.where((i <= rlen)[:, None], new_row, row)
    return torch.gather(row, 1, torch.clamp(hlen, max=n)[:, None].long())[:, 0]


def error_rate(hyp, hyp_lengths, ref, ref_lengths) -> ErrorStats:
    """Corpus error rate (WER when ids are words, CER for characters)."""
    errs = edit_distance(hyp, hyp_lengths, ref, ref_lengths)
    rlen = _int32(ref_lengths, errs.device)
    rate = errs.sum() / torch.clamp(rlen.sum(), min=1).to(torch.float32)
    return ErrorStats(errors=errs, lengths=rlen, rate=rate)
