"""Packed-layout compatibility shims.

PyTorch counterpart of ``monotonic_rnnt_tpu/ops/packing.py``. The reference
consumes activations in a *packed* layout, one flat
[sum_b T_b*(S_b+1), V] tensor with per-sample row offset `(t*(S_b+1)+s)`
(reference: cpu_workspace_manager.h:125-135, gpu_workspace_manager.h:
112-122), so that variable-length batches waste no memory. The loss runs on
the padded [B, T_max, S_max+1, V] layout; these shims convert between the
two on the tensor's device, from one host-to-device copy of a row index
built with numpy from the host lengths (the packed shape depends on them,
exactly as in the reference where T[]/S[] are host arrays).

``pack_acts`` is a row gather (``index_select``), whose backward scatters
each packed row's gradient back to its one padded cell. ``unpack_acts``
copies the packed rows into a zero tensor (``index_copy_``), whose backward
is the gather of pack_acts. So ``monotonic_rnnt_loss_packed``'s gradient is
exactly pack_acts of the padded loss's gradient, made by the padded loss's
own route and kernels. (The JAX package unpacks by a gather with padding
cells pointing at row 0; the gather's backward would then add every padding
cell's zero into row 0, a scatter with tens of thousands of repeats of one
index.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.status import RnntError, Status
from .loss import monotonic_rnnt_loss


def _as_host_lengths(input_lengths, label_lengths) -> Tuple[np.ndarray,
                                                           np.ndarray]:
    """The [B] lengths as int64 numpy arrays; a tensor is copied to the host."""
    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
        return np.asarray(a).astype(np.int64)

    try:
        return host(input_lengths), host(label_lengths)
    except Exception as exc:
        raise RnntError(
            Status.INVALID_VALUE,
            "packed-layout APIs need concrete (host) lengths; use the "
            "padded-layout API otherwise") from exc


def packed_row_indices(ilen: np.ndarray, slen: np.ndarray, t_max: int,
                       s1: int):
    """Map padded cells -> packed rows.

    Returns (idx [B, t_max, s1] int32 with -1 on padding, total_rows).
    Row of cell (b, t, s) is offset_b + t*(S_b+1) + s, matching
    cpu_workspace_manager.h:125-135.
    """
    rows_per_sample = ilen * (slen + 1)
    offsets = np.concatenate([[0], np.cumsum(rows_per_sample)[:-1]])
    t_idx = np.arange(t_max)[None, :, None]
    s_idx = np.arange(s1)[None, None, :]
    valid = (t_idx < ilen[:, None, None]) & (s_idx <= slen[:, None, None])
    idx = (offsets[:, None, None] + t_idx * (slen[:, None, None] + 1) + s_idx)
    idx = np.where(valid, idx, -1)
    return idx.astype(np.int32), int(rows_per_sample.sum())


def _padded_rows_of_packed(idx: np.ndarray, total: int) -> np.ndarray:
    """Packed row r -> its flat padded row (b*t_max*s1 + t*s1 + s), int64."""
    flat = idx.reshape(-1)
    cells = np.flatnonzero(flat >= 0)
    src = np.empty(total, np.int64)
    src[flat[cells]] = cells
    return src


def unpack_acts(acts_packed: torch.Tensor, input_lengths, label_lengths,
                t_max: Optional[int] = None,
                s_max: Optional[int] = None) -> torch.Tensor:
    """Packed [sum T_b*(S_b+1), V] -> padded [B, T_max, S_max+1, V] (zeros pad)."""
    ilen, slen = _as_host_lengths(input_lengths, label_lengths)
    t_max = int(t_max or ilen.max())
    s1 = int((s_max or slen.max()) + 1)
    idx, total = packed_row_indices(ilen, slen, t_max, s1)
    if acts_packed.shape[0] != total:
        raise RnntError(
            Status.INVALID_VALUE,
            f"packed acts have {acts_packed.shape[0]} rows, lengths imply "
            f"{total}")
    rows = torch.from_numpy(_padded_rows_of_packed(idx, total)).to(
        acts_packed.device)
    v = acts_packed.shape[1]
    out = acts_packed.new_zeros((len(ilen) * t_max * s1, v))
    out.index_copy_(0, rows, acts_packed)
    return out.view(len(ilen), t_max, s1, v)


def pack_acts(acts_padded: torch.Tensor, input_lengths,
              label_lengths) -> torch.Tensor:
    """Padded [B, T_max, S_max+1, V] -> packed [sum T_b*(S_b+1), V]."""
    ilen, slen = _as_host_lengths(input_lengths, label_lengths)
    batch, t_max, s1, v = acts_padded.shape
    idx, total = packed_row_indices(ilen, slen, t_max, s1)
    rows = torch.from_numpy(_padded_rows_of_packed(idx, total)).to(
        acts_padded.device)
    return acts_padded.reshape(batch * t_max * s1, v).index_select(0, rows)


def monotonic_rnnt_loss_packed(
    acts: torch.Tensor,
    labels: torch.Tensor,
    input_lengths,
    label_lengths,
    *,
    blank_id: int = 0,
    alignment: Optional[torch.Tensor] = None,
    max_distance_from_alignment: int = 0,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Reference-compatible packed-layout loss.

    Mirrors the reference Python API surface (monotonic_rnnt_op.py:121-163):
    acts [sum_b T_b*(S_b+1), V], labels [B, >= S_max], per-sample lengths
    (host arrays, or tensors copied to the host), optional alignment
    restriction ([B, >= T_max], sliced to T_max). Returns [B] f32 costs on
    acts' device; the gradient w.r.t. the packed acts comes from autograd
    through the unpack (see the module doc), in acts' dtype.
    """
    ilen, slen = _as_host_lengths(input_lengths, label_lengths)
    t_max, s_max = int(ilen.max()), int(slen.max())
    padded = unpack_acts(acts, ilen, slen, t_max, s_max)
    if labels.shape[1] < s_max:
        raise RnntError(Status.INVALID_VALUE,
                        f"labels second dim {labels.shape[1]} < S_max {s_max}")
    align = alignment
    if align is not None and align.shape[1] != t_max:
        align = align[:, :t_max]
    dev = acts.device
    return monotonic_rnnt_loss(
        padded, labels[:, :s_max],
        torch.from_numpy(ilen.astype(np.int32)).to(dev),
        torch.from_numpy(slen.astype(np.int32)).to(dev),
        blank_id=blank_id, alignment=align,
        max_distance_from_alignment=max_distance_from_alignment,
        backend=backend)
