"""The copy-ceiling kernels, their wrappers and their plain versions.

Counterpart of ``monotonic_rnnt_tpu/ops/pallas/stream.py``: exact copies
whose time, for one read and one write of the tensor, is the card's
achievable HBM copy rate, the yardstick a loss kernel's time is held
against. All three launch kernels of csrc/stream.cu:

* ``stream_copy`` (TPU kernel at stream.py:50), mode ``"vmem"``: a register
  copy (``mrnnt_copy_tiles_kernel``): the [block_rows, C] blocks cut into
  8 KB tiles, one CTA a tile, which the block scheduler hands out in order;
  16-byte loads and stores where both pointers agree mod 16 (narrower units
  otherwise, and single bytes at a tile's unaligned head and tail); mode
  ``"dma"``: TMA bulk copies of 16 KB chunks of the ``nbuf`` slabs through a
  ring in shared memory, one persistent CTA a SM, the chunks drawn in order
  from a zeroed int64 ticket counter of the call's own
  (``mrnnt_copy_tma_kernel``). On the TPU "vmem" staged blocks through VMEM
  and "dma" copied HBM to HBM; Hopper has no HBM-to-HBM copy engine a
  kernel can drive, so "dma" is the copy in which no thread touches the
  data;
* ``stream_copy_blocked`` (stream.py:82): the order in which the DP-fused
  kernels (rows 1-2) stream the logits, on [B, T, S1, V]: one sample's
  tt*S1 rows of a t-block after another, t-major across samples, a warp
  per V-row; persistent warps draw pieces of that row sequence in order
  from a zeroed int64 ticket counter of the call's own
  (``mrnnt_copy_rows_kernel``);
* ``stream_copy_blocked_tbsv`` (stream.py:114): [T, B, S1, V], whose
  [tt, B, S1, V] t-blocks are each one contiguous run (the layout control),
  by the register copy of ``"vmem"`` on the t-blocks in t order. It does
  not share ``stream_copy_blocked``'s kernel, so the pair compares layout
  and kernel together.

The copy moves bytes, so any dtype goes. Each keeps its Pallas function's
name, arguments (without ``interpret``) and ValueErrors; an unknown mode
raises too, where the Pallas function took it for "vmem", and the dma mode
raises on a slab that is not a whole number of 16-byte units on 16-byte
aligned tensors (TMA bulk copies move 16-byte multiples). Each wrapper
takes its plain version for CPU tensors, launches its kernel or raises for
CUDA tensors, and adds one to ``kernels.LAUNCHES[<name>]`` when it has
launched. The plain versions copy block by block as the Pallas grids cut
the tensor.
"""

from __future__ import annotations

import torch

from .kernels import LAUNCHES, _call, _check_cuda, _ptr

_MODES = ("vmem", "dma")


def _check_flat(x, mode: str, block_rows: int, nbuf: int) -> int:
    """The 2-D shape and its divisibility; returns the rows of one block."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if x.dim() != 2:
        raise ValueError("stream_copy takes a 2-D [R, C] tensor, got shape "
                         f"{tuple(x.shape)}")
    rows = x.shape[0]
    if mode == "dma":
        if rows % nbuf:
            raise ValueError(f"rows {rows} not divisible by nbuf {nbuf}")
        return rows // nbuf
    if rows % block_rows:
        raise ValueError(f"rows {rows} not divisible by block {block_rows}")
    return block_rows


def _check_blocked(x, tt: int, layout: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"the blocked copy takes a 4-D {layout} tensor, got "
                         f"shape {tuple(x.shape)}")
    t = x.shape[1] if layout == "[B, T, S1, V]" else x.shape[0]
    if t % tt:
        raise ValueError(f"T {t} not divisible by tt {tt}")


def _cuda_operand(x) -> torch.Tensor:
    _check_cuda(x)
    if not x.is_contiguous():
        raise ValueError("the copy kernels take a contiguous tensor")
    return torch.empty_like(x)


# --- stream_copy ---------------------------------------------------------------

def stream_copy_plain(x, mode: str = "vmem", block_rows: int = 512,
                      nbuf: int = 8) -> torch.Tensor:
    """Plain-torch stream_copy: the same checks, one block (or slab) at a time."""
    step = _check_flat(x, mode, block_rows, nbuf)
    out = torch.empty_like(x)
    for r in range(0, x.shape[0], max(step, 1)):
        out[r:r + step] = x[r:r + step]
    return out


def stream_copy(x, mode: str = "vmem", block_rows: int = 512,
                nbuf: int = 8) -> torch.Tensor:
    """Copy a [R, C] tensor at the card's best copy rate (see the module doc).

    mode "vmem": R % block_rows == 0, the blocks of block_rows rows cut into
    the register copy's tiles. mode "dma": R % nbuf == 0, the rows cut into
    nbuf slabs of TMA bulk copies. Returns a new tensor equal to x bit for
    bit.
    """
    step = _check_flat(x, mode, block_rows, nbuf)
    if x.device.type == "cpu":
        return stream_copy_plain(x, mode, block_rows, nbuf)
    out = _cuda_operand(x)
    block_bytes = step * x.shape[1] * x.element_size()
    n_blocks = x.shape[0] // step if step else 0
    if mode == "dma":
        if block_bytes % 16 or x.data_ptr() % 16 or out.data_ptr() % 16:
            raise ValueError(
                "dma mode moves 16-byte units: each slab's bytes "
                f"({block_bytes}) and the tensor's address must be multiples "
                "of 16")
        tickets = torch.zeros(1, dtype=torch.int64, device=x.device)
        _call("mrnnt_stream_copy_dma", x.device, _ptr(x), _ptr(out),
              _ptr(tickets), n_blocks, block_bytes)
    else:
        _call("mrnnt_stream_copy_vmem", x.device, _ptr(x), _ptr(out),
              n_blocks, block_bytes)
    LAUNCHES["stream_copy"] += 1
    return out


# --- the blocked copies --------------------------------------------------------

def stream_copy_blocked_plain(x, tt: int = 1) -> torch.Tensor:
    """Plain-torch stream_copy_blocked: [B, tt, S1, V] blocks in turn."""
    _check_blocked(x, tt, "[B, T, S1, V]")
    out = torch.empty_like(x)
    for t in range(0, x.shape[1], tt):
        out[:, t:t + tt] = x[:, t:t + tt]
    return out


def stream_copy_blocked(x, tt: int = 1) -> torch.Tensor:
    """Copy a [B, T, S1, V] tensor in the DP-fused kernels' order.

    Tile k is sample k % B's tt*S1 rows of t-block k // B, so a t-block is B
    runs one sample's lattice apart; warps copy the tiles' rows in that
    order, one warp per V-row. Returns a new tensor equal to x bit for bit.
    """
    _check_blocked(x, tt, "[B, T, S1, V]")
    if x.device.type == "cpu":
        return stream_copy_blocked_plain(x, tt)
    out = _cuda_operand(x)
    batch, t_max, s1, v = x.shape
    tickets = torch.zeros(1, dtype=torch.int64, device=x.device)
    _call("mrnnt_stream_copy_blocked", x.device, _ptr(x), _ptr(out),
          _ptr(tickets), batch, t_max, s1, v, x.element_size(), tt)
    LAUNCHES["stream_copy_blocked"] += 1
    return out


def stream_copy_blocked_tbsv_plain(x, tt: int = 1) -> torch.Tensor:
    """Plain-torch stream_copy_blocked_tbsv: [tt, B, S1, V] blocks in turn."""
    _check_blocked(x, tt, "[T, B, S1, V]")
    out = torch.empty_like(x)
    for t in range(0, x.shape[0], tt):
        out[t:t + tt] = x[t:t + tt]
    return out


def stream_copy_blocked_tbsv(x, tt: int = 1) -> torch.Tensor:
    """Copy a [T, B, S1, V] tensor in [tt, B, S1, V] blocks, each contiguous.

    The same bytes a t-block as stream_copy_blocked, each t-block one
    contiguous run (the layout control), copied in t order by the register
    copy of stream_copy's "vmem" mode. Returns a new tensor equal to x bit
    for bit.
    """
    _check_blocked(x, tt, "[T, B, S1, V]")
    if x.device.type == "cpu":
        return stream_copy_blocked_tbsv_plain(x, tt)
    out = _cuda_operand(x)
    t_max, batch, s1, v = x.shape
    _call("mrnnt_stream_copy_blocked_tbsv", x.device, _ptr(x), _ptr(out),
          t_max, batch, s1, v, x.element_size(), tt)
    LAUNCHES["stream_copy_blocked_tbsv"] += 1
    return out
