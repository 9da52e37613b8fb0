"""Input validation and error reporting.

PyTorch counterpart of ``monotonic_rnnt_tpu/utils/status.py``: the same
status enum, the same typed exception and the same checks with the same
messages, on torch tensors.
"""

from __future__ import annotations

import enum

import torch


class Status(enum.Enum):
    """Parity enum with reference include/status.h:4-10."""

    SUCCESS = 0
    MEMOPS_FAILED = 1
    INVALID_VALUE = 2
    EXECUTION_FAILED = 3
    UNKNOWN_ERROR = 4


class RnntError(ValueError):
    """Raised for invalid monotonic RNN-T inputs."""

    def __init__(self, status: Status, message: str):
        # args set here rather than through super().__init__, which
        # torch.compile cannot trace: a compiled call that raises then
        # names this error and its message.
        self.args = (f"[{status.name}] {message}",)
        self.status = status


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def tracing() -> bool:
    """Whether torch.export or torch.compile is tracing the call: the
    lengths are then data of a graph, as JAX's traced values are, and
    nothing reads their values on the host."""
    return torch.compiler.is_exporting() or torch.compiler.is_compiling()


def validate_loss_inputs(logits, labels, input_lengths, label_lengths) -> None:
    """Eager shape/dtype/length validation of the padded-layout API.

    Enforces the reference's constraints (cpu_workspace_manager.h:99-115):
    B > 0, T_b > 0, S_b >= 0 and T_b >= S_b. Under torch.export and
    torch.compile only the shape and dtype checks run: the length values
    are data.
    """
    if logits.dim() != 4:
        raise RnntError(Status.INVALID_VALUE,
                        "logits must be [B, T, S+1, V], got shape "
                        f"{tuple(logits.shape)}")
    batch, t_max, s1, v = logits.shape
    if batch <= 0 or t_max <= 0 or s1 <= 0 or v <= 0:
        raise RnntError(Status.INVALID_VALUE,
                        "all logits dims must be positive, got "
                        f"{tuple(logits.shape)}")
    if labels.dim() != 2 or labels.shape[0] != batch:
        raise RnntError(Status.INVALID_VALUE,
                        f"labels must be [B, S_max], got {tuple(labels.shape)}")
    if labels.shape[1] < s1 - 1:
        raise RnntError(Status.INVALID_VALUE,
                        f"labels second dim ({labels.shape[1]}) must be >= "
                        f"S_max ({s1 - 1})")
    for name, arr in (("input_lengths", input_lengths),
                      ("label_lengths", label_lengths)):
        if tuple(arr.shape) != (batch,):
            raise RnntError(Status.INVALID_VALUE,
                            f"{name} must be [B]={batch}, got "
                            f"{tuple(arr.shape)}")
        if not _is_integer(arr.dtype):
            raise RnntError(Status.INVALID_VALUE,
                            f"{name} must be integer, got "
                            f"{str(arr.dtype).removeprefix('torch.')}")

    # The value checks need the lengths on the host: one copy of two [B]
    # tensors, the same eager check the JAX version makes outside jit. A
    # graph that torch.export or torch.compile traces holds no such check,
    # as JAX holds none on traced lengths (status.py:65-70).
    if tracing():
        return
    ilen = input_lengths.detach().cpu()
    slen = label_lengths.detach().cpu()
    if bool((ilen <= 0).any()):
        raise RnntError(Status.INVALID_VALUE, "input_lengths must be >= 1")
    if bool((slen < 0).any()):
        raise RnntError(Status.INVALID_VALUE, "label_lengths must be >= 0")
    if bool((ilen < slen).any()):
        raise RnntError(Status.INVALID_VALUE,
                        "monotonic RNN-T requires T_b >= S_b for every sample")
    if bool((ilen > t_max).any()):
        raise RnntError(Status.INVALID_VALUE,
                        f"input_lengths exceed padded T_max={t_max}")
    if bool((slen > s1 - 1).any()):
        raise RnntError(Status.INVALID_VALUE,
                        f"label_lengths exceed padded S_max={s1 - 1}")
