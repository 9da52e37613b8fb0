"""Moves the state the JAX package and the port share into torch tensors.

The loss holds no learned weights, so what crosses between the two
packages is the loss's inputs and its bands, as numpy arrays: logits,
labels, lengths, and ``Bands(min_s, max_s)``. Integer arrays become int32
tensors, as the JAX package keeps them. The functions create tensors, so
they default to ``device="cuda"`` and raise when no GPU is present; pass
``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .ops.bands import Bands


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def _float_tensor(arr) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # torch.from_numpy shares memory
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16, as JAX hands out
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _int_tensor(arr, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.int32)).to(dev)  # a copy


def loss_inputs_from_numpy(logits, labels, input_lengths, label_lengths, *,
                           device="cuda", dtype: Optional[torch.dtype] = None
                           ) -> Tuple[torch.Tensor, ...]:
    """(logits, labels, input_lengths, label_lengths) as tensors on `device`.

    logits keep their dtype unless `dtype` is given (e.g. torch.bfloat16:
    float32 rounds to nearest even, as JAX's astype does).
    """
    dev = _device(device)
    lg = _float_tensor(logits)
    if dtype is not None:
        lg = lg.to(dtype)
    return (lg.to(dev), _int_tensor(labels, dev), _int_tensor(input_lengths, dev),
            _int_tensor(label_lengths, dev))


def bands_from_numpy(min_s, max_s, device="cuda") -> Bands:
    """The JAX package's Bands(min_s, max_s), as [B, T] int32 tensors."""
    dev = _device(device)
    return Bands(_int_tensor(min_s, dev), _int_tensor(max_s, dev))
