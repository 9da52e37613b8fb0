"""Moves the state the JAX package and the port share into torch tensors.

What crosses between the two packages is the loss's inputs, its bands and
its packed band layout, and the parameters of the fused-joint losses'
joint, as numpy arrays: logits, labels, lengths, ``Bands(min_s, max_s)``,
``BandLayout(offset, d, d_next, width)`` and a dict of joint weights. Integer arrays become int32
tensors, as the JAX package keeps them. The functions create tensors, so
they default to ``device="cuda"`` and raise when no GPU is present; pass
``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .ops.bands import BandLayout, Bands


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


def joint_params_from_numpy(params, device="cuda") -> Dict[str, torch.Tensor]:
    """A joint's numpy parameters as a dict of tensors on `device`.

    The additive tanh joint of the fused-joint losses' tests and benchmarks
    takes {we [De, H], wp [Dp, H], wv [H, V], bv [V]}; any dict of float
    arrays converts, each keeping its dtype. The tensors are copies.
    """
    dev = _device(device)
    return {name: _float_tensor(np.array(arr)).to(dev)
            for name, arr in params.items()}


def bands_from_numpy(min_s, max_s, device="cuda") -> Bands:
    """The JAX package's Bands(min_s, max_s), as [B, T] int32 tensors."""
    dev = _device(device)
    return Bands(_int_tensor(min_s, dev), _int_tensor(max_s, dev))


def band_layout_from_numpy(offset, d, d_next, width: int,
                           device="cuda") -> BandLayout:
    """The JAX package's BandLayout, its arrays as [B, T] int32 tensors."""
    dev = _device(device)
    return BandLayout(_int_tensor(offset, dev), _int_tensor(d, dev),
                      _int_tensor(d_next, dev), int(width))
