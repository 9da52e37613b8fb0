"""flax's default initialisers, drawn from an explicit ``torch.Generator``.

The JAX models take flax's defaults: ``lecun_normal`` kernels (a normal of
variance 1/fan_in truncated at two standard deviations, rescaled so the
truncated variance is 1/fan_in) and zero biases for ``Dense`` and ``Conv``;
``LayerNorm`` scale 1 and bias 0; ``Embed`` a normal of variance
1/embed_dim; the LSTM cell's input kernels ``lecun_normal`` and its
recurrent kernels orthogonal, one gate at a time. ``init_like_flax`` gives a
torch module the same distributions (not the same draws: the PRNGs
differ), so a model built on the card alone starts where a flax model
starts. Parameters are drawn on the CPU, so one seed gives the same weights
whatever device the model then moves to.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..convert import _device

# The standard deviation of a unit normal truncated to [-2, 2]: flax's
# truncated_normal initialisers divide by it (jax.nn.initializers).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


@torch.no_grad()
def init_like_flax(module: nn.Module,
                   generator: Optional[torch.Generator] = None) -> None:
    """Re-draw every parameter of `module` (its submodules in registration
    order) with flax's default initialiser for the layer it stands for."""
    from .predictor import LstmCell  # predictor.py imports this module

    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
        elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, m.embedding_dim ** -0.5,
                            generator=generator)
        elif isinstance(m, LstmCell):
            lecun_normal_(m.weight_ih, m.input_size, generator)
            for gate in m.weight_hh.split(m.hidden_size):  # i, f, g, o
                nn.init.orthogonal_(gate, generator=generator)
            nn.init.zeros_(m.bias_hh)
        else:
            continue
        if isinstance(getattr(m, "bias", None), torch.Tensor):
            nn.init.zeros_(m.bias)


def finish_init(module: nn.Module, generator: Optional[torch.Generator],
                device) -> nn.Module:
    """init_like_flax on the CPU, then `module` on `device` (the card unless
    the caller names another)."""
    init_like_flax(module, generator)
    return module.to(_device(device))
