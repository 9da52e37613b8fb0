"""How the train-step tests hold gradients and parameters after AdamW.

Adam divides each gradient element by its own running RMS, so an element
whose gradient is rounding noise on both sides (the attention's key bias,
whose true gradient is exactly 0; an element 1e5 times smaller than its
leaf's largest) takes a step of about the lr in a direction that noise
decides, whatever the tolerance of the gradients. Adam also ignores a
constant scale on a leaf's gradient, so the parameters alone cannot see a
leaf whose gradient is c times too large. ``close_params`` therefore holds
the first step's gradients of the two sides at rtol 1e-4 / atol 1e-5 (the
sharded losses' gradient tolerance), then every parameter element at rtol
2e-4 / atol 2e-5 (tests/test_models.py's), except the noise-held ones,
which it finds from the reference's gradients alone and holds within
Adam's drift bound (``models.train.adam_drift_bound``) of their start, on
both sides. At most
HELD_SHARE of each leaf's elements may be held that way, so the rule
cannot swallow a real difference in a small leaf.
No JAX import: the 4-rank worker of tests/test_torch_parallel.py uses it.
"""

import numpy as np
import torch

from monotonic_rnnt_tpu_torch.models.train import adam_drift_bound

KEY_BIAS = "mhsa.key.bias"
NOISE_REL = 1e-5        # |g_ref| below this share of the leaf's largest
HELD_SHARE = 2e-2       # at most this share of a leaf's elements


def noise_held(grad, grad_ref):
    """The elements whose reference gradient is below NOISE_REL of the
    leaf's largest, a threshold of the reference alone, so that the other
    side's error cannot widen it. An element whose gradient is exactly 0 on
    both sides (an embedding row no label uses) is not noise: both sides
    take the same step there."""
    exact_zero = (grad == 0) & (grad_ref == 0)
    small = grad_ref.abs() < NOISE_REL * float(grad_ref.abs().max())
    return small & ~exact_zero


def close_params(got, want, start, grads, grads_ref, lrs, first=1):
    """got, want, start: {name: tensor} after the updates and before them;
    grads, grads_ref: each side's gradients of the first update; lrs: the
    updates' learning rates, from update `first` (1-based, Adam's count).
    Returns the number of noise-held elements."""
    bound = adam_drift_bound(lrs, first) * (1 + 1e-6) + 1e-7
    held_other = 0
    for name, g in got.items():
        g, w = torch.as_tensor(g).double(), torch.as_tensor(want[name]).double()
        s = torch.as_tensor(start[name]).double()
        assert bool(torch.isfinite(g).all()), name
        dg = torch.as_tensor(grads[name]).double()
        dg_ref = torch.as_tensor(grads_ref[name]).double()
        np.testing.assert_allclose(dg.numpy(), dg_ref.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=f"{name} gradient")
        held = noise_held(dg, dg_ref)
        if name.endswith(KEY_BIAS):
            held = torch.ones_like(held)        # its exact gradient is 0
        else:
            n_held = int(held.sum())
            assert n_held <= HELD_SHARE * held.numel(), (name, n_held,
                                                         held.numel())
            held_other += n_held
        for side in (g, w):
            drift = float(((side - s).abs() * held).max()) if held.any() \
                else 0.0
            assert drift <= bound, f"{name}: drift {drift:.3g} > {bound:.3g}"
        keep = ~held
        np.testing.assert_allclose(g[keep].numpy(), w[keep].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    return held_other
