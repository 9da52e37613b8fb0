"""Case builders and checks shared by the harness and ``chip_smoke.py``.

``make_inputs``, ``banded_case``, ``random_alignment`` and ``assert_close``
(with ``check`` and ``CheckFailed``) live here once: ``chip_smoke.py``
imports them from here, as do ``fuzz_gpu`` and ``gpu_acceptance``; nothing
in the package imports ``chip_smoke.py``. ``loss_route`` and
``banded_route`` drive one backend's route of the padded and banded losses
(``costs_and_grads`` differentiates one, ``band_layout`` lays out a band),
``one_rank_group`` gives the sharded checks their one-process gloo group,
and ``require_device`` refuses a CUDA run where torch sees no card.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..ops import banded as banded_loss
from ..ops import bands as bd
from ..ops import loss as padded_loss


class CheckFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def assert_close(got, ref, atol: float, rtol: float, what: str) -> float:
    """max |got - ref|; raises CheckFailed where |d| > atol + rtol|ref|
    (NaN counts as past it, equal values, infinities too, as 0)."""
    got, ref = got.detach().float(), ref.detach().float()
    diff = torch.where(got == ref, 0.0, (got - ref).abs())
    bad = ~(diff <= atol + rtol * ref.abs())  # NaN counts as bad
    err = float(diff.max())
    if bool(bad.any()):
        idx = tuple(int(i) for i in torch.nonzero(bad)[0])
        raise CheckFailed(f"{what}: max |d| {err:.3g}; first bad index {idx}: "
                          f"got {float(got[idx])!r} ref {float(ref[idx])!r}")
    return err


def require_device(device: str, prog: str) -> torch.device:
    """torch.device(device). A CUDA device where torch sees no card ends the
    process with one line on stderr: the harness never falls back to the
    CPU unless asked for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"{prog}: torch.cuda.is_available() is false; run it on an "
                 "NVIDIA GPU, or pass --device cpu")
    return dev


def int32(dev, *arrays):
    """Each array as an int32 tensor on `dev`."""
    return tuple(torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)
                 for a in arrays)


def make_inputs(b, t, s, v, *, blank=0, dtype=torch.float32, seed=0,
                t_range=None, s_range=None, device="cuda"):
    """Seeded inputs on `device`: logits ~ 2*N(0,1), non-blank labels with a
    planted repeat, lengths drawn from the given ranges (default: full)."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    logits = (torch.randn((b, t, s + 1, v), generator=gen, device=device)
              * 2).to(dtype)
    labels = rng.randint(0, v - 1, size=(b, s))
    labels = np.where(labels >= blank, labels + 1, labels)
    if s >= 3:
        labels[:, s // 2] = labels[:, s // 2 - 1]
    ilen = (rng.randint(t_range[0], t_range[1] + 1, size=b) if t_range
            else np.full(b, t))
    slen = (rng.randint(s_range[0], s_range[1] + 1, size=b) if s_range
            else np.full(b, s))
    slen = np.minimum(slen, ilen)
    return (logits, *int32(device, labels, ilen, slen))


def random_alignment(rng, ilen, slen, labels, t_max, blank=0):
    """Frames of each sample's S_b labels, drawn at random among its T_b."""
    align = np.full((len(ilen), t_max), blank, np.int32)
    for b, (tb, sb) in enumerate(zip(ilen, slen)):
        frames = np.sort(rng.choice(tb, size=sb, replace=False))
        align[b, frames] = labels[b, :sb]
    return align


def banded_case(b, t, s, v, shift, seed=0, device="cuda", *, logits=None,
                ilen=None, slen=None, pack=True):
    """The banded acceptance case, built as benchmarks/banded_bench.py:30-54
    builds it, with the port's own functions: logits N(0,1) (unless given)
    and labels from RandomState(seed), full-length utterances (unless
    `ilen` / `slen` are given), a random monotonic alignment
    (random_alignment), then bands_from_alignment, suggested_band_width,
    compute_band_layout and, with `pack`, pack_band."""
    rng = np.random.RandomState(seed)
    if logits is None:
        logits = torch.from_numpy(
            rng.randn(b, t, s + 1, v).astype(np.float32)).to(device)
    labels = rng.randint(1, v, size=(b, s)).astype(np.int32)
    ilen = np.full(b, t) if ilen is None else np.asarray(ilen)
    slen = np.full(b, s) if slen is None else np.asarray(slen)
    align = random_alignment(rng, ilen, slen, labels, t)
    labels, ilen, slen, align = int32(device, labels, ilen, slen, align)
    bands = bd.bands_from_alignment(align, ilen, slen, shift, 0)
    w_req = int(bd.required_band_width(ilen, slen, bands, t, s + 1))
    w = bd.suggested_band_width(ilen, slen, bands, t, s + 1)
    layout = bd.compute_band_layout(ilen, slen, bands, t, s + 1, w)
    return {"logits": logits,
            "logits_band": bd.pack_band(logits, layout) if pack else None,
            "labels": labels, "ilen": ilen, "slen": slen,
            "bands": bands, "layout": layout, "w": w, "w_req": w_req}


def band_layout(ilen, slen, bands, t, s1):
    """The packed layout at the bands' suggested width."""
    w = bd.suggested_band_width(ilen, slen, bands, t, s1)
    return bd.compute_band_layout(ilen, slen, bands, t, s1, w)


def costs_and_grads(fn, x, cotangent=None):
    """fn(leaf) and its vector-Jacobian product with `cotangent` (ones:
    the gradient of the summed costs), for a leaf on x's storage."""
    leaf = x.detach().requires_grad_(True)
    costs = fn(leaf)
    ct = torch.ones_like(costs) if cotangent is None else cotangent
    (grads,) = torch.autograd.grad(costs, leaf, ct)
    return costs.detach(), grads


def loss_route(x, labels, ilen, slen, *, backend, blank=0, bands=None):
    """[B] costs of the padded loss on `backend`'s route: the public
    monotonic_rnnt_loss, except 'cuda' on CPU tensors, which it refuses;
    there its own loss_on_route takes that route, each kernel wrapper its
    plain version."""
    if backend == "cuda" and not x.is_cuda:
        bands = bands or bd.default_bands(ilen, slen, x.shape[1])
        return padded_loss.loss_on_route(x, labels, ilen, slen, bands, blank,
                                         "cuda")
    return padded_loss.monotonic_rnnt_loss(x, labels, ilen, slen,
                                           blank_id=blank, bands=bands,
                                           backend=backend)


def banded_route(x_band, labels, ilen, slen, bands, *, backend, blank=0):
    """[B] costs of the banded loss on the packed layout, as loss_route."""
    if backend == "cuda" and not x_band.is_cuda:
        return banded_loss.banded_loss_on_route(x_band, labels, ilen, slen,
                                                bands, blank, "cuda")
    return banded_loss.monotonic_rnnt_loss_banded(
        x_band, labels, ilen, slen, bands=bands, blank_id=blank,
        backend=backend)


@contextlib.contextmanager
def one_rank_group():
    """A gloo group of this process alone (dist.new_group([0])). The default
    group is initialised in memory where it is not, and destroyed on exit
    when it was initialised here."""
    from ..parallel import initialize_multihost

    owner = not dist.is_initialized()
    if owner:
        initialize_multihost(world_size=1, rank=0, backend="gloo")
    try:
        yield dist.new_group([0])
    finally:
        if owner:
            dist.destroy_process_group()
