"""Deployment export: serialize entry points to ``torch.export`` artifacts.

PyTorch counterpart of ``monotonic_rnnt_tpu/serving.py``.
``torch.export`` captures a function as an ExportedProgram, which
``torch.export.save`` writes as bytes and ``torch.export.load`` reads in
another process that has torch and this package's operators (for the
``cuda`` loss) but runs no Python of the function: the artifact is the
compiled contract, with shapes and dtypes checked at call time.

    blob = export_loss(logits, labels, ilen, slen)         # bytes
    Path("loss.pt2").write_bytes(blob)
    ...
    loss_fn = import_fn(Path("loss.pt2").read_bytes())
    costs, grads = loss_fn(logits, labels, ilen, slen)

A JAX artifact lowers for several platforms at once; an artifact here
holds the device it was traced on (its tensors' device), and
``import_fn(blob, device=...)`` moves it to another. The ``cuda`` loss holds
the kernels of the pipeline the config names as ``torch.ops.mrnnt``
operators (ops/cuda/kernels.py): rows 1-2 (``stats_alpha_fused``,
``beta_grad_fused``), or under ``pipeline='split'`` rows 3, 4 and 6
(``softmax_stats``, ``fwdbwd_scan``, ``grad_pass``), so it serves CUDA
devices only. An artifact checks no length values: those are data, as on a
JAX artifact, whose traced lengths skip the value checks.
"""

from __future__ import annotations

import io
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from .ops.banded import rnnt_loss_banded_reference
from .ops.bands import Bands, default_bands
from .ops.cuda.fused import rnnt_loss_cuda
from .ops.reference import rnnt_loss_reference
from .utils.status import RnntError, Status, validate_loss_inputs

_LOSS_BACKENDS = ("reference", "cuda")


class _Fn(nn.Module):
    """fn as a module's forward, for torch.export. fn is held as a plain
    attribute, so a model it closes over lends no parameters to the
    artifact."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class _Method(nn.Module):
    """model.<method> as a module's forward, for torch.func.functional_call
    (its parameters are model's, each name prefixed with 'model.')."""

    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model, self.method = model, method

    def forward(self, *args):
        return getattr(self.model, self.method)(*args)


def _moved(obj, device):
    """obj with every tensor in its tuples, lists and dicts on device."""
    if device is None:
        return obj
    return torch.utils._pytree.tree_map_only(
        torch.Tensor, lambda t: t.to(device), obj)


def export_fn(fn: Callable, example_args: Tuple,
              device: Optional[str] = None) -> bytes:
    """Serialize fn at example_args' shapes, dtypes and device to bytes.

    device: the device the artifact serves; the example arguments (tensors
    in tuples, lists and dicts) are moved there first. None: where they
    lie.
    """
    args = _moved(tuple(example_args), device)
    program = torch.export.export(_Fn(fn), args, strict=False)
    # The artifact keeps the examples' shapes, not their values (which
    # torch.export.save would write: the logits, or a decoder's weights).
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def import_fn(blob: bytes, device: Optional[str] = None) -> Callable:
    """Deserialize an export_fn artifact into a callable module.

    device: move the artifact's tensors and device arguments there
    (torch.export.passes.move_to_device_pass); None keeps the device it was
    exported on.
    """
    program = torch.export.load(io.BytesIO(bytes(blob)))
    if device is not None:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, device)
    return program.module()


def export_loss(example_logits, example_labels, example_input_lengths,
                example_label_lengths, *, blank_id: int = 0,
                device: str = "cuda", backend: str = "reference") -> bytes:
    """Export the monotonic RNN-T loss with gradients.

    The artifact computes (costs [B] f32, dlogits in the logits' dtype) in
    one call, directly rather than through autograd: the same contract as
    the reference's C entry point (costs + per-logit grads,
    src/rnnt_entrypoint.cpp:16-48), shape-specialized to the example
    batch, on the unrestricted lattice.

    backend: "reference" (default) holds the plain-torch oracle; "cuda"
    holds the operators the live route of the config's pipeline calls,
    gradient scale 1, and needs device="cuda": rows 1 then 2
    (stats_alpha_fused, beta_grad_fused), or under pipeline='split' rows
    3, 4 and 6 (softmax_stats, fwdbwd_scan, grad_pass).
    """
    if backend not in _LOSS_BACKENDS:
        raise ValueError(f"backend must be one of {_LOSS_BACKENDS}, got "
                         f"{backend!r}")
    if backend == "cuda":
        if torch.device(device).type != "cuda":
            raise ValueError("backend='cuda' exports must use "
                             f"device='cuda', got {device!r}")

    def fn(logits, labels, input_lengths, label_lengths):
        validate_loss_inputs(logits, labels, input_lengths, label_lengths)
        ilen = input_lengths.to(torch.int32)
        slen = label_lengths.to(torch.int32)
        bands = default_bands(ilen, slen, logits.shape[1])
        if backend == "cuda":
            return rnnt_loss_cuda(logits.contiguous(), labels, ilen, slen,
                                  blank_id=blank_id, bands=bands)
        costs, grads = rnnt_loss_reference(logits, labels, ilen, slen,
                                           blank_id=blank_id, bands=bands)
        return costs, grads.to(logits.dtype)

    return export_fn(fn, (example_logits, example_labels,
                          example_input_lengths, example_label_lengths),
                     device)


def export_banded_loss(example_logits_band, example_labels,
                       example_input_lengths, example_label_lengths,
                       example_band_min, example_band_max, *,
                       blank_id: int = 0, device: str = "cuda") -> bytes:
    """Export the packed band-layout loss (costs + packed-layout dlogits).

    The long-utterance serving artifact: takes the [B, T, W, V] band tensor
    plus the Bands arrays (ops/bands.py), returns (costs, dlogits_band) from
    the banded oracle, e.g. for alignment-restricted rescoring outside this
    package.
    """
    def fn(logits_band, labels, input_lengths, label_lengths, band_min,
           band_max):
        batch, t_max, w, v = logits_band.shape
        s1 = labels.shape[1] + 1
        if w > s1:
            raise RnntError(Status.INVALID_VALUE,
                            f"band width {w} exceeds S_max+1={s1}")
        validate_loss_inputs(torch.empty((batch, t_max, s1, v),
                                         device="meta"),
                             labels, input_lengths, label_lengths)
        costs, grads = rnnt_loss_banded_reference(
            logits_band, labels, input_lengths.to(torch.int32),
            label_lengths.to(torch.int32),
            Bands(band_min.to(torch.int32), band_max.to(torch.int32)),
            blank_id=blank_id)
        return costs, grads.to(logits_band.dtype)

    return export_fn(fn, (example_logits_band, example_labels,
                          example_input_lengths, example_label_lengths,
                          example_band_min, example_band_max), device)


def _model_call(model: nn.Module, method: str, *static):
    """fn(params, *args) -> model.<method>(*args, *static) with the
    parameters (and buffers) taken from `params`, a dict by name."""
    bound = _Method(model, method)

    def fn(params, *args):
        named = {f"model.{k}": v for k, v in params.items()}
        return torch.func.functional_call(bound, named, (*args, *static))

    return fn


def export_greedy_decoder(model, example_params, example_feats,
                          example_feat_lengths, max_labels: int,
                          device: str = "cuda") -> bytes:
    """Export a transducer's greedy decoder as a serving artifact.

    The artifact takes (params, feats [B,T,F], feat_lengths [B]) and
    returns (hyp [B, max_labels], hyp_lengths [B]); params is a dict of
    the model's tensors by name, as ``dict(model.named_parameters())``
    (with ``named_buffers()`` where the model has any), so one artifact
    serves every checkpoint of the model. The model must lie on `device`.
    """
    return export_fn(_model_call(model, "greedy_decode", max_labels),
                     (dict(example_params), example_feats,
                      example_feat_lengths), device)


def export_streaming_decoder(model, example_params, batch: int,
                             feat_dim: int, chunk_frames: int,
                             max_labels: int, device: str = "cuda"):
    """Export one streaming_step as an artifact, plus its initial state.

    Returns (blob, init_state): the artifact takes (params, state,
    feat_chunk [B, C, F] f32, chunk_valid [B] int32) and returns (state,
    emitted); the serving loop feeds each returned state back in (its
    n_seen is a tensor, so one artifact serves every chunk). The lookback
    is sized from conformer.streaming_lookback (exact-recompute guarantee).
    The model must lie on `device`.
    """
    from .models.conformer import streaming_lookback

    lookback = streaming_lookback(model.cfg.encoder)
    init_state = _moved(model.streaming_init(batch, feat_dim, lookback,
                                             max_labels), device)
    chunk = torch.zeros((batch, chunk_frames, feat_dim), dtype=torch.float32)
    chunk_valid = torch.zeros((batch,), dtype=torch.int32)
    blob = export_fn(_model_call(model, "streaming_step"),
                     (dict(example_params), init_state, chunk, chunk_valid),
                     device)
    return blob, init_state
