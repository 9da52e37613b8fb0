"""TensorFlow binding (API-compatible with the reference's tensorflow_binding).

PyTorch counterpart of ``monotonic_rnnt_tpu/interop/tf_binding.py``. It
mirrors the reference's public TF surface (register_op.py:20-72 and the
MonotonicRNNT / MonotonicRNNTAlignRestrict custom ops,
monotonic_rnnt_op.cu:16-41, monotonic_rnnt_op_align_restrict.cu:25-41):

  monotonic_rnnt_loss(acts, labels, input_lengths, label_lengths,
                      alignment=None, max_distance_from_alignment=0,
                      blank_label=0) -> costs [B]

over the packed activation layout ([sum_b T_b*(S_b+1), V]), with the
gradient registered as the reference does it: the forward produces logit
grads, the backward is ``tf.repeat(grad_loss, T_b*(S_b+1))[:, None] * grads``
(register_op.py:77-148). It runs on the port's native C++ engine
(native_src/mrnnt.cpp) through ``tf.numpy_function``, in eager and graph
mode, on CPU hosts.

``monotonic_rnnt_loss_padded`` and ``monotonic_rnnt_loss_banded`` bridge
TensorFlow onto the port's torch losses (by default on the card), and the
decoder helpers onto the port's greedy decoder, each through
``tf.numpy_function`` (under ``tf.custom_gradient`` for the losses). Where
the JAX package stages its losses into TF with jax2tf, as XLA that a
SavedModel can hold and ``jit_compile=True`` can compile, a bridge is a
Python call: it runs in eager and graph mode in this process, but it
cannot go into a SavedModel, nor under ``jit_compile=True``.

TensorFlow is imported when a function here is called, not when the module
is imported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..native import rnnt_loss_native


def _require_tf():
    """The tensorflow module; raises ImportError where it is missing."""
    try:
        import tensorflow as tf
    except ImportError as exc:
        raise ImportError("tensorflow is not available in this "
                          "environment") from exc
    return tf


def _native_fwd(acts, labels, ilen, slen, align, max_dist, blank):
    tf = _require_tf()
    # Adopt TF's intra-op thread pool size for the OpenMP engine, as the
    # reference's CPU TF op does (monotonic_rnnt_op.cu:182); 0 = the
    # engine's default when TF reports 0 (= "pick for me").
    threads = tf.config.threading.get_intra_op_parallelism_threads()
    costs, grads = rnnt_loss_native(
        acts, labels, ilen, slen, blank_id=int(blank),
        alignment=None if align.size == 0 else align,
        max_distance_from_alignment=int(max_dist), with_grads=True,
        num_threads=int(threads))
    return costs.astype(np.float32), grads.astype(np.float32)


def monotonic_rnnt_loss(
    acts,
    labels,
    input_lengths,
    label_lengths,
    alignment=None,
    max_distance_from_alignment: int = 0,
    blank_label: int = 0,
):
    """Reference-compatible packed-layout TF loss.

    Args:
      acts: packed 2-D float32 tensor [sum_b T_b*(S_b+1), V] of raw logits,
        row-major per sample exactly as the reference documents
        (register_op.py:32-39); softmax is applied internally.
      labels: [B, S_max] int32 padded label sequences (no blanks).
      input_lengths / label_lengths: [B] int32 per-sample T_b / S_b.
      alignment: optional [B, T_max] int32 reference alignment; selects the
        alignment-restricted variant (reference MonotonicRNNTAlignRestrict).
      max_distance_from_alignment: allowed band half-width around `alignment`.
      blank_label: vocabulary index of blank.

    Returns:
      [B] float32 per-sample negative log-likelihoods, differentiable w.r.t.
      acts (and only acts, matching register_op.py:77-148).
    """
    tf = _require_tf()
    acts = tf.convert_to_tensor(acts, tf.float32)
    labels = tf.convert_to_tensor(labels, tf.int32)
    input_lengths = tf.convert_to_tensor(input_lengths, tf.int32)
    label_lengths = tf.convert_to_tensor(label_lengths, tf.int32)
    align_t = (tf.zeros([0, 0], tf.int32) if alignment is None
               else tf.convert_to_tensor(alignment, tf.int32))

    @tf.custom_gradient
    def _loss(acts_in):
        costs, grads = tf.numpy_function(
            _native_fwd,
            [acts_in, labels, input_lengths, label_lengths, align_t,
             np.int32(max_distance_from_alignment), np.int32(blank_label)],
            [tf.float32, tf.float32])
        costs.set_shape(input_lengths.shape)
        grads.set_shape(acts_in.shape)

        def grad_fn(grad_loss, variables=None):
            del variables
            repeats = input_lengths * (label_lengths + 1)
            scale = tf.expand_dims(tf.repeat(grad_loss, repeats, axis=0), 1)
            return scale * grads

        return costs, grad_fn

    return _loss(acts)


def _torch_loss_fwd(loss, device, *arrays):
    """costs and d sum(costs) / d x of loss(x, *rest) on `device`, as f32
    numpy arrays (x = arrays[0])."""
    x = torch.from_numpy(np.array(arrays[0], np.float32)).to(device)
    x.requires_grad_(True)
    rest = [torch.from_numpy(np.array(a, np.int32)).to(device)
            for a in arrays[1:]]
    with torch.enable_grad():
        costs = loss(x, *rest)
        (grads,) = torch.autograd.grad(costs.sum(), x)
    return (costs.detach().float().cpu().numpy(),
            grads.float().cpu().numpy())


def _bridge(loss, device, x, *rest):
    """loss through tf.numpy_function, differentiable w.r.t. x by
    tf.custom_gradient: the forward makes the per-sample gradient, the
    backward scales it by the cost cotangent."""
    tf = _require_tf()
    x = tf.convert_to_tensor(x, tf.float32)
    rest = [tf.convert_to_tensor(a, tf.int32) for a in rest]

    @tf.custom_gradient
    def _loss(x_in):
        costs, grads = tf.numpy_function(
            lambda *a: _torch_loss_fwd(loss, device, *a), [x_in, *rest],
            [tf.float32, tf.float32])
        costs.set_shape(x_in.shape[:1])
        grads.set_shape(x_in.shape)

        def grad_fn(grad_loss, variables=None):
            del variables
            return tf.reshape(grad_loss, [-1, 1, 1, 1]) * grads

        return costs, grad_fn

    return _loss(x)


def monotonic_rnnt_loss_padded(
    logits,
    labels,
    input_lengths,
    label_lengths,
    blank_label: int = 0,
    backend: Optional[str] = None,
    device="cuda",
):
    """Padded-layout loss, bridged from TF onto the port's torch loss.

    logits: [B, T_max, S_max+1, V] float32 tensor (other float types are
    cast to float32); other args as in the packed API. Runs
    ``monotonic_rnnt_loss`` on `device` with `backend` (None: the
    config's), differentiable under tf.GradientTape. A bridge is a Python
    call (tf.numpy_function): it cannot go into a SavedModel or under
    jit_compile=True, where JAX's jax2tf loss can.
    """
    from ..ops.loss import monotonic_rnnt_loss as torch_loss

    def loss(x, labels, ilen, slen):
        return torch_loss(x, labels, ilen, slen, blank_id=int(blank_label),
                          backend=backend)

    return _bridge(loss, device, logits, labels, input_lengths,
                   label_lengths)


def monotonic_rnnt_loss_banded(
    logits_band,
    labels,
    input_lengths,
    label_lengths,
    band_min,
    band_max,
    blank_label: int = 0,
    backend: Optional[str] = None,
    device="cuda",
):
    """Packed band-layout loss, bridged from TF onto the port's torch loss.

    logits_band: [B, T_max, W, V] float32 tensor (ops/bands.py packed
    layout); band_min / band_max: [B, T_max] int32 Bands arrays. Runs
    ``monotonic_rnnt_loss_banded`` on `device`, differentiable under
    tf.GradientTape (gradients in the packed layout). Like every bridge, it
    cannot go into a SavedModel or under jit_compile=True.
    """
    from ..ops.banded import monotonic_rnnt_loss_banded as torch_banded
    from ..ops.bands import Bands

    def loss(x, labels, ilen, slen, bmin, bmax):
        return torch_banded(x, labels, ilen, slen, bands=Bands(bmin, bmax),
                            blank_id=int(blank_label), backend=backend)

    return _bridge(loss, device, logits_band, labels, input_lengths,
                   label_lengths, band_min, band_max)


def make_tf_loss_module(blank_label: int = 0, backend: Optional[str] = None,
                        device="cuda"):
    """tf.Module exposing the padded and banded bridges as tf.functions.

    The JAX package's module can be written with tf.saved_model.save; this
    one cannot (a bridge is a Python call), so it serves in-process TF
    code only.
    """
    tf = _require_tf()

    class _LossModule(tf.Module):
        @tf.function
        def padded(self, logits, labels, input_lengths, label_lengths):
            return monotonic_rnnt_loss_padded(
                logits, labels, input_lengths, label_lengths,
                blank_label=blank_label, backend=backend, device=device)

        @tf.function
        def banded(self, logits_band, labels, input_lengths, label_lengths,
                   band_min, band_max):
            return monotonic_rnnt_loss_banded(
                logits_band, labels, input_lengths, label_lengths,
                band_min, band_max, blank_label=blank_label,
                backend=backend, device=device)

    return _LossModule()


def _greedy_bridge(model, max_labels, device, names, feats, feat_lengths,
                   values):
    """model.greedy_decode on `device` with the parameters `names` taken
    from `values`, through tf.numpy_function: (hyp, hyp_lengths) int32."""
    tf = _require_tf()
    from ..serving import _model_call

    decode = _model_call(model, "greedy_decode", max_labels)
    dtypes = {k: v.dtype for k, v in model.named_parameters()}

    def run(feats, flen, *vals):
        params = {n: torch.from_numpy(np.array(v)).to(device=device,
                                                      dtype=dtypes[n])
                  for n, v in zip(names, vals)}
        with torch.no_grad():
            hyp, n = decode(params,
                            torch.from_numpy(np.array(feats)).to(device),
                            torch.from_numpy(np.array(flen)).to(device))
        return hyp.cpu().numpy(), n.cpu().numpy()

    feats = tf.convert_to_tensor(feats, tf.float32)
    feat_lengths = tf.convert_to_tensor(feat_lengths, tf.int32)
    hyp, n = tf.numpy_function(run, [feats, feat_lengths, *values],
                               [tf.int32, tf.int32])
    hyp.set_shape([feats.shape[0], max_labels])
    n.set_shape(feats.shape[:1])
    return hyp, n


def _as_f32_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def make_tf_decoder_module(model, params, max_labels: int, device="cuda"):
    """tf.Module bundling model weights (as tf.Variables) + greedy decode.

    params: the model's tensors by name (``dict(model.named_parameters())``),
    held as float32 variables. ``decode(feats, feat_lengths)`` is a
    tf.function over the bridge onto the port's greedy_decode on `device`
    (the model must lie there). Unlike the JAX package's module it cannot
    be written with tf.saved_model.save: the bridge is a Python call.
    """
    tf = _require_tf()
    names = sorted(params)

    class _DecoderModule(tf.Module):
        def __init__(self):
            super().__init__()
            self._params = [tf.Variable(_as_f32_numpy(params[n]),
                                        trainable=False, name=f"param_{i}")
                            for i, n in enumerate(names)]

        @tf.function
        def decode(self, feats, feat_lengths):
            return _greedy_bridge(model, max_labels, device, names, feats,
                                  feat_lengths, list(self._params))

    return _DecoderModule()


def make_tf_greedy_decoder(model, max_labels: int, device="cuda"):
    """TF-callable greedy decoder for the transducer model family.

    Returns fn(params, feats [B,T,F], feat_lengths [B]) -> (hyp [B,
    max_labels], hyp_lengths [B]), params a dict of the model's tensors by
    name; it runs the port's greedy_decode on `device` through
    tf.numpy_function, in eager mode and under tf.function (no SavedModel,
    no jit_compile: it is a bridge).
    """
    tf = _require_tf()

    def tf_fn(params, feats, feat_lengths):
        names = sorted(params)
        values = [tf.convert_to_tensor(_as_f32_numpy(params[n]))
                  if isinstance(params[n], torch.Tensor) else params[n]
                  for n in names]
        return _greedy_bridge(model, max_labels, device, names, feats,
                              feat_lengths, values)

    return tf_fn
