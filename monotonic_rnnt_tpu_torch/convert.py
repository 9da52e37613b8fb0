"""Moves the state the JAX package and the port share into torch tensors.

What crosses between the two packages is the loss's inputs, its bands and
its packed band layout, and the parameters of the fused-joint losses'
joint, as numpy arrays: logits, labels, lengths, ``Bands(min_s, max_s)``,
``BandLayout(offset, d, d_next, width)`` and a dict of joint weights; and a
flax Conformer-transducer's parameter tree, which becomes the port model's
``state_dict`` by explicit layout rules (``transducer_params_from_flax``).
Integer arrays become int32 tensors, as the JAX package keeps them. The
functions create tensors, so they default to ``device="cuda"`` and raise
when no GPU is present; pass ``device="cpu"`` to run on the CPU.
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


# --- a flax Conformer-transducer's parameters -------------------------------

def _flax_leaves(tree, prefix=""):
    """{"a/b/c": leaf} of a nested mapping (flax's params, FrozenDict too)."""
    out = {}
    for name, sub in tree.items():
        path = f"{prefix}{name}"
        if hasattr(sub, "items"):
            out.update(_flax_leaves(sub, path + "/"))
        else:
            out[path] = np.asarray(sub)
    return out


def _dense(m):          # kernel [in, out] -> Linear.weight [out, in]
    return {"weight": m["kernel"].T, "bias": m["bias"]}


def _layer_norm(m):     # scale -> weight
    return {"weight": m["scale"], "bias": m["bias"]}


def _conv1d(m):         # (k, in/g, out) -> Conv1d (out, in/g, k)
    return {"weight": m["kernel"].transpose(2, 1, 0), "bias": m["bias"]}


def _conv2d(m):         # (kh, kw, in, out) -> Conv2d (out, in, kh, kw)
    return {"weight": m["kernel"].transpose(3, 2, 0, 1), "bias": m["bias"]}


def _heads_in(m):       # query/key/value: [D, H, Dh], [H, Dh] -> [H*Dh, D]
    d = m["kernel"].shape[0]
    return {"weight": m["kernel"].reshape(d, -1).T,
            "bias": m["bias"].reshape(-1)}


def _heads_out(m):      # out: [H, Dh, D] -> [D, H*Dh]
    d = m["kernel"].shape[-1]
    return {"weight": m["kernel"].reshape(-1, d).T, "bias": m["bias"]}


def _embed(m):
    return {"weight": m["embedding"]}


def _lstm(m):
    """OptimizedLSTMCell's ii/if/ig/io (input kernels, no bias) and
    hi/hf/hg/ho (hidden kernels with bias) -> predictor.LstmCell, gates i,
    f, g, o: weight_ih = cat(ii, if, ig, io)^T, weight_hh = cat(hi, hf, hg,
    ho)^T, bias_hh = cat(their biases)."""
    gates = "ifgo"
    return {"weight_ih": np.concatenate([m[f"i{g}/kernel"] for g in gates],
                                        axis=1).T,
            "weight_hh": np.concatenate([m[f"h{g}/kernel"] for g in gates],
                                        axis=1).T,
            "bias_hh": np.concatenate([m[f"h{g}/bias"] for g in gates])}


def _transducer_modules(cfg):
    """(flax module path, torch module path, layout rule) of every module
    of a MonotonicTransducer with config `cfg` that holds parameters."""
    stages = int(cfg.encoder.subsample_factor).bit_length() - 1
    sub = "encoder/ConvSubsampler_0"
    mods = [(f"{sub}/Conv_{i}", f"encoder.subsampler.convs.{i}", _conv2d)
            for i in range(stages)]
    mods.append((f"{sub}/Dense_0", "encoder.subsampler.dense", _dense))
    for i in range(cfg.encoder.num_layers):
        fb, tb = f"encoder/ConformerBlock_{i}", f"encoder.blocks.{i}"
        for j, ff in enumerate(("ff1", "ff2")):
            mods += [(f"{fb}/FeedForward_{j}/LayerNorm_0", f"{tb}.{ff}.norm",
                      _layer_norm),
                     (f"{fb}/FeedForward_{j}/Dense_0", f"{tb}.{ff}.dense1",
                      _dense),
                     (f"{fb}/FeedForward_{j}/Dense_1", f"{tb}.{ff}.dense2",
                      _dense)]
        mha = f"{fb}/MHSA_0/MultiHeadDotProductAttention_0"
        mods.append((f"{fb}/MHSA_0/LayerNorm_0", f"{tb}.mhsa.norm",
                     _layer_norm))
        mods += [(f"{mha}/{n}", f"{tb}.mhsa.{n}", _heads_in)
                 for n in ("query", "key", "value")]
        mods.append((f"{mha}/out", f"{tb}.mhsa.out", _heads_out))
        conv = f"{fb}/ConvModule_0"
        mods += [(f"{conv}/LayerNorm_0", f"{tb}.conv.norm1", _layer_norm),
                 (f"{conv}/Dense_0", f"{tb}.conv.pointwise1", _dense),
                 (f"{conv}/Conv_0", f"{tb}.conv.depthwise", _conv1d),
                 (f"{conv}/LayerNorm_1", f"{tb}.conv.norm2", _layer_norm),
                 (f"{conv}/Dense_1", f"{tb}.conv.pointwise2", _dense),
                 (f"{fb}/LayerNorm_0", f"{tb}.norm", _layer_norm)]
    mods.append(("predictor/embed", "predictor.embed", _embed))
    if cfg.predictor_kind == "lstm":
        mods.append(("predictor/cell", "predictor.cell", _lstm))
    else:
        mods.append(("predictor/conv", "predictor.conv", _conv1d))
    mods.append(("predictor/out", "predictor.out", _dense))
    mods += [(f"joint/{n}", f"joint.{n}", _dense)
             for n in ("enc_proj", "pred_proj", "vocab_proj")]
    return mods


def _state_from_flax(params, modules, device) -> Dict[str, torch.Tensor]:
    """The state_dict of `modules` ((flax path, torch path, layout rule)
    each) from a flax parameter tree; raises ValueError if a flax leaf is
    left over or a module is missing."""
    dev = _device(device)
    leaves = _flax_leaves(params.get("params", params))
    state = {}
    for flax_mod, torch_mod, rule in modules:
        mine = {path[len(flax_mod) + 1:]: leaf for path, leaf in leaves.items()
                if path.startswith(flax_mod + "/")}
        if not mine:
            raise ValueError(f"flax params hold no module {flax_mod!r}")
        for name, arr in rule(mine).items():
            state[f"{torch_mod}.{name}"] = _float_tensor(arr).to(dev)
        for path in mine:
            del leaves[f"{flax_mod}/{path}"]
    if leaves:
        raise ValueError("flax params the config does not name: "
                         + ", ".join(sorted(leaves)))
    return state


def transducer_params_from_flax(params, cfg, device="cuda"
                                ) -> Dict[str, torch.Tensor]:
    """A flax MonotonicTransducer's parameters as the port's state_dict.

    params: what ``model.init`` returns (``{"params": ...}``) or its
    "params" tree, numpy or JAX leaves; any tree of that structure (a
    gradient tree too) converts. cfg: the port's ``TransducerConfig`` (its
    layer count, subsampling and predictor kind name the modules). Returns
    {name: tensor on `device`} that ``MonotonicTransducer.load_state_dict``
    accepts; each leaf keeps its dtype. Raises ValueError if a flax leaf is
    left over or missing.
    """
    return _state_from_flax(params, _transducer_modules(cfg), device)


def lstm_lm_params_from_flax(params, cfg, device="cuda"
                             ) -> Dict[str, torch.Tensor]:
    """A flax ``models/lm.py`` LstmLm's parameters as the port's
    ``models.lm.LstmLm`` state_dict, by the transducer's layout rules
    (embedding, OptimizedLSTMCell, Dense). cfg: the port's ``LstmLmConfig``,
    whose widths the parameters must have. Raises ValueError if a flax leaf
    is left over or missing, or a width differs from cfg's."""
    state = _state_from_flax(params, [("embed", "embed", _embed),
                                      ("cell", "cell", _lstm),
                                      ("out", "out", _dense)], device)
    v, d, e = cfg.vocab_size, cfg.dim, cfg.embed_dim
    for name, want in (("embed.weight", (v, e)), ("cell.weight_ih", (4 * d, e)),
                       ("cell.weight_hh", (4 * d, d)), ("out.weight", (v, d))):
        if tuple(state[name].shape) != want:
            raise ValueError(f"flax LM {name} has shape "
                             f"{tuple(state[name].shape)}, the config {want}")
    return state


# --- a JAX TrainState ----------------------------------------------------------

def _optax_counts(opt_state):
    """(ScaleByAdamState, the schedule's count) found in an optax state
    (the chain of clip_by_global_norm and adamw), by their fields."""
    adam, sched = None, None
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if hasattr(node, "mu") and hasattr(node, "nu"):
            adam = node
        elif type(node).__name__ == "ScaleByScheduleState":
            sched = node.count
        elif isinstance(node, (tuple, list)):
            stack.extend(node)
    if adam is None or sched is None:
        raise ValueError("opt_state holds no adam moments and schedule count "
                         "(create_train_state's optax chain)")
    return adam, int(np.asarray(sched))


def train_state_from_optax(jax_state, cfg, example_batch, *,
                           learning_rate: float = 1e-3,
                           weight_decay: float = 1e-6,
                           warmup_steps: int = 1000, device="cuda"):
    """A JAX TrainState (``models/train.create_train_state``'s, after any
    number of steps) as the port's ``models.train.TrainState``.

    The parameters convert by ``transducer_params_from_flax``, optax's Adam
    moments ``mu``/``nu`` as gradient trees do (so the LSTM's gate biases
    land in its one ``bias_hh``), the Adam count into each parameter's
    AdamW ``step``, the schedule's count into the LambdaLR, and ``step``.
    An optax chain's hyperparameters are closures that cannot be read:
    pass the learning_rate, weight_decay and warmup_steps the JAX state was
    created with (cfg and example_batch as for create_train_state). The
    dropout key cannot cross: the PRNGs differ, so the port's seed is one
    derived from the key's bits, and the masks after the crossing are not
    JAX's.
    """
    from .models.train import create_train_state, fold_in

    state = create_train_state(cfg, 0, example_batch, learning_rate,
                               weight_decay, warmup_steps, device=device)
    state.model.load_state_dict(transducer_params_from_flax(
        jax_state.params, cfg, device=device))
    adam, sched_count = _optax_counts(jax_state.opt_state)
    mu = transducer_params_from_flax(adam.mu, cfg, device=device)
    nu = transducer_params_from_flax(adam.nu, cfg, device=device)
    count = float(np.asarray(adam.count))
    for name, p in state.model.named_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": mu[name].to(p.dtype),
            "exp_avg_sq": nu[name].to(p.dtype)}
    state.set_update_count(sched_count)
    state.step = int(np.asarray(jax_state.step))
    state.dropout_seed = 0
    for word in np.asarray(jax_state.dropout_rng).astype(np.uint64).ravel():
        state.dropout_seed = fold_in(state.dropout_seed, int(word))
    return state
