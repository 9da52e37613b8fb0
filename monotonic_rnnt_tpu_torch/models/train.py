"""Training loop pieces: optimiser and schedule, train steps, checkpoints.

PyTorch counterpart of ``monotonic_rnnt_tpu/models/train.py``. A
``TrainState`` holds the model (its parameters), a ``torch.optim.AdamW``,
the learning-rate schedule, the update count ``step`` and the dropout seed;
the steps update it in place and return it with their metrics, as JAX's
return a new state. The optimiser is optax's chain exactly:

  * ``clip_by_global_norm(5.0)``: every gradient times 5 / ||g|| where the
    global norm ||g|| is 5 or more (no epsilon, where ``clip_grad_norm_``
    adds 1e-6 to the norm);
  * ``adamw(schedule, weight_decay)``: b1 0.9, b2 0.999, eps 1e-8 outside
    the square root, the decay on every parameter (no mask: LayerNorm scales
    and biases decay too), lr times (Adam step + weight_decay * p);
  * the schedule ``warmup_cosine_decay_schedule(0, lr, warmup,
    max(10 * warmup, 10_000))``, evaluated at the update count before the
    update (the first update has lr 0).

Dropout draws from a ``torch.Generator`` seeded from (the state's dropout
seed, ``step``), as JAX's steps fold the step into their key; the masks
differ from JAX's by design (another PRNG). A step leaves the global RNG
as it found it.

The sharded steps run one process per shard over the port's ``parallel/``
(``make_mesh``): each rank passes the global batch and takes its
``local_batch_slice``; the loss is the global mean, every rank ends with
the global gradient (of the vocab-TP step's two sharded leaves, its
shard), and the clip reads the norm of the whole gradient, so every rank
takes the same update.

Metrics stay tensors on the parameters' device ("loss", "grad_norm", the
norm before clipping) beside "step", the update count before the update
(an int); no step reads a device value on the host.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..ops.bands import Bands
from ..ops.chunked import rnnt_loss_fused_joint
from ..ops.chunked_banded import rnnt_loss_fused_joint_banded
from ..parallel.data_parallel import batch_total
from ..parallel.mesh import (MODEL_AXIS, Mesh, Spec, local_batch_slice,
                             local_shard)
from ..parallel.sharding import (make_dp_tp_fused_banded_loss,
                                 make_dp_tp_fused_loss)
from .transducer import MonotonicTransducer, TransducerConfig

CLIP_NORM = 5.0     # optax.clip_by_global_norm(5.0)
_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit ints."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data), the role of jax.random.fold_in:
    distinct data give unrelated seeds."""
    return _mix64(_mix64(seed & _MASK64) ^ (data & _MASK64)) >> 1


def warmup_cosine_factor(count: int, warmup_steps: int,
                         decay_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, 1, warmup_steps, decay_steps)
    at update `count`: count / warmup_steps over the warmup, then the
    cosine from 1 down to 0 over decay_steps - warmup_steps updates, 0
    after."""
    if count < warmup_steps:
        return count / warmup_steps
    span = decay_steps - warmup_steps
    done = min(count - warmup_steps, span)
    return 0.5 * (1.0 + math.cos(math.pi * done / span))


def adam_drift_bound(lrs: Sequence[float], first: int = 1,
                     b1: float = 0.9, b2: float = 0.999) -> float:
    """The most AdamW's steps can move a parameter over updates first,
    first + 1, ... at learning rates lrs (weight decay aside), whatever the
    gradients: update t moves it by lr_t * |m_hat| / (sqrt(v_hat) + eps),
    and m_hat = sum a_i g_i, v_hat = sum b_i g_i^2 with Adam's
    bias-corrected weights, so by Cauchy-Schwarz |m_hat| / sqrt(v_hat) <=
    sqrt(sum a_i^2 / b_i). A parameter whose true gradient is 0 moves on
    rounding noise by up to this much."""
    total = 0.0
    for t, lr in enumerate(lrs, start=first):
        a = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
        b = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
        total += lr * math.sqrt(sum(x * x / y for x, y in zip(a, b)))
    return total


@dataclasses.dataclass
class TrainState:
    """The model, its optimiser and schedule, the update count and the
    dropout seed (JAX's TrainState with its dropout_rng)."""

    model: MonotonicTransducer
    optimizer: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int
    dropout_seed: int

    @property
    def learning_rate(self) -> float:
        """The lr the next update takes."""
        return self.optimizer.param_groups[0]["lr"]

    def set_update_count(self, count: int) -> None:
        """Put the schedule at update `count` (the optimiser's moments and
        count are the optimiser's state, left as they are)."""
        sched = self.scheduler
        sched.last_epoch = count
        for group, base, fn in zip(self.optimizer.param_groups,
                                   sched.base_lrs, sched.lr_lambdas):
            group["lr"] = base * fn(count)
        sched._last_lr = [g["lr"] for g in self.optimizer.param_groups]


def create_train_state(cfg: TransducerConfig,
                       seed_or_generator: Union[int, torch.Generator],
                       example_batch, learning_rate: float = 1e-3,
                       weight_decay: float = 1e-6, warmup_steps: int = 1000,
                       *, device="cuda") -> TrainState:
    """A fresh TrainState: the model's weights drawn from a CPU generator
    (the seed's, or the one given) with flax's initialisers, then the
    dropout seed from the same generator (JAX splits one key into both);
    feat_dim from example_batch[0]'s last axis, as flax infers it. The
    model lives on `device`, the card unless the caller asks otherwise."""
    if isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
    else:
        gen = torch.Generator().manual_seed(int(seed_or_generator))
    model = MonotonicTransducer(cfg, int(example_batch[0].shape[-1]),
                                generator=gen, device=device)
    dropout_seed = int(torch.randint(0, 1 << 62, (), generator=gen))
    optimizer = torch.optim.AdamW(model.parameters(), lr=learning_rate,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, functools.partial(
            warmup_cosine_factor, warmup_steps=warmup_steps,
            decay_steps=max(warmup_steps * 10, 10_000)))
    return TrainState(model, optimizer, scheduler, 0, dropout_seed)


# --- the update --------------------------------------------------------------

def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _dropout_generator(state: TrainState, *folds: int) -> torch.Generator:
    """The step's dropout generator on the model's device, seeded from
    (dropout_seed, step, *folds)."""
    seed = fold_in(state.dropout_seed, state.step)
    for data in folds:
        seed = fold_in(seed, data)
    return torch.Generator(device=_device(state.model)).manual_seed(seed)


def _grads(params: Sequence[torch.Tensor]):
    """Every parameter's gradient, a zero one where backward left None (a
    parameter the loss does not reach still decays, as under optax)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


def _sum_of_squares(grads) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(grads)).square().sum()


def _update(state: TrainState, loss: torch.Tensor,
            grad_norm: Optional[torch.Tensor] = None):
    """Clip by the global norm (of these gradients unless given), one AdamW
    update, one schedule step; returns (state, metrics)."""
    params = list(state.model.parameters())
    grads = _grads(params)
    if grad_norm is None:
        grad_norm = _sum_of_squares(grads).sqrt()
    coef = torch.where(grad_norm < CLIP_NORM, 1.0, CLIP_NORM / grad_norm)
    torch._foreach_mul_(grads, coef)
    state.optimizer.step()
    state.scheduler.step()
    metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
               "step": state.step}
    state.step += 1
    return state, metrics


def _on(model: torch.nn.Module, batch):
    dev = _device(model)
    return tuple(x.to(dev) for x in batch)


def train_step_with_loss(state: TrainState, loss_fn, *args):
    """One update on loss_fn(*args, generator=g) -> scalar (e.g. a
    make_memory_efficient_loss function and (batch,), or a banded one and
    (batch, bands)), g the step's dropout generator."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(*args, generator=_dropout_generator(state))
    loss.backward()
    return _update(state, loss)


def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
    """One training step. batch = (feats, feat_lens, labels, label_lens);
    the mean cost with dropout on (deterministic=False)."""
    return _accumulated_step(state, batch, 1, None)


# --- the memory-efficient losses --------------------------------------------

def _encode_and_predict(model, batch, deterministic, generator):
    feats, feat_lengths, labels, label_lengths = _on(model, batch)
    enc, enc_lengths = model.encode(feats, feat_lengths, deterministic,
                                    generator=generator)
    pred = model.predictor(labels, deterministic)
    return enc, pred, labels, enc_lengths, label_lengths


def make_memory_efficient_loss(model: MonotonicTransducer, chunk_t: int = 32,
                               deterministic: bool = True):
    """Loss fn that never holds the [B, T', S+1, V] joint tensor.

    The encoder and predictor run as usual; the joint (``Joint.joint_fn``
    with ``joint_params()``) runs T'-chunk by chunk inside
    ``rnnt_loss_fused_joint``, so peak activation memory drops from
    O(B*T'*S*V) to one chunk's worth. Returns loss_fn(batch, generator=None)
    -> the mean cost, differentiable w.r.t. every parameter of `model`
    (generator: dropout's, where deterministic=False).
    """

    def loss_fn(batch, generator=None):
        enc, pred, labels, enc_lengths, slen = _encode_and_predict(
            model, batch, deterministic, generator)
        costs = rnnt_loss_fused_joint(
            enc, pred, labels, enc_lengths, slen, model.joint.joint_fn,
            model.joint.joint_params(), blank_id=model.cfg.blank_id,
            chunk_t=chunk_t)
        return costs.mean()

    return loss_fn


def make_banded_memory_efficient_loss(model: MonotonicTransducer,
                                      band_width: int, chunk_t: int = 32,
                                      deterministic: bool = True):
    """Fused-joint loss restricted to a band: the O(W) training step.

    Like make_memory_efficient_loss, but the joint (``Joint.banded_fn``)
    runs on the packed band window only (``rnnt_loss_fused_joint_banded``).
    Returns loss_fn(batch, bands, generator=None) -> the mean cost; `bands`
    is the restriction in encoder-frame time (e.g. bands_from_alignment on
    stored alignments), band_width the window width (size it with
    required_band_width).
    """

    def loss_fn(batch, bands: Bands, generator=None):
        enc, pred, labels, enc_lengths, slen = _encode_and_predict(
            model, batch, deterministic, generator)
        costs = rnnt_loss_fused_joint_banded(
            enc, pred, labels, enc_lengths, slen, model.joint.banded_fn,
            model.joint.joint_params(), bands=bands, band_width=band_width,
            blank_id=model.cfg.blank_id, chunk_t=chunk_t)
        return costs.mean()

    return loss_fn


# --- gradient accumulation and the sharded steps -----------------------------

def _local_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (or of global [B, T] bands)."""
    start, size = local_batch_slice(batch[0].shape[0], mesh)
    return tuple(x[start:start + size] for x in batch)


def _all_reduce(grads, group) -> None:
    """Sum each gradient over `group`, in one flat all-reduce."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _accumulated_step(state: TrainState, batch, n_micro: int,
                      mesh: Optional[Mesh]):
    """The one update body of train_step and the accumulating and
    data-parallel steps (make_grad_accum_train_step's contract)."""
    total = batch[0].shape[0]
    if total % n_micro:
        raise ValueError(f"batch {total} not divisible by n_micro {n_micro}")
    folds = ()
    if mesh is not None:
        batch = _local_batch(batch, mesh)
        folds = (mesh.data_index,)
        if batch[0].shape[0] % n_micro:
            raise ValueError(f"the data shard of {batch[0].shape[0]} rows is "
                             f"not divisible by n_micro {n_micro}")
    m = batch[0].shape[0] // n_micro
    model = state.model
    state.optimizer.zero_grad(set_to_none=True)
    loss = 0.0
    for i in range(n_micro):
        micro = _on(model, (x[i * m:(i + 1) * m] for x in batch))
        # One microbatch keeps the step's own seed (train_step's masks).
        gen = _dropout_generator(state, *((i,) if n_micro > 1 else ()),
                                 *folds)
        costs = model(*micro, deterministic=False, generator=gen)
        part = (costs.mean() if mesh is None
                else batch_total(costs, mesh, True)) / n_micro
        part.backward()
        loss = loss + part.detach()
    if mesh is not None and mesh.data > 1:
        _all_reduce(_grads(list(model.parameters())), mesh.data_group)
    return _update(state, loss)


def make_grad_accum_train_step(n_micro: int, mesh: Optional[Mesh] = None):
    """Train step that accumulates gradients over n_micro microbatches.

    The batch splits into n_micro equal slices; each slice's mean cost,
    divided by n_micro, is backpropagated (the gradients add up), then ONE
    clip and AdamW update apply. With dropout off this is the update of one
    step on the whole batch up to summation order; microbatch i draws its
    masks from (the step's seed, i). Peak activation memory is one
    microbatch's.

    With mesh set, each rank takes its data shard of the batch
    (make_sharded_train_step's layout) and splits that; each microbatch's
    loss is the global mean over the data axis, and the gradients are
    summed over it before the update.

    Returns step(state, batch) -> (state, metrics); the batch (with a mesh:
    each rank's shard) must divide by n_micro.
    """
    return functools.partial(_accumulated_step, n_micro=n_micro, mesh=mesh)


def make_sharded_train_step(mesh: Mesh):
    """train_step over the data axis: each rank takes its shard of the
    global batch, the loss is the global mean (parallel.batch_total), and
    the gradients are summed over the data group before the clip, so every
    rank holds the global gradient and takes the same update. Dropout masks
    differ per data shard (the data index is folded into the seed).

    Returns step(state, batch) -> (state, metrics), batch the global one.
    """
    return make_grad_accum_train_step(1, mesh)


def transducer_tp_specs(model: torch.nn.Module) -> Dict[str, Spec]:
    """{parameter name: spec} for vocab tensor parallelism of the
    transducer: everything replicated (()) except the joint's vocab
    projection, whose vocab axis is sharded over MODEL_AXIS. torch's
    Linear weight is [V, H] (flax's kernel [H, V] transposed), so the
    weight's spec is (MODEL_AXIS, None) and the bias's (MODEL_AXIS,); an
    AdamW moment takes its parameter's spec."""
    specs = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        spec = ()
        if "vocab_proj" in parts:
            if parts[-1] == "weight" and p.dim() >= 2:
                spec = (MODEL_AXIS,) + (None,) * (p.dim() - 1)
            elif parts[-1] == "bias" and p.dim() == 1:
                spec = (MODEL_AXIS,)
        specs[name] = spec
    return specs


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Cut the state's model-sharded parameters (transducer_tp_specs) to
    this rank's shard, in place, with their AdamW moments where they exist
    (AdamW makes them in the shard's shape otherwise), so the moments of
    the vocab projection stay sharded. Call it once, before the first
    make_tp_sharded_train_step step; the model's own forward then no
    longer sees the whole vocabulary."""
    specs = transducer_tp_specs(state.model)
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            spec = specs[name]
            if MODEL_AXIS not in spec:
                continue
            whole = p.shape
            p.data = local_shard(p.data, spec, mesh)
            p.grad = None
            moments = state.optimizer.state.get(p, {})
            for key, value in moments.items():
                if torch.is_tensor(value) and value.shape == whole:
                    moments[key] = local_shard(value, spec, mesh)
    return state


def make_tp_sharded_train_step(mesh: Mesh, model: MonotonicTransducer,
                               chunk_t: int = 32,
                               deterministic: bool = False,
                               band_width: Optional[int] = None):
    """Train step with the batch on 'data' AND the vocab axis on 'model'.

    The joint's output projection lives sharded (transducer_tp_specs;
    shard_train_state once before stepping): each rank evaluates only its
    V-slice of the joint, chunk by chunk, through
    parallel.make_dp_tp_fused_loss (with band_width:
    make_dp_tp_fused_banded_loss, O(B/data * T * W * V/model) a rank), and
    the [B, T, S+1, V] logits exist on no rank. The fused loss sums the
    joint's gradients over the ranks that hold each whole; this step adds
    the sum of the encoder's and predictor's over the data group. The clip
    reads the norm of the whole gradient: the replicated leaves once, the
    two sharded ones summed over the model group. Dropout
    (deterministic=False) folds the data index into the step's seed, so
    the masks differ per data shard and agree across the model axis.

    Returns step(state, batch) -> (state, metrics), or step(state, batch,
    bands) with band_width set (bands a global Bands pair in encoder-frame
    time); state.model must be `model`.
    """
    n_model = mesh.shape[MODEL_AXIS]
    vocab = model.cfg.vocab_size
    if vocab % n_model:
        raise ValueError(f"vocab_size {vocab} not divisible by model axis "
                         f"{n_model}")
    specs = transducer_tp_specs(model)
    joint_specs = {name[len("joint."):]: spec for name, spec in specs.items()
                   if name.startswith("joint.")}
    joint = model.joint
    blank = model.cfg.blank_id
    if band_width is None:
        loss_fn = make_dp_tp_fused_loss(mesh, joint.joint_fn, joint_specs,
                                        blank_id=blank, chunk_t=chunk_t)
    else:
        loss_fn = make_dp_tp_fused_banded_loss(
            mesh, joint.banded_fn, joint_specs, band_width=band_width,
            blank_id=blank, chunk_t=chunk_t)
    sharded = [p for n, p in model.named_parameters()
               if MODEL_AXIS in specs[n]]
    replicated = [p for n, p in model.named_parameters()
                  if MODEL_AXIS not in specs[n]]
    outer = [p for n, p in model.named_parameters()
             if not n.startswith("joint.")]

    def _step(state: TrainState, batch, bands: Optional[Bands]):
        if state.model is not model:
            raise ValueError("state.model is not the model this step was "
                             "made for")
        local = _local_batch(batch, mesh)
        gen = (None if deterministic
               else _dropout_generator(state, mesh.data_index))
        state.optimizer.zero_grad(set_to_none=True)
        enc, pred, labels, enc_lengths, slen = _encode_and_predict(
            model, local, deterministic, gen)
        band_args = ()
        if bands is not None:
            band_args = _on(model, _local_batch(tuple(bands), mesh))
        loss = loss_fn(enc, pred, labels, enc_lengths, slen,
                       joint.joint_params(), *band_args)
        loss.backward()
        if mesh.data > 1:
            _all_reduce(_grads(outer), mesh.data_group)
        sq_sharded = _sum_of_squares(_grads(sharded))
        if mesh.model > 1:
            dist.all_reduce(sq_sharded, group=mesh.model_group)
        norm = (_sum_of_squares(_grads(replicated)) + sq_sharded).sqrt()
        return _update(state, loss, norm)

    if band_width is None:
        def step(state: TrainState, batch):
            return _step(state, batch, None)
    else:
        def step(state: TrainState, batch, bands: Bands):
            return _step(state, batch, bands)
    return step


# --- checkpoints -------------------------------------------------------------

def save_checkpoint(path, state: TrainState) -> None:
    """The model's, optimiser's and schedule's state dicts, step and the
    dropout seed, in one torch.save file (its directory made if missing)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(),
                "step": state.step, "dropout_seed": state.dropout_seed},
               path)


def restore_checkpoint(path, state: TrainState) -> TrainState:
    """Load a save_checkpoint file into `state` (a TrainState of the same
    config, from any seed), in place; returns it. Resuming then follows
    the saved run's trajectory."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = int(ckpt["step"])
    state.dropout_seed = int(ckpt["dropout_seed"])
    return state
