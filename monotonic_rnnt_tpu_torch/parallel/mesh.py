"""The (data, model) process mesh and the multi-process runtime.

PyTorch counterpart of ``monotonic_rnnt_tpu/parallel/mesh.py``. Where JAX
runs one program over a device mesh (``shard_map``), the port runs one
process per shard (SPMD over ``torch.distributed``): the batch is split
over the 'data' axis and the vocabulary over the 'model' axis. The global
rank of the shard (d, m) is ``d * model + m``, the layout of JAX's
``reshape(data, model)`` (mesh.py:40), so rank r holds what JAX's device r
holds.

``data_sharding`` and ``replicated`` (JAX ``NamedSharding``s) have no
counterpart: a process holds its own shard as an ordinary tensor, and
``local_shard`` / ``shard_params`` cut it from a global tensor.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# A spec names, per dimension of a tensor, the mesh axis it is split over
# (None: whole); () is a replicated tensor. E.g. (None, MODEL_AXIS) for an
# output projection [H, V] sharded over the vocabulary.
Spec = Sequence[Optional[str]]


@dataclass(frozen=True)
class Mesh:
    """This process's place in a (data, model) mesh.

    data_group: the ranks that share this model index, over which the batch
      is split (JAX's psum over 'data'); model_group: the ranks that share
      this data index, over which the vocabulary is split. device: where
      this rank's tensors live.
    """

    data: int
    model: int
    data_index: int
    model_index: int
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def index(self, axis: str) -> int:
        return self.data_index if axis == DATA_AXIS else self.model_index


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run the mesh on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(data: Optional[int] = None, model: int = 1,
              device=None) -> Mesh:
    """Create this rank's ('data', 'model') mesh over the initialised group.

    Every rank of the default group must call it, with the same sizes: it
    builds one process group per model index and one per data index, in the
    same order everywhere. data defaults to world_size // model, and
    data * model must equal the world size (one process per shard).
    device defaults to cuda:{LOCAL_RANK % device_count()}; the CPU is used
    only when asked for (device='cpu').
    """
    world = dist.get_world_size()
    if data is None:
        if world % model:
            raise ValueError(f"{world} processes not divisible by "
                             f"model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} "
                         f"processes, the group has {world}")
    rank = dist.get_rank()
    d_idx, m_idx = divmod(rank, model)
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    dev = torch.device(device) if device is not None else _default_device()
    return Mesh(data, model, d_idx, m_idx, data_groups[m_idx],
                model_groups[d_idx], dev)


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None, *,
                         backend: Optional[str] = None,
                         timeout_s: float = 300.0) -> None:
    """Initialise the default process group (no-op if it already is).

    world_size and rank default to the WORLD_SIZE and RANK environment
    variables (1 and 0); init_method to 'env://' (MASTER_ADDR, MASTER_PORT).
    A single process with neither an init_method nor MASTER_ADDR gets an
    in-memory store. backend defaults to 'nccl' where CUDA is available,
    else 'gloo' (NCCL takes one rank per card: ranks sharing a card need
    'gloo'). A rank that waits longer than timeout_s for the others raises.
    """
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = dict(backend=backend, world_size=world_size, rank=rank,
                  timeout=timedelta(seconds=timeout_s))
    if init_method is None and world_size == 1 and (
            "MASTER_ADDR" not in os.environ):
        dist.init_process_group(store=dist.HashStore(), **kwargs)
    else:
        dist.init_process_group(init_method=init_method or "env://", **kwargs)


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_batch_slice(global_batch: int, mesh: Mesh) -> Tuple[int, int]:
    """(start, size) of this process's batch shard along the data axis.

    The arithmetic of JAX's mesh.py:71-102 over the process index and
    count. With one process per shard, as make_mesh builds, that is
    (data_index * B / data, B / data): the processes of one data index (its
    model shards) feed the same slice.
    """
    n_data = mesh.data
    if global_batch % n_data:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data axis {n_data}")
    per = global_batch // n_data
    idx = _process_index()
    procs = max(1, _process_count())
    if procs >= n_data:
        if procs % n_data:
            raise ValueError(
                f"process count {procs} not divisible by data axis {n_data}; "
                "shard assignment would depend on the process layout")
        return idx // (procs // n_data) * per, per
    if n_data % procs:
        raise ValueError(
            f"data axis {n_data} not divisible by process count {procs}; "
            "some shards would never be fed")
    shards_per_proc = n_data // procs
    return idx * shards_per_proc * per, shards_per_proc * per


def local_shard(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of a global tensor under `spec`, contiguous."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} is not "
                             f"divisible by the {axis} axis ({n})")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(axis) * size, size)
    return x.contiguous()


def shard_params(params: Dict[str, torch.Tensor], specs: Dict[str, Spec],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The joint's parameters cut to this rank's shards, leaf by leaf."""
    return {k: local_shard(v, specs[k], mesh) for k, v in params.items()}
