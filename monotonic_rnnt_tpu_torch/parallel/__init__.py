"""Data and vocab sharding over torch.distributed, one process per shard.

PyTorch counterpart of ``monotonic_rnnt_tpu/parallel``. JAX's
``data_sharding`` and ``replicated`` (``NamedSharding``s) have no
counterpart: each process holds its shard (``local_shard``,
``shard_params``, ``local_batch_slice``).
"""

from .data_parallel import make_data_parallel_loss, make_per_sample_loss
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, initialize_multihost,
                   local_batch_slice, local_shard, make_mesh, shard_params)
from .sharding import (make_dp_tp_banded_loss, make_dp_tp_fused_banded_loss,
                       make_dp_tp_fused_loss, make_dp_tp_loss,
                       rnnt_loss_banded_vocab_sharded,
                       rnnt_loss_vocab_sharded)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "initialize_multihost",
    "local_batch_slice", "local_shard", "shard_params",
    "make_data_parallel_loss", "make_per_sample_loss", "make_dp_tp_loss",
    "make_dp_tp_banded_loss", "make_dp_tp_fused_loss",
    "make_dp_tp_fused_banded_loss", "rnnt_loss_vocab_sharded",
    "rnnt_loss_banded_vocab_sharded",
]
