"""Conformer-transducer model family of the PyTorch port.

Counterpart of ``monotonic_rnnt_tpu/models``, with the same public names:
  ConformerConfig / ConformerEncoder     — acoustic encoder (causal option)
  PredictorConfig / LstmPredictor / ConvPredictor — label-context networks
  TransducerConfig / MonotonicTransducer — encoder + predictor + joint + loss,
      with greedy_decode, beam_search_decode (path merging, LM shallow
      fusion) and chunked streaming (streaming_init/step,
      streaming_beam_init/step); Joint also runs as the fused-joint losses'
      joint_fn
  lm (not exported here, as in JAX): BigramLm, LstmLmConfig, LstmLm,
      ModuleLmAdapter — the LMs of shallow fusion
  train: create_train_state, train_step, make_sharded_train_step,
      make_grad_accum_train_step, make_memory_efficient_loss /
      make_banded_memory_efficient_loss, make_tp_sharded_train_step /
      shard_train_state / transducer_tp_specs (vocab-TP fused-joint
      training), save_checkpoint, restore_checkpoint
``convert.transducer_params_from_flax`` loads a flax model's parameters,
``convert.lstm_lm_params_from_flax`` a flax LstmLm's,
``convert.train_state_from_optax`` a JAX TrainState.
"""

from .conformer import ConformerConfig, ConformerEncoder
from .predictor import ConvPredictor, LstmPredictor, PredictorConfig
from .transducer import Joint, MonotonicTransducer, TransducerConfig

__all__ = [
    "ConformerConfig", "ConformerEncoder", "PredictorConfig",
    "LstmPredictor", "ConvPredictor", "TransducerConfig",
    "MonotonicTransducer", "Joint",
]
