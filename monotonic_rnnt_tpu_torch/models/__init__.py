"""Conformer-transducer model family of the PyTorch port.

Counterpart of ``monotonic_rnnt_tpu/models``, with the same public names:
  ConformerConfig / ConformerEncoder     — acoustic encoder (causal option)
  PredictorConfig / LstmPredictor / ConvPredictor — label-context networks
  TransducerConfig / MonotonicTransducer — encoder + predictor + joint + loss,
      with greedy_decode; Joint also runs as the fused-joint losses' joint_fn
``convert.transducer_params_from_flax`` loads a flax model's parameters.
"""

from .conformer import ConformerConfig, ConformerEncoder
from .predictor import ConvPredictor, LstmPredictor, PredictorConfig
from .transducer import Joint, MonotonicTransducer, TransducerConfig

__all__ = [
    "ConformerConfig", "ConformerEncoder", "PredictorConfig",
    "LstmPredictor", "ConvPredictor", "TransducerConfig",
    "MonotonicTransducer", "Joint",
]
