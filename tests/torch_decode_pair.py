"""The decoder tests' shared models: one tiny Conformer transducer in both
frameworks, the port's holding the flax model's weights through
``convert.transducer_params_from_flax`` (as tests/test_torch_models.py
pairs them), and seeded numpy batches."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from monotonic_rnnt_tpu.data.synthetic import tiny_batch
from monotonic_rnnt_tpu.models import conformer as jc
from monotonic_rnnt_tpu.models import predictor as jp
from monotonic_rnnt_tpu.models import transducer as jt
from monotonic_rnnt_tpu_torch import convert
from monotonic_rnnt_tpu_torch.models import conformer as tc
from monotonic_rnnt_tpu_torch.models import predictor as tp
from monotonic_rnnt_tpu_torch.models import transducer as tt

FEAT = 15
# The beam cell (test_models.py's tiny decoders, V widened to 128) and the
# streaming cell (test_models.py:182's: causal, a 4-frame attention window,
# depthwise kernel 7, so lookback 88 input frames; V = 32).
BEAM = {"vocab": 128, "causal": False, "left": -1, "conv_kernel": 15}
STREAM = {"vocab": 32, "causal": True, "left": 4, "conv_kernel": 7}


def configs(kind="lstm", dtype="float32", vocab=128, causal=False, left=-1,
            conv_kernel=15):
    """The same tiny config in both frameworks: 2 layers, dim 32."""
    def make(mod_c, mod_p, mod_t, dt):
        enc = mod_c.ConformerConfig(num_layers=2, dim=32, num_heads=2,
                                    dropout=0.0, causal=causal,
                                    attn_left_context=left,
                                    conv_kernel=conv_kernel, dtype=dt)
        pred = mod_p.PredictorConfig(vocab_size=vocab, dim=32, embed_dim=16,
                                     dtype=dt)
        return mod_t.TransducerConfig(encoder=enc, predictor=pred,
                                      joint_dim=32, vocab_size=vocab,
                                      predictor_kind=kind, dtype=dt)
    return (make(jc, jp, jt, getattr(jnp, dtype)),
            make(tc, tp, tt, getattr(torch, dtype)))


@functools.lru_cache(maxsize=None)
def pair(kind="lstm", cell="beam", seed=0):
    """(flax model, its params, the port's model with the same weights on
    the CPU), f32: one JAX init per (kind, cell, seed) in a worker."""
    cfg = BEAM if cell == "beam" else STREAM
    jcfg, tcfg = configs(kind, **cfg)
    jm = jt.MonotonicTransducer(jcfg)
    feats, flen, labels, slen = batch(vocab=cfg["vocab"])
    params = jm.init(jax.random.PRNGKey(seed), feats, flen, labels, slen)
    tm = tt.MonotonicTransducer(tcfg, FEAT, device="cpu")
    tm.load_state_dict(convert.transducer_params_from_flax(params, tcfg,
                                                           device="cpu"))
    return jm, params, tm


def batch(b=2, t=24, vocab=128, seed=0):
    return tiny_batch(batch=b, t=t, feat_dim=FEAT, s=4, vocab=vocab,
                      seed=seed)


def t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def assert_beams_equal(got, want, rtol=1e-5):
    """(tokens, lengths, scores) of the port against JAX's: tokens and
    lengths equal, scores within rtol (-inf where JAX's are)."""
    for g, w, what in zip(got[:2], want[:2], ("tokens", "lengths")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=what)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=rtol, atol=0, err_msg="scores")
