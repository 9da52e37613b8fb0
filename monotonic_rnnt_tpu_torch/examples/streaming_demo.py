"""Streaming serving demo: overfit a causal transducer, then decode it
chunk by chunk as audio "arrives", printing the incremental hypothesis.

The port's counterpart of ``examples/streaming_demo.py``: the same model,
data and schedule, trained with ``models.train`` on one device (the card
unless --device cpu). It shows the serving loop a real-time recognizer
runs: one ``streaming_step`` per chunk, carried state (feature lookback +
predictor + hypothesis), bounded per-chunk latency. The final hypothesis
is checked against the full-utterance greedy decode, token for token; a
mismatch raises SystemExit.

  python -m monotonic_rnnt_tpu_torch.examples.streaming_demo [--steps 150]
      [--chunk 16] [--device cpu]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=150,
                   help="overfit steps before the streaming decode")
    p.add_argument("--chunk", type=int, default=16,
                   help="chunk size in 10ms frames (160ms of audio)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from ..data.synthetic import tiny_batch
    from ..models import ConformerConfig, PredictorConfig, TransducerConfig
    from ..models.conformer import streaming_lookback
    from ..models.train import create_train_state, train_step

    f32 = torch.float32
    cfg = TransducerConfig(
        encoder=ConformerConfig(num_layers=2, dim=64, num_heads=2,
                                dropout=0.0, causal=True,
                                attn_left_context=8, conv_kernel=7,
                                dtype=f32),
        predictor=PredictorConfig(vocab_size=32, dim=64, embed_dim=32,
                                  dtype=f32),
        joint_dim=64, vocab_size=32, dtype=f32)

    B, T, F, S, max_labels = 2, 128, 16, 6, 12
    batch = tuple(torch.from_numpy(a).to(args.device) for a in tiny_batch(
        batch=B, t=T, feat_dim=F, s=S, vocab=32))
    feats, flen, labels, slen = batch

    state = create_train_state(cfg, 0, batch, learning_rate=3e-3,
                               warmup_steps=1, device=args.device)
    model = state.model
    device = next(model.parameters()).device
    print(f"training {args.steps} steps on {device} (causal model, attn "
          f"window {cfg.encoder.attn_left_context})...")
    metrics = None
    for _ in range(args.steps):
        state, metrics = train_step(state, batch)
    if metrics is not None:
        print(f"final loss {float(metrics['loss']):.4f}")
    model.eval()

    hyp_full, n_full = model.greedy_decode(feats, flen, max_labels)

    lookback = streaming_lookback(cfg.encoder)
    print(f"\nstreaming: {args.chunk}-frame chunks ({args.chunk * 10} ms), "
          f"lookback {lookback} frames")
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sstate = model.streaming_init(B, F, lookback, max_labels)
    for i in range(0, T, args.chunk):
        cv = torch.clamp(flen - i, 0, args.chunk)
        t0 = time.perf_counter()
        sstate, _ = model.streaming_step(sstate, feats[:, i:i + args.chunk],
                                         cv)
        sync()
        dt = (time.perf_counter() - t0) * 1e3
        hyp0 = sstate["hyp"][0][:int(sstate["n_hyp"][0])].tolist()
        print(f"  t={i * 10 + args.chunk * 10:5d} ms | chunk {dt:6.2f} ms "
              f"wall on {device.type} | stream 0 hypothesis: {hyp0}")

    ok = (torch.equal(sstate["hyp"], hyp_full)
          and torch.equal(sstate["n_hyp"], n_full))
    print(f"\nstreaming == full-utterance greedy decode: "
          f"{'exact' if ok else 'MISMATCH'}")
    for b in range(B):
        tgt = labels[b][:int(slen[b])].tolist()
        got = sstate["hyp"][b][:int(sstate["n_hyp"][b])].tolist()
        print(f"  stream {b}: target {tgt} -> decoded {got}")
    if not ok:
        raise SystemExit("streaming mismatch")


if __name__ == "__main__":
    main()
