"""End-to-end example: train a tiny Conformer-transducer with the monotonic
RNN-T loss on synthetic data, then decode greedily and with beam search.

The port's counterpart of ``examples/train_tiny.py``: the same data,
config and optimiser settings, through ``models.train.create_train_state``
and ``train_step`` on one device (the card unless --device cpu), and the
same greedy and beam decode of the last batch.

  python -m monotonic_rnnt_tpu_torch.examples.train_tiny [--steps 30]
      [--batch 8] [--beam 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def label_accuracy(model, batch, max_labels: int = 6) -> float:
    """1 - the normalised edit distance of greedy decodes to the targets,
    averaged over the samples."""
    import torch

    from ..utils.metrics import edit_distance

    feats, flen, labels, slen = batch
    hyp, n_hyp = model.greedy_decode(feats, flen, max_labels)
    errs = edit_distance(hyp, n_hyp, labels, slen)
    return float((1.0 - errs / torch.clamp(slen, min=1)).mean())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--beam", type=int, default=4)
    p.add_argument("--overfit", action="store_true",
                   help="repeat one batch: the loss should collapse and "
                        "greedy decoding reproduce the targets")
    p.add_argument("--json-out", default=None,
                   help="write the loss curve and decode accuracy as JSON")
    p.add_argument("--seed", type=int, default=0, help="data and init seed")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from ..data.synthetic import SyntheticConfig, SyntheticDataset
    from ..models import ConformerConfig, PredictorConfig, TransducerConfig
    from ..models.train import create_train_state, train_step

    vocab = 64
    data = SyntheticDataset(
        SyntheticConfig(feat_dim=32, min_frames=32, max_frames=64,
                        frames_per_label=10.0, vocab_size=vocab,
                        seed=args.seed),
        batch_size=args.batch)
    cfg = TransducerConfig(
        encoder=ConformerConfig(num_layers=2, dim=96, num_heads=4,
                                dropout=0.0),
        predictor=PredictorConfig(vocab_size=vocab, dim=96, embed_dim=48),
        joint_dim=96, vocab_size=vocab)

    def tensors(batch_np):
        return tuple(torch.from_numpy(a).to(args.device) for a in batch_np)

    it = data.batches()
    first_batch = next(it)
    if args.overfit:
        it = iter(lambda: first_batch, None)   # the same batch forever
    state = create_train_state(cfg, args.seed, tensors(first_batch),
                               learning_rate=3e-3, warmup_steps=5,
                               device=args.device)
    model = state.model
    device = next(model.parameters()).device
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({kind}), batch {args.batch}")

    curve, acc_curve = [], []
    first = last = None
    acc0 = label_accuracy(model, tensors(first_batch))
    for i in range(args.steps):
        batch_np = next(it)
        state, metrics = train_step(state, tensors(batch_np))
        loss = float(metrics["loss"])
        first = first if first is not None else loss
        last = loss
        if i % 10 == 0 or i == args.steps - 1:
            curve.append({"step": i, "loss": round(loss, 4)})
        if i % 50 == 0 or i == args.steps - 1:
            acc = label_accuracy(model, tensors(first_batch))
            acc_curve.append({"step": i, "label_acc": round(acc, 4)})
            print(f"step {i:3d}  loss {loss:8.4f}  label_acc {acc:.3f}")
        elif i % 5 == 0:
            print(f"step {i:3d}  loss {loss:8.4f}")
    print(f"loss {first:.4f} -> {last:.4f} over {args.steps} steps")
    if args.json_out:
        Path(args.json_out).write_text(json.dumps({
            "device": kind,
            "torch": torch.__version__, "seed": args.seed,
            "steps": args.steps, "batch": args.batch,
            "overfit": args.overfit,
            "loss_first": round(first, 4), "loss_last": round(last, 4),
            "label_acc_init": round(acc0, 4),
            "label_acc_final": acc_curve[-1]["label_acc"],
            "loss_curve": curve, "label_acc_curve": acc_curve,
        }, indent=1) + "\n")

    # Decode the last batch, greedy and beam.
    feats, flen, labels, slen = tensors(batch_np)
    hyp, n_hyp = model.greedy_decode(feats, flen, 6)
    tok, n_b, score = model.beam_search_decode(feats, flen, 6, args.beam)
    for b in range(min(2, hyp.shape[0])):
        print(f"sample {b}: target {labels[b, :int(slen[b])].tolist()} | "
              f"greedy {hyp[b, :int(n_hyp[b])].tolist()} | "
              f"beam-{args.beam} {tok[b, 0, :int(n_b[b, 0])].tolist()} "
              f"(logp {float(score[b, 0]):.2f})")


if __name__ == "__main__":
    main()
