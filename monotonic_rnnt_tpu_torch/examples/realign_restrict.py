"""The long-utterance recipe end to end: align, then train restricted at O(W).

The port's counterpart of ``examples/realign_restrict.py``:

  1. warm up the tiny transducer unrestricted for a few steps (Adam);
  2. Viterbi-align the training batch with the current model
     (``viterbi_alignment`` on the full lattice, once);
  3. build a band around those alignments (``bands_from_alignment``, width
     from ``required_band_width``) and continue training through the
     banded fused-joint loss (``models.train.make_banded_memory_efficient_loss``):
     joint matmuls and loss scale with the band width W, not S+1;
  4. every few steps re-align inside the band with the packed-layout
     Viterbi (``viterbi_alignment_banded``), growing the width when a new
     alignment needs a wider window, so the full lattice never exists
     after step 2.

Synthetic data; loss values printed per phase. Runs on the card unless
--device cpu.

  python -m monotonic_rnnt_tpu_torch.examples.realign_restrict
      [--warmup 40] [--restricted 80] [--device cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--warmup", type=int, default=40)
    p.add_argument("--restricted", type=int, default=80)
    p.add_argument("--shift", type=int, default=3)
    p.add_argument("--realign-every", type=int, default=25)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from .. import (Bands, band_layout_is_exact, bands_from_alignment,
                    compute_band_layout, required_band_width,
                    viterbi_alignment, viterbi_alignment_banded)
    from ..convert import _device
    from ..data.synthetic import tiny_batch
    from ..models import (ConformerConfig, MonotonicTransducer,
                          PredictorConfig, TransducerConfig)
    from ..models.train import make_banded_memory_efficient_loss

    dev = _device(args.device)
    vocab, f32 = 32, torch.float32
    cfg = TransducerConfig(
        encoder=ConformerConfig(num_layers=1, dim=64, num_heads=2,
                                dropout=0.0, dtype=f32),
        predictor=PredictorConfig(vocab_size=vocab, dim=64, embed_dim=32,
                                  dtype=f32),
        joint_dim=64, vocab_size=vocab, dtype=f32)
    batch = tuple(torch.from_numpy(a).to(dev) for a in tiny_batch(
        batch=4, t=64, feat_dim=16, s=6, vocab=vocab))
    feats, flen, labels, slen = batch
    model = MonotonicTransducer(cfg, feats.shape[-1],
                                generator=torch.Generator().manual_seed(0),
                                device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)

    def update(loss):
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return float(loss.detach())

    # --- Phase 1: unrestricted warmup (overfit one batch). ------------------
    for i in range(args.warmup):
        loss = update(model(*batch).mean())
        if i % 10 == 0:
            print(f"[warmup]     step {i:3d}  loss {loss:8.4f}")

    # --- Phase 2: align with the current model (full lattice, once). --------
    with torch.no_grad():
        logits, enc_lengths = model.logits(feats, flen, labels)
        res = viterbi_alignment(logits, labels, enc_lengths, slen)
    print(f"[align]      viterbi score {res.score.cpu().numpy().round(3)}")
    t_enc, s1 = logits.shape[1], labels.shape[1] + 1
    del logits
    bands = bands_from_alignment(res.alignment, enc_lengths, slen,
                                 args.shift, cfg.blank_id)
    width = int(required_band_width(enc_lengths, slen, bands, t_enc, s1))
    print(f"[align]      band width {width} vs S+1={s1}")

    # --- Phase 3: banded training; re-align inside the band. ----------------
    def realign(bands, width):
        with torch.no_grad():
            enc, el = model.encode(feats, flen)
            pred = model.predictor(labels)
            layout = compute_band_layout(el, slen, bands, t_enc, s1, width)
            idx = (layout.offset.long()[:, :, None]
                   + torch.arange(width, device=dev)[None, None, :])
            rows = torch.arange(feats.shape[0], device=dev)[:, None, None]
            logits_band = model.joint.banded(enc, pred[rows, idx])
            return viterbi_alignment_banded(logits_band, labels, el, slen,
                                            bands=bands)

    banded_loss = make_banded_memory_efficient_loss(model, width, chunk_t=16)
    for i in range(args.restricted):
        loss = update(banded_loss(batch, bands))
        if i % 10 == 0:
            print(f"[restricted] step {i:3d}  loss {loss:8.4f}")
        if (i + 1) % args.realign_every == 0:
            res = realign(bands, width)
            bands = bands_from_alignment(res.alignment, enc_lengths, slen,
                                         args.shift, cfg.blank_id)
            # A new alignment can need a wider window than the width the
            # loss was made for; training on a clipped band would change the
            # objective, so grow the width instead.
            if not bool(band_layout_is_exact(enc_lengths, slen, bands, t_enc,
                                             s1, width).all()):
                width = int(required_band_width(enc_lengths, slen, bands,
                                                t_enc, s1))
                banded_loss = make_banded_memory_efficient_loss(
                    model, width, chunk_t=16)
                print(f"[realign]    band width grown to {width}")
            print(f"[realign]    step {i:3d}  packed viterbi score "
                  f"{res.score.cpu().numpy().round(3)}")

    print(f"done: final restricted loss {loss:.4f}")


if __name__ == "__main__":
    main()
