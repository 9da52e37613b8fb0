"""The port's Emformer RNN-T against a plain reference, on the CPU.

The JAX package has no Emformer, so the port is held against
``emformer_reference.py``: the same model written out from its equations
in plain PyTorch. A tiny configuration keeps every part: 2 layers of width
32 (a 4-frame stack of 8), 2 heads, segment 4, right context 1 and left
context 3 reduced frames, 3 LN-LSTM layers, the ReLU joint, V = 13 with
blank 12. Both take the same seeded weights; the loss on both sides is the
port's (on the CPU its plain path, tested against its oracles elsewhere),
so what is compared is the encoder, the predictor and the joint.

Tolerances, float32: encodings and logits 1e-5, costs 1e-5 relative and
each parameter's gradient a relative L2 gap of 1e-4 of the larger of its
norm and a thousandth of the largest leaf's (another summation order in
every matmul, einsum and LayerNorm; a leaf whose gradient is near zero is
held to the others' scale), padded against unpadded encodings 1e-5
absolute (the same: other shapes, other orders).
"""

from pathlib import Path

import pytest
import torch

import emformer_reference as ref
from monotonic_rnnt_tpu_torch import monotonic_rnnt_loss
from monotonic_rnnt_tpu_torch.models import (ConformerConfig, Joint,
                                             LstmPredictor, PredictorConfig,
                                             TransducerConfig)
from monotonic_rnnt_tpu_torch.models.emformer import (EmformerConfig,
                                                      EmformerEncoder,
                                                      attention_mask,
                                                      dropped_scores,
                                                      kept_cells)
from monotonic_rnnt_tpu_torch.models.transducer import MonotonicTransducer
from monotonic_rnnt_tpu_torch.utils.profiling import (counters,
                                                      reset_counters)

FEAT, V, BLANK = 20, 13, 12
CFG = dict(feat_dim=FEAT, time_reduction_input_dim=8, time_reduction_stride=4,
           transformer_num_layers=2, transformer_num_heads=2,
           transformer_ffn_dim=64, segment_length=16, right_context_length=4,
           transformer_left_context_length=3, encoding_dim=24,
           symbol_embedding_dim=16, num_lstm_layers=3,
           lstm_layer_norm_epsilon=1e-3, vocab_size=V, blank_id=BLANK)
ENC = EmformerConfig(num_layers=2, reduction_dim=8, num_heads=2, ffn_dim=64,
                     left_context=3, output_dim=24, dtype=torch.float32)


@pytest.fixture(autouse=True)
def _fresh_counters():
    """An Emformer forward leaves counters()["emformer"] set; tests that
    read the counters' changes later in the same process expect none."""
    yield
    reset_counters()


def _config() -> TransducerConfig:
    pred = PredictorConfig(vocab_size=V, dim=16, embed_dim=16,
                           dtype=torch.float32, bos_id=BLANK, num_layers=3,
                           layer_norm=True, out_dim=24)
    return TransducerConfig(ENC, pred, joint_dim=24, vocab_size=V,
                            blank_id=BLANK, dtype=torch.float32,
                            joint_activation="relu")


def _weights(seed: int) -> dict:
    """Seeded weights by the reference's names: matrices a fan-in normal,
    LayerNorm scales 1 + 0.1 z, other vectors 0.1 z, the embedding z."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in ref.build(CFG).named_parameters():
        z = torch.randn(p.shape, generator=g)
        if name.endswith("embed.weight"):
            out[name] = z
        elif p.dim() >= 2:
            out[name] = z * p.shape[1] ** -0.5
        elif "norm" in name.split(".")[-2] and name.endswith(".weight"):
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = 0.1 * z
    return out


def _models(seed: int):
    weights = _weights(seed)
    port = MonotonicTransducer(_config(), FEAT, device="cpu")
    plain = ref.build(CFG).to_empty(device="cpu")
    with torch.no_grad():
        for model in (port, plain):
            for name, p in model.named_parameters():
                p.copy_(weights[name])
    return port, plain


def _batch(seed: int):
    """Frames 150, 121, 70, 43: T' 37, 30, 17, 10, none a multiple of the
    segment and some of their frames past the last whole group of 4."""
    g = torch.Generator().manual_seed(seed)
    frames = torch.tensor([150, 121, 70, 43], dtype=torch.int32)
    feats = torch.randn(4, 150, FEAT, generator=g)
    labels = torch.randint(0, BLANK, (4, 6), generator=g, dtype=torch.int32)
    slen = torch.tensor([6, 5, 3, 2], dtype=torch.int32)
    return feats, frames, labels, slen


@pytest.mark.parametrize("seed", [0, 1])
def test_costs_and_gradients_match_the_reference(seed):
    port, plain = _models(seed)
    feats, frames, labels, slen = _batch(seed + 10)
    enc, enc_len = port.encode(feats, frames)
    want_enc, tprime = plain.encoder(feats, frames)
    assert torch.equal(enc_len, tprime) and enc_len.tolist() == [37, 30, 17,
                                                                 10]
    valid = torch.arange(enc.shape[1])[None, :] < tprime[:, None]
    torch.testing.assert_close(enc[valid], want_enc[valid], rtol=1e-5,
                               atol=1e-5)
    got_logits, _ = port.logits(feats, frames, labels)
    logits, _ = plain(feats, frames, labels)
    torch.testing.assert_close(got_logits[valid], logits[valid], rtol=1e-5,
                               atol=1e-5)
    costs = port(feats, frames, labels, slen)
    want = monotonic_rnnt_loss(logits, labels, tprime.to(torch.int32), slen,
                               blank_id=BLANK)
    torch.testing.assert_close(costs, want, rtol=1e-5, atol=0)
    weights = torch.tensor([1.0, -0.5, 2.0, 0.7])
    got = dict(zip((n for n, _ in port.named_parameters()),
                   torch.autograd.grad((costs * weights).sum(),
                                       list(port.parameters()))))
    exp = dict(zip((n for n, _ in plain.named_parameters()),
                   torch.autograd.grad((want * weights).sum(),
                                       list(plain.parameters()))))
    assert sorted(got) == sorted(exp)
    floor = 1e-3 * max(g.norm() for g in exp.values())
    for name, g in exp.items():
        gap = (got[name] - g).norm() / max(g.norm(), floor)
        assert gap < 1e-4, (name, float(gap))


def test_the_mask_keeps_each_segments_blocks():
    """T = 14 utterance frames, L = 4, R = 1, LC = 3: segments 0-3 (the last
    of 2 frames), rows [RC 0-3; U 0-13]. A row of segment i keeps its own
    right-context key and the utterance keys max(4i - 3, 0) .. min(4i + 4,
    14) - 1; key padding then drops the utterance keys at or past T'_b."""
    t, n = 14, 4
    mask = attention_mask(t, ENC)
    assert torch.equal(mask, ref.block_mask(t, CFG))
    assert int(mask.sum()) == kept_cells(t, ENC)
    want = {i: [i] + [n + u for u in range(max(4 * i - 3, 0),
                                           min(4 * i + 4, t))]
            for i in range(n)}
    for row in range(n + t):
        seg = row if row < n else (row - n) // 4
        assert mask[row].nonzero()[:, 0].tolist() == want[seg], row
    assert want[3] == [3, n + 9, n + 10, n + 11, n + 12, n + 13]

    dropped = dropped_scores(t, torch.tensor([14, 6]), ENC)
    assert dropped.shape == (2, 1, n + t, n + t)
    assert torch.equal(~dropped[0, 0], mask)
    keep = ~dropped[1, 0]
    assert not keep[:, n + 6:].any()
    assert torch.equal(keep[:, :n + 6], mask[:, :n + 6])
    assert bool(keep.any(dim=1).all())          # own right-context key


def test_the_right_context_reads_an_utterances_own_frames():
    """Block i copies from min((i + 1) L, T'_b): in a batch with a longer
    utterance, a short one's last block and those past its end hold its
    own frame T'_b (its last partial group of 4, then zeros), as alone."""
    enc = EmformerEncoder(ENC, FEAT, device="cpu")
    feats = torch.randn(2, 47, FEAT)
    x, lengths = enc._embed(feats, torch.tensor([47, 22]))
    assert x.shape[1] == 11 + 1 and lengths.tolist() == [11, 5]
    rc = enc._right_context(x, lengths, 3)
    assert torch.equal(rc[0], x[0, [4, 8, 11]])
    assert torch.equal(rc[1], x[1, [4, 5, 5]])
    alone, _ = enc._embed(feats[1:, :22], torch.tensor([22]))
    assert torch.equal(alone[0, 5], x[1, 5]) and bool(x[1, 5].ne(0).any())
    assert bool(x[1, 6:].eq(0).all())


def test_an_utterance_alone_equals_it_in_a_padded_batch():
    port, _ = _models(3)
    feats, frames, _, _ = _batch(4)
    padded = feats.clone()
    for b, n in enumerate(frames.tolist()):
        padded[b, n:] = 1e3 * torch.randn(150 - n, FEAT)
    enc, lengths = port.encode(padded, frames)
    for b, n in enumerate(frames.tolist()):
        alone, alone_len = port.encode(feats[b:b + 1, :n], frames[b:b + 1])
        assert int(alone_len) == int(lengths[b]) == n // 4
        torch.testing.assert_close(enc[b:b + 1, :int(alone_len)], alone,
                                   rtol=0, atol=1e-5)


def test_bos_is_the_blank_in_forward_step_and_decoding():
    port, plain = _models(5)
    pred = port.predictor
    labels = torch.randint(0, BLANK, (3, 5), generator=torch.Generator()
                           .manual_seed(1), dtype=torch.int32)
    with torch.no_grad():
        full = pred(labels)
        torch.testing.assert_close(full, plain.predictor(labels), rtol=1e-5,
                                   atol=1e-5)
        state = pred.init_state(3)
        assert len(state) == 3                  # one (c, h) a layer
        steps = []
        tokens = torch.cat([torch.full((3, 1), BLANK, dtype=torch.int32),
                            labels], dim=1)
        for tok in tokens.T:
            state, ctx = pred.step(state, tok)
            steps.append(ctx)
        torch.testing.assert_close(torch.stack(steps, dim=1), full,
                                   rtol=1e-6, atol=1e-6)
        _, bos = port._bos_context(3)
        assert torch.equal(bos, steps[0])
        _, zero = pred.step(pred.init_state(3),
                            torch.zeros(3, dtype=torch.int32))
        assert not torch.allclose(zero, full[:, 0])
    feats, frames, _, _ = _batch(6)
    hyp, n = port.greedy_decode(feats, frames, max_labels=8)
    assert hyp.shape == (4, 8) and bool((n <= 8).all())
    assert bool((hyp != BLANK).all())
    one, one_len, _ = port.beam_search_decode(feats, frames, 8, 1)
    assert torch.equal(one[:, 0], hyp) and torch.equal(one_len[:, 0], n)
    tokens, _, _ = port.beam_search_decode(feats, frames, 8, 3)
    assert tokens.shape == (4, 3, 8)
    with pytest.raises(ValueError, match="Emformer"):
        port.streaming_init(4, FEAT, 16, 8)


def test_a_step_reads_nothing_on_the_host():
    """Forward and backward on meta tensors, which refuse any read of their
    values (a host sync on the card), the port's sync counter unmoved, and
    the attention counted from the padded shapes: B H layers (nR + T)^2
    cells computed, B H layers kept_cells(T) kept, B n R rows carried."""
    model = MonotonicTransducer(_config(), FEAT, device="cpu").to_empty(
        device="meta")
    feats, frames, labels, _ = (x.to("meta") for x in _batch(0))
    reset_counters()
    logits, _ = model.logits(feats, frames, labels)
    logits.sum().backward()
    seen = counters()
    assert seen["syncs"] == {}
    assert all(p.grad is not None for p in model.parameters())
    t, n = 150 // 4, -(-(150 // 4) // 4)
    assert seen["emformer"] == {"attn_cells": 4 * 2 * 2 * (n + t) ** 2,
                                "attn_kept": 4 * 2 * 2 * kept_cells(t, ENC),
                                "rc_rows": 4 * n}


def test_emformer_rnnt_base_size():
    """torchaudio's emformer_rnnt_base(4097): encoder 63,605,760, predictor
    8,932,864, joint 4,199,425 parameters, 76,738,049 in all."""
    pred = PredictorConfig(vocab_size=4097, dim=512, embed_dim=512,
                           dtype=torch.float32, bos_id=4096, num_layers=3,
                           layer_norm=True, out_dim=1024)
    cfg = TransducerConfig(EmformerConfig(dtype=torch.float32), pred,
                           joint_dim=1024, vocab_size=4097, blank_id=4096,
                           dtype=torch.float32, joint_activation="relu")
    with torch.device("meta"):
        encoder = EmformerEncoder(cfg.encoder, 80, device="meta")
        predictor = LstmPredictor(pred, device="meta")
        joint = Joint(cfg, device="meta")
    sizes = [sum(p.numel() for p in m.parameters())
             for m in (encoder, predictor, joint)]
    assert sizes == [63_605_760, 8_932_864, 4_199_425]
    assert sum(sizes) == 76_738_049
    assert encoder.cfg.model_dim == 512 and encoder.cfg.dim == 1024
    with pytest.raises(ValueError, match="widths"):
        Joint(TransducerConfig(EmformerConfig(), pred, joint_dim=512,
                               joint_activation="relu"), device="meta")


def test_the_conformer_predictor_and_joint_keep_their_form():
    """The defaults build flax's one-layer LSTM predictor (BOS 0) and the
    tanh joint with its two projections, leaf for leaf, and compute them
    as flax's cell does."""
    cfg = TransducerConfig(ConformerConfig(num_layers=1, dim=16, num_heads=2,
                                           dtype=torch.float32),
                           PredictorConfig(vocab_size=V, dim=8, embed_dim=6,
                                           dtype=torch.float32),
                           joint_dim=10, vocab_size=V, dtype=torch.float32)
    gen = torch.Generator().manual_seed(2)
    pred = LstmPredictor(cfg.predictor, generator=gen, device="cpu")
    joint = Joint(cfg, generator=gen, device="cpu")
    assert [n for n, _ in pred.named_parameters()] == [
        "embed.weight", "cell.weight_ih", "cell.weight_hh", "cell.bias_hh",
        "out.weight", "out.bias"]
    assert [n for n, _ in joint.named_parameters()] == [
        "enc_proj.weight", "enc_proj.bias", "pred_proj.weight",
        "pred_proj.bias", "vocab_proj.weight", "vocab_proj.bias"]
    labels = torch.tensor([[3, 1, 4]], dtype=torch.int32)
    with torch.no_grad():
        x = pred.embed.weight[torch.tensor([0, 3, 1, 4])]
        c = h = torch.zeros(1, 8)
        hs = []
        for k in range(4):
            g = (x[k:k + 1] @ pred.cell.weight_ih.T + h @ pred.cell.weight_hh.T
                 + pred.cell.bias_hh)
            i, f, gg, o = g.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        want = torch.cat(hs) @ pred.out.weight.T + pred.out.bias
        torch.testing.assert_close(pred(labels)[0], want)
        enc, p = torch.randn(1, 2, 16), torch.randn(1, 3, 8)
        hid = torch.tanh((enc @ joint.enc_proj.weight.T
                          + joint.enc_proj.bias)[:, :, None]
                         + (p @ joint.pred_proj.weight.T
                            + joint.pred_proj.bias)[:, None])
        torch.testing.assert_close(
            joint(enc, p), hid @ joint.vocab_proj.weight.T
            + joint.vocab_proj.bias)


def test_the_fused_joint_losses_take_the_relu_joint():
    """The memory-efficient losses run Joint.joint_fn and Joint.banded_fn
    chunk by chunk: with the ReLU joint they give the materialised loss's
    mean cost and gradients (the banded one with a band that holds every
    state)."""
    from monotonic_rnnt_tpu_torch.models.train import (
        make_banded_memory_efficient_loss, make_memory_efficient_loss)
    from monotonic_rnnt_tpu_torch.ops.bands import default_bands
    port, _ = _models(7)
    batch = _batch(8)
    params = list(port.parameters())
    want = port(*batch).mean()
    want_g = torch.autograd.grad(want, params)
    fused = make_memory_efficient_loss(port, chunk_t=8)(batch)
    tprime = batch[1] // 4
    bands = default_bands(tprime, batch[3], int(tprime.max()))
    banded = make_banded_memory_efficient_loss(port, band_width=7,
                                               chunk_t=8)(batch, bands)
    for got in (fused, banded):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        for g, w in zip(torch.autograd.grad(got, params), want_g):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)


def test_the_reference_is_the_benchmarks_copy():
    """tests/emformer_reference.py and h100_bench/reference/emformer.py are one
    reference: below the first paragraph of their docstrings, which says
    whose copy each is, they are the same bytes."""
    def body(path):
        return path.read_bytes().split(b"\n\n", 1)[1]

    tests = Path(__file__).parent
    assert body(tests / "emformer_reference.py") == body(
        tests.parent / "h100_bench" / "reference" / "emformer.py")
