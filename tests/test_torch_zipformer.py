"""The port's Zipformer transducer against a plain reference, on the CPU.

The JAX package has no Zipformer, so the port is held against
``zipformer_reference.py``: the same model written out from its equations
in plain PyTorch. A tiny configuration keeps all six rates (1, 2, 4, 8, 4,
2) with one layer a stack. Both take the same seeded weights; the loss on
both sides is the port's (on the CPU its plain path, tested against its
oracles elsewhere), so what is compared is the encoder, the stateless
predictor and the joint.

Tolerances, float32: costs 1e-5 relative and each parameter's gradient a
relative L2 gap of 1e-4 of the larger of its norm and a thousandth of the
largest leaf's (another summation order in every matmul, convolution and
einsum; a leaf whose gradient is near zero, the attention key bias under
the softmax, is held to the others' scale), padded against unpadded
encodings 1e-5 absolute (the same: other shapes, other orders).
"""

import dataclasses
import math
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import zipformer_reference as ref
from monotonic_rnnt_tpu_torch import monotonic_rnnt_loss
from monotonic_rnnt_tpu_torch.models import (PredictorConfig,
                                             TransducerConfig)
from monotonic_rnnt_tpu_torch.models.predictor import ConvPredictor
from monotonic_rnnt_tpu_torch.models.transducer import MonotonicTransducer
from monotonic_rnnt_tpu_torch.models.zipformer import (
    AttentionWeights, Downsample, Stack, ZipformerConfig, ZipformerEncoder,
    compact_rel_positions, rel_shift, swoosh_l, swoosh_r)
from monotonic_rnnt_tpu_torch.utils.profiling import (counters,
                                                      reset_counters)

FEAT, V = 20, 11
CFG = dict(num_encoder_layers=[1] * 6, downsampling_factor=[1, 2, 4, 8, 4, 2],
           encoder_dim=[16, 24, 32, 40, 32, 24], feedforward_dim=[32] * 6,
           num_heads=[2, 2, 2, 3, 2, 2], query_head_dim=8, pos_head_dim=4,
           value_head_dim=6, pos_dim=12, cnn_module_kernel=[3, 3, 5, 5, 3, 3],
           output_downsampling_factor=2, embed_channels=[2, 4, 8],
           convnext_hidden_ratio=3, decoder_dim=16, joiner_dim=8,
           context_size=2, vocab_size=V, blank_id=0, feat_dim=FEAT)


def _config(cfg=CFG) -> TransducerConfig:
    f32 = torch.float32
    enc = ZipformerConfig(
        num_layers=tuple(cfg["num_encoder_layers"]),
        downsampling=tuple(cfg["downsampling_factor"]),
        encoder_dims=tuple(cfg["encoder_dim"]),
        feedforward_dims=tuple(cfg["feedforward_dim"]),
        num_heads=tuple(cfg["num_heads"]),
        conv_kernels=tuple(cfg["cnn_module_kernel"]),
        query_head_dim=cfg["query_head_dim"],
        pos_head_dim=cfg["pos_head_dim"],
        value_head_dim=cfg["value_head_dim"], pos_dim=cfg["pos_dim"],
        output_downsampling=cfg["output_downsampling_factor"],
        embed_channels=tuple(cfg["embed_channels"]),
        convnext_expansion=cfg["convnext_hidden_ratio"], dtype=f32)
    d = cfg["decoder_dim"]
    pred = PredictorConfig(vocab_size=V, dim=d, embed_dim=d,
                           context=cfg["context_size"], stateless=True,
                           dtype=f32)
    return TransducerConfig(enc, pred, joint_dim=cfg["joiner_dim"],
                            vocab_size=V, predictor_kind="conv", dtype=f32)


def _weights(seed: int) -> dict:
    """Seeded weights by the reference's names: kernels a fan-in normal,
    vectors 0.1 z; BiasNorm scales, bypass scales and downsample weights
    away from their initial values, so that each enters the comparison."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in ref.build(CFG).named_parameters():
        z = torch.randn(p.shape, generator=g)
        if name.endswith("log_scale"):
            out[name] = 1.0 + 0.1 * z
        elif name.endswith(".scale"):
            out[name] = 0.5 + 0.1 * z
        elif p.dim() >= 2:
            out[name] = z * p[0].numel() ** -0.5
        else:
            out[name] = 0.3 * z if "downsample" in name else 0.1 * z
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
    g = torch.Generator().manual_seed(seed)
    frames = torch.tensor([150, 121, 70, 43], dtype=torch.int32)
    feats = torch.randn(4, 150, FEAT, generator=g)
    labels = torch.randint(1, V, (4, 6), generator=g, dtype=torch.int32)
    slen = torch.tensor([6, 5, 3, 2], dtype=torch.int32)
    return feats, frames, labels, slen


@pytest.mark.parametrize("seed", [0, 1])
def test_costs_and_gradients_match_the_reference(seed):
    port, plain = _models(seed)
    feats, frames, labels, slen = _batch(seed + 10)
    costs = port(feats, frames, labels, slen)
    logits, tprime = plain(feats, frames, labels)
    want = monotonic_rnnt_loss(logits, labels, tprime.to(torch.int32), slen)
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


def test_relative_positions_run_key_minus_query():
    """Column m of the scores by offset is offset m - (T - 1); rel_shift
    puts offset j - i at (query i, key j); and with only a positional
    score that grows with the offset, each query weighs later keys more."""
    t = 5
    by_offset = torch.arange(2 * t - 1, dtype=torch.float32).expand(
        1, t, 2 * t - 1).contiguous()
    got = rel_shift(by_offset)[0]
    i, j = torch.meshgrid(torch.arange(t), torch.arange(t), indexing="ij")
    assert torch.equal(got, (t - 1 + j - i).float())

    cfg = ZipformerConfig(query_head_dim=2, pos_head_dim=1, pos_dim=4,
                          dtype=torch.float32)
    attn = AttentionWeights(cfg, dim=3, heads=1)
    with torch.no_grad():
        attn.in_proj.weight.zero_()
        attn.in_proj.bias.copy_(torch.tensor([0.0, 0, 0, 0, 1]))  # p = 1
        attn.linear_pos.weight.copy_(torch.tensor([[0.0, 10.0, 0, 0]]))
    pe = compact_rel_positions(t, 4, "cpu")
    a = attn(torch.randn(1, t, 3), pe, torch.ones(1, t, dtype=torch.bool))
    offsets = (j - i).float()
    c = 2.0
    xc = c * offsets.sign() * (torch.log(offsets.abs() + c) - math.log(c))
    want = torch.softmax(10 * torch.sin(torch.atan(xc * 2 * math.pi / 4)),
                         dim=-1)
    torch.testing.assert_close(a[0, 0], want)
    assert (a[0, 0].diff(dim=-1) > 0).all()


def test_compact_positions_match_the_formula():
    t, dim = 7, 12
    pe = compact_rel_positions(t, dim, "cpu")
    want = ref.relative_encoding(torch.arange(-(t - 1), t), dim)
    torch.testing.assert_close(pe, want)
    assert torch.equal(pe[:, -1], torch.ones(2 * t - 1))
    assert torch.equal(pe[t - 1, 0:dim - 1:2], torch.ones(dim // 2))


def test_swoosh_and_bias_norm_values():
    x = torch.tensor([0.0, 4.0, 1.0, -30.0, 40.0])
    torch.testing.assert_close(swoosh_l(x), torch.tensor(
        [math.log1p(math.exp(-4)) - 0.035, math.log(2) - 0.355,
         math.log1p(math.exp(-3)) - 0.115, 2.4 - 0.035 + math.exp(-34),
         36 - 3.2 - 0.035]))
    torch.testing.assert_close(swoosh_r(x), torch.tensor(
        [0.0, math.log1p(math.exp(3)) - 0.32 - 0.313261687,
         math.log(2) - 0.08 - 0.313261687, 2.4 - 0.313261687,
         39 - 3.2 - 0.313261687]), atol=1e-6, rtol=1e-6)
    enc = ZipformerEncoder(_config().encoder, FEAT, device="cpu")
    norm = enc.embed.out_norm
    with torch.no_grad():
        norm.bias.zero_()
        norm.log_scale.fill_(math.log(2.0))
    y = torch.tensor([[1.0, 3.0] + [0.0] * 14])
    torch.testing.assert_close(norm(y, torch.float32),
                               2 * y / math.sqrt(10 / 16))
    with torch.no_grad():
        norm.bias.fill_(1.0)
    torch.testing.assert_close(norm(y, torch.float32),
                               2 * y / math.sqrt((0 + 4 + 14) / 16))


def test_downsample_repeats_each_utterance_last_frame():
    down = Downsample(4)
    with torch.no_grad():
        down.weight.zero_()
    x = torch.arange(7.0).view(1, 7, 1).repeat(2, 1, 1)
    got = down(x, torch.tensor([7, 5]))
    torch.testing.assert_close(got[:, :, 0], torch.tensor(
        [[1.5, (4 + 5 + 6 + 6) / 4], [1.5, 4.0]]))


@pytest.mark.parametrize("index,factor", [(0, 1), (1, 2), (2, 4), (3, 8)])
def test_each_rate_masks_and_resamples(index, factor):
    """At rate ds a stack runs ceil(T / ds) frames, of which ceil(len / ds)
    are valid; upsampled, frame t of the output is group t // ds."""
    cfg = _config().encoder
    stack = Stack(cfg, index)
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x, pe, valid):
            seen.append(valid)
            return x

    stack.layers = torch.nn.ModuleList([Probe()])
    if factor > 1:
        with torch.no_grad():
            stack.downsample.weight.zero_()
            stack.out_combiner.scale.fill_(1.0)
    lengths = torch.tensor([29, 17, 1])
    x = torch.arange(29.0).view(1, 29, 1).expand(3, 29, cfg.encoder_dims[
        index]).contiguous()
    out = stack(x, lengths)
    n = -(-29 // factor)
    assert seen[0].shape == (3, n)
    assert seen[0].sum(1).tolist() == [-(-int(n_) // factor)
                                       for n_ in lengths]
    assert out.shape == x.shape
    if factor == 1:
        assert torch.equal(out, x)
        return
    group = torch.arange(29) // factor
    want = torch.stack([
        torch.stack([torch.clamp(torch.arange(g * factor, (g + 1) * factor),
                                 max=int(l) - 1).float().mean()
                     for g in group]) for l in lengths])
    torch.testing.assert_close(out[..., 0], want)


def test_output_takes_each_channel_from_the_latest_stack():
    cfg = ZipformerConfig()
    outputs = [torch.full((1, 2, d), float(i))
               for i, d in enumerate(cfg.encoder_dims)]
    got = ZipformerEncoder._full_width(SimpleNamespace(cfg=cfg), outputs)[0, 0]
    assert got.shape == (768,)
    assert got[:256].eq(5).all() and got[256:512].eq(4).all()
    assert got[512:].eq(3).all()


def test_an_utterance_alone_equals_it_in_a_padded_batch():
    port, _ = _models(3)
    feats, frames, _, _ = _batch(4)
    padded = feats.clone()
    for b, n in enumerate(frames.tolist()):
        padded[b, n:] = 1e3 * torch.randn(150 - n, FEAT)
    enc, lengths = port.encode(padded, frames)
    for b, n in enumerate(frames.tolist()):
        alone, alone_len = port.encode(feats[b:b + 1, :n], frames[b:b + 1])
        assert int(alone_len) == int(lengths[b]) == -(-((n - 7) // 2) // 2)
        torch.testing.assert_close(enc[b:b + 1, :int(alone_len)], alone,
                                   rtol=0, atol=1e-5)


def test_a_step_reads_nothing_on_the_host():
    """Forward and backward on meta tensors, which refuse any read of their
    values (a host sync on the card), and the port's sync counter
    unmoved."""
    model = MonotonicTransducer(_config(), FEAT, device="cpu").to_empty(
        device="meta")
    feats, frames, labels, _ = (x.to("meta") for x in _batch(0))
    reset_counters()
    logits, _ = model.logits(feats, frames, labels)
    logits.sum().backward()
    assert counters()["syncs"] == {}
    assert all(p.grad is not None for p in model.parameters())


def test_greedy_and_beam_decoding_run():
    port, _ = _models(5)
    feats, frames, _, _ = _batch(6)
    hyp, n = port.greedy_decode(feats, frames, max_labels=8)
    assert hyp.shape == (4, 8) and bool((n <= 8).all())
    tokens, lengths, scores = port.beam_search_decode(feats, frames, 8, 3)
    assert tokens.shape == (4, 3, 8)
    one, one_len, _ = port.beam_search_decode(feats, frames, 8, 1)
    assert torch.equal(one[:, 0], hyp) and torch.equal(one_len[:, 0], n)
    with pytest.raises(ValueError, match="causal"):
        port.streaming_init(4, FEAT, 16, 8)


@pytest.mark.parametrize("context", [2, 3])
def test_stateless_decoder_steps_equal_its_forward(context):
    cfg = PredictorConfig(vocab_size=V, dim=16, embed_dim=16,
                          context=context, stateless=True,
                          dtype=torch.float32)
    model = ConvPredictor(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    assert model.conv.bias is None and model.out is None
    labels = torch.randint(1, V, (3, 5), generator=torch.Generator()
                           .manual_seed(1), dtype=torch.int32)
    state = model.init_state(3)
    steps = []
    for tok in torch.cat([torch.zeros(3, 1, dtype=torch.int32), labels],
                         dim=1).T:
        state, ctx = model.step(state, tok)
        steps.append(ctx)
    with torch.no_grad():
        torch.testing.assert_close(torch.stack(steps, dim=1), model(labels),
                                   rtol=1e-6, atol=1e-6)


def test_zipformer_l_size_and_initial_values():
    """Zipformer-L with the stateless decoder and the joint counts 147.79M
    parameters: the paper's 148.4M less icefall's simple-loss projections
    (768 x 500 + 500 and 512 x 500 + 500)."""
    enc = ZipformerConfig(dtype=torch.float32)
    pred = PredictorConfig(vocab_size=500, dim=512, embed_dim=512,
                           stateless=True, dtype=torch.float32)
    cfg = TransducerConfig(enc, pred, joint_dim=512, vocab_size=500,
                           predictor_kind="conv", dtype=torch.float32)
    with torch.device("meta"):
        encoder = ZipformerEncoder(enc, 80, device="meta")
    cfg = dataclasses.replace(cfg, encoder=_config().encoder)
    rest = MonotonicTransducer(cfg, FEAT, device="cpu")
    n = sum(p.numel() for p in encoder.parameters()) + sum(
        p.numel() for name, p in rest.named_parameters()
        if not name.startswith("encoder.") and name != "joint.enc_proj.weight")
    n += 768 * 512
    assert n == 147_789_230
    assert abs(n + 384_500 + 256_500 - 148.4e6) < 0.001 * 148.4e6
    small = ZipformerEncoder(_config().encoder, FEAT, device="cpu")
    layer = small.stacks[1].layers[0]
    assert layer.norm.log_scale.eq(1.0)
    assert layer.bypass.scale.eq(0.5).all()
    assert small.stacks[1].downsample.weight.eq(0).all()


def test_train_step_spans_the_zipformer_under_encode():
    """One train_step under the profiler: the embed, each stack once, each
    layer's shared softmax once and the three modules that read it, all
    inside mrnnt.encode."""
    from monotonic_rnnt_tpu_torch.models.train import (create_train_state,
                                                       train_step)
    batch = _batch(7)
    state = create_train_state(_config(), 0, batch, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        train_step(state, batch)
    events = [e for e in prof.events() if e.name.startswith("mrnnt.")]
    (encode,) = [e for e in events if e.name == "mrnnt.encode"]
    names = [e.name for e in events if e.name.startswith("mrnnt.zipformer.")]
    layers = sum(CFG["num_encoder_layers"])
    assert sorted(set(names)) == sorted(
        ["mrnnt.zipformer.embed", "mrnnt.zipformer.attn_weights",
         "mrnnt.zipformer.attend"]
        + [f"mrnnt.zipformer.stack{i}" for i in range(1, 7)])
    assert names.count("mrnnt.zipformer.attn_weights") == layers
    assert names.count("mrnnt.zipformer.attend") == 3 * layers
    assert all(encode.time_range.start <= e.time_range.start
               and e.time_range.end <= encode.time_range.end
               for e in events if e.name.startswith("mrnnt.zipformer."))


def test_the_reference_is_the_benchmarks_copy():
    """tests/zipformer_reference.py and h100_bench/reference/zipformer.py are one
    reference: below the first paragraph of their docstrings, which says
    whose copy each is, they are the same bytes."""
    def body(path):
        return path.read_bytes().split(b"\n\n", 1)[1]

    tests = Path(__file__).parent
    assert body(tests / "zipformer_reference.py") == body(
        tests.parent / "h100_bench" / "reference" / "zipformer.py")
