"""The Emformer training cell on the CPU, at a tiny size: its files load, a
run is correct, its faults are caught, its labels avoid the blank, its FLOP
counts hold, and its reader reads what it should."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from monotonic_rnnt_tpu_torch.models import MonotonicTransducer
from monotonic_rnnt_tpu_torch.utils.profiling import reset_counters

from h100_bench import emformer_work, faults, run, traffic
from h100_bench.entries import emformer_train
from h100_bench.reference import emformer

from conftest import tiny_mix

CELL = "emformer_rnnt_base.train.libri"
TINY = dict(feat_dim=20, time_reduction_input_dim=8, time_reduction_stride=4,
            transformer_num_layers=2, transformer_num_heads=2,
            transformer_ffn_dim=32, transformer_activation="gelu",
            segment_length=16, right_context_length=4,
            transformer_left_context_length=3, transformer_max_memory_size=0,
            encoding_dim=24, symbol_embedding_dim=16, num_lstm_layers=3,
            lstm_layer_norm=True, lstm_layer_norm_epsilon=1e-3,
            vocab_size=13, blank_id=12, subsample_factor=4, dtype="float32",
            tf32=False, learning_rate=1e-3, weight_decay=1e-6,
            warmup_steps=1000, dropout=0.0, lstm_dropout=0.0)


@pytest.fixture(autouse=True)
def _fresh_counters():
    """An Emformer forward leaves counters()["emformer"] set; tests that
    read the counters' changes later in the same process expect none."""
    yield
    reset_counters()


def _bench():
    return run.load_json(run.ROOT / "BENCHMARK.json")


def _mix():
    return dict(tiny_mix("train"), entry="emformer_train")


def _run():
    limits = run.load_json(run.HERE / "limits" / f"{CELL}.json")
    metrics = [{"name": "setup_s", "unit": "s"}]
    return run.execute(CELL, dict(TINY), _mix(), limits, metrics,
                       2 ** 31 + 9, 0.2, False, device="cpu", start=0.0)


def test_the_cell_finds_its_files_and_metrics():
    bench = _bench()
    spec = run.by_name(bench["workloads"], CELL)
    cfg = run.load_json(run.HERE / "configs" / f"{spec['config']}.json")
    mix = run.load_json(run.HERE / "traffic" / f"{spec['traffic']}.json")
    assert cfg["name"] == spec["config"] and mix["entry"] == "emformer_train"
    limits = run.load_json(run.HERE / "limits" / f"{CELL}.json")
    assert limits and all(v > 0 for v in limits.values())
    per_layer = {m["name"] for m in run.cell_metrics(bench, CELL,
                                                     "per_layer")}
    assert {"attn_kept.emformer", "mfu.train",
            "device_idle.train", "host_syncs.train",
            "device_ops.train"} <= per_layer
    for section in ("end_to_end", "per_layer"):
        for m in run.cell_metrics(bench, CELL, section):
            run.reader(m["name"])
    base = run.load_json(run.HERE / "traffic" / "train.libri.json")
    own = ("entry", "assumed")
    assert {k: v for k, v in mix.items() if k not in own} \
        == {k: v for k, v in base.items() if k not in own}
    cycle = traffic.make_cycle(mix, 2882400018, cfg["subsample_factor"],
                               cfg["vocab_size"])
    assert sorted({b.size for b in cycle.batches}) == [26, 30, 36, 72]


def test_the_config_is_torchaudios_base_model():
    cfg = run.load_json(run.HERE / "configs" / "emformer_rnnt_base.json")
    assert (cfg["time_reduction_input_dim"], cfg["time_reduction_stride"],
            cfg["transformer_num_layers"], cfg["transformer_num_heads"],
            cfg["transformer_ffn_dim"], cfg["segment_length"],
            cfg["right_context_length"],
            cfg["transformer_left_context_length"],
            cfg["transformer_max_memory_size"], cfg["encoding_dim"],
            cfg["symbol_embedding_dim"], cfg["num_lstm_layers"],
            cfg["lstm_layer_norm_epsilon"], cfg["vocab_size"],
            cfg["blank_id"]) == (128, 4, 20, 8, 2048, 16, 4, 30, 0, 1024,
                                 512, 3, 1e-3, 4097, 4096)
    model = emformer.build(cfg)
    assert sum(p.numel() for p in model.parameters()) == cfg["parameters"]
    parts = {k: sum(p.numel() for p in getattr(model, k).parameters())
             for k in ("encoder", "predictor", "joint")}
    assert parts == cfg["parameters_by_part"]
    spec = run.by_name(_bench()["configs"], "emformer_rnnt_base")
    assert spec["reduced"] == ["dropout", "lstm_dropout"]
    assert all(cfg[k] == 0.0 for k in spec["reduced"])


def test_an_unbroken_run_is_correct():
    line = _run()
    assert line["correct"], line["compared"]
    assert sorted(line["compared"]) == sorted(run.load_json(
        run.HERE / "limits" / f"{CELL}.json"))
    assert not set(emformer_train.NOT_COMPARED) & set(line["compared"])


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_fault_is_caught(fault):
    with faults.FAULTS[fault](emformer_train):
        line = _run()
    assert not line["correct"], line["compared"]


def test_labels_never_take_the_blank():
    drv = emformer_train.Entry(dict(TINY), _mix(), 2 ** 31 + 5, "cpu")
    for (_, _, labels, slen), b in zip(drv.batches, drv.cycle.batches):
        inside = torch.arange(labels.shape[1])[None, :] < slen[:, None].long()
        assert int(labels[inside].max()) < TINY["blank_id"]
        assert int(labels.min()) >= 0
        assert torch.equal(labels[inside].long() + 1, torch.from_numpy(
            b.labels[:, :labels.shape[1]])[inside].long())
    got = emformer_train.remap(np.array([[1, 12, 0], [5, 0, 0]]),
                               np.array([2, 1]))
    assert got.tolist() == [[0, 11, 0], [4, 0, 0]]


def test_a_traced_step_reports_its_loss_and_attention():
    drv = emformer_train.Entry(dict(TINY), _mix(), 4, "cpu")
    work = drv.traced_step(0)
    assert work["trace_steps"] == 1 and work["model_flops"] > 0
    feats, frames, _, _ = drv.batches[0]
    t = feats.shape[1] // 4
    heads = TINY["transformer_num_layers"] * TINY["transformer_num_heads"]
    n = -(-t // 4)
    assert work["attn_cells"] == heads * feats.shape[0] * (n + t) ** 2
    assert work["attn_kept"] == heads * feats.shape[0] * int(
        emformer.block_mask(t, TINY).sum())


def test_the_attention_reader_reads_the_kept_share():
    kept = run.reader("attn_kept.emformer")
    assert kept({"trace": dict(attn_cells=400, attn_kept=30)}) == 7.5
    assert kept({"trace": dict(attn_cells=0, attn_kept=0)}) is None
    assert kept({"trace": dict(model_flops=1.0)}) is None
    assert kept({}) is None


@pytest.mark.parametrize("frames,labels", [(60, 3), (148, 6)])
def test_flops_match_a_flop_counter_and_the_kept_cells(frames, labels):
    """Everything but the attention's two products against torch's FLOP
    counter on the reference (frames a multiple of 4, so that the input
    linear's rows are the ones the reduction keeps); the products, which
    the reference computes densely, against the kept cells of its mask."""
    model = emformer.build(TINY).to_empty(device="cpu")
    weights = emformer_work.make_weights(TINY, 1, "cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    feats = torch.randn(1, frames, TINY["feat_dim"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        _, tprime = model(feats, torch.tensor([frames]),
                          torch.randint(0, 12, (1, labels)))
    t = int(tprime)
    assert t == emformer_work.tprime(TINY, frames)
    rows = -(-t // 4) + t
    d, layers = 32, TINY["transformer_num_layers"]
    dense = layers * 4 * d * rows ** 2
    assert counter.get_total_flops() == emformer_work.matmul_flops(
        TINY, frames, labels) + dense
    kept = int(emformer.block_mask(t, TINY).sum())
    assert emformer_work.attention_flops(TINY, frames) == layers * 4 * d * kept
    assert emformer_work.utterance_forward_flops(TINY, frames, labels) < \
        counter.get_total_flops()


def test_seeded_weights_scale_the_attention_by_depth():
    cfg = dict(TINY, transformer_num_layers=4, time_reduction_input_dim=64)
    w = emformer_work.make_weights(cfg, 7, "cpu")
    for i in range(4):
        q = w[f"encoder.layers.{i}.query.weight"]
        assert 0.8 < float(q.std()) * (256 * (i + 1)) ** 0.5 < 1.2
    norm = w["encoder.layers.0.norm_in.weight"]
    assert 0.9 < float(norm.mean()) < 1.1
    assert w["predictor.embed.weight"].std() > 0.8


def test_the_reference_matches_the_port():
    weights = emformer_work.make_weights(TINY, 5, "cpu")
    port = MonotonicTransducer(emformer_train.transducer_config(TINY),
                               TINY["feat_dim"], device="cpu")
    ref = emformer.build(TINY).to_empty(device="cpu")
    with torch.no_grad():
        for model in (port, ref):
            for name, p in model.named_parameters():
                p.copy_(weights[name])
    g = torch.Generator().manual_seed(3)
    feats = torch.randn(2, 90, TINY["feat_dim"], generator=g)
    frames = torch.tensor([90, 61])
    labels = torch.randint(0, 12, (2, 3), generator=g)
    got, got_len = port.logits(feats, frames, labels)
    want, want_len = ref(feats, frames, labels)
    assert torch.equal(got_len, want_len)
    valid = torch.arange(got.shape[1])[None, :] < want_len[:, None]
    torch.testing.assert_close(got[valid], want[valid], rtol=1e-5, atol=1e-5)
