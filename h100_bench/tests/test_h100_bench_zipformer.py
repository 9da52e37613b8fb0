"""The Zipformer training cell and the long-form banded cell on the CPU, at a
tiny size: each cell's files load, a run is correct, its faults are caught,
and the Zipformer's FLOP counts and seeded weights hold."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from monotonic_rnnt_tpu_torch.models import MonotonicTransducer

from h100_bench import faults, run, zipformer_work
from h100_bench.entries import banded as banded_entry
from h100_bench.entries import zipformer_train
from h100_bench.reference import zipformer

from conftest import tiny_mix

CELLS = ("conformer_m.banded.longform", "zipformer_l.train.libri")
# A cell whose files are in place but which BENCHMARK.json does not list
# until its traffic cites a source.
WAITING = {"conformer_m.banded.longform": {"config": "conformer_m",
                                           "traffic": "banded.longform"}}
TINY = dict(num_encoder_layers=[1] * 6, downsampling_factor=[1, 2, 4, 8, 4, 2],
            encoder_dim=[16, 24, 32, 40, 32, 24], feedforward_dim=[32] * 6,
            num_heads=[2, 2, 2, 3, 2, 2], query_head_dim=8, pos_head_dim=4,
            value_head_dim=6, pos_dim=12,
            cnn_module_kernel=[3, 3, 5, 5, 3, 3],
            output_downsampling_factor=2, embed_channels=[2, 4, 8],
            convnext_hidden_ratio=3, decoder_dim=16, joiner_dim=8,
            context_size=2, vocab_size=11, blank_id=0, feat_dim=20,
            subsample_factor=4,
            dtype="float32", tf32=False, learning_rate=1e-3,
            weight_decay=1e-6, warmup_steps=1000)


def _bench():
    return run.load_json(run.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_finds_its_files(cell):
    bench = _bench()
    listed = [w["name"] for w in bench["workloads"]]
    spec = (run.by_name(bench["workloads"], cell) if cell in listed
            else WAITING[cell])
    cfg = run.load_json(run.HERE / "configs" / f"{spec['config']}.json")
    mix = run.load_json(run.HERE / "traffic" / f"{spec['traffic']}.json")
    limits = run.load_json(run.HERE / "limits" / f"{cell}.json")
    assert (run.HERE / "entries" / f"{mix['entry']}.py").exists()
    assert limits and all(v > 0 for v in limits.values())
    for section in ("end_to_end", "per_layer"):
        for m in run.cell_metrics(bench, cell, section):
            run.reader(m["name"])
    assert cfg["name"] == spec["config"]


def test_zipformer_l_config_is_the_recipes():
    cfg = run.load_json(run.HERE / "configs" / "zipformer_l.json")
    assert cfg["encoder_dim"] == [192, 256, 512, 768, 512, 256]
    assert cfg["num_encoder_layers"] == [2, 2, 4, 5, 4, 2]
    model = zipformer.build(cfg)
    assert sum(p.numel() for p in model.parameters()) == cfg["parameters"]
    spec = run.by_name(_bench()["configs"], "zipformer_l")
    assert all(cfg[k] == 0.0 for k in spec["reduced"])


def _run(cell, cfg, mix):
    limits = run.load_json(run.HERE / "limits" / f"{cell}.json")
    metrics = [{"name": "setup_s", "unit": "s"}]
    return run.execute(cell, cfg, mix, limits, metrics, 2 ** 31 + 9, 0.2,
                       False, device="cpu", start=0.0)


def _zipformer_mix():
    return dict(tiny_mix("train"), entry="zipformer_train")


def test_an_unbroken_zipformer_run_is_correct():
    line = _run("zipformer_l.train.libri", dict(TINY), _zipformer_mix())
    assert line["correct"], line["compared"]
    assert sorted(line["compared"]) == sorted(run.load_json(
        run.HERE / "limits" / "zipformer_l.train.libri.json"))


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_zipformer_fault_is_caught(fault):
    with faults.FAULTS[fault](zipformer_train):
        line = _run("zipformer_l.train.libri", dict(TINY), _zipformer_mix())
    assert not line["correct"], line["compared"]


def test_the_longform_cell_runs_and_catches_a_fault(tiny_model):
    line = _run("conformer_m.banded.longform", tiny_model,
                tiny_mix("banded"))
    assert line["correct"], line["compared"]
    with faults.FAULTS["altered_answer"](banded_entry):
        line = _run("conformer_m.banded.longform", tiny_model,
                    tiny_mix("banded"))
    assert not line["correct"], line["compared"]


def test_the_bf16_control_fails_the_longform_limits(tiny_model):
    drv = banded_entry.Entry(tiny_model, tiny_mix("banded"), 2 ** 31 + 3,
                             "cpu")
    limits = run.load_json(run.HERE / "limits"
                           / "conformer_m.banded.longform.json")
    numbers = drv.control()
    assert any(numbers[n] > limits[n] for n in numbers)


def test_a_traced_step_counts_one_step():
    drv = zipformer_train.Entry(dict(TINY), _zipformer_mix(), 4, "cpu")
    work = drv.traced_step(0)
    assert work["trace_steps"] == 1 and work["model_flops"] > 0
    read = run.reader("device_ops.train")
    trace = dict(device_op_count=120, trace_steps=4, model_flops=1.0)
    assert read({"trace": trace}) == 30
    assert read({"trace": dict(trace, trace_steps=0)}) is None
    assert read({}) is None


@pytest.mark.parametrize("frames,labels", [(61, 3), (150, 6)])
def test_zipformer_flops_match_a_flop_counter(frames, labels):
    model = zipformer.build(TINY).to_empty(device="cpu")
    weights = zipformer_work.make_weights(TINY, 1, "cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    feats = torch.randn(1, frames, TINY["feat_dim"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        _, tprime = model(feats, torch.tensor([frames]),
                          torch.randint(1, TINY["vocab_size"], (1, labels)))
    assert int(tprime) == zipformer_work.tprime(TINY, frames)
    assert counter.get_total_flops() == zipformer_work.utterance_forward_flops(
        TINY, frames, labels)


def test_seeded_weights_take_icefalls_initial_values():
    w = zipformer_work.make_weights(TINY, 7, "cpu")
    assert float(w["encoder.stacks.0.layers.0.norm.log_scale"]) == 1.0
    assert w["encoder.stacks.1.out_combiner.scale"].eq(0.5).all()
    assert w["encoder.downsample_output.weight"].eq(0).all()
    out = w["encoder.stacks.0.layers.0.ff1.out_proj.weight"]
    assert 0.05 < float(out.std()) * out.shape[1] ** 0.5 / 0.1 < 2


def test_the_reference_matches_the_port():
    weights = zipformer_work.make_weights(TINY, 5, "cpu")
    port = MonotonicTransducer(zipformer_train.transducer_config(TINY),
                               TINY["feat_dim"], device="cpu")
    ref = zipformer.build(TINY).to_empty(device="cpu")
    with torch.no_grad():
        for model in (port, ref):
            for name, p in model.named_parameters():
                p.copy_(weights[name])
    g = torch.Generator().manual_seed(3)
    feats = torch.randn(2, 90, TINY["feat_dim"], generator=g)
    frames = torch.tensor([90, 61])
    labels = torch.randint(1, TINY["vocab_size"], (2, 3), generator=g)
    got, got_len = port.logits(feats, frames, labels)
    want, want_len = ref(feats, frames, labels)
    assert torch.equal(got_len, want_len)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
