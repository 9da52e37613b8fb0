"""The port's spans and counters (utils/profiling.py): what a profiler sees
of a training step and of the loss, what they cost with no profiler, and
that no traced graph holds them."""

import contextlib
import types

import pytest
import torch

import monotonic_rnnt_tpu_torch as mt
from monotonic_rnnt_tpu_torch import serving
from monotonic_rnnt_tpu_torch.models import conformer as tc
from monotonic_rnnt_tpu_torch.models import predictor as tp
from monotonic_rnnt_tpu_torch.models import train as ttrain
from monotonic_rnnt_tpu_torch.models import transducer as tt
from monotonic_rnnt_tpu_torch.ops import loss as tloss
from monotonic_rnnt_tpu_torch.ops.cuda import kernels as tk
from monotonic_rnnt_tpu_torch.utils import profiling as tprof

B, T, S, V, F = 2, 32, 4, 32, 16      # 4x subsampling: T' = 8 >= S


def _tiny_state():
    cfg = tt.TransducerConfig(
        encoder=tc.ConformerConfig(num_layers=1, dim=32, num_heads=2,
                                   dropout=0.0),
        predictor=tp.PredictorConfig(vocab_size=V, dim=32, embed_dim=16),
        joint_dim=32, vocab_size=V)
    gen = torch.Generator().manual_seed(0)
    batch = (torch.randn(B, T, F, generator=gen),
             torch.tensor([T, T - 5], dtype=torch.int32),
             torch.randint(1, V, (B, S), generator=gen, dtype=torch.int32),
             torch.tensor([S, S - 1], dtype=torch.int32))
    state = ttrain.create_train_state(cfg, 0, batch, learning_rate=1e-3,
                                      warmup_steps=1, device="cpu")
    return state, batch


def _loss_case(seed=0):
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn(B, 6, S + 1, 5, generator=gen)
    labels = torch.randint(1, 5, (B, S), generator=gen, dtype=torch.int32)
    return (logits, labels, torch.tensor([6, 5], dtype=torch.int32),
            torch.tensor([S, 2], dtype=torch.int32))


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith("mrnnt.")]


def _inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def _only(events, name):
    found = [e for e in events if e.name == name]
    assert len(found) == 1, (name, [e.name for e in events])
    return found[0]


def _descendants(event):
    for child in event.cpu_children:
        yield child
        yield from _descendants(child)


def test_span_is_a_shared_null_context_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler on")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first, second = tprof.span("mrnnt.a"), tprof.span("mrnnt.b")
    assert first is second
    with first:
        pass
    tloss.monotonic_rnnt_loss(*_loss_case())


def test_train_step_spans_nest_by_layer():
    state, batch = _tiny_state()
    events = _profiled(lambda: ttrain.train_step(state, batch))
    step = _only(events, "mrnnt.train_step")
    under = {e.name for e in _descendants(step)}
    assert {"mrnnt.encode", "mrnnt.predict", "mrnnt.joint", "mrnnt.loss",
            "mrnnt.validate", "mrnnt.bands", "mrnnt.loss.forward",
            "mrnnt.backward", "mrnnt.update"} <= under
    loss = _only(events, "mrnnt.loss")
    assert {"mrnnt.validate", "mrnnt.bands", "mrnnt.loss.forward"} <= {
        e.name for e in _descendants(loss)}
    # The backward runs on autograd's thread (on the CPU, the caller's):
    # inside mrnnt.backward in time, whichever thread ran it.
    backward = _only(events, "mrnnt.loss.backward")
    assert _inside(backward, _only(events, "mrnnt.backward"))
    assert _inside(_only(events, "mrnnt.update"), step)
    # The loss's lengths lie on the CPU here: no host sync to span.
    assert not any(e.name.startswith("mrnnt.sync.") for e in events)


def test_banded_loss_spans_its_entry_and_core():
    logits, labels, ilen, slen = _loss_case(seed=1)
    bands = mt.default_bands(ilen, slen, logits.shape[1])
    x = logits.clone().requires_grad_(True)

    def run():
        mt.monotonic_rnnt_loss_banded(x, labels, ilen, slen,
                                      bands=bands).sum().backward()
    events = _profiled(run)
    loss = _only(events, "mrnnt.loss")
    assert {"mrnnt.validate", "mrnnt.loss.forward"} <= {
        e.name for e in _descendants(loss)}
    _only(events, "mrnnt.loss.backward")


def _profiler_ops(graph) -> list:
    return [str(n.target) for n in graph.nodes
            if n.op == "call_function" and "profiler" in str(n.target)]


def test_no_span_in_an_exported_or_compiled_graph(monkeypatch):
    """Under a profiler, torch.export and a fullgraph torch.compile of the
    loss's kernel route (its plain versions on the CPU) trace no span: the
    graphs hold no profiler operator, and the compiled call still equals
    the eager one."""
    monkeypatch.setattr(tloss, "_resolve_backend", lambda b, x: "cuda")
    case = _loss_case(seed=2)
    graphs = []

    def keep(gm, example_inputs):
        graphs.append(gm.graph)
        return gm.forward

    def probe(x):
        """x + 1 where span gives its null context, x + 2 where a range."""
        null = isinstance(tprof.span("mrnnt.probe"), contextlib.nullcontext)
        return x + (1.0 if null else 2.0)

    one = torch.zeros(1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        program = torch.export.export(
            serving._Fn(lambda *a: mt.monotonic_rnnt_loss(*a)), case,
            strict=False)
        compiled = torch.compile(mt.monotonic_rnnt_loss, fullgraph=True,
                                 backend=keep)
        got = compiled(*case)
        eager = probe(one)
        exported = torch.export.export(serving._Fn(probe), (one,),
                                       strict=False).module()(one)
        compiled_probe = torch.compile(probe, fullgraph=True,
                                       backend="eager")(one)
    torch._dynamo.reset()
    assert graphs and _profiler_ops(program.graph) == []
    assert all(_profiler_ops(g) == [] for g in graphs)
    assert torch.equal(got, mt.monotonic_rnnt_loss(*case))
    assert eager.item() == 2.0
    assert exported.item() == 1.0 and compiled_probe.item() == 1.0


def test_an_emformer_step_spans_its_layers_and_counts_its_attention():
    """One Emformer train step: the embed, the right-context copies and
    each layer with its masked attention open their spans inside
    mrnnt.encode; counters()["emformer"] holds the score cells of the
    [B, 1, nR + T, nR + T] mask over heads and layers, the cells its block
    mask keeps (before key padding) and the right-context rows."""
    from monotonic_rnnt_tpu_torch.models import emformer as te
    enc = te.EmformerConfig(num_layers=2, reduction_dim=4, num_heads=2,
                            ffn_dim=16, left_context=3, output_dim=16,
                            dtype=torch.float32)
    pred = tp.PredictorConfig(vocab_size=V, dim=8, embed_dim=8,
                              dtype=torch.float32, bos_id=V - 1,
                              num_layers=2, layer_norm=True, out_dim=16)
    cfg = tt.TransducerConfig(enc, pred, joint_dim=16, vocab_size=V,
                              blank_id=V - 1, dtype=torch.float32,
                              joint_activation="relu")
    gen = torch.Generator().manual_seed(1)
    batch = (torch.randn(B, 70, F, generator=gen),
             torch.tensor([70, 41], dtype=torch.int32),
             torch.randint(0, V - 1, (B, S), generator=gen, dtype=torch.int32),
             torch.tensor([S, S - 1], dtype=torch.int32))
    state = ttrain.create_train_state(cfg, 0, batch, device="cpu")
    tprof.reset_counters()
    events = _profiled(lambda: ttrain.train_step(state, batch))
    encode = _only(events, "mrnnt.encode")
    names = [e.name for e in events if e.name.startswith("mrnnt.emformer.")]
    assert sorted(set(names)) == [
        "mrnnt.emformer.attend", "mrnnt.emformer.embed",
        "mrnnt.emformer.layer0", "mrnnt.emformer.layer1",
        "mrnnt.emformer.rc_blocks"]
    assert names.count("mrnnt.emformer.attend") == 2
    assert all(_inside(e, encode) for e in events
               if e.name.startswith("mrnnt.emformer."))
    t = 70 // 4
    dropped = te.dropped_scores(t, torch.tensor([t, 41 // 4]), enc)
    layers_heads = enc.num_layers * enc.num_heads
    assert tprof.counters()["emformer"] == {
        "attn_cells": layers_heads * dropped.numel(),
        "attn_kept": layers_heads * B * int(te.attention_mask(t, enc).sum()),
        "rc_rows": B * -(-t // 4)}
    tprof.reset_counters()
    assert "emformer" not in tprof.counters()


def test_counters_copy_and_reset():
    """The launch counters are the kernel wrappers' LAUNCHES, by row."""
    assert tk.LAUNCHES is tprof.LAUNCHES
    tprof.reset_counters()
    assert tprof.counters() == {"launches": {}, "syncs": {}}
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0),
                                    cpu=lambda: torch.ones(2))
    for _ in range(3):
        assert torch.equal(tprof.to_host(on_card, "unit.site"),
                           torch.ones(2))
    host = torch.arange(3)
    assert tprof.to_host(host, "unit.host") is host     # no copy, no sync
    tk.LAUNCHES["grad_pass"] += 2
    tprof.ROWS["stats_alpha_fused.read"] += 7
    tprof.AHEAD["validate"] += 1
    seen = tprof.counters()
    assert seen == {"launches": {"grad_pass": 2}, "syncs": {"unit.site": 3},
                    "rows": {"stats_alpha_fused.read": 7},
                    "ahead": {"validate": 1}}
    seen["syncs"]["unit.site"] = 99                      # a copy
    seen["rows"]["stats_alpha_fused.read"] = 99
    assert tprof.counters()["syncs"]["unit.site"] == 3
    assert tprof.counters()["rows"]["stats_alpha_fused.read"] == 7
    tprof.reset_counters()
    assert tprof.counters() == {"launches": {}, "syncs": {}}
    assert tk.LAUNCHES["grad_pass"] == 0                 # the rows stay
    assert tprof.ROWS["stats_alpha_fused.padded"] == 0
    assert tprof.AHEAD == {"validate": 0}


@pytest.mark.parametrize("route, traced, counted", [
    ("cuda", False, True), ("reference", False, False),
    ("cuda", True, False)], ids=["deferred", "reference", "traced"])
def test_rows_counter_counts_row_1s_live_lattice(monkeypatch, route, traced,
                                                 counted):
    """A padded loss call on the route that runs row 1 adds the lattice rows
    row 1 reads, sum_b T'_b (S_b + 1), and those of the padded lattice,
    B T S1, to counters()["rows"], from validation's host copy of the
    lengths: no sync of its own. No other route counts, nor a call whose
    validation made no host copy (a traced graph's). The 'cuda' route on
    CPU tensors runs the operators' CPU implementations."""
    from monotonic_rnnt_tpu_torch.utils import status

    x, labels, il, sl = _loss_case()          # [2, 6, 5, 5]: T' 6, 5; S 4, 2
    monkeypatch.setattr(tloss, "_resolve_backend", lambda b, x: route)
    monkeypatch.setattr(status, "tracing", lambda: traced)
    tprof.reset_counters()
    xg = x.clone().requires_grad_(True)
    mt.monotonic_rnnt_loss(xg, labels, il, sl).sum().backward()
    with torch.no_grad():
        mt.monotonic_rnnt_loss(x, labels, il, sl)
    seen = tprof.counters()
    assert seen.get("rows") == ({"stats_alpha_fused.read": 2 * (6 * 5 + 5 * 3),
                                 "stats_alpha_fused.padded": 2 * 2 * 6 * 5}
                                if counted else None)
    assert seen["syncs"] == {}
    assert seen["launches"] == {}             # the CPU implementations


def test_sync_span_names_its_site():
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0),
                                    cpu=lambda: torch.ones(1))
    events = _profiled(lambda: tprof.to_host(on_card, "unit.site"))
    assert [e.name for e in events] == ["mrnnt.sync.unit.site"]


@pytest.mark.parametrize("err", [0, 7])
def test_call_spans_each_launch(monkeypatch, err):
    """kernels._call, the one launch site of rows 1-14, with a stubbed
    launcher: each launch inside its span, a failed one raised."""
    launched = []

    def entry_point(*args):
        launched.append(args)
        return err

    lib = types.SimpleNamespace(mrnnt_error_string=lambda e: b"stub")
    monkeypatch.setattr(tk, "_bound", lambda entry: (entry_point, lib))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1234, raising=False)

    def call():
        tk._call("mrnnt_stats_alpha", torch.device("cuda", 0), 1, 2)

    if err:
        with pytest.raises(RuntimeError, match="CUDA error 7"):
            call()
        return
    events = _profiled(call)
    assert launched == [(1, 2, 1234)]
    assert [e.name for e in events] == ["mrnnt.launch.mrnnt_stats_alpha"]


@pytest.mark.parametrize("op, entry", [
    ("loss_prologue", "mrnnt_loss_prologue"),
    ("loss_costs", "mrnnt_loss_costs"),
    ("beta_operands", "mrnnt_beta_operands")])
def test_glue_operators_launch_once_in_their_spans(monkeypatch, op, entry):
    """Each glue operator's CUDA implementation, with a stubbed launcher
    (CPU tensors pass its checks): one launch of its C entry point with
    the arguments its argtypes declare, inside mrnnt.launch.<entry>, and
    one count in LAUNCHES[op]."""
    x, labels, il, sl = _loss_case()
    t_max, s1 = x.shape[1], x.shape[2]
    bands = mt.default_bands(il, sl, t_max)
    lab, a_lo, a_hi, b_lo, b_hi = tk.loss_prologue_plain(
        labels, il, sl, *bands, t_max, s1)
    _, lpb, lpl, alphas = tk.stats_alpha_fused_plain(x, lab, a_lo, a_hi, il,
                                                     sl, 0)
    ll, _ = tk.loss_costs_plain(alphas, il, sl)
    args = {"loss_prologue": (labels, il, sl, *bands, t_max, s1),
            "loss_costs": (alphas, il, sl),
            "beta_operands": (lpb, lpl, alphas, ll, il, sl, b_lo, b_hi)}[op]
    launched = []

    def entry_point(*a):
        launched.append(a)
        return 0

    monkeypatch.setattr(tk, "_bound", lambda e: (entry_point, None))
    monkeypatch.setattr(tk, "_check_cuda", lambda t: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1234, raising=False)
    monkeypatch.setitem(tk.LAUNCHES, op, tk.LAUNCHES[op])
    before = tk.LAUNCHES[op]
    events = _profiled(lambda: getattr(tk, op + "_cuda")(*args))
    assert len(launched) == 1
    assert len(launched[0]) == len(tk._ENTRIES[entry][1])
    assert launched[0][-1] == 1234                       # the stream, last
    assert tk.LAUNCHES[op] == before + 1
    assert [e.name for e in events] == ["mrnnt.launch." + entry]
