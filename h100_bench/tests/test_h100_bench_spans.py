"""spans.py: the span table of a hand-built profile, the idle-gap names
seen past the spans on a real CPU profile, and the readers of the
program's counters."""

import types

import pytest
import torch

from h100_bench import run, spans, trace
from h100_bench.spans import Launch, Span
from monotonic_rnnt_tpu_torch.utils import profiling

MAIN, AUTOGRAD = 1, 2


def _step_profile():
    """One train step in microseconds: the backward's loss span and one
    launch on autograd's thread, a launch there under no span of its own,
    and a device operation the profile does not link to a host call."""
    spans_ = [Span("mrnnt.train_step", MAIN, 0, 100),
              Span("mrnnt.encode", MAIN, 10, 40),
              Span("mrnnt.backward", MAIN, 50, 90),
              Span("mrnnt.update", MAIN, 90, 100),
              Span("mrnnt.loss.backward", AUTOGRAD, 60, 70),
              Span("mrnnt.launch.k", AUTOGRAD, 62, 65)]
    launches = [Launch(MAIN, 15, 20, 30),          # under encode
                Launch(AUTOGRAD, 63, 64, 80),      # under launch.k
                Launch(AUTOGRAD, 75, 85, 88),      # no span there: backward
                Launch(MAIN, 95, 96, 99),          # under update
                Launch(None, None, 100, 101)]      # not linked
    return spans_, launches


def test_span_table_of_a_hand_built_step():
    table = spans.span_table(*_step_profile(), steps=1)
    want = {  # calls, host, self, device, idle (microseconds)
        "mrnnt.train_step": (1, 100, 20, 32, 34),
        "mrnnt.encode": (1, 30, 30, 10, 0),
        "mrnnt.backward": (1, 40, 30, 19, 5),
        "mrnnt.update": (1, 10, 10, 3, 9),
        "mrnnt.loss.backward": (1, 10, 7, 16, 0),
        "mrnnt.launch.k": (1, 3, 3, 16, 0),
        spans.OUTSIDE: (0, 0, 0, 1, 0)}
    assert set(table) == set(want)
    for name, (calls, host, self_, device, idle) in want.items():
        row = table[name]
        assert row["calls"] == calls, name
        for key, us in (("host_ms", host), ("self_ms", self_),
                        ("device_ms", device), ("idle_ms", idle)):
            assert row[key] == pytest.approx(us * 1e-3), (name, key)
    # Every idle microsecond is put down once: the 48 us between the
    # device operations.
    assert sum(r["idle_ms"] for r in table.values()) == pytest.approx(0.048)
    halved = spans.span_table(*_step_profile(), steps=2)
    assert halved["mrnnt.backward"]["idle_ms"] == pytest.approx(0.0025)


def test_glue_idle_counts_the_loss_spans_and_their_syncs():
    spans_ = [Span("mrnnt.loss", MAIN, 0, 50),
              Span("mrnnt.validate", MAIN, 0, 10),
              Span("mrnnt.sync.validate.input_lengths", MAIN, 2, 8),
              Span("mrnnt.update", MAIN, 50, 70)]
    launches = [Launch(MAIN, 0.5, 0.5, 1),
                Launch(MAIN, 5, 9, 10),        # ends a gap under the sync
                Launch(MAIN, 20, 30, 40),      # ends a gap under mrnnt.loss
                Launch(MAIN, 60, 62, 63),      # ends a gap under update
                Launch(MAIN, 90, 90, 91)]      # ends a gap outside
    table = spans.span_table(spans_, launches, steps=1)
    assert table["mrnnt.sync.validate.input_lengths"]["idle_ms"] == \
        pytest.approx(0.008)
    assert table["mrnnt.loss"]["idle_ms"] == pytest.approx(0.020)
    assert table["mrnnt.update"]["idle_ms"] == pytest.approx(0.022)
    assert table[spans.OUTSIDE]["idle_ms"] == pytest.approx(0.027)
    assert spans.glue_idle_ms(table) == pytest.approx(0.028)


def _event(name, id_, start, end, device_type, thread=MAIN, linked=0,
           annotation=False):
    return types.SimpleNamespace(
        name=name, id=id_, thread=thread, device_type=device_type,
        linked_correlation_id=linked, is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_from_events_links_each_device_operation_to_its_launch():
    cpu, cuda = "cpu", "cuda"
    events = [
        _event("mrnnt.loss", 1, 0, 50, cpu, annotation=True),
        _event("mrnnt.loss", 90, 5, 45, cuda, annotation=True),  # its GPU side
        _event("aten::mul", 2, 5, 9, cpu),
        _event("cudaLaunchKernel", 700, 6, 7, cpu, linked=2),
        _event("mul_kernel", 700, 10, 12, cuda, linked=2),
        _event("ctypes_kernel", 701, 13, 15, cuda, linked=3),   # no runtime
        _event("aten::empty", 3, 11, 12, cpu, thread=AUTOGRAD),
        _event("lost_kernel", 702, 16, 17, cuda)]
    spans_, launches, ops = spans.from_events(events, cuda)
    assert spans_ == [Span("mrnnt.loss", MAIN, 0, 50)]
    assert launches == [Launch(MAIN, 6, 10, 12), Launch(AUTOGRAD, 11, 13, 15),
                        Launch(None, None, 16, 17)]
    assert [e.name for e in ops] == ["aten::mul", "cudaLaunchKernel",
                                     "aten::empty"]


def _cpu_work(with_spans: bool):
    """(spans, host operations) of the same CPU work, with or without
    enclosing spans."""
    span = profiling.span if with_spans else (lambda name: profiling._NULL)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("mrnnt.outer"):
            x = torch.ones(20_000)
            with span("mrnnt.inner"):
                y = (x * 2).sum()
            z = torch.cat([x, x]) + y
        z.mean()
    spans_, launches, ops = spans.from_events(
        prof.events(), torch.autograd.DeviceType.CUDA)
    assert launches == []
    return spans_, ops


def _gaps_at(roots):
    """Device intervals that leave a 0.02 us gap at the middle of each
    root operation; the middles."""
    mids = sorted(0.5 * (e.time_range.start + e.time_range.end)
                  for e in roots)
    eps = 0.01
    points = ([mids[0] - 1.0] + [p for m in mids for p in (m - eps, m + eps)]
              + [mids[-1] + 1.0])
    return mids, list(zip(points[0::2], points[1::2]))


def test_gap_names_see_past_the_spans():
    """Gaps of the same CPU work are named by the same (outermost) host
    operations with spans as trace.py names them without; with spans, the
    innermost span open is their prefix."""
    no_spans, ops = _cpu_work(False)
    assert no_spans == []
    roots = sorted((e for e in ops if e.cpu_parent is None),
                   key=lambda e: e.time_range.start)
    mids, _ = _gaps_at(roots)
    starts = [e.time_range.start for e in roots]
    want = {trace._host_activity(roots, starts, m).split(" / ")[0]
            for m in mids}

    spans_, ops = _cpu_work(True)
    assert {s.name for s in spans_} == {"mrnnt.outer", "mrnnt.inner"}
    roots = [e for e in ops if spans._root(e)]
    assert len(roots) == len(starts)
    _, intervals = _gaps_at(roots)
    named = [n for n, _ in spans.named_gaps(ops, intervals, spans_)]
    assert {n.split(" | ")[-1].split(" / ")[0] for n in named} == want
    assert {n.split(" | ")[0] for n in named if " | " in n} == {
        "mrnnt.outer", "mrnnt.inner"}


# --- the readers -------------------------------------------------------------

LOSS = {"trace": {"least_s": 1.0, "busy_s": 1.0, "untraced_s": 2.0}}
TRAIN = {"trace": {"model_flops": 1.0, "busy_s": 1.0, "untraced_s": 2.0}}


@pytest.mark.parametrize("name", ["host_syncs.loss", "host_syncs.train"])
def test_readers_read_nothing_without_their_keys(name):
    read = run.reader(name)
    for readings in ({}, {"trace": {}}, {"window_s": 1.0, "steps": 3}):
        assert read(readings) is None


@pytest.mark.parametrize("name,readings,other", [
    ("host_syncs.loss", LOSS, TRAIN), ("host_syncs.train", TRAIN, LOSS)])
def test_readers_divide_the_syncs_by_the_loss_calls(monkeypatch, name,
                                                    readings, other):
    read = run.reader(name)
    monkeypatch.setattr(profiling, "counters", lambda: {
        "launches": {spans.ROW_1: 4, "beta_grad_fused": 4},
        "syncs": {"validate.input_lengths": 4, "validate.label_lengths": 4}})
    assert read(readings) == 2.0
    assert read(other) is None
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"launches": {}, "syncs": {}})
    assert read(readings) is None           # no loss call counted


def test_readers_read_nothing_from_a_program_without_counters(monkeypatch):
    """A program that keeps no counters (the port before them) reads
    nothing and raises nothing."""
    monkeypatch.delattr(profiling, "counters")
    assert run.reader("host_syncs.loss")(LOSS) is None
    assert run.reader("host_syncs.train")(TRAIN) is None


# --- the tool, on the CPU ----------------------------------------------------

@pytest.mark.parametrize("entry,names,metric", [
    ("loss", {"mrnnt.loss", "mrnnt.validate", "mrnnt.bands",
              "mrnnt.loss.forward", "mrnnt.loss.backward"},
     "glue_idle_ms.loss"),
    ("train", {"mrnnt.train_step", "mrnnt.encode", "mrnnt.predict",
               "mrnnt.joint", "mrnnt.loss", "mrnnt.validate", "mrnnt.bands",
               "mrnnt.loss.forward", "mrnnt.backward", "mrnnt.loss.backward",
               "mrnnt.update"}, "kernel_roofline.train")])
def test_measure_tables_every_span_of_the_path(tiny_model, entry, names,
                                               metric):
    from conftest import tiny_mix
    out = spans.measure(tiny_model, tiny_mix(entry), 2 ** 31 + 7, "cpu")
    assert out["steps"] > 0 and names <= set(out["spans"])
    assert all(out["spans"][n]["calls"] == 1 for n in names)     # a step
    # No device here: nothing launched, nothing synced, nothing idle.
    assert out["counters"] == {"launches": {}, "syncs": {}}
    assert out["busy_s"] == 0 and out["idle_gaps"] == []
    assert metric in out
