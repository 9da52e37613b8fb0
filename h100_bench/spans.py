"""The port's spans in a torch.profiler run, one row per span name, and a
cell's trace batches reduced to them.

The port opens ``mrnnt.<...>`` spans (``torch.profiler.record_function``
ranges, monotonic_rnnt_tpu_torch/utils/profiling.py) at each of its layers,
and counts its kernel launches and host syncs. This module reduces a
profile to, per span name and per step:

* ``calls``;
* ``host_ms``: the spans' host time;
* ``self_ms``: the same less the union of its child spans' time. A span
  on another thread is the child of the innermost span that holds it in
  time (the loss's backward, on autograd's thread, is the child of the
  model's ``mrnnt.backward``);
* ``device_ms``: the union of the device intervals of the operations
  whose launching runtime call lies inside the span or one of its
  descendants;
* ``idle_ms``: each device-idle gap is put down to the innermost span open
  at the gap's midpoint on the thread that launched the operation ending
  the gap (if no span is open there, on any thread); a gap under no span
  goes to ``outside the port``.

It also names the idle gaps as the benchmark's trace.py does (the
outermost and innermost host operation running), seeing past the spans:
an operation whose parent is a span counts as a root, and the innermost
span open gives the label a prefix (``mrnnt.validate | aten::any``).

Run as a tool, it drives a cell's trace batches as run.py's traced run
does (the same entry, set-up and batches):

    python3 -m h100_bench.spans --workload <cell> --seed <n> \\
        [--sync-debug 1] [--span-cost 1]

and prints one JSON line: the span table; the counters a step over the
untraced run of the trace batches; ``glue_idle_ms.loss`` in the loss cell
(the idle ms a step put down to the loss's entry points, its autograd
Functions and their host syncs) or
``kernel_roofline.train`` in a train cell (the loss's least time of the
traced steps over the device time under ``mrnnt.loss.forward`` and
``mrnnt.loss.backward``, in %); and the named idle gaps. ``--sync-debug 1``
runs one step under ``torch.cuda.set_sync_debug_mode("warn")`` and sets
the synchronising calls it reports beside the sync counter's count;
``--span-cost 1`` times a span with no profiler collecting.
"""

from __future__ import annotations

import bisect
import json
import sys
import time
import traceback
import warnings
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional

PREFIX = "mrnnt."
OUTSIDE = "outside the port"
GLUE = ("mrnnt.loss", "mrnnt.validate", "mrnnt.bands", "mrnnt.loss.forward",
        "mrnnt.loss.backward")
LOSS_CORE = ("mrnnt.loss.forward", "mrnnt.loss.backward")
PORT = "monotonic_rnnt_tpu_torch"
TOP = 10
NAMED_GAPS = 200


class Span(NamedTuple):
    name: str
    thread: int
    start: float        # microseconds
    end: float


class Launch(NamedTuple):
    """A device operation: the thread and host time of the runtime call
    that launched it (None where the profile does not link them), and
    its interval on the device."""
    thread: Optional[int]
    at: Optional[float]
    start: float
    end: float


def _union(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _gaps(intervals) -> List[tuple]:
    """(start, end, index of the interval ending the gap) of each idle gap
    between the intervals' union."""
    order = sorted(range(len(intervals)), key=lambda i: intervals[i])
    gaps, end = [], None
    for i in order:
        s, e = intervals[i]
        if end is not None and s > end:
            gaps.append((end, s, i))
        end = e if end is None else max(end, e)
    return gaps


class _Open:
    """Which span is open at a time, per thread and on any thread."""

    def __init__(self, spans: List[Span]):
        by_thread = defaultdict(list)
        for i, s in enumerate(spans):
            by_thread[s.thread].append(i)
        self.spans = spans
        self.threads = {}
        for thread, ids in by_thread.items():
            ids.sort(key=lambda i: (spans[i].start, -spans[i].end))
            self.threads[thread] = (ids, [spans[i].start for i in ids])

    def holder(self, thread, start: float, end: float,
               skip: int = -1) -> Optional[int]:
        """The innermost span of `thread` (not `skip`) that holds
        [start, end]."""
        if thread not in self.threads:
            return None
        ids, starts = self.threads[thread]
        k = bisect.bisect_right(starts, start) - 1
        while k >= 0:
            i = ids[k]
            if i != skip and self.spans[i].end >= end:
                return i
            k -= 1
        return None

    def anywhere(self, start: float, end: float, skip_thread=None,
                 skip: int = -1) -> Optional[int]:
        """The innermost span of any thread (but `skip_thread`) that holds
        [start, end]: the one that started last."""
        found = [i for t in self.threads if t != skip_thread
                 if (i := self.holder(t, start, end, skip)) is not None]
        return max(found, key=lambda i: (self.spans[i].start,
                                         -self.spans[i].end), default=None)

    def at(self, thread, at: float) -> Optional[int]:
        """The innermost span open at `at` on `thread`, else on any."""
        found = self.holder(thread, at, at)
        return found if found is not None else self.anywhere(at, at)


def _parents(spans: List[Span], open_: _Open) -> List[Optional[int]]:
    """Each span's parent: the innermost span of its own thread that holds
    it, else the innermost span of another thread that holds it."""
    out = []
    for i, s in enumerate(spans):
        p = open_.holder(s.thread, s.start, s.end, skip=i)
        if p is None:
            p = open_.anywhere(s.start, s.end, skip_thread=s.thread)
        out.append(p)
    return out


def span_table(spans: Iterable[Span], launches: Iterable[Launch],
               steps: int) -> Dict[str, dict]:
    """{span name: {calls, host_ms, self_ms, device_ms, idle_ms}}, each a
    step, and the row ``outside the port`` (device and idle ms under no
    span)."""
    spans = [s for s in spans if s.end >= s.start]
    launches = list(launches)
    open_ = _Open(spans)
    parents = _parents(spans, open_)
    children = defaultdict(list)
    for i, p in enumerate(parents):
        if p is not None:
            children[p].append(i)

    def names_up(i):
        names = []
        while i is not None:
            if spans[i].name not in names:
                names.append(spans[i].name)
            i = parents[i]
        return names

    rows = defaultdict(lambda: dict(calls=0, host_ms=0.0, self_ms=0.0,
                                    device_ms=0.0, idle_ms=0.0))
    for i, s in enumerate(spans):
        row = rows[s.name]
        row["calls"] += 1
        row["host_ms"] += (s.end - s.start) * 1e-3
        inner = _union((max(spans[c].start, s.start),
                        min(spans[c].end, s.end)) for c in children[i])
        row["self_ms"] += (s.end - s.start - inner) * 1e-3

    device = defaultdict(list)
    for op in launches:
        holder = (open_.at(op.thread, op.at) if op.at is not None else None)
        for name in (names_up(holder) if holder is not None else [OUTSIDE]):
            device[name].append((op.start, op.end))
    for name, intervals in device.items():
        rows[name]["device_ms"] = _union(intervals) * 1e-3

    for s, e, k in _gaps([(op.start, op.end) for op in launches]):
        holder = open_.at(launches[k].thread, 0.5 * (s + e))
        name = OUTSIDE if holder is None else spans[holder].name
        rows[name]["idle_ms"] += (e - s) * 1e-3

    steps = max(steps, 1)
    return {name: {k: v / steps for k, v in row.items()}
            for name, row in sorted(rows.items())}


def glue_idle_ms(table: Dict[str, dict]) -> float:
    """Idle ms a step put down to the loss's entry points and autograd
    Functions (layers 2-3: GLUE) and to their host syncs."""
    return sum(row["idle_ms"] for name, row in table.items()
               if name in GLUE or name.startswith("mrnnt.sync."))


# --- from torch.profiler's events --------------------------------------------

def _is_annotation(e) -> bool:
    """A profiler range (record_function), such as a span: not a host
    operation of trace.py's."""
    return (bool(getattr(e, "is_user_annotation", False))
            or e.name.startswith(PREFIX))


def _runtime(e) -> bool:
    """A host runtime call (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...)."""
    return e.name.startswith("cu")


def from_events(events, cuda) -> tuple:
    """(spans, launches, host operations) from ``prof.events()``; `cuda`
    is torch.autograd.DeviceType.CUDA. A device operation's launching call
    is the host runtime call of the same correlation id; where the profile
    has none, the host operation the device operation is linked to stands
    in. The host operations are trace.py's: every host event but a span."""
    spans, device, ops, runtime, linked_to = [], [], [], {}, {}
    for e in events:
        if e.device_type == cuda:
            if not _is_annotation(e) and e.time_range.end > e.time_range.start:
                device.append(e)
        elif _is_annotation(e):
            if e.name.startswith(PREFIX):
                spans.append(Span(e.name, e.thread, e.time_range.start,
                                  e.time_range.end))
        else:
            ops.append(e)
            (runtime if _runtime(e) else linked_to).setdefault(e.id, e)
    launches = []
    for d in device:
        linked = getattr(d, "linked_correlation_id", 0) or 0
        call = runtime.get(d.id) or (linked_to.get(linked) if linked
                                     else None)
        launches.append(Launch(
            call.thread if call is not None else None,
            call.time_range.start if call is not None else None,
            d.time_range.start, d.time_range.end))
    return spans, launches, ops


def _root(e) -> bool:
    p = e.cpu_parent
    return p is None or _is_annotation(p)


def named_gaps(ops, intervals, spans: List[Span]) -> List[list]:
    """trace.py's idle-gap breakdown of the NAMED_GAPS longest gaps between
    the device intervals, from the host operations `ops`, with roots found
    past the spans and the innermost span open as a prefix: [label,
    seconds], the TOP largest."""
    roots = sorted((e for e in ops if _root(e)),
                   key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in roots]
    open_ = _Open(spans)
    by_label = defaultdict(float)
    gaps = sorted(_gaps(intervals), key=lambda g: g[0] - g[1])
    for s, e, _ in gaps[:NAMED_GAPS]:
        mid = 0.5 * (s + e)
        label = _host_op(roots, starts, mid)
        holder = open_.anywhere(mid, mid)
        if holder is not None:
            label = f"{spans[holder].name} | {label}"
        by_label[label] += (e - s) * 1e-6
    top = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
    return [[n[:120], v] for n, v in top]


def _host_op(roots, starts, at: float) -> str:
    """'outermost / innermost' host operation running at `at`, spans left
    out (trace.py's _host_activity, with spans seen through)."""
    i = bisect.bisect_right(starts, at) - 1
    while i >= 0 and roots[i].time_range.end < at and starts[i] > at - 1e5:
        i -= 1
    if i < 0 or roots[i].time_range.end < at:
        return "host between ops"
    outer = inner = roots[i]
    node = outer
    while True:
        child = next((c for c in node.cpu_children
                      if c.time_range.start <= at <= c.time_range.end), None)
        if child is None:
            break
        node = child
        if not _is_annotation(child):
            inner = child
    return outer.name if outer is inner else f"{outer.name} / {inner.name}"


# --- the program's counters --------------------------------------------------

ROW_1 = "stats_alpha_fused"     # the padded loss's forward kernel


def syncs_a_call() -> Optional[float]:
    """The port's host syncs, summed over its sites, over the launches of
    row 1 (one a padded loss call) that its counters hold; None where the
    program keeps no counters or launched no row 1."""
    try:
        from monotonic_rnnt_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    seen = counters()
    calls = seen.get("launches", {}).get(ROW_1)
    if not calls:
        return None
    return sum(seen.get("syncs", {}).values()) / calls


# --- the tool ----------------------------------------------------------------

def loss_least_s(cfg: dict, batch) -> float:
    """The least time of one train step's padded loss call: its logits are
    [B, the batch's longest T', its longest S + 1, V]."""
    from . import counts
    bytes_, flops = counts.padded_loss_work(
        batch.tprime, batch.label_lengths, int(batch.tprime.max()),
        int(batch.label_lengths.max()), cfg["vocab_size"])
    return counts.loss_least_seconds(bytes_, flops)


def _per_step(before: dict, after: dict, steps: int) -> dict:
    return {kind: {k: (v - before[kind].get(k, 0)) / steps
                   for k, v in after[kind].items()
                   if v != before[kind].get(k, 0)}
            for kind in after}


def sync_debug(step) -> dict:
    """One step under torch.cuda.set_sync_debug_mode("warn"): each
    synchronising call reported, by the innermost frames of its stack,
    and the sync counter's count over the same step."""
    import torch
    from monotonic_rnnt_tpu_torch.utils.profiling import counters
    seen, armed = [], [False]

    def record(message, category, filename, lineno, file=None, line=None):
        if not armed[0]:
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "warnings" not in f.filename]
        seen.append({
            "frames": [f"{Path(f.filename).name}:{f.lineno} {f.name}"
                       for f in frames[-4:]],
            "port": any(PORT in f.filename for f in frames),
            "counted": any(f.name == "to_host" for f in frames)})

    torch.cuda.synchronize()
    before = counters()["syncs"]
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        armed[0] = True
        try:
            step()
        finally:
            armed[0] = False
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    after = counters()["syncs"]
    return {"counted": sum(after.values()) - sum(before.values()),
            "reported": len(seen), "calls": seen}


def span_cost(n: int = 200_000, repeats: int = 5) -> dict:
    """Host ns, with no profiler collecting, of a span (`with span(...)`),
    of a call through a function that ``spanned`` decorates (over the
    same call undecorated), and of a launch's span with its name built:
    the least of `repeats` means over n calls, less an empty loop's."""
    from monotonic_rnnt_tpu_torch.utils import profiling
    span = profiling.span

    def bare():
        pass

    wrapped = profiling.spanned("mrnnt.cost")(bare)

    def loop(body):
        def run():
            for _ in range(n):
                body()
        return run

    def with_span():
        with span("mrnnt.cost"):
            pass

    entry = "mrnnt_cost_probe"

    def launch():
        with span("mrnnt.launch." + entry):
            pass

    def best(run) -> float:
        times = []
        for _ in range(repeats):
            t = time.perf_counter()
            run()
            times.append((time.perf_counter() - t) / n * 1e9)
        return min(times)

    base = best(loop(bare))
    return {"span_ns": best(loop(with_span)) - base,
            "spanned_ns": best(loop(wrapped)) - base,
            "launch_ns": best(loop(launch)) - base}


def measure(cfg: dict, mix: dict, seed: int, device: str = "cuda",
            sync_check: bool = False, cost: bool = False) -> dict:
    """A cell's trace batches, untraced (counters) and then traced (the
    span table), after the entry's set-up and warm cycle."""
    import importlib

    import torch
    from monotonic_rnnt_tpu_torch.utils.profiling import counters

    from . import run
    card = run.Card(device)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(cfg.get("tf32", False))
    if card.cuda:
        from monotonic_rnnt_tpu_torch.ops.cuda import _build
        _build.build()
    drv = importlib.import_module(
        f"h100_bench.entries.{mix['entry']}").Entry(cfg, mix, seed, device)
    drv.warm()
    batches = drv.trace_batches()
    steps = len(batches)

    def trace_run():
        for j in batches:
            drv.traced_step(j)

    card.sync()
    before = counters()
    t = time.perf_counter()
    trace_run()
    card.sync()
    out = {"steps": steps, "untraced_s": time.perf_counter() - t,
           "counters": _per_step(before, counters(), steps)}

    activities = [torch.profiler.ProfilerActivity.CPU]
    if card.cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        card.sync()
        t = time.perf_counter()
        trace_run()
        card.sync()
        out["traced_window_s"] = time.perf_counter() - t
    spans_, launches, ops = from_events(prof.events(),
                                        torch.autograd.DeviceType.CUDA)
    table = span_table(spans_, launches, steps)
    out["busy_s"] = _union((op.start, op.end) for op in launches) * 1e-6
    out["unlinked_ops"] = sum(op.at is None for op in launches)
    out["spans"] = table
    if mix["entry"] == "loss":
        out["glue_idle_ms.loss"] = glue_idle_ms(table)
    else:
        least = sum(loss_least_s(cfg, drv.cycle.batches[j]) for j in batches)
        core = sum(table.get(n, {}).get("device_ms", 0.0)
                   for n in LOSS_CORE) * steps * 1e-3
        out["kernel_roofline.train"] = 100.0 * least / core if core else None
    out["idle_gaps"] = named_gaps(
        ops, [(op.start, op.end) for op in launches], spans_)
    if sync_check and card.cuda:
        out["sync_debug"] = sync_debug(lambda: drv.traced_step(batches[0]))
    if cost:
        out["span_cost"] = span_cost()
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    from . import run
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sync-debug", type=int, choices=(0, 1), default=0)
    ap.add_argument("--span-cost", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = run.by_name(bench["workloads"], args.workload)
    cfg = run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    mix = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    out = {"cell": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0)}
    out.update(measure(cfg, mix, args.seed, "cuda", bool(args.sync_debug),
                       bool(args.span_cost)))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
