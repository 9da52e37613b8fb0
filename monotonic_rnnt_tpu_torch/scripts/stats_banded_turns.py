"""Row 7 (``softmax_stats_banded``) from several checkouts in turns, on one card.

    python3 -m monotonic_rnnt_tpu_torch.scripts.stats_banded_turns \
        --tree p=PARENT --tree c=CHANGE [--order pccp] [--profile] \
        [--out FILE]

Each ``--tree NAME=DIR`` names a checkout of the repository (a ``git
archive`` copy); ``--order`` gives the turns by name, one letter a turn
(default: the names in order). Each turn is a process of its own that
imports that checkout's package, builds its ``csrc/banded.cu`` and, on the
operands of ``chip_smoke.py``'s banded case (B=2, T=1600, S=200, V=1024,
shift 20: the layout from ``scripts/_cases.banded_case``; the band drawn
N(0, 1) on the card from a seeded generator, as that case's logits are,
since packing only gathers rows), in float32 and bfloat16:

* ``ms``: one wrapper call from an idle card, host prelude included,
  median of 20 CUDA-event timings (``chip_smoke.py``'s ``ms``);
  ``queued_ms``: 20 calls back to back between two events;
  ``kernel_ms``: 20 calls captured in one CUDA graph, replayed (the kernel
  alone); ``gbps``: the band's bytes over ``kernel_ms``;
* ``l2_kernel_ms``: the kernel alone on the first frames of sample 0 that
  fill 32 MB (resident in the 50 MB L2 across replays), and
  ``l2_ms_per_band``: that time scaled to the band's rows, the kernel's
  time when HBM is not what it waits on; ``ninf_kernel_ms``: the kernel
  alone on a band of -inf, whose rows take no exponential (the reduction
  returns after the max), so the time of the bytes alone;
* ``clock``: the SM clock (MHz) and power draw (W) that ``nvidia-smi``
  reads every 50 ms while the kernel runs back to back for 2 s;
* ``prelude_us``: host µs a call (median of 5 runs of 200 calls, the card
  synchronised after each run) on a small band of the same widths, so that
  the card never holds the host back: the wrapper, the operator
  (``torch.ops.mrnnt.softmax_stats_banded``), its CUDA implementation, the
  C launch through ctypes alone and through ``kernels._call`` (with the
  current device and stream it reads, the stream as a ``Stream`` object
  and as the raw handle), and the pieces of an implementation that
  checks each operand with ``kernels._check`` (``checks_each``), allocates
  the stacked outputs (``alloc``), reads its pointers through five output
  views (``pointers_views``) and is unbound (``unbind``);
* ``sha256`` of each output, so that trees compare bit for bit, and the
  largest |difference| from the plain version; ``launch``: the launch's
  grid and ring where the tree's wrapper module reports them;
* ``sass``: the static SASS of the two kernels the case launches (16-byte
  loads, a warp a row), counted by opcode with ``cuobjdump`` where the
  toolkit has it;
* with ``--profile`` (first turn of each tree): the kernel's device time
  from ``torch.profiler``, and the CUPTI metrics (DRAM throughput, issue
  slots, stall reasons) asked through its experimental config, or the
  error that refused them.

Prints each turn's JSON, then one summary JSON object as the last line:
for each figure its values by tree in run order, and whether every tree
gave the same output bits. Exits nonzero if a turn fails or the bits
differ.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BANDED_CASE = (2, 1600, 200, 1024)
BAND_SHIFT = 20
REPS = 20
L2_BYTES = 32 << 20
CLOCK_WINDOW_S = 2.0
PRELUDE_CASE = (1, 2)       # B, T of the small band
PRELUDE_CALLS, PRELUDE_RUNS = 200, 5
TURN_TIMEOUT_S = 600
# CUPTI profiler metrics (Nsight Compute's names), asked per kernel.
CUPTI_METRICS = (
    "dram__throughput.avg.pct_of_peak_sustained_elapsed",
    "sm__inst_issued.avg.pct_of_peak_sustained_active",
    "smsp__average_warp_latency_issue_stalled_long_scoreboard",
    "smsp__average_warp_latency_issue_stalled_math_pipe_throttle",
)


def _events_ms(fn, reps):
    import torch
    times = []
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _queued_ms(fn, reps):
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def _host_us(fn):
    import torch
    for _ in range(20):
        fn()
    times = []
    for _ in range(PRELUDE_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PRELUDE_CALLS):
            fn()
        times.append((time.perf_counter() - t0) / PRELUDE_CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def _sass(lib_path):
    """Opcode counts of the row-7 kernels at 16-byte loads and 32 lanes a
    row, from cuobjdump -sass of the built library."""
    import os
    import re
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            name = (("bf16" if "bfloat16" in fn else "f32")
                    if "stats_banded_kernel" in fn and "Li16ELi32E" in fn
                    else None)
            if name:
                counts[name] = {}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if name and m:
            op = m.group(2).split(".")[0]
            counts[name][op] = counts[name].get(op, 0) + 1
    return {k: {"total": sum(v.values()),
                "ops": dict(sorted(v.items(), key=lambda kv: -kv[1])[:16])}
            for k, v in counts.items()}


def _clock_under(fn):
    """nvidia-smi's SM clock and power draw, sampled every 50 ms while
    fn() runs back to back for CLOCK_WINDOW_S."""
    import torch
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < CLOCK_WINDOW_S:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    samples = [tuple(float(f) for f in line.split(","))
               for line in out.splitlines() if line.count(",") == 1]
    if not samples:
        return None
    clocks = sorted(c for c, _ in samples)
    power = sorted(p for _, p in samples)
    return {"samples": len(samples), "sm_mhz_median": clocks[len(clocks) // 2],
            "sm_mhz_min": clocks[0],
            "power_w_median": power[len(power) // 2]}


def _operands(case, x):
    """Row 7's arguments on band x of the case's layout."""
    from monotonic_rnnt_tpu_torch.ops import banded
    from monotonic_rnnt_tpu_torch.ops import bands as bd
    labels, ilen, slen = case["labels"], case["ilen"], case["slen"]
    layout, bands = case["layout"], case["bands"]
    t_max, s1 = x.shape[1], labels.shape[1] + 1
    lab = banded.band_labels(labels, slen, layout, s1).contiguous()
    rel = tuple(r.contiguous() for r in bd.band_relative_bounds(
        ilen, slen, bands, layout, t_max, s1))
    return x, lab, rel


def _prelude(BK, K, args):
    """Host µs a call of the wrapper and of its parts."""
    import torch
    x, lab, rel = args
    op = torch.ops.mrnnt.softmax_stats_banded
    batch, t_max, w, v = x.shape
    out = torch.empty((5, batch, t_max, w), dtype=torch.float32,
                      device=x.device)
    fn, _lib = K._bound("mrnnt_stats_banded")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (x, lab, *rel)]
    plane = batch * t_max * w * 4
    # A tree whose launch takes a ticket counter has one argument more.
    tickets = torch.empty(1, dtype=torch.int64, device=x.device)
    extra = (tickets.data_ptr(),) if len(fn.argtypes) == 19 else ()
    c_args = (ptrs[0], int(x.dtype == torch.bfloat16), *ptrs[1:], batch,
              t_max, w, v, 0, *(out.data_ptr() + i * plane for i in range(5)),
              *extra, stream)
    dev = x.device

    def checks():   # each operand through kernels._check
        K._check_logits(x, 0)
        K._check(lab, "lab_band", torch.int32, (batch, t_max, w), dev)
        for name, t in zip(("ra_lo", "ra_hi", "rb_lo", "rb_hi"), rel):
            K._check(t, name, torch.int32, (batch, t_max), dev)

    def pointers():  # the pointers, five of them through output views
        betas = (out[3], out[4])
        return ([K._ptr(x), K._ptr(lab)] + [K._ptr(t) for t in rel]
                + [K._ptr(out[i]) for i in range(3)]
                + [K._ptr(t) for t in betas])

    parts = {
        "wrapper": lambda: BK.softmax_stats_banded(x, lab, rel, 0),
        "operator": lambda: op(x, lab, *rel, 0, True),
        "cuda_impl": lambda: BK.softmax_stats_banded_cuda(x, lab, *rel, 0,
                                                          True),
        "ctypes_launch": lambda: fn(*c_args),
        "call": lambda: K._call("mrnnt_stats_banded", dev, *c_args[:-1]),
        "current_device": torch.cuda.current_device,
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device()),
        "checks_each": checks,
        "alloc": lambda: torch.empty((5, batch, t_max, w),
                                     dtype=torch.float32, device=dev),
        "pointers_views": pointers,
        "unbind": lambda: out.unbind(0),
    }
    us = {}
    for name, f in parts.items():
        try:
            us[name] = _host_us(f)
        except (TypeError, ValueError, RuntimeError) as exc:
            # a tree whose entry point takes other arguments
            print(f"prelude part {name}: {exc}", file=sys.stderr)
            us[name] = float("nan")
    us["dispatch"] = us["operator"] - us["cuda_impl"]
    us["wrapper_less_operator"] = us["wrapper"] - us["operator"]
    us["impl_less_launch"] = us["cuda_impl"] - us["ctypes_launch"]
    return us


def _profile(BK, args):
    """Device time and CUPTI metrics of three calls, or why there are none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x, lab, rel = args
    out = {}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(3):
            BK.softmax_stats_banded(x, lab, rel, 0)
        torch.cuda.synchronize()
    out["device_us"] = {e.key: round(e.device_time_total / e.count, 3)
                        for e in prof.key_averages()
                        if "stats_banded" in e.key and e.device_time_total}
    try:
        from torch._C._profiler import _ExperimentalConfig
        cfg = _ExperimentalConfig(profiler_metrics=list(CUPTI_METRICS),
                                  profiler_measure_per_kernel=True)
        with profile(activities=acts, experimental_config=cfg) as prof:
            BK.softmax_stats_banded(x, lab, rel, 0)
            torch.cuda.synchronize()
        rows = []
        for e in prof.events():
            extra = {k: v for k, v in vars(e).items()
                     if any(m.split("__")[0] in k for m in CUPTI_METRICS)}
            if "stats_banded" in e.name or extra:
                rows.append({"name": e.name[:60], **extra})
        out["cupti"] = rows or "profiler ran; no metric in its events"
    except Exception as exc:  # the sandbox may refuse CUPTI's profiler
        out["cupti"] = f"refused: {type(exc).__name__}: {exc}"[:400]
    return out


def worker(tree: str, profile_it: bool) -> dict:
    sys.path.insert(0, tree)
    import torch
    import monotonic_rnnt_tpu_torch as mt
    from monotonic_rnnt_tpu_torch.ops.cuda import banded_kernels as BK
    from monotonic_rnnt_tpu_torch.ops.cuda import kernels as K
    from monotonic_rnnt_tpu_torch.scripts._cases import banded_case
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    assert Path(mt.__file__).resolve().is_relative_to(Path(tree).resolve())
    t0 = time.perf_counter()
    from monotonic_rnnt_tpu_torch.ops.cuda import _build
    _build.build(["banded"])
    build_s = time.perf_counter() - t0
    b, t, s, v = BANDED_CASE
    case = banded_case(b, t, s, v, BAND_SHIFT, seed=0, device="cuda",
                       logits=torch.empty(0), pack=False)
    w = case["w"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    band = torch.randn((b, t, w, v), generator=gen, device="cuda")
    res = {"tree": tree, "build_s": build_s, "shape": [b, t, w, v],
           "gpu": torch.cuda.get_device_name(0)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    res["nvidia_smi"] = smi.stdout.strip()
    for dtype in (torch.float32, torch.bfloat16):
        x, lab, rel = _operands(case, band.to(dtype))
        call = lambda: BK.softmax_stats_banded(x, lab, rel, 0)  # noqa: E731
        got = call()
        want = BK.softmax_stats_banded_plain(x, lab, rel, 0)
        torch.cuda.synchronize()
        err = max(float(torch.nan_to_num((g - r).abs(), nan=0.0).max())
                  for g, r in zip(got, want))
        d = {"sha256": [hashlib.sha256(g.cpu().numpy().tobytes()).hexdigest()
                        for g in got],
             "max_abs_err_vs_plain": err}
        d["ms"] = _events_ms(call, REPS)
        d["queued_ms"] = _queued_ms(call, REPS)
        d["kernel_ms"] = _graph_ms(call, REPS)
        d["gbps"] = x.numel() * x.element_size() / d["kernel_ms"] / 1e6
        n_t = max(1, L2_BYTES // (w * v * x.element_size()))
        xs, labs, rels = (x[:1, :n_t].contiguous(), lab[:1, :n_t].contiguous(),
                          tuple(r[:1, :n_t].contiguous() for r in rel))
        d["l2_kernel_ms"] = _graph_ms(
            lambda: BK.softmax_stats_banded(xs, labs, rels, 0), REPS)
        d["l2_rows"] = n_t * w
        d["l2_ms_per_band"] = d["l2_kernel_ms"] * (b * t * w) / (n_t * w)
        ninf = torch.full_like(x, float("-inf"))
        d["ninf_kernel_ms"] = _graph_ms(
            lambda: BK.softmax_stats_banded(ninf, lab, rel, 0), REPS)
        del ninf
        d["clock"] = _clock_under(call)
        nb, nt = PRELUDE_CASE
        d["prelude_us"] = _prelude(BK, K, (
            x[:nb, :nt].contiguous(), lab[:nb, :nt].contiguous(),
            tuple(r[:nb, :nt].contiguous() for r in rel)))
        if hasattr(BK, "stats_banded_launch_shape"):
            d["launch"] = BK.stats_banded_launch_shape(x)
        if profile_it:
            d["profile"] = _profile(BK, (x, lab, rel))
        res[str(dtype).removeprefix("torch.")] = d
        del x, got, want
    res["launches"] = K.LAUNCHES["softmax_stats_banded"]
    res["sass"] = _sass(_build.library_path("banded"))
    return res


def _figures(res: dict) -> dict:
    out = {}
    for dt in ("float32", "bfloat16"):
        for k, val in res[dt].items():
            if isinstance(val, (int, float)):
                out[f"{dt}.{k}"] = val
        for k, val in res[dt]["prelude_us"].items():
            out[f"{dt}.prelude_us.{k}"] = val
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=DIR, a checkout of the repository")
    parser.add_argument("--order", default=None)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--out", default=None)
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.profile)), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    if not trees:
        parser.error("give at least one --tree NAME=DIR")
    order = args.order or "".join(trees)
    runs, profiled = [], set()
    for i, name in enumerate(order):
        tree = str(Path(trees[name]).resolve())
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", tree]
        if args.profile and name not in profiled:
            cmd.append("--profile")
            profiled.add(name)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True,
                              timeout=TURN_TIMEOUT_S)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n",
                  flush=True)
            print(f"turn {i + 1} ({name}) exited {proc.returncode}",
                  flush=True)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res.update(turn=i + 1, name=name, seconds=time.perf_counter() - t0)
        print(json.dumps(res), flush=True)
        runs.append(res)
    figures = {}
    for res in runs:
        for k, val in _figures(res).items():
            figures.setdefault(k, {}).setdefault(res["name"], []).append(val)
    bits = {dt: len({tuple(r[dt]["sha256"]) for r in runs}) == 1
            for dt in ("float32", "bfloat16")}
    summary = {"order": order, "gpu": runs[0]["nvidia_smi"],
               "same_bits": bits, "figures": figures}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": runs, **summary},
                                             indent=1))
    print(json.dumps(summary), flush=True)
    return 0 if all(bits.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
