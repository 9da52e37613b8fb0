"""A traced window: torch.profiler over some steps, reduced to the device's
busy time, the device operations that took most of it, and the idle gaps
named by what the host was doing during them."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

TOP = 10
NAMED_GAPS = 200


def _union(intervals: List[Tuple[float, float]]):
    """(busy microseconds, idle gaps between busy spans) of intervals."""
    busy, gaps = 0.0, []
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def _host_activity(roots, starts, at: float) -> str:
    """'outermost / innermost' host op running at time `at` (us); roots are
    the top-level host ops sorted by start, starts their start times."""
    i = bisect.bisect_right(starts, at) - 1
    # Top-level ops of other threads (autograd's) may start later and end
    # earlier: look back a little for one that covers `at`.
    while i >= 0 and roots[i].time_range.end < at and starts[i] > at - 1e5:
        i -= 1
    if i < 0 or roots[i].time_range.end < at:
        return "host between ops"
    outer = inner = roots[i]
    while True:
        child = next((c for c in inner.cpu_children
                      if c.time_range.start <= at <= c.time_range.end), None)
        if child is None:
            break
        inner = child
    return outer.name if outer is inner else f"{outer.name} / {inner.name}"


def traced(run: Callable[[], Dict[str, float]]) -> Dict:
    """Runs run() under torch.profiler (CPU and CUDA); returns its work
    summed, with busy_s, window_s and the breakdown."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work = run()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    device_ops, cpu_ops = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == cuda:
            if e.time_range.end > e.time_range.start:
                device_ops.append(e)
        else:
            cpu_ops.append(e)
    busy_us, gaps = _union([(e.time_range.start, e.time_range.end)
                            for e in device_ops])
    by_op = defaultdict(float)
    for e in device_ops:
        by_op[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    roots = sorted((e for e in cpu_ops if e.cpu_parent is None),
                   key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in roots]
    by_host = defaultdict(float)
    gaps.sort(key=lambda g: g[0] - g[1])
    for s, e in gaps[:NAMED_GAPS]:
        by_host[_host_activity(roots, starts, 0.5 * (s + e))] += (e - s) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(work, busy_s=busy_us * 1e-6, window_s=window_s,
                device_ops=[[n[:120], s] for n, s in top],
                idle_gaps=[[n[:120], s] for n, s in idle],
                device_op_count=len(device_ops))
