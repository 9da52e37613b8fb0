"""Profiling and benchmarking utilities.

PyTorch counterpart of ``monotonic_rnnt_tpu/utils/profiling.py``: phase
timers that show in a ``torch.profiler`` trace, a device trace written as a
Chrome trace, and a timing method that keeps every iteration honest: a chain
of data-dependent iterations, so no iteration can be skipped, reordered or
overlapped away. On CUDA tensors the chain is timed with CUDA events, on CPU
tensors with the host clock.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Tuple

import numpy as np
import torch


def _sync() -> None:
    """Waits for the current CUDA device, if this process has used one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def phase_timer(name: str, enabled: bool = True, file=None):
    """Wall-clock a phase (the DEBUG_TIME equivalent), as a profiler range.

    The clock is read after the current CUDA device has finished its queued
    work, at the start and at the end, so the time covers the phase's device
    work and not only its launches.
    """
    _sync()
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if enabled:
        _sync()
        print(f"[mrnnt] {name}: {(time.perf_counter() - t0) * 1e3:.2f} ms",
              file=file)


@contextmanager
def device_trace(log_dir: str):
    """Trace the host and the GPU into a Chrome trace under log_dir.

    Yields the ``torch.profiler.profile``; after the block, its
    ``key_averages()`` give the time by operation and kernel, and log_dir
    holds ``<host>_<pid>.<time>.pt.trace.json`` (view in Perfetto or
    chrome://tracing). The GPU is traced where one is present.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _timed(fn: Callable, device: torch.device):
    """(fn()'s result, its seconds): CUDA events on a CUDA device, else the
    host clock (CPU ops run eagerly, so the clock covers them)."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def dependent_loop_bench(
    step_fn: Callable,
    perturb_fn: Callable,
    feedback_fn: Callable,
    args: Tuple,
    iters: int = 30,
    trials: int = 3,
) -> Tuple[float, float]:
    """Time `step_fn` as a data-dependent chain.

    Each iteration perturbs the first argument with the previous
    iteration's scalar feedback, so the chain is data-dependent end to end:

        x_{i+1} = perturb_fn(x_i, feedback_fn(step_fn(x_i, *rest)))

    Returns (mean seconds per iteration over trials, variance), as the
    reference harness's 10-iteration mean+variance report
    (tests/test_time.cpp:31-59). The first chain warms up and is not timed.
    """
    x0, rest = args[0], args[1:]
    device = _device_of(args)

    def run():
        x = x0
        acc = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(iters):
            x = perturb_fn(x, acc)
            acc = feedback_fn(step_fn(x, *rest))
        return acc

    run()
    _sync()
    times = [_timed(run, device)[1] / iters for _ in range(trials)]
    return float(np.mean(times)), float(np.var(times))


def corrected_args_loop_bench(
    make_run: Callable,
    args: Tuple,
    iters: int,
    trials: int = 3,
) -> float:
    """Two-point launch-corrected seconds/iteration of a chain over `args`.

    `make_run(n)` returns a callable taking *args* with a data-dependent
    chain of n iterations inside. Timing it at n = iters and n = iters/4
    and solving t(n) = overhead + n * per_iter removes the fixed cost of a
    call. Requires iters >= 2 (the correction solves a two-point line).
    """
    if iters < 2:
        raise ValueError(f"iters must be >= 2 for the two-point "
                         f"correction, got {iters}")
    lo = max(1, iters // 4)
    device = _device_of(args)

    # CUDA events time the device itself, so the fit removes only the host's
    # fixed cost per call; the JAX package's remote-runtime forcing has no
    # counterpart.
    def measure(fn, n):
        fn(*args)                                 # warm up
        _sync()
        return min(_timed(lambda: fn(*args), device)[1]
                   for _ in range(trials)) / n

    t_hi = measure(make_run(iters), iters)
    t_lo = measure(make_run(lo), lo)
    return float((t_hi * iters - t_lo * lo) / (iters - lo))


def default_perturb(x, acc):
    """Data dependence at the cost of a copy: x with acc * 1e-20 added to its
    first element, out of place (JAX's x.at[...].add)."""
    out = x.clone()
    idx = (0,) * (x.dim() - 1) + (slice(0, 1),)
    out[idx] += torch.as_tensor(acc * 1e-20, device=x.device).to(x.dtype)
    return out


def corrected_loop_bench(
    step_fn: Callable,
    perturb_fn: Callable,
    feedback_fn: Callable,
    args: Tuple,
    iters: int = 100,
    trials: int = 3,
) -> Tuple[float, float]:
    """dependent_loop_bench with the fixed cost per chain removed.

    Times the same chain at iters and iters/4 and solves
    t(n) = overhead + n * per_iter. Returns (per_iter_seconds,
    overhead_seconds); per_iter is the asymptotic throughput number.
    """
    if iters < 2:
        raise ValueError(f"iters must be >= 2 for the two-point "
                         f"correction, got {iters}")
    lo = max(1, iters // 4)
    t_hi, _ = dependent_loop_bench(step_fn, perturb_fn, feedback_fn, args,
                                   iters=iters, trials=trials)
    t_lo, _ = dependent_loop_bench(step_fn, perturb_fn, feedback_fn, args,
                                   iters=lo, trials=trials)
    # t_hi/t_lo are per-iter means: total_n = overhead + n * per_iter.
    per_iter = (t_hi * iters - t_lo * lo) / (iters - lo)
    overhead = max(0.0, (t_lo - per_iter) * lo)
    return float(per_iter), float(overhead)
