"""Profiling and benchmarking utilities.

PyTorch counterpart of ``monotonic_rnnt_tpu/utils/profiling.py``: the
port's spans and counters, phase timers that show in a ``torch.profiler``
trace, a device trace written as a Chrome trace, and a timing method that
keeps every iteration honest: a chain of data-dependent iterations, so no
iteration can be skipped, reordered or overlapped away. On CUDA tensors the
chain is timed with CUDA events, on CPU tensors with the host clock.

Spans. ``span(name)`` marks a layer of the port in a profiler's trace, as
a ``torch.profiler.record_function`` range. With no profiler collecting
(one read of a module global) and while torch.export or torch.compile
traces a graph, it is a shared null context: it never syncs and costs a
function call. The port's spans, all named ``mrnnt.<...>``:

* model step: ``mrnnt.train_step`` around each training step, holding
  ``mrnnt.encode``, ``mrnnt.predict``, ``mrnnt.joint`` (the transducer's
  logits), ``mrnnt.backward`` and ``mrnnt.update`` (clip, AdamW, schedule);
  a Zipformer encoder opens ``mrnnt.zipformer.embed``,
  ``mrnnt.zipformer.stack<i>``, ``mrnnt.zipformer.attn_weights`` (each
  layer's shared softmax) and ``mrnnt.zipformer.attend`` (each module that
  reads it) inside ``mrnnt.encode``, an Emformer encoder
  ``mrnnt.emformer.embed`` (input linear and time reduction),
  ``mrnnt.emformer.rc_blocks`` (the right-context copies),
  ``mrnnt.emformer.layer<i>`` (i = 0..) and ``mrnnt.emformer.attend`` (each
  layer's masked attention);
* loss entry points: ``mrnnt.loss`` around the public padded and banded
  losses, holding ``mrnnt.validate`` (the input checks) and ``mrnnt.bands``
  (the default or alignment bands);
* autograd Functions: ``mrnnt.loss.forward`` and ``mrnnt.loss.backward``,
  the padded and banded cores; the backward runs on autograd's thread;
* kernels: ``mrnnt.launch.<entry>`` around each launch of a CUDA kernel's
  C entry point (``ops/cuda/kernels.py`` ``_call``);
* host syncs: ``mrnnt.sync.<site>`` around each read of device data on the
  host; its length is the time the host waited for the card.

Counters. Plain integers, always on: ``LAUNCHES[row]``, one per kernel
launch by kernel-table row (each row's CUDA implementation adds one when
it has launched; ``ops/cuda/kernels.py`` names the rows),
``syncs[site]``, one per host read of device data, and ``ROWS[name]``,
lattice rows (a row: one cell's V logits) by what a kernel did with them:
``stats_alpha_fused.read``, the live rows row 1 reads, and
``stats_alpha_fused.padded``, the rows of the padded lattice it was given,
counted by the padded loss from the host copy of the lengths that its
validation makes (none where it makes none), ``AHEAD["validate"]``, one
per padded loss call that queued its forward's launches before it waited
for that copy, and ``EMFORMER[name]``, what an Emformer encoder's forward
did, counted from padded shapes on the host: ``attn_cells``, the attention
score cells computed (batch x heads x layers x rows x keys), ``attn_kept``,
those the block mask keeps at the padded length before key padding, and
``rc_rows``, the right-context rows carried (batch x blocks x R).
``counters()`` returns a copy of them, ``reset_counters()`` zeroes them.
"""

from __future__ import annotations

import functools
import time
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

_NULL = nullcontext()
LAUNCHES: Dict[str, int] = {}
_SYNCS: Dict[str, int] = {}
ROWS: Dict[str, int] = {}
AHEAD: Dict[str, int] = {"validate": 0}
EMFORMER: Dict[str, int] = {"attn_cells": 0, "attn_kept": 0, "rc_rows": 0}


def tracing() -> bool:
    """Whether torch.export or torch.compile is tracing the call: values
    are then data of a graph, as JAX's traced values are, nothing reads
    them on the host and no span is opened."""
    return torch.compiler.is_exporting() or torch.compiler.is_compiling()


def span(name: str):
    """A profiler range named `name` where a profiler is collecting and no
    graph is being traced; else a shared null context. Never syncs."""
    if not _autograd_profiler._is_profiler_enabled or tracing():
        return _NULL
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: each call of the function runs inside span(name). With
    no profiler collecting, the call goes straight through."""
    def decorate(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return decorate


def to_host(t: torch.Tensor, site: str) -> torch.Tensor:
    """`t` on the host. From a device, the copy waits for the device's
    queued work: a sync, counted as ``syncs[site]`` and spanned as
    ``mrnnt.sync.<site>``."""
    if t.device.type == "cpu":
        return t
    _SYNCS[site] = _SYNCS.get(site, 0) + 1
    with span("mrnnt.sync." + site):
        return t.cpu()


def to_host_ahead(t: torch.Tensor) -> Tuple[torch.Tensor, "torch.cuda.Event"]:
    """Starts a copy of CUDA tensor `t` into pinned host memory and returns
    the host tensor with the CUDA event that marks the copy's end, without
    waiting: the copy runs after the work queued on the current stream, and
    the host tensor holds `t` only once ``wait_host`` has returned."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return host, done


def wait_host(done: Optional["torch.cuda.Event"], site: str) -> None:
    """Waits for a copy that ``to_host_ahead`` started, as ``to_host`` waits
    for its own: a sync, counted as ``syncs[site]`` and spanned as
    ``mrnnt.sync.<site>``. Nothing where there is no event (no copy)."""
    if done is None:
        return
    _SYNCS[site] = _SYNCS.get(site, 0) + 1
    with span("mrnnt.sync." + site):
        done.synchronize()


def counters() -> Dict[str, Dict[str, int]]:
    """A copy of the counters that are not zero: {"launches": {row: n},
    "syncs": {site: n}}, "rows": {name: n} once a kernel has counted rows,
    "ahead": {"validate": n} once a loss call has queued its forward
    before its sync, and "emformer": {name: n} once an Emformer encoder has
    run (so a process that runs neither reads the same two kinds)."""
    out = {"launches": {k: n for k, n in LAUNCHES.items() if n},
           "syncs": dict(_SYNCS)}
    for kind, counts in (("rows", ROWS), ("ahead", AHEAD),
                         ("emformer", EMFORMER)):
        seen = {k: n for k, n in counts.items() if n}
        if seen:
            out[kind] = seen
    return out


def reset_counters() -> None:
    for row in LAUNCHES:
        LAUNCHES[row] = 0
    for counts in (ROWS, AHEAD, EMFORMER):
        for name in counts:
            counts[name] = 0
    _SYNCS.clear()


def _sync() -> None:
    """Waits for the current CUDA device, if this process has used one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def phase_timer(name: str, enabled: bool = True, file=None):
    """Wall-clock a phase (the DEBUG_TIME equivalent), as a span.

    Where enabled, the clock is read after the current CUDA device has
    finished its queued work, at the start and at the end, so the time
    covers the phase's device work and not only its launches; otherwise
    the phase is only its span, with no sync and no print.
    """
    if enabled:
        _sync()
    t0 = time.perf_counter()
    with span(name):
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
