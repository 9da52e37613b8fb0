"""Runs one cell of the port's benchmark once.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration and its metrics
come from ``BENCHMARK.json``; everything else is found by name:

* ``h100_bench/configs/<config>.json``: the model's sizes as run;
* ``h100_bench/traffic/<traffic>.json``: the mix, read by traffic.py, and
  the timed entry that serves it (``"entry"``): entries/<entry>.py;
* ``h100_bench/metrics/<metric>.py``: one reader per metric, which turns
  the run's readings into the number (or None where it finds nothing);
* ``h100_bench/limits/<cell>.json``: the limit of each number that the
  comparison with the plain reference reads.

A run makes its inputs from the seed on the card, warms up every shape the
cell's cycle holds (that and everything before it is ``setup_s``), then
calls the entry's timed step back to back for ``--seconds``. With
``--trace 1`` the entry's trace batches follow, once untraced and timed,
then again under torch.profiler. Then the timed path's outputs are held against the plain
reference. The last line of standard output is the result; the numbers
compared, each beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "monotonic_rnnt_tpu")


def _process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat[stat.rindex(")") + 2:].split()[19])
        for line in Path("/proc/stat").read_text().splitlines():
            if line.startswith("btime "):
                return int(line.split()[1]) + ticks / os.sysconf(
                    "SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return time.time()


START = _process_start()
# Kernel caches stay inside the checkout at a fixed path.
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_cache" /
                                              "triton"))

import torch  # noqa: E402


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def by_name(entries, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def cell_metrics(bench: dict, cell: str, section: str):
    """The metrics of `section` that cell reports: those that list it, and
    those without a list whose `moves` metric it reports (end-to-end ones
    without a list: every cell)."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    out = []
    for m in bench[section]:
        if "workloads" in m:
            keep = cell in m["workloads"]
        else:
            keep = section == "end_to_end" or m["moves"] in e2e
        if keep:
            out.append(m)
    return out


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_metric_{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Card:
    """What the run asks of the device: synchronisation and memory peaks
    on the card, nothing on the CPU (where only the tests run it)."""

    def __init__(self, device: str):
        self.device = device
        self.cuda = device.startswith("cuda")

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated() if self.cuda else 0


def execute(cell: str, cfg: dict, mix: dict, limits: dict, metrics,
            seed: int, seconds: float, trace: bool, device: str = "cuda",
            start: float = START) -> dict:
    """One run of a cell; returns the result line (a dict)."""
    card = Card(device)
    parts = {"before_execute_s": time.time() - start}
    # One process with few threads: no host op of a cell runs in parallel.
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(cfg.get("tf32", False))
    if card.cuda:
        from monotonic_rnnt_tpu_torch.ops.cuda import _build
        t = time.perf_counter()
        _build.build()
        parts["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    module = importlib.import_module(f"h100_bench.entries.{mix['entry']}")
    drv = module.Entry(cfg, mix, seed, device)
    card.sync()
    parts["inputs_s"] = time.perf_counter() - t
    parts.update(getattr(drv, "parts", {}))
    t = time.perf_counter()
    drv.warm()
    card.sync()
    parts["warm_s"] = time.perf_counter() - t
    card.reset_peak()
    readings = {"setup_s": time.time() - start}

    work, steps = defaultdict(float), 0
    t0 = time.perf_counter()
    while True:
        for k, v in drv.step(steps).items():
            work[k] += v
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    card.sync()
    readings.update(work, window_s=time.perf_counter() - t0, steps=steps,
                    window_peak_bytes=card.peak())
    if card.cuda:
        readings["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    else:
        readings["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                              "memory_peak_bytes": 0}
    if trace:
        from .trace import traced

        def run():
            total = defaultdict(float)
            for j in drv.trace_batches():
                for k, v in drv.traced_step(j).items():
                    total[k] += v
            return total

        # The same steps untraced first: the profiler's own host cost
        # stretches the traced window, not the device's busy time.
        card.sync()
        t = time.perf_counter()
        run()
        card.sync()
        untraced_s = time.perf_counter() - t
        readings["trace"] = dict(traced(run), untraced_s=untraced_s)
    log(f"{cell}: seed {seed}, {steps} steps in {readings['window_s']:.3f} s,"
        f" set-up {readings['setup_s']:.3f} s " + json.dumps(parts))

    values = {}
    for m in metrics:
        v = reader(m["name"])(readings)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    numbers, attempted, failed = drv.check(limits)
    compared = {n: {"value": v, "limit": limits.get(n)}
                for n, v in numbers.items()}
    correct = failed == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in compared.values())
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": values, "device": readings["device"]}
    if trace:
        t = readings["trace"]
        line["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
        log("traced: " + json.dumps({k: t[k] for k in (
            "busy_s", "window_s", "untraced_s", "device_op_count")}))
    line["setup_parts"] = parts
    line["compared"] = compared
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = by_name(bench["workloads"], args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"torch sees {torch.cuda.device_count()}")
        return 2
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{args.workload}.json")
    section = "per_layer" if args.trace else "end_to_end"
    line = execute(args.workload, cfg, mix, limits,
                   cell_metrics(bench, args.workload, section), args.seed,
                   args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log("the run loaded JAX or the JAX package: " + ", ".join(found))
        return 3
    for name, c in line["compared"].items():
        log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
