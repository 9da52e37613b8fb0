"""Reads the numbers that decide `correct` over many seeds in one process:
the program's (its timed entry driven as a run drives it, for one cycle)
and, on the seeds asked for, the control's (the reference in the precision
below the configuration's: logits rounded to bfloat16 for a loss cell,
TF32 matmuls for a float32 training cell). The limits in
h100_bench/limits/<cell>.json are set from these readings.

    python3 -m h100_bench.control --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3

Needs the card. One JSON line per seed on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import sys

import torch

from .faults import FAULTS
from .run import HERE, ROOT, by_name, load_json, log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=sorted(FAULTS),
                    help="read the program with this fault planted")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 2
    cell = by_name(load_json(ROOT / "BENCHMARK.json")["workloads"],
                   args.workload)
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(cfg.get("tf32", False))
    module = importlib.import_module(f"h100_bench.entries.{mix['entry']}")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds + [s for s in controls if s not in seeds]:
        drv = module.Entry(cfg, mix, seed, "cuda")
        out = {"workload": args.workload, "seed": seed}
        if seed in seeds:
            fault = (FAULTS[args.fault](module) if args.fault
                     else contextlib.nullcontext())
            with fault:
                steps = len(drv.cycle.batches)
                if mix["entry"] == "train":
                    # As a run: the whole cycle in set-up, then the
                    # window's compared steps.
                    drv.warm()
                    steps = module.COMPARED_STEPS
                else:
                    drv.warm(min(steps, 3))
                for i in range(steps):
                    drv.step(i)
            out[args.fault or "program"] = drv.check({})[0]
        if seed in controls:
            out["control"] = drv.control()
        print(json.dumps(out), flush=True)
        del drv
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
