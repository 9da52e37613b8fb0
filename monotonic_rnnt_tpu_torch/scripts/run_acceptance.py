"""Acceptance on the card: the checks and the fuzz sweep, as one record.

The counterpart of ``scripts/run_acceptance.py``. It runs the acceptance
checks (``gpu_acceptance``) but the two over-cap ones, then the fuzz sweep
(``fuzz_gpu``) in a process of its own, then each over-cap check in a
process of its own, so that one out-of-memory error cannot poison the
allocations of the rest, and writes one JSON record to --out: the port's
provenance, the card's name and power limit (the stamp's ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` line), the elapsed
seconds, every check, the fuzz record and ``ok`` -- the role the reference
library's ``test_gpu.cu`` plays (its kernels against goldens on the
hardware), repeatable and recorded:

    python -m monotonic_rnnt_tpu_torch.scripts.run_acceptance
        [--out ACCEPTANCE.json] [--cases 30] [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..utils.provenance import provenance_stamp
from . import fuzz_gpu, gpu_acceptance
from ._cases import require_device

OVER_CAP = ("over-cap (8,850,299,512)", "over-cap (8,850,299,1024)")
FUZZ_TIMEOUT_S = 3600
CHECK_TIMEOUT_S = 1800


def in_process(module: str, args, timeout_s: float):
    """`python -m <module> *args --json-out tmp` in a process of its own:
    (its exit code, the JSON it wrote or None). Its output goes to ours."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out.json"
        try:
            rc = subprocess.run([sys.executable, "-u", "-m", module, *args,
                                 "--json-out", str(out)],
                                timeout=timeout_s).returncode
        except subprocess.TimeoutExpired:
            rc = -9
        try:
            return rc, json.loads(out.read_text())
        except (OSError, ValueError):   # it died before writing its record
            return rc, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="ACCEPTANCE.json")
    ap.add_argument("--cases", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device, "run_acceptance")
    t0 = time.perf_counter()

    acc = gpu_acceptance.Acceptance(dev, skip=OVER_CAP)
    gpu_acceptance.run(acc)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    pkg = __package__
    rc_fuzz, fuzz_rec = in_process(
        f"{pkg}.fuzz_gpu", ["--cases", str(args.cases), "--seed",
                            str(args.seed), "--device", args.device],
        FUZZ_TIMEOUT_S)
    fuzz_error = None
    if fuzz_rec is None:
        fuzz_error = f"the fuzz process died (rc={rc_fuzz}) before its record"
    elif not fuzz_rec["ok"]:
        fuzz_error = fuzz_rec["failed_case"]
    fuzz_ok = rc_fuzz == 0 and fuzz_error is None

    for name in OVER_CAP:
        rc, rec = in_process(f"{pkg}.gpu_acceptance",
                             ["--only", name, "--device", args.device],
                             CHECK_TIMEOUT_S)
        checks = rec["checks"] if rec is not None else []
        if not checks and dev.type == "cuda":
            checks = [{"name": name, "ok": False,
                       "error": f"its process exited {rc} before a record"}]
        for c in checks:
            acc.results.append(c)
            if not c["ok"]:
                acc.failures.append(c["name"])

    stamp = provenance_stamp(seed=args.seed, device=str(dev))
    record = {
        "provenance": stamp,
        "device": stamp["power_limit"] or "cpu",   # nvidia-smi's line
        "elapsed_s": round(time.perf_counter() - t0, 1),
        "acceptance": {"checks": acc.results,
                       "n_failed": len(acc.failures)},
        "fuzz": {"cases": args.cases, "seed": args.seed,
                 "dimensions": fuzz_gpu.DIMENSIONS, "ok": fuzz_ok,
                 "error": fuzz_error,
                 **{k: (fuzz_rec or {}).get(k)
                    for k in ("seconds", "max_abs_err", "drawn")}},
        "ok": not acc.failures and fuzz_ok,
    }
    Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    print(f"wrote {args.out}: ok={record['ok']}")
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
