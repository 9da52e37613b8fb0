"""chip_smoke.py from two checkouts in turns: the figures a change of the
host prelude may move, parent against change on one card.

    python3 -m monotonic_rnnt_tpu_torch.scripts.smoke_turns PARENT CHANGE \
        [--order pccp] [--out-dir DIR]

PARENT and CHANGE are checkouts of the repository (``git archive``
copies). Each run is ``python3 chip_smoke.py`` from a checkout's root,
its output kept in ``DIR/run<i>-<parent|change>.log``; ``--order`` gives
the turns (``p`` parent, ``c`` change). From each run: the card's name
and power limit; every kernel's ``ms`` (its wrapper, one call from an
idle card, host prelude included) and ``queued_ms`` from the kernels JSON
line; the end-to-end lines' figures (the padded, split and banded
``*fwd_bwd_ms``, the fused-joint and banded fused-joint step ms, and every
other number on those lines); the script's total seconds. Prints one JSON
object: the runs, and for each figure its values in the parent's runs and
in the change's, in run order. Exits nonzero if a run fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# The log lines whose JSON tail holds end-to-end figures, by prefix.
E2E_LINES = {"end-to-end loss at": "padded",
             "end-to-end split loss at": "split",
             "end-to-end banded loss at": "banded",
             "end-to-end fused-joint losses at": "fused_joint",
             "traced routes (": "traced"}
RUN_TIMEOUT_S = 1200


def _flat(prefix, obj, out):
    """Every number in obj (nested dicts) under its dotted key."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flat(f"{prefix}.{k}", v, out)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[prefix] = obj
    return out


def figures(log: str) -> dict:
    """The figures of one chip_smoke.py output."""
    out = {}
    lines = log.splitlines()
    for line in lines:
        if line.startswith('{"kernels": '):
            for k in json.loads(line)["kernels"]:
                for key in ("ms", "queued_ms"):
                    if isinstance(k.get(key), (int, float)):
                        out[f"kernel.{k['name']}.{key}"] = k[key]
        elif line.startswith("total ") and line.endswith(" s"):
            out["total_s"] = float(line.split()[1])
        for prefix, name in E2E_LINES.items():
            if line.startswith(prefix) and ": {" in line:
                _flat(name, json.loads(line[line.index(": {") + 2:]), out)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parent", type=Path)
    parser.add_argument("change", type=Path)
    parser.add_argument("--order", default="pccp")
    parser.add_argument("--out-dir", type=Path,
                        default=Path("tmp") / "smoke_turns")
    args = parser.parse_args(argv)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"p": ("parent", args.parent), "c": ("change", args.change)}
    runs, table = [], {}
    for i, turn in enumerate(args.order, 1):
        label, tree = trees[turn]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                              capture_output=True, text=True,
                              timeout=RUN_TIMEOUT_S)
        log = proc.stdout + proc.stderr
        (args.out_dir / f"run{i}-{label}.log").write_text(log)
        lines = proc.stdout.strip().splitlines()
        runs.append({"run": i, "tree": label, "rc": proc.returncode,
                     "seconds": time.perf_counter() - t0,
                     "card": lines[-2] if len(lines) >= 2 else None})
        print(json.dumps(runs[-1]), flush=True)
        if proc.returncode != 0:
            print(log[-4000:], file=sys.stderr)
            return 1
        for key, value in figures(proc.stdout).items():
            table.setdefault(key, {"parent": [], "change": []})[label].append(
                value)
    print(json.dumps({"runs": runs, "figures": table}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
