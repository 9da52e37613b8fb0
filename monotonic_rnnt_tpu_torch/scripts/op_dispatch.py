"""Host cost of one call of an operator in each ``torch.library`` form.

Defines two operators that compute ``x.clone()``, one with
``torch.library.custom_op`` and one with ``torch.library.Library``
(``define``, ``impl`` for CPU and CUDA, ``register_fake``), in a namespace
of their own, and times on the host clock ``calls`` calls of each and of
``Tensor.clone`` itself on a small tensor, the device synchronised at the
end of each run. Prints each form's median over ``runs`` runs in µs a call,
and its excess over ``Tensor.clone``: the dispatch cost an operator adds
to each kernel wrapper's call.

    python -m monotonic_rnnt_tpu_torch.scripts.op_dispatch [--device cuda]
        [--calls 10000] [--runs 3]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

_NS = "mrnnt_dispatch_probe"


def _define_ops():
    """The two forms of one operator: (custom_op, Library op)."""

    @torch.library.custom_op(f"{_NS}::clone_custom", mutates_args=(),
                             device_types=("cpu", "cuda"))
    def clone_custom(x: torch.Tensor) -> torch.Tensor:
        return x.clone()

    @clone_custom.register_fake
    def _(x):
        return torch.empty_like(x)

    lib = torch.library.Library(_NS, "FRAGMENT")
    lib.define("clone_lib(Tensor x) -> Tensor")
    for key in ("CPU", "CUDA"):
        lib.impl("clone_lib", lambda x: x.clone(), key)
    torch.library.register_fake(f"{_NS}::clone_lib", torch.empty_like,
                                lib=lib)
    return clone_custom, torch.ops.mrnnt_dispatch_probe.clone_lib, lib


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def per_call_us(fn, x, calls: int, runs: int) -> float:
    """Median over runs of (host time of `calls` calls of fn(x)) / calls."""
    for _ in range(100):
        fn(x)
    times = []
    for _ in range(runs):
        _sync(x.device)
        start = time.perf_counter()
        for _ in range(calls):
            fn(x)
        _sync(x.device)
        times.append((time.perf_counter() - start) / calls * 1e6)
    return statistics.median(times)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--calls", type=int, default=10000)
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", flush=True)
        return 1
    clone_custom, clone_lib, _lib = _define_ops()
    x = torch.zeros((8, 16), device=device)
    forms = {"Tensor.clone": torch.Tensor.clone,
             "custom_op": clone_custom,
             "Library.define+impl": clone_lib}
    us = {name: per_call_us(fn, x, args.calls, args.runs)
          for name, fn in forms.items()}
    base = us["Tensor.clone"]
    result = {"device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "calls": args.calls, "runs": args.runs,
              "us_per_call": us,
              "dispatch_us": {k: v - base for k, v in us.items()
                              if k != "Tensor.clone"}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
