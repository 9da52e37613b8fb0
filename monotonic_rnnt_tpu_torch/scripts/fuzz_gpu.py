"""Randomized fuzz sweep: the port's kernel routes against its oracle.

The counterpart of ``scripts/fuzz_tpu.py``, on the card. Each case draws
(``draw_case``) a shape, the dtype, degenerate lengths (S_b = 0, T_b = S_b,
T_b = 1), a blank anywhere in [0, V), a random alignment band and a
logit scale, and holds the kernel route (``monotonic_rnnt_loss`` with
backend='cuda') against the port's oracle (backend='reference') on the
same tensor: costs, gradients (``torch.autograd.grad`` of the summed
costs), feasibility (+inf on the same samples, with a zero gradient
there), and for banded cases the packed band layout (``pack_band`` ->
``monotonic_rnnt_loss_banded`` -> ``unpack_band``). Three dimensions that
fuzz_tpu lacks:

  * scale 50 and 100: there the gradient may overflow (0 * inf) on cells
    whose cost stays finite, in the JAX package's oracle as in the port's,
    so the two gradients' non-finite cells must be the same cells and the
    finite cells agree;
  * sharded: on a one-rank gloo group, ``rnnt_loss_vocab_sharded`` (banded
    cases: ``rnnt_loss_banded_vocab_sharded`` on the band) against the
    unsharded oracle, with sample 0 made a NaN cost by a row of +inf
    logits: costs, gradients and NaN cells;
  * export: one ``export_loss`` artifact a backend ('reference', and
    'cuda' on the card) at EXPORT_SHAPE, exported once a run, called with
    lengths that include T_b = T + 1 and S_b = S + 1: the in-range samples
    against the live call, the others NaN with a zero gradient.

Every run first probes the overflow at fixed inputs (``overflow_probe``):
the NaN-cost input of the ROADMAP with finite logits, scaled by 50, 100
and 1e4, through the deferred route (row 2 makes the gradient), on the
device against the same route on the CPU (the kernels' plain versions)
and the oracle: the same non-finite cells.

fuzz_tpu's pipeline dimension has no counterpart: the port's padded loss
has one CUDA route at every shape.

Tolerances are fuzz_tpu's: costs 2e-3 relative to max(1, |cost|) (2e-2 in
bf16), gradients 1e-3 absolute (2e-2 in bf16); a bf16 case holds both
routes on the same bf16 tensor. Logits come from a per-case
torch.Generator on the device.

    python -m monotonic_rnnt_tpu_torch.scripts.fuzz_gpu [--cases 30]
        [--seed 0] [--device cuda|cpu] [--json-out FILE]

It prints one ok/FAIL line per case with its reproducer and exits nonzero
at the first disagreement. It runs on the card; on the CPU only when given
--device cpu, where every kernel wrapper takes its plain version.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..ops import bands as bd
from ..parallel import (rnnt_loss_banded_vocab_sharded,
                        rnnt_loss_vocab_sharded)
from ..serving import export_loss, import_fn
from ..utils.provenance import provenance_stamp
from ._cases import (CheckFailed, band_layout, banded_route, check,
                     costs_and_grads, int32, loss_route, one_rank_group,
                     random_alignment, require_device)

# The randomized dimensions each case draws from (recorded in the
# acceptance artifact so the fuzz surface is auditable).
DIMENSIONS = ["B", "T", "S", "V", "blank_id", "bf16", "scale",
              "alignment_band+shift",
              "scale 50/100: non-finite gradient cells",
              "sharded: one-rank gloo group, NaN-cost sample",
              "export: lengths T+1 and S+1"]
B_SET = (1, 2, 3, 8, 17)
T_SET = (1, 4, 9, 33, 100, 257)
V_SET = (2, 3, 17, 100, 384, 1500)
SCALES = (0.5, 2.0, 8.0, 50.0, 100.0)
OVERFLOW_SCALE = 50.0      # from this scale on the gradient may overflow
P_BAND, P_BF16, P_SHARDED, P_EXPORT = 0.4, 0.25, 0.3, 0.3
EXPORT_SHAPE = (4, 12, 4, 37)   # B, T, S, V of the export artifacts


@dataclasses.dataclass
class Case:
    """One drawn configuration; labels, ilen, slen and align are numpy."""

    index: int
    seed: int
    B: int
    T: int
    S: int
    V: int
    blank: int
    bf16: bool
    scale: float
    labels: np.ndarray
    ilen: np.ndarray
    slen: np.ndarray
    shift: Optional[int]
    align: Optional[np.ndarray]
    sharded: bool
    export: bool

    def describe(self) -> str:
        return (f"case {self.index}: seed={self.seed} B={self.B} T={self.T} "
                f"S={self.S} V={self.V} blank={self.blank} bf16={self.bf16} "
                f"scale={self.scale} shift={self.shift} "
                f"sharded={self.sharded} export={self.export}")


def draw_case(rng: np.random.RandomState, index: int = 0) -> Case:
    """The next case from the master generator `rng`: a case seed, then
    every dimension from a RandomState of that seed (fuzz_tpu.py:75-128's
    value sets and order, the added dimensions last)."""
    seed = int(rng.randint(2**31))
    r = np.random.RandomState(seed)
    B = int(r.choice(B_SET))
    T = int(r.choice(T_SET))
    S = int(r.randint(0, min(T, 40) + 1))
    V = int(r.choice(V_SET))
    blank = int(r.randint(0, V))
    bf16 = bool(r.rand() < P_BF16)
    scale = float(r.choice(SCALES))
    pool = np.setdiff1d(np.arange(V), [blank])     # labels avoid the blank
    labels = pool[r.randint(0, len(pool), (B, S))].astype(np.int32)
    ilen = r.randint(max(S, 1), T + 1, (B,)).astype(np.int32)
    slen = np.minimum(r.randint(0, S + 1, (B,)), ilen).astype(np.int32)
    shift = align = None
    if r.rand() < P_BAND:
        shift = int(r.randint(0, 5))
        align = random_alignment(r, ilen, slen, labels, T, blank)
    sharded = bool(r.rand() < P_SHARDED)
    export = bool(r.rand() < P_EXPORT)
    return Case(index, seed, B, T, S, V, blank, bf16, scale, labels, ilen,
                slen, shift, align, sharded, export)


def case_logits(case: Case, dev) -> torch.Tensor:
    """The case's [B, T, S+1, V] logits: N(0, 1) from a torch.Generator on
    `dev` seeded with the case's seed, times its scale, in its dtype."""
    gen = torch.Generator(device=dev).manual_seed(case.seed)
    x = torch.randn((case.B, case.T, case.S + 1, case.V), generator=gen,
                    device=dev) * case.scale
    return x.to(torch.bfloat16) if case.bf16 else x


def compare(got, ref, *, bf16: bool, masks: bool, what: str):
    """(costs, grads) of a route against the oracle's: the same +inf and
    NaN costs, a zero gradient on both sides where the cost is +inf, finite
    costs within 2e-3 (2e-2) of max(1, |cost|), gradients within 1e-3
    (2e-2). With masks, both gradients' non-finite cells must be the same
    cells and only the finite ones are compared; else every cell must be
    finite. Returns (cost err, grad err)."""
    c1, g1 = got
    c2, g2 = ref
    c1, c2 = c1.float(), c2.float()
    g1, g2 = g1.float(), g2.float()
    check(torch.equal(torch.isnan(c1), torch.isnan(c2))
          and torch.equal(torch.isinf(c1), torch.isinf(c2))
          and bool((c1[torch.isinf(c2)] > 0).all()),
          f"{what}: feasibility {c1.tolist()} vs {c2.tolist()}")
    inf = torch.isinf(c2)
    check(bool((g1[inf] == 0).all()) and bool((g2[inf] == 0).all()),
          f"{what}: an infeasible sample's gradient is not zero")
    fin = torch.isfinite(c2)
    ce, c_ref = 0.0, 1.0
    if bool(fin.any()):
        ce = float((c1 - c2)[fin].abs().max())
        c_ref = max(c_ref, float(c2[fin].abs().max()))
    tol_c, tol_g = (2e-2, 2e-2) if bf16 else (2e-3, 1e-3)
    check(ce <= tol_c * c_ref, f"{what}: cost err {ce}")
    bad1, bad2 = ~torch.isfinite(g1), ~torch.isfinite(g2)
    if masks:
        differ = torch.nonzero(bad1 != bad2)
        check(differ.numel() == 0,
              f"{what}: non-finite gradient cells differ: {int(bad1.sum())} "
              f"vs {int(bad2.sum())}; first cells "
              f"{differ[:8].tolist()}")
    else:
        check(not bool(bad1.any()) and not bool(bad2.any()),
              f"{what}: non-finite gradients ({int(bad1.sum())} vs "
              f"{int(bad2.sum())} cells)")
    ok = ~bad2
    ge = float((g1 - g2)[ok].abs().max()) if bool(ok.any()) else 0.0
    check(ge <= tol_g, f"{what}: grad err {ge}")
    return ce, ge


def nan_cost_input(scale: float = 1.0):
    """The ROADMAP's NaN-cost input with every logit finite, scaled by
    `scale`: (logits, labels, ilen, slen) as numpy, blank 0."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 4, 5).astype(np.float32)
    labels = rng.randint(1, 5, (2, 3)).astype(np.int32)
    return ((x * np.float32(scale)).astype(np.float32), labels,
            np.array([6, 5], np.int32), np.array([3, 2], np.int32))


def overflow_probe(dev, log=print):
    """The overflow at large margins, at fixed inputs (nan_cost_input at c
    = 50, 100, 1e4): on the deferred route (rows 1-2) the device's
    gradient has its non-finite values on the same cells as the same route
    on the CPU (the plain versions) and as the oracle, and the finite cells
    agree. Returns the worst |d|."""
    worst = 0.0
    for scale in (50.0, 100.0, 1e4):
        x, labels, ilen, slen = nan_cost_input(scale)
        ref = costs_and_grads(lambda z: loss_route(
            z, *int32(dev, labels, ilen, slen), backend="reference"),
            torch.from_numpy(x).to(dev))
        got, plain = (costs_and_grads(lambda z: loss_route(
            z, *int32(d, labels, ilen, slen), backend="cuda"),
            torch.from_numpy(x).to(d)) for d in (dev, "cpu"))
        what = f"overflow probe c={scale:g}"
        for other, name in ((plain, "plain"), (ref, "oracle")):
            other = tuple(t.to(dev) for t in other)
            worst = max(worst, *compare(got, other, bf16=False, masks=True,
                                        what=f"{what} vs {name}"))
        log(f"overflow probe c={scale:g}: non-finite gradient cells oracle "
            f"{int((~torch.isfinite(ref[1])).sum())}, deferred route "
            f"{int((~torch.isfinite(got[1])).sum())} (the same cells as its "
            "plain versions')")
    return worst


class Fuzz:
    """One sweep's state: the device, the one-rank group of the sharded
    dimension and the export artifacts (made at their first use)."""

    def __init__(self, dev, group, log=print):
        self.dev, self.group, self.log = dev, group, log
        self.artifacts = None

    def export_artifacts(self):
        if self.artifacts is None:
            b, t, s, v = EXPORT_SHAPE
            example = (torch.zeros((b, t, s + 1, v), device=self.dev),
                       *int32(self.dev, np.ones((b, s)), np.full(b, t),
                                 np.full(b, s)))
            backends = ("reference", "cuda") if self.dev.type == "cuda" else (
                "reference",)
            t0 = time.perf_counter()
            self.artifacts = {name: import_fn(export_loss(
                *example, device=str(self.dev), backend=name))
                for name in backends}
            self.log(f"export artifacts {list(self.artifacts)} at B,T,S,V="
                     f"{EXPORT_SHAPE}: {time.perf_counter() - t0:.1f} s")
        return self.artifacts

    def run_case(self, case: Case) -> float:
        """Every check of one case; returns its worst |d| against the
        oracle (costs and gradients). Raises CheckFailed."""
        dev = self.dev
        x = case_logits(case, dev)
        labels, ilen, slen = int32(dev, case.labels, case.ilen, case.slen)
        bands = None
        if case.align is not None:
            bands = bd.bands_from_alignment(
                torch.as_tensor(case.align, device=dev), ilen, slen,
                case.shift, case.blank)
        masks = case.scale >= OVERFLOW_SCALE
        kw = dict(bf16=case.bf16, masks=masks)

        def padded(backend, z):
            return loss_route(z, labels, ilen, slen, backend=backend,
                              blank=case.blank, bands=bands)

        got = costs_and_grads(lambda z: padded("cuda", z), x)
        ref = costs_and_grads(lambda z: padded("reference", z), x)
        errs = list(compare(got, ref, what="kernel route", **kw))
        layout = None
        if bands is not None:
            layout = band_layout(ilen, slen, bands, case.T, case.S + 1)
            c3, g3 = costs_and_grads(lambda z: banded_route(
                z, labels, ilen, slen, bands, backend="cuda",
                blank=case.blank), bd.pack_band(x, layout))
            errs += compare((c3, bd.unpack_band(g3, layout, case.S + 1)),
                            ref, what="packed band layout", **kw)
        if case.sharded:
            errs += self.sharded(case, x, labels, ilen, slen, bands, layout)
        if case.export:
            errs += self.export(case)
        return max(errs)

    def sharded(self, case, x, labels, ilen, slen, bands, layout):
        """The vocab-sharded losses on the one-rank group against the
        unsharded oracle, sample 0 a NaN cost (its lattice cell (0, 0) a
        row of +inf logits); banded cases also on the band `layout`."""
        x = x.clone()
        x[0, 0, 0, :] = float("inf")
        kw = dict(bf16=case.bf16, masks=True)
        b = bands or bd.default_bands(ilen, slen, case.T)
        got = costs_and_grads(lambda z: rnnt_loss_vocab_sharded(
            z, labels, ilen, slen, b.min_s, b.max_s, case.blank,
            self.group), x)
        ref = costs_and_grads(lambda z: loss_route(
            z, labels, ilen, slen, backend="reference", blank=case.blank,
            bands=bands), x)
        check(bool(torch.isnan(ref[0][0])) or bool(torch.isinf(ref[0][0])),
              f"sharded: sample 0's cost {float(ref[0][0])} is finite")
        errs = list(compare(got, ref, what="vocab-sharded", **kw))
        if bands is not None:
            xb = bd.pack_band(x, layout)
            got = costs_and_grads(lambda z: rnnt_loss_banded_vocab_sharded(
                z, labels, ilen, slen, bands.min_s, bands.max_s, case.blank,
                self.group), xb)
            ref = costs_and_grads(lambda z: banded_route(
                z, labels, ilen, slen, bands, backend="reference",
                blank=case.blank), xb)
            errs += compare(got, ref, what="banded vocab-sharded", **kw)
        return errs

    def export(self, case):
        """Each artifact at lengths drawn from the case's seed: sample 0
        past the padded shape (T_b = T + 1 or S_b = S + 1), the others past
        it with probability 1/2. Out-of-range samples cost NaN with an
        all-zero gradient (JAX's artifact); the rest are held against the
        live call on the same backend, at lengths cut into range."""
        b, t, s, v = EXPORT_SHAPE
        r = np.random.RandomState(case.seed + 1)
        gen = torch.Generator(device=self.dev).manual_seed(case.seed + 1)
        x = torch.randn((b, t, s + 1, v), generator=gen, device=self.dev) * 2
        labels = r.randint(1, v, (b, s)).astype(np.int32)
        ilen = r.randint(s, t + 1, (b,))
        slen = np.minimum(r.randint(0, s + 1, (b,)), ilen)
        past = r.rand(b) < 0.5
        past[0] = True
        to_t = r.rand(b) < 0.5
        ilen = np.where(past & to_t, t + 1, ilen)
        slen = np.where(past & ~to_t, s + 1, slen)
        ilen = np.maximum(ilen, slen)
        out = torch.as_tensor((ilen > t) | (slen > s), device=self.dev)
        il_in = np.minimum(ilen, t)
        sl_in = np.minimum(np.minimum(slen, s), il_in)
        args = int32(self.dev, labels, ilen, slen)
        errs = []
        for backend, artifact in self.export_artifacts().items():
            what = f"export[{backend}] at ilen {ilen.tolist()} slen " \
                   f"{slen.tolist()}"
            costs, grads = artifact(x, *args)
            check(bool(torch.isnan(costs[out]).all()),
                  f"{what}: out-of-range costs {costs[out].tolist()}")
            check(bool((grads[out] == 0).all()),
                  f"{what}: an out-of-range sample's gradient is not all "
                  "zero")
            live = costs_and_grads(lambda z: loss_route(
                z, *int32(self.dev, labels, il_in, sl_in),
                backend=backend), x)
            keep = ~out
            errs += compare((costs[keep], grads[keep]),
                            (live[0][keep], live[1][keep]), bf16=False,
                            masks=False, what=what)
        return errs


def run(cases: int, seed: int, dev, log=print) -> dict:
    """The sweep: the overflow probe, then `cases` drawn cases, stopping at
    the first failure. Returns {ok, failed_case, max_abs_err, seconds,
    drawn}: drawn counts the passed cases of each added dimension (and of
    the banded and bf16 ones)."""
    t0 = time.perf_counter()
    drawn = {"overflow_scale": 0, "sharded": 0, "export": 0, "banded": 0,
             "bf16": 0}
    record = {"ok": False, "failed_case": None, "max_abs_err": 0.0,
              "drawn": drawn}
    with one_rank_group() as group:
        fuzz = Fuzz(dev, group, log)
        master = np.random.RandomState(seed)
        what = "overflow probe"
        try:
            record["max_abs_err"] = overflow_probe(dev, log)
            for i in range(cases):
                case = draw_case(master, i)
                what = case.describe()
                err = fuzz.run_case(case)
                record["max_abs_err"] = max(record["max_abs_err"], err)
                for key, hit in (("overflow_scale",
                                  case.scale >= OVERFLOW_SCALE),
                                 ("sharded", case.sharded),
                                 ("export", case.export),
                                 ("banded", case.align is not None),
                                 ("bf16", case.bf16)):
                    drawn[key] += int(hit)
                log(f"ok   {what}  (max |d| {err:.2e})")
            record["ok"] = True
        except CheckFailed as exc:
            log(f"FAIL {what}: {exc}")
            record["failed_case"] = what
        finally:
            record["seconds"] = time.perf_counter() - t0
    if record["ok"]:
        log(f"all {cases} fuzz cases passed in {record['seconds']:.1f} s; "
            f"drawn: {json.dumps(drawn)}")
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cases", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json-out", default=None)
    args = p.parse_args(argv)
    dev = require_device(args.device, "fuzz_gpu")
    record = run(args.cases, args.seed, dev)
    if args.json_out:
        Path(args.json_out).write_text(json.dumps({
            "cases": args.cases, "seed": args.seed, "ok": record["ok"],
            "dimensions": DIMENSIONS, "failed_case": record["failed_case"],
            "seconds": record["seconds"],
            "max_abs_err": record["max_abs_err"], "drawn": record["drawn"],
            "provenance": provenance_stamp(seed=args.seed,
                                           device=str(dev))}) + "\n")
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
