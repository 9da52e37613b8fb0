"""The card's fuzz sweep (``monotonic_rnnt_tpu_torch.scripts.fuzz_gpu``) on
the CPU, where every kernel wrapper takes its plain version.

``draw_case`` is deterministic for a seed and covers each of fuzz_tpu's
value sets and each added dimension (scale 50/100, sharded, export); the
smoke run's cases (chip_smoke.py's ACCEPTANCE_CASES at seed 0) hold at
least one case of each added dimension. Six small drawn cases (B*T*S1*V
at most SMALL_CAP) pass every check of the sweep and are held against
the JAX package's ``rnnt_loss_reference`` on the same logits, with the
sweep's own comparator and tolerances (fuzz_tpu's: costs 2e-3 relative,
gradients 1e-3; 2e-2 in bf16; the non-finite cells equal at scale 50 and
100). A planted gradient error fails a case and the sweep; without CUDA
and without --device cpu the sweep exits nonzero.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monotonic_rnnt_tpu.ops.bands import \
    bands_from_alignment as j_bands_from_alignment
from monotonic_rnnt_tpu.ops.reference import rnnt_loss_reference as j_ref
from monotonic_rnnt_tpu_torch.ops.reference import compute_stats
from monotonic_rnnt_tpu_torch.scripts import fuzz_gpu as F
from monotonic_rnnt_tpu_torch.scripts._cases import (CheckFailed,
                                                     costs_and_grads, int32,
                                                     one_rank_group)

ROOT = Path(__file__).resolve().parents[1]
SMALL_CAP = 5000
N_DRAWS = 300


def _draws(seed, n):
    master = np.random.RandomState(seed)
    return [F.draw_case(master, i) for i in range(n)]


def _small_cases(n=6):
    cases = [c for c in _draws(0, 40)
             if c.B * c.T * (c.S + 1) * c.V <= SMALL_CAP]
    return cases[:n]


SMALL = _small_cases()


@pytest.fixture(scope="module")
def fuzz():
    with one_rank_group() as group:
        yield F.Fuzz(torch.device("cpu"), group, log=lambda msg: None)


def test_draw_case_is_deterministic_for_a_seed():
    def fields(c):
        return [np.asarray(v).tolist() if v is not None else None
                for v in vars(c).values()]

    a, b = _draws(3, 20), _draws(3, 20)
    assert [fields(x) for x in a] == [fields(x) for x in b]
    assert [fields(x) for x in a] != [fields(x) for x in _draws(4, 20)]


def test_draw_case_covers_every_value_set_and_added_dimension():
    cases = _draws(0, N_DRAWS)
    assert {c.B for c in cases} == set(F.B_SET)
    assert {c.T for c in cases} == set(F.T_SET)
    assert {c.V for c in cases} == set(F.V_SET)
    assert {c.scale for c in cases} == set(F.SCALES)
    assert {c.shift for c in cases} == {None, 0, 1, 2, 3, 4}
    for flag in ("bf16", "sharded", "export"):
        assert {getattr(c, flag) for c in cases} == {False, True}
    assert all(c.S <= min(c.T, 40) for c in cases)
    assert min(c.S for c in cases) == 0 and max(c.S for c in cases) >= 38
    # Degenerate lengths: S_b = 0, T_b = S_b (> 0) and T_b = 1.
    assert any((c.slen == 0).any() for c in cases)
    assert any(((c.ilen == c.slen) & (c.slen > 0)).any() for c in cases)
    assert any((c.ilen == 1).any() for c in cases)
    # The blank anywhere in [0, V), never among the labels.
    assert any(c.blank == c.V - 1 for c in cases)
    assert any(0 < c.blank < c.V - 1 for c in cases)
    assert all(not (c.labels == c.blank).any() for c in cases)
    assert all((c.ilen >= c.slen).all() and (c.ilen <= c.T).all()
               for c in cases)


def test_the_smoke_runs_cases_hold_each_added_dimension():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cases = _draws(smoke.ACCEPTANCE_SEED, smoke.ACCEPTANCE_CASES)
    assert any(c.scale >= F.OVERFLOW_SCALE for c in cases)
    assert any(c.sharded for c in cases)
    assert any(c.export for c in cases)


def test_the_small_cases_span_the_dimensions():
    assert len(SMALL) == 6
    assert {c.bf16 for c in SMALL} == {False, True}
    assert any(c.scale >= F.OVERFLOW_SCALE for c in SMALL)
    assert any(c.align is not None for c in SMALL)
    assert any(c.sharded for c in SMALL) and any(c.export for c in SMALL)


def _jax_oracle(case, x):
    """The JAX oracle's (costs, grads) on the case's logits (bf16 as bf16)."""
    xj = jnp.asarray(x.float().numpy())
    if case.bf16:
        xj = xj.astype(jnp.bfloat16)
    la, il, sl = (jnp.asarray(a) for a in (case.labels, case.ilen,
                                           case.slen))
    bands = None
    if case.align is not None:
        bands = j_bands_from_alignment(jnp.asarray(case.align), il, sl,
                                       case.shift, case.blank)
    costs, grads = jax.jit(j_ref, static_argnames=("blank_id",))(
        xj, la, il, sl, blank_id=case.blank, bands=bands)
    return (torch.from_numpy(np.array(costs, np.float32)),
            torch.from_numpy(np.array(grads, np.float32)))


@pytest.mark.parametrize("index", range(6))
def test_small_drawn_case_passes_and_matches_jax(fuzz, index):
    """Every check of the sweep on the case, then its kernel route (the
    plain versions) against the JAX oracle on the same logits."""
    case = SMALL[index]
    fuzz.run_case(case)
    x = F.case_logits(case, "cpu")
    labels, ilen, slen = int32("cpu", case.labels, case.ilen,
                                    case.slen)
    bands = None
    if case.align is not None:
        bands = F.bd.bands_from_alignment(torch.from_numpy(case.align), ilen,
                                          slen, case.shift, case.blank)
    got = costs_and_grads(lambda z: F.loss_route(
        z, labels, ilen, slen, backend="cuda", blank=case.blank,
        bands=bands), x)
    want = _jax_oracle(case, x)
    # XLA's exp on the CPU flushes a subnormal result to 0; torch's (and
    # the card's) keeps it. Where p(v|t,s) is subnormal, a near-overflowing
    # coefficient (scale 50 and 100) makes a finite p * coef ~1 here and 0
    # in JAX: those finite cells are left out of the values (the non-finite
    # cells are still held to be the same).
    denom = compute_stats(x, labels, slen, case.blank).denom
    p = torch.exp(x.float() + denom[..., None])
    sub = (p > 0) & (p < torch.finfo(torch.float32).tiny)
    g_got, g_want = got[1].float(), want[1]
    skip = sub & torch.isfinite(g_got) & torch.isfinite(g_want)
    F.compare((got[0], torch.where(skip, 0.0, g_got)),
              (want[0], torch.where(skip, 0.0, g_want)), bf16=case.bf16,
              masks=case.scale >= F.OVERFLOW_SCALE,
              what=f"{case.describe()} vs JAX")


def _plant(monkeypatch):
    """The kernel route's gradient off by 0.1 on its first cell (costs
    unchanged)."""
    route = F.loss_route

    def planted(z, *args, backend, **kw):
        costs = route(z, *args, backend=backend, **kw)
        if backend == "cuda":
            first = z.reshape(-1)[0].float()
            costs = costs + (first - first.detach()) * 0.1
        return costs

    monkeypatch.setattr(F, "loss_route", planted)


def test_a_planted_gradient_error_fails_the_case_and_the_sweep(
        fuzz, monkeypatch, capsys):
    case = next(c for c in SMALL if not c.bf16)
    fuzz.run_case(case)
    _plant(monkeypatch)
    with pytest.raises(CheckFailed, match="grad err"):
        fuzz.run_case(case)
    assert F.main(["--device", "cpu", "--cases", "1"]) != 0
    assert "FAIL" in capsys.readouterr().out


def test_without_cuda_the_sweep_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit) as exc:
        F.main(["--cases", "1"])
    assert exc.value.code not in (0, None)


def test_a_cpu_sweep_writes_its_record(tmp_path):
    out = tmp_path / "fuzz.json"
    assert F.main(["--device", "cpu", "--cases", "2", "--json-out",
                   str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["failed_case"] is None
    assert (rec["cases"], rec["seed"]) == (2, 0)
    assert rec["dimensions"] == F.DIMENSIONS
    assert rec["provenance"]["device"] == "cpu"
