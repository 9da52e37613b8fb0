"""The card's acceptance sweep (``monotonic_rnnt_tpu_torch.scripts.
gpu_acceptance``) and its record (``run_acceptance``) on the CPU, where
every kernel wrapper takes its plain version.

Each check sized for the CPU passes on its own under --device cpu (each a
case of one parametrised test); the card-sized ones print SKIP; --only and
--skip select by substring; without CUDA and without --device cpu both
entry points exit nonzero; run_acceptance writes one record with every
check, the fuzz sweep's and the device line.
"""

import json

import pytest
import torch

from monotonic_rnnt_tpu_torch.scripts import gpu_acceptance as GA
from monotonic_rnnt_tpu_torch.scripts import run_acceptance as RA

CPU_SIZED = [
    "golden README lattice (kernel route)",
    "parity B=8 T=64 S=16 V=256",
    "parity odd-V lane masking (2,24,7,1003)",
    "cost-only fast path",
    "bf16 inputs (grads written bf16)",
    "dp and dp-tp sharded losses (one-rank gloo group)",
    "dp sharded gradient (deferred route, one-rank gloo group)",
    "dp sharded loss+grad, seed 9 (deferred route, one-rank gloo group)",
    "dp sharded bf16 loss+grad (deferred route, one-rank gloo group)",
    "deferred-gradient route == forward-produced grads * ct",
    "banded packed pipeline (3,64,16,256, shift 2)",
    "banded fused scan == its plain version",
    "fused-joint loss parity (loss + enc/pred/param grads)",
    "streaming greedy+beam(+LM) == full decode",
    "export round-trip == live pipeline",
    "parity blank=V-1 with repeated labels (kernel route)",
]
CPU = torch.device("cpu")


def _offered():
    """Every check of the sweep as (name, card_sized), none of them run."""
    acc = GA.Acceptance(CPU, only=("\0",), log=lambda msg: None)
    GA.run(acc)
    assert acc.results == []
    return acc.offered


def test_the_sweep_offers_tpu_acceptances_checks():
    offered = _offered()
    assert [n for n, card in offered if not card] == CPU_SIZED
    card = [n for n, c in offered if c]
    assert len(card) == 8 and len(offered) == 24
    assert sum("over-cap" in n for n in card) == len(RA.OVER_CAP) == 2
    assert all(any(o in n for n in card) for o in RA.OVER_CAP)


@pytest.mark.parametrize("name", CPU_SIZED)
def test_cpu_sized_check_passes(name):
    lines = []
    acc = GA.Acceptance(CPU, only=(name,), log=lines.append)
    GA.run(acc)
    assert [r["name"] for r in acc.results] == [name], lines
    assert acc.results[0]["ok"], acc.results[0]
    assert acc.failures == []


def test_card_sized_checks_skip_on_the_cpu():
    lines = []
    acc = GA.Acceptance(CPU, only=("over-cap", "large-V"), log=lines.append)
    GA.run(acc)
    assert acc.results == [] and len(lines) == 3
    assert all(line.startswith("SKIP ") and "sized for the card" in line
               for line in lines)


def test_skip_leaves_a_check_out():
    lines = []
    acc = GA.Acceptance(CPU, only=("parity B=8", "odd-V"), skip=("odd-V",),
                        log=lines.append)
    GA.run(acc)
    assert [r["name"] for r in acc.results] == [CPU_SIZED[1]]
    assert any(line.startswith("SKIP parity odd-V") for line in lines)


@pytest.mark.parametrize("module", [GA, RA], ids=["gpu_acceptance",
                                                  "run_acceptance"])
def test_without_cuda_the_entry_point_exits_nonzero(module):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit) as exc:
        module.main([])
    assert exc.value.code not in (0, None)


def test_main_writes_the_checks(tmp_path):
    out = tmp_path / "acc.json"
    assert GA.main(["--device", "cpu", "--only", "cost-only", "--only",
                    "golden", "--json-out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["n_failed"] == 0
    assert [c["name"] for c in rec["checks"]] == [CPU_SIZED[0],
                                                  CPU_SIZED[3]]
    assert all(c["ok"] and c["seconds"] >= 0 for c in rec["checks"])
    assert rec["provenance"]["device"] == "cpu"


def test_run_acceptance_writes_one_record(tmp_path):
    out = tmp_path / "ACCEPTANCE.json"
    assert RA.main(["--device", "cpu", "--cases", "1", "--out",
                    str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["device"] == "cpu"
    assert rec["acceptance"]["n_failed"] == 0
    assert [c["name"] for c in rec["acceptance"]["checks"]] == CPU_SIZED
    fuzz = rec["fuzz"]
    assert fuzz["ok"] and fuzz["error"] is None and fuzz["cases"] == 1
    assert fuzz["dimensions"] and fuzz["seconds"] > 0
    assert rec["elapsed_s"] > 0 and rec["provenance"]["seed"] == 0
