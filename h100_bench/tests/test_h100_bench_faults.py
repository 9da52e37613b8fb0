"""A run with its timed path broken underneath comes out not correct.

The harness's look for a card is skipped (``run.execute`` on the CPU, at a
tiny size, with each cell's own limits); the rest of a run is driven as on
the card. Each fault a cell can have is planted once: a loss cell's (padded or
banded) answer
altered where it is produced and half of its batch left out; a training
cell's step returning its state unchanged and half of its batch left out
(one chip: there is no exchange between chips to leave out).
"""

import json

import pytest

from h100_bench import faults, run
from h100_bench.entries import banded as banded_entry
from h100_bench.entries import loss as loss_entry
from h100_bench.entries import train as train_entry

from conftest import tiny_mix

CELLS = {"loss": ("conformer_m.loss.libri", loss_entry),
         "banded": ("conformer_m.loss.libri", banded_entry),
         "train": ("conformer_m.train.libri", train_entry)}


def _run(tiny_model, entry):
    cell, _ = CELLS[entry]
    limits = json.loads((run.HERE / "limits" / f"{cell}.json").read_text())
    metrics = [{"name": "setup_s", "unit": "s"}]
    return run.execute(cell, tiny_model, tiny_mix(entry), limits, metrics,
                       2 ** 31 + 5, 0.2, False, device="cpu", start=0.0)


@pytest.mark.parametrize("entry", sorted(CELLS))
def test_an_unbroken_run_is_correct(tiny_model, entry):
    line = _run(tiny_model, entry)
    assert line["correct"], line["compared"]
    assert list(line)[-1] == "compared"


@pytest.mark.parametrize("entry,fault", [
    ("loss", "altered_answer"), ("loss", "half_batch"),
    ("banded", "altered_answer"), ("banded", "half_batch"),
    ("train", "unchanged_state"), ("train", "half_batch")])
def test_a_fault_is_caught(tiny_model, entry, fault):
    with faults.FAULTS[fault](CELLS[entry][1]):
        line = _run(tiny_model, entry)
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_fault_that_starts_with_the_window_is_caught(tiny_model, fault,
                                                      monkeypatch):
    """A training step that goes wrong only once set-up is over (a path
    swapped in after warm-up) fails the window's numbers, while the start's
    still pass."""
    warm = train_entry.Entry.warm
    planted = []

    def warm_then_break(self, steps=None):
        warm(self, steps)
        planted.append(faults.FAULTS[fault](train_entry))
        planted[-1].__enter__()

    monkeypatch.setattr(train_entry.Entry, "warm", warm_then_break)
    try:
        line = _run(tiny_model, "train")
    finally:
        for p in planted:
            p.__exit__(None, None, None)
    assert not line["correct"]
    compared = line["compared"]
    assert all(c["value"] <= c["limit"] for n, c in compared.items()
               if not n.startswith("window_")), compared
    assert any(c["value"] > c["limit"] for n, c in compared.items()
               if n.startswith("window_")), compared
