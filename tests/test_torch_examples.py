"""Smoke tests of the port's examples (monotonic_rnnt_tpu_torch/examples),
as tests/test_examples.py runs the JAX package's: each runs end to end on
the CPU at a tiny step count and prints or writes sane output. Unmarked:
they are the port's guard that its training and serving entry points run
as a user calls them."""

import json
import math

import re

from monotonic_rnnt_tpu_torch.examples import (realign_restrict,
                                               streaming_demo, train_tiny)


def test_train_tiny_example(tmp_path, capfd):
    out = tmp_path / "train.json"
    rc = train_tiny.main(["--steps", "4", "--batch", "8", "--device", "cpu",
                          "--json-out", str(out)])
    assert rc in (None, 0)
    rec = json.loads(out.read_text())
    losses = [p["loss"] for p in rec["loss_curve"]]
    assert losses and all(math.isfinite(x) for x in losses)
    assert rec["steps"] == 4 and rec["device"] == "cpu"
    out = capfd.readouterr().out
    assert "greedy" in out and "beam-4" in out
    assert re.search(r"beam-4 \[[^\]]*\] \(logp -?\d+\.\d+\)", out)


def test_train_tiny_overfits_one_batch(tmp_path):
    """--overfit repeats the first batch: 20 steps at lr 3e-3 take its
    loss below half of the first one."""
    out = tmp_path / "overfit.json"
    train_tiny.main(["--steps", "20", "--batch", "4", "--overfit",
                     "--device", "cpu", "--json-out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["loss_last"] < 0.5 * rec["loss_first"], rec["loss_curve"]


def test_streaming_demo_example(capfd):
    """tests/test_examples.py::test_streaming_demo_example on the port: the
    streaming decode equals the full-utterance decode, over labels."""
    rc = streaming_demo.main(["--steps", "40", "--chunk", "16",
                              "--device", "cpu"])
    assert rc in (None, 0)
    out = capfd.readouterr().out
    assert "streaming == full-utterance greedy decode: exact" in out
    decoded = re.findall(r"-> decoded \[([^\]]*)\]", out)
    assert any(d.strip() for d in decoded), "demo emitted no labels"


def test_realign_restrict_example(capfd):
    rc = realign_restrict.main(["--warmup", "3", "--restricted", "3",
                                "--realign-every", "2", "--device", "cpu"])
    assert rc in (None, 0)
    out = capfd.readouterr().out
    assert "restricted" in out.lower() and "packed viterbi score" in out
    assert "done: final restricted loss" in out
