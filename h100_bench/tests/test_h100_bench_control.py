"""The control, the reference in the precision below the configuration's,
fails the cell's limits: logits rounded to bfloat16 in the loss cells (at a
tiny size, on the CPU), TF32 matmuls in the float32 training cells (on the
card only: the CPU has no TF32)."""

import json

import pytest
import torch

from h100_bench import run
from h100_bench.entries import banded, loss, train

from conftest import tiny_mix


def _limits(cell):
    return json.loads((run.HERE / "limits" / f"{cell}.json").read_text())


def _fails(numbers, limits):
    return any(numbers[n] > limits[n] for n in numbers)


@pytest.mark.parametrize("module,cell", [
    (loss, "conformer_m.loss.libri"), (banded, "conformer_m.loss.libri")])
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 3, 77777])
def test_bf16_control_fails_a_loss_cell(tiny_model, module, cell, seed):
    drv = module.Entry(tiny_model, tiny_mix(module.__name__.split(".")[-1]),
                        seed, "cpu")
    assert _fails(drv.control(), _limits(cell))


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["conformer_m", "conformer_l"])
def test_tf32_control_fails_a_training_cell(config):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    cfg = json.loads((run.HERE / "configs" / f"{config}.json").read_text())
    mix = dict(tiny_mix("train"), lengths=dict(min_s=8.0, max_s=12.0),
               buckets=1, audio_budget_s=96.0, batches_per_bucket=3)
    drv = train.Entry(cfg, mix, 5, "cuda")
    drv.warm()
    for i in range(train.COMPARED_STEPS):
        drv.step(i)
    assert _fails(drv.control(), _limits(f"{config}.train.libri"))
