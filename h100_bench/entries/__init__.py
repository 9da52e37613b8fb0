"""Timed entries, one module per entry; a mix names its module.

Each module has an ``Entry(cfg, mix, seed, device)`` that makes its inputs
from the seed on the device, and:

* ``warm(steps=None)``: every shape of the cycle once (or its first
  `steps`), before the window;
* ``step(i) -> dict``: the window's i-th call, and the work it did, by the
  names the metric readers sum (``loss_audio_s``, ``least_s``,
  ``train_audio_s``, ``model_flops``);
* ``trace_batches()`` and ``traced_step(j) -> dict``: the traced window;
* ``check(limits) -> (numbers, attempted, failed)``: after the window,
  the numbers that decide `correct`, from the plain reference;
* ``control() -> numbers``: the same numbers for the reference in the
  precision below the configuration's (for the limits' readings).
"""
