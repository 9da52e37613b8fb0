"""Faults planted under an entry's timed call, for the tests that show the
comparison catches them and for the readings that set the limits.

Each is a context manager over the entry module's seam (``loss_fn`` of
the loss entries, ``step_fn`` of the training entry):

* ``unchanged_state``: a training step that returns its state as it was;
* ``half_batch``: half of the batch left out, the mean (or the costs)
  taken over the rest;
* ``altered_answer``: one cost of each call off by a thousandth.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def unchanged_state(module):
    def make(step):
        def broken(state, batch):
            loss = torch.zeros((), device=batch[0].device)
            return state, {"loss": loss, "step": state.step}
        return broken
    return _patched(module, "step_fn", make)


def half_batch(module):
    if hasattr(module, "step_fn"):
        def make(step):
            def broken(state, batch):
                half = batch[0].shape[0] // 2
                return step(state, tuple(x[:half] for x in batch))
            return broken
        return _patched(module, "step_fn", make)

    def make(loss):
        def broken(logits, *rest):
            half = logits.shape[0] // 2
            costs = loss(logits[:half], *(
                x[:half] if torch.is_tensor(x) else x for x in rest))
            return torch.cat([costs, costs.new_zeros(logits.shape[0] - half)])
        return broken
    return _patched(module, "loss_fn", make)


def altered_answer(module):
    def make(loss):
        def broken(*args):
            costs = loss(*args)
            bump = torch.zeros_like(costs)
            bump[0] = 1e-3
            return costs * (1 + bump)
        return broken
    return _patched(module, "loss_fn", make)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
