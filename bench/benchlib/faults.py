"""The faults a training cell's check must refuse, each planted around the
port's step builder (``benchlib.program.train_step``) by wrapping the step
it returns.  The limits tool reads them on the card, and the tests see
each make ``correct`` false at test size."""

from __future__ import annotations

import copy


def unchanged_state(step):
    """A train step that returns its state unchanged (it computes on a
    copy and keeps the loss)."""
    def broken(model, opt, batch):
        _, _, metrics = step(copy.deepcopy(model), copy.deepcopy(opt), batch)
        return model, opt, metrics
    return broken


def half_batch(step):
    """A train step that leaves half of each batch out: the mean over the
    rows that remain."""
    def broken(model, opt, batch):
        half = next(iter(batch.values())).shape[0] // 2
        return step(model, opt, {k: v[:half] for k, v in batch.items()})
    return broken


TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch}


def planted(program, name: str):
    """Plant fault ``name`` in ``program`` (the module); returns a function
    that takes it out."""
    wrap = TRAIN[name]
    real = program.train_step
    program.train_step = lambda *a: wrap(real(*a))
    return lambda: setattr(program, "train_step", real)
