"""Faults planted under the timed path, for the tests that show the
comparison catches them and for the readings that set its limits.  Each is
a context manager that breaks the port's ``training/steps.py`` where the
fold trainer calls it."""

from __future__ import annotations

import contextlib

from portbench.drive import patched


def _steps():
    from eegnetreplication_tpu_torch.training import steps

    return steps


@contextlib.contextmanager
def unchanged():
    """Every train step returns the state it was given."""
    def wrap(train_step):
        def step(model, state, *args, **kwargs):
            _, loss, norm = train_step(model, state, *args, **kwargs)
            return state, loss, norm
        return step

    with patched(_steps(), "train_step", wrap):
        yield


@contextlib.contextmanager
def half_batch():
    """Every train step sees the first half of its batch, the loss the mean
    over that half."""
    def wrap(train_step):
        def step(model, state, x, y, w, **kwargs):
            half = x.shape[1] // 2
            return train_step(model, state, x[:, :half], y[:, :half],
                              w[:, :half], **kwargs)
        return step

    with patched(_steps(), "train_step", wrap):
        yield


@contextlib.contextmanager
def altered_answer():
    """The first fold's validation answers come out altered where they are
    produced: its logits negated, every trial of every batch."""
    def wrap(eval_forward):
        def forward(*args, **kwargs):
            logits = eval_forward(*args, **kwargs).clone()
            logits[0] = -logits[0]
            return logits
        return forward

    with patched(_steps(), "eval_forward", wrap):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered_answer": altered_answer}
