"""Faults planted underneath the timed path, for the tests and for reading
the faults' numbers on the card (``calibrate.py``). Each is a context
manager that patches the program while it is active; the benchmark's own
runs plant none.

* ``answer``: an answer altered where it is produced. A served request's
  first frame gets its logits negated (its class becomes the least
  likely); an extraction's first frame gets its feature 6 (mean |x|)
  scaled by 1.01.
* ``half_batch``: each training step takes the first half of its batch
  and the mean over it.
* ``unchanged``: the optimizer's step returns and leaves the state as it
  was.
* ``skip_steps``: past set-up's first steps, every other training step is
  skipped and returns the step before's loss and accuracy (an epoch that
  steps only some of its batches).
"""

from __future__ import annotations

import contextlib

__all__ = ["FAULTS", "planted"]

#: the faults each kind of traffic can have
FAULTS = {"serve": ("answer",), "extract": ("answer",),
          "train": ("half_batch", "unchanged", "skip_steps")}


@contextlib.contextmanager
def _patch(obj, name: str, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _serve_answer():
    from amcpy_tpu_torch.serve import AMCPipeline

    orig = AMCPipeline.logits

    def logits(self, frames):
        out = orig(self, frames).clone()
        out[0] = -out[0]
        return out

    return _patch(AMCPipeline, "logits", logits)


def _extract_answer():
    from amcpy_tpu_torch import extraction

    orig = extraction.extract_batch

    def extract_batch(*args, **kwargs):
        out = orig(*args, **kwargs)
        out[0, 5] *= 1.01
        return out

    return _patch(extraction, "extract_batch", extract_batch)


def _half_batch():
    from amcpy_tpu_torch.train import training

    orig = training.train_step

    def train_step(model, optimizer, xb, yb, *args, **kwargs):
        half = xb.shape[0] // 2
        return orig(model, optimizer, xb[:half], yb[:half], *args, **kwargs)

    return _patch(training, "train_step", train_step)


def _skip_steps():
    from amcpy_tpu_torch.train import training

    from port_bench.drivers.train import CHECK_STEPS

    orig = training.train_step
    calls, last = [0], [None]

    def train_step(*args, **kwargs):
        calls[0] += 1
        if calls[0] > CHECK_STEPS and calls[0] % 2 == 0:
            return last[0]
        last[0] = orig(*args, **kwargs)
        return last[0]

    return _patch(training, "train_step", train_step)


def _unchanged():
    import torch

    return _patch(torch.optim.RMSprop, "step", lambda self, closure=None: None)


_MAKERS = {("serve", "answer"): _serve_answer, ("extract", "answer"): _extract_answer,
           ("train", "half_batch"): _half_batch, ("train", "unchanged"): _unchanged,
           ("train", "skip_steps"): _skip_steps}


def planted(kind: str, fault: str | None):
    """The fault ``fault`` of ``kind``'s traffic, or nothing."""
    if fault is None:
        return contextlib.nullcontext()
    return _MAKERS[(kind, fault)]()
