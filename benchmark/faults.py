"""Faults planted in the program, each the way a later change could break the
timed path, for the readings the limits of ``correct`` are set from
(``calibrate.py --faults``) and for the tests that see ``correct`` come out
false (``tests/test_bench_faults.py``). Each is a context manager that
patches the port's module for the run inside it and restores it after.

- ``state_unchanged``: the optimizer's step returns with the state as it was;
- ``half_batch``: each step on the first half of its batch, the mean over it;
- ``masks_zeroed``: the ISW statistics pass's masks zeroed where it makes
  them (its answer altered where it is produced);
- ``wt_dropped``: the ISW whitening loss made nought where the step computes
  it, so the step trains without it;
- ``preds_bypassed``: the evaluator hands its predictions to the confusion
  matrix past the name the harness keeps them at.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@contextlib.contextmanager
def _patched(owner, name: str, value):
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def state_unchanged():
    return _patched(torch.optim.SGD, "step", lambda self, closure=None: None)


@contextlib.contextmanager
def half_batch():
    from mrfp_tpu_torch.train import step, zoo_step
    train_step, zoo_train_step = step.train_step, zoo_step.zoo_train_step

    def half_train(state, images, labels, cfg, perturb=None, **kw):
        n = images.shape[0] // 2
        if perturb is not None and isinstance(perturb.np0, tuple):
            perturb = dataclasses.replace(perturb, np0=tuple(t[:n] for t in perturb.np0),
                                          np1=tuple(t[:n] for t in perturb.np1))
        return train_step(state, images[:n], labels[:n], cfg, perturb=perturb, **kw)

    def half_zoo(state, images, labels, cfg, masks, counts, dropout=None, **kw):
        n = images.shape[0] // 2
        if isinstance(dropout, torch.Tensor):
            dropout = dropout[:n]
        return zoo_train_step(state, images[:n], labels[:n], cfg, masks, counts,
                              dropout=dropout, **kw)

    with _patched(step, "train_step", half_train), \
            _patched(zoo_step, "zoo_train_step", half_zoo):
        yield


def masks_zeroed():
    from mrfp_tpu_torch.train import zoo_step
    covstat_pass = zoo_step.covstat_pass

    def zeroed(*args, **kw):
        masks, counts = covstat_pass(*args, **kw)
        return [torch.zeros_like(m) for m in masks], counts
    return _patched(zoo_step, "covstat_pass", zeroed)


def wt_dropped():
    from mrfp_tpu_torch.train import zoo_step
    loss = zoo_step.instance_whitening_loss
    return _patched(zoo_step, "instance_whitening_loss", lambda *a, **kw: 0.0 * loss(*a, **kw))


def preds_bypassed():
    from mrfp_tpu_torch.ops import hist
    from mrfp_tpu_torch.train import evaluator
    step = evaluator.SegEvaluator._step

    def bypassing(self, *args, **kw):
        with _patched(evaluator, "confusion_matrix_update", hist.confusion_matrix_update):
            return step(self, *args, **kw)
    return _patched(evaluator.SegEvaluator, "_step", bypassing)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "masks_zeroed": masks_zeroed, "wt_dropped": wt_dropped,
          "preds_bypassed": preds_bypassed}
