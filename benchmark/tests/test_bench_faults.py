"""The harness's run at a small size on the CPU, past its look for a card:
sound, it is correct; with the timed path broken underneath
(``benchmark/faults.py``), ``correct`` comes out false, once for each fault
the cell can have. The training cells run in fp32 here, where the program
matches the reference to rounding, so the faults alone fail the cells'
limits."""

import time

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests.conftest import SMALL

CPU = torch.device("cpu")
TRAIN = ("mrfp_plus_r50_train_b16", "isw_r50_train_b8")
ISW = "isw_r50_train_b8"
EVAL = "mrfp_plus_r50_eval_1024x2048"


def _run(workload):
    small = dict(SMALL["eval" if workload == EVAL else "train"])
    if workload != EVAL:
        small["train.compute_dtype"] = "float32"
    torch.manual_seed(0)
    m = harness.measure(workload, 2 ** 33 + 9, 0.3, False, CPU, time.perf_counter(), small)
    return harness.is_correct(m), m.checks


def _over(checks, name):
    return checks[name]["value"] > checks[name]["limit"]


@pytest.mark.parametrize("workload", TRAIN + (EVAL,))
def test_sound_run_is_correct(workload):
    ok, checks = _run(workload)
    assert ok, checks


@pytest.mark.parametrize("workload", TRAIN)
def test_state_left_unchanged(workload):
    with faults.state_unchanged():
        ok, checks = _run(workload)
    assert not ok and _over(checks, "change"), checks


@pytest.mark.parametrize("workload", TRAIN)
def test_half_of_the_batch_left_out(workload):
    """Each step on the first half of its batch, the mean over that half."""
    with faults.half_batch():
        ok, checks = _run(workload)
    assert not ok, checks


def test_isw_masks_zeroed_where_they_are_made():
    """The statistics pass's answer altered: its masks all nought."""
    with faults.masks_zeroed():
        ok, checks = _run(ISW)
    assert not ok and _over(checks, "masks"), checks


def test_isw_whitening_loss_dropped():
    """The step's whitening term made nought where it is computed."""
    with faults.wt_dropped():
        ok, checks = _run(ISW)
    assert not ok and _over(checks, "loss_wt"), checks


def test_an_answer_altered_where_it_is_made(monkeypatch):
    """The logits of one class raised over a patch before the argmax."""
    from mrfp_tpu_torch.models.mrfp import MRFP
    forward = MRFP.forward

    def altered(self, x, *a, **kw):
        out = forward(self, x, *a, **kw)
        out = out.clone()
        out[:, 3, :8, :8] += 1e3
        return out

    monkeypatch.setattr(MRFP, "forward", altered)
    ok, checks = _run(EVAL)
    assert not ok and _over(checks, "logit_gap"), checks


def test_a_histogram_count_lost(monkeypatch):
    """The confusion matrix drops one pixel of every image."""
    from mrfp_tpu_torch.train import evaluator
    update = evaluator.confusion_matrix_update

    def lossy(hist, pred, label, num_classes, impl=None):
        out = update(hist, pred, label, num_classes, impl)
        first = label.reshape(-1)[0].long().clamp(max=num_classes - 1)
        out.view(-1)[first * (num_classes + 1)] -= 1
        return out

    monkeypatch.setattr(evaluator, "confusion_matrix_update", lossy)
    ok, checks = _run(EVAL)
    assert not ok and checks["hist"]["value"] > 0, checks


def test_predictions_that_pass_the_kept_path_by():
    """The evaluator updates the histogram past the kept predictions: no
    comparison may pass for want of anything to compare."""
    with faults.preds_bypassed():
        ok, checks = _run(EVAL)
    assert not ok and _over(checks, "unkept"), checks
