"""The port's confusion matrix (plain version, CPU) against the JAX package:
the Pallas kernel it replaces, run in interpret mode, and fast_hist.
Integer counts, so equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.ops.hist import fast_hist as jax_fast_hist
from mrfp_tpu.ops.pallas_hist import confusion_matrix_pallas
from mrfp_tpu_torch.ops.cuda_hist import confusion_matrix_plain
from mrfp_tpu_torch.ops.hist import confusion_matrix_update, fast_hist

torch.set_num_threads(2)


def _labels(rng, shape, num_classes):
    label = rng.integers(0, num_classes, size=shape)
    label[rng.random(shape) < 0.1] = 255      # ignore pixels
    label[rng.random(shape) < 0.02] = -1      # negative labels
    return label


@pytest.mark.parametrize("num_classes,shape", [(19, (2, 40, 56)), (7, (3, 33)),
                                               (128, (5000,))])
def test_plain_equals_pallas_with_out_of_range(num_classes, shape):
    rng = np.random.default_rng(num_classes)
    pred = rng.integers(-2, num_classes + 3, size=shape)   # some out of range
    label = _labels(rng, shape, num_classes)
    got = confusion_matrix_plain(torch.from_numpy(pred), torch.from_numpy(label),
                                 num_classes)
    ref = np.asarray(confusion_matrix_pallas(jnp.asarray(pred), jnp.asarray(label),
                                             num_classes, interpret=True))
    assert got.dtype == torch.int32 and got.shape == (num_classes, num_classes)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_equals_fast_hist_for_in_range_preds():
    rng = np.random.default_rng(0)
    pred = rng.integers(0, 19, size=(3, 64, 64))
    label = _labels(rng, (3, 64, 64), 19)
    hist = torch.zeros(19, 19, dtype=torch.int32)
    got = confusion_matrix_update(hist, torch.from_numpy(pred),
                                  torch.from_numpy(label).to(torch.uint8), 19)
    assert got is hist  # accumulates in place
    np.testing.assert_array_equal(hist.numpy(), jax_fast_hist(pred, label, 19))
    np.testing.assert_array_equal(hist.numpy(), fast_hist(pred, label, 19))


def test_accumulates_across_batches():
    rng = np.random.default_rng(1)
    hist = torch.zeros(19, 19, dtype=torch.int32)
    total = np.zeros((19, 19), np.int64)
    for _ in range(3):
        pred = rng.integers(0, 19, size=(32, 32))
        label = rng.integers(0, 19, size=(32, 32))
        confusion_matrix_update(hist, torch.from_numpy(pred), torch.from_numpy(label), 19)
        total += fast_hist(pred, label, 19)
    np.testing.assert_array_equal(hist.numpy(), total)


def test_rejects_more_than_128_classes():
    with pytest.raises(ValueError, match="128"):
        confusion_matrix_plain(torch.zeros(4, dtype=torch.long),
                               torch.zeros(4, dtype=torch.long), 129)


def _run_structured(rng, rows, w, num_classes):
    """Label runs of 8-64 pixels along each row (class 0 on about 40% of
    runs, 255 on about 10%), and a pred that is the label except on about
    10% of the runs of a second cut and on ignore pixels."""
    def per_pixel(values):
        ends = np.cumsum(rng.integers(8, 65, (rows, w // 8 + 1)), axis=1)
        run = np.stack([np.searchsorted(e, np.arange(w), side="right") for e in ends])
        return np.take_along_axis(values, run, axis=1)
    u = rng.random((rows, w // 8 + 1))
    cls = rng.integers(1, num_classes, u.shape)
    cls[u < 0.4] = 0
    cls[(u >= 0.4) & (u < 0.5)] = 255
    label = per_pixel(cls)
    other = rng.integers(0, num_classes, u.shape)
    wrong = rng.random(u.shape) < 0.1
    pick = per_pixel(np.where(wrong, other, -7))
    pred = np.where((pick != -7) | (label == 255), np.abs(pick) % num_classes, label)
    return label, pred.astype(np.int64)


@pytest.mark.parametrize("label_dtype", [np.uint8, np.int32, np.int64])
def test_plain_equals_pallas_on_a_run_structured_map(label_dtype):
    """A map whose neighbouring pixels share their (label, pred) pair, as
    the kernel's run and warp aggregation expect: uint8 labels with 255
    ignore pixels (and int32 / int64 copies), int64 preds with some out of
    range."""
    rng = np.random.default_rng(7)
    label, pred = _run_structured(rng, 2 * 24, 256, 19)
    spots = rng.integers(0, pred.size, (3, 40))
    for s, v in zip(spots, (-1, 19, 1000)):
        pred.reshape(-1)[s] = v
    label = label.astype(np.uint8).astype(label_dtype).reshape(2, 24, 256)
    pred = pred.reshape(2, 24, 256)
    assert (label == 0).mean() > 0.25 and (label == 255).mean() > 0.04
    got = confusion_matrix_plain(torch.from_numpy(pred), torch.from_numpy(label), 19)
    ref = np.asarray(confusion_matrix_pallas(jnp.asarray(pred.astype(np.int32)),
                                             jnp.asarray(label.astype(np.int32)), 19,
                                             interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.sum().item() == ((label < 19) & (pred >= 0) & (pred < 19)).sum()


def test_plain_drops_int64_preds_that_int32_would_wrap():
    """Ranges are compared in the value's own width: 2^32 + 3 is out of
    range, though int32 would read it as 3."""
    pred = torch.tensor([3, 2 ** 32 + 3, -(2 ** 32) + 1, 5], dtype=torch.int64)
    label = torch.tensor([1, 1, 1, 255], dtype=torch.uint8)
    got = confusion_matrix_plain(pred, label, 19)
    assert got.sum().item() == 1 and got[1, 3].item() == 1
