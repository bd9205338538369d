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
