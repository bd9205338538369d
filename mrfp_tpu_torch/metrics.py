"""Top-level metrics API mirroring the reference metrics.py surface
(mrfp_tpu/metrics.py), over the port's own pieces.

- fast_hist(pred, label, C)      -> numpy confusion matrix (metrics.py:122-126)
- fast_hist_device(hist, ...)    -> accumulate on the device: the
                                    confusion-matrix kernel on the card
                                    (``ops/hist.py``)
- eval(gt, pred)                 -> scalar mIoU (metrics.py:54-58)
- evaluate_eval(hist, ...)       -> per-class table + summary (metrics.py:60-120)
"""

from __future__ import annotations

import numpy as np

from mrfp_tpu_torch.ops.hist import confusion_matrix_update as fast_hist_device
from mrfp_tpu_torch.ops.hist import fast_hist
from mrfp_tpu_torch.train.evaluator import evaluate_hist as evaluate_eval

__all__ = ["fast_hist", "fast_hist_device", "eval", "mean_iou", "evaluate_eval",
           "fast_hist_pasta"]


def eval(gt, pred, num_classes: int = 19) -> float:  # noqa: A001 (reference name)
    """Mean IoU of one prediction/target pair (metrics.py:54-58)."""
    hist = fast_hist(np.asarray(pred), np.asarray(gt), num_classes)
    with np.errstate(divide="ignore", invalid="ignore"):
        iu = np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist))
    return float(np.nanmean(iu))


mean_iou = eval
fast_hist_pasta = fast_hist  # duplicate alias kept by the reference (metrics.py:128-133)
