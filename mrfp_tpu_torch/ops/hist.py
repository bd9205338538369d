"""Streaming confusion matrix on the device, and its numpy counterpart.

Only the C x C int32 histogram ever crosses to the host. Rows are ground
truth, columns prediction (metrics.py:122-126 of the reference). On a CUDA
tensor the counts come from the hand-written kernel (``ops/cuda_hist.py``);
on a CPU tensor from its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mrfp_tpu_torch.ops import cuda_hist


def confusion_matrix_update(hist: torch.Tensor, pred: torch.Tensor,
                            label: torch.Tensor, num_classes: int,
                            impl: Optional[str] = None) -> torch.Tensor:
    """Accumulate int32 (C, C) ``hist`` in place with one batch; returns it.

    ``pred``/``label``: integer tensors of the same size, any shape. A pixel
    whose label or pred lies outside [0, C) is dropped. ``impl="plain"``
    forces the plain version on any device; it exists only so that tests and
    ``chip_smoke.py`` can hold the kernel against it.
    """
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if impl == "plain" or hist.device.type == "cpu":
        return hist.add_(cuda_hist.confusion_matrix_plain(pred, label, num_classes))
    return cuda_hist.confusion_matrix_cuda(hist, pred, label, num_classes)


def fast_hist(pred, label, num_classes: int) -> np.ndarray:
    """numpy equivalent of the reference fast_hist (labels outside [0, C)
    are ignored; preds are taken as they are)."""
    pred = np.asarray(pred).reshape(-1)
    label = np.asarray(label).reshape(-1)
    mask = (label >= 0) & (label < num_classes)
    return np.bincount(
        num_classes * label[mask].astype(int) + pred[mask],
        minlength=num_classes ** 2,
    ).reshape(num_classes, num_classes)
