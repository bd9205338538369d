"""Confusion matrix: the CUDA kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/confusion_matrix.cu``) replaces
mrfp_tpu/ops/pallas_hist.py::confusion_matrix_pallas. Semantics are that
kernel's: rows = label, cols = pred, and a pixel is dropped when its label
OR its pred lies outside [0, C). (The JAX scatter form,
mrfp_tpu/ops/hist.py:29-30, would alias an out-of-range pred into the next
row; argmax preds never are, so the two agree on the eval path.)
"""

from __future__ import annotations

import torch

from mrfp_tpu_torch.ops import _build

MAX_CLASSES = 128  # the TPU kernel's lane limit; 64 KB of shared memory here


def _check_classes(num_classes: int) -> None:
    if not 0 < num_classes <= MAX_CLASSES:
        raise ValueError(f"num_classes must be in [1, {MAX_CLASSES}], got {num_classes}")


def confusion_matrix_plain(pred: torch.Tensor, label: torch.Tensor,
                           num_classes: int) -> torch.Tensor:
    """int32 (C, C) counts by masked ``torch.bincount``."""
    _check_classes(num_classes)
    pred = pred.reshape(-1).long()
    label = label.reshape(-1).long()
    keep = (label >= 0) & (label < num_classes) & (pred >= 0) & (pred < num_classes)
    flat = torch.bincount(label[keep] * num_classes + pred[keep],
                          minlength=num_classes * num_classes)
    return flat.reshape(num_classes, num_classes).to(torch.int32)


def confusion_matrix_cuda(hist: torch.Tensor, pred: torch.Tensor,
                          label: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Add the counts of (pred, label) into the int32 (C, C) CUDA ``hist``
    in place; returns ``hist``. Raises if the kernel cannot launch."""
    lib = _build.load_library()
    _check_classes(num_classes)
    if not (hist.is_cuda and pred.is_cuda and label.is_cuda):
        raise ValueError("confusion_matrix_cuda needs CUDA tensors")
    if hist.dtype != torch.int32 or hist.shape != (num_classes, num_classes) \
            or not hist.is_contiguous():
        raise ValueError(f"hist must be a contiguous int32 ({num_classes}, "
                         f"{num_classes}) tensor")
    if pred.numel() != label.numel():
        raise ValueError(f"pred and label differ in size: {pred.numel()} vs {label.numel()}")
    pred = pred.reshape(-1).to(torch.int32).contiguous()
    label = label.reshape(-1).to(torch.int32).contiguous()
    with torch.cuda.device(hist.device):
        err = lib.mrfp_confusion_matrix(
            pred.data_ptr(), label.data_ptr(), pred.numel(), num_classes,
            hist.data_ptr(), torch.cuda.current_stream(hist.device).cuda_stream)
    _build.check(err, "confusion_matrix")
    _build.LAUNCHES["confusion_matrix"] += 1
    return hist
