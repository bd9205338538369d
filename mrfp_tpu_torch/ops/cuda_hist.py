"""Confusion matrix: the CUDA kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/confusion_matrix.cu``) replaces
mrfp_tpu/ops/pallas_hist.py::confusion_matrix_pallas. Semantics are that
kernel's: rows = label, cols = pred, and a pixel is dropped when its label
OR its pred lies outside [0, C). (The JAX scatter form,
mrfp_tpu/ops/hist.py:29-30, would alias an out-of-range pred into the next
row; argmax preds never are, so the two agree on the eval path.) The kernel
reads the eval path's own dtypes (an int64 argmax, a uint8 label), with no
cast pass, and compares each value's range in its own width.
"""

from __future__ import annotations

from typing import NamedTuple

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


# the dtypes the kernel reads as they are (any other is cast to int32 first)
PRED_DTYPES = {torch.int32: 0, torch.int64: 1}
LABEL_DTYPES = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}


class HistPlan(NamedTuple):
    """The dtypes the kernel reads pred and label in (a cast to int32 where
    the given one is not native) and whether it loads 16-byte vectors (both
    arrays 16-byte aligned; a cast array is a fresh, aligned allocation)."""
    pred_dtype: torch.dtype
    label_dtype: torch.dtype
    vec: bool


def hist_plan(pred_dtype: torch.dtype, label_dtype: torch.dtype, pred_ptr: int,
              label_ptr: int) -> HistPlan:
    pd = pred_dtype if pred_dtype in PRED_DTYPES else torch.int32
    ld = label_dtype if label_dtype in LABEL_DTYPES else torch.int32
    vec = (pd != pred_dtype or pred_ptr % 16 == 0) and (ld != label_dtype or label_ptr % 16 == 0)
    return HistPlan(pd, ld, vec)


def confusion_matrix_cuda(hist: torch.Tensor, pred: torch.Tensor, label: torch.Tensor,
                          num_classes: int) -> torch.Tensor:
    """Add the counts of (pred, label) into the int32 (C, C) CUDA ``hist``
    in place; returns ``hist``. pred int32/int64 and label uint8/int32/int64
    are read as they are; another integer dtype is cast to int32 here, an
    explicit conversion. Raises if the kernel cannot launch."""
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
    pred, label = pred.reshape(-1).contiguous(), label.reshape(-1).contiguous()
    plan = hist_plan(pred.dtype, label.dtype, pred.data_ptr(), label.data_ptr())
    pred, label = pred.to(plan.pred_dtype), label.to(plan.label_dtype)
    with torch.cuda.device(hist.device):
        err = lib.mrfp_confusion_matrix(
            pred.data_ptr(), label.data_ptr(), pred.numel(), num_classes,
            PRED_DTYPES[plan.pred_dtype], LABEL_DTYPES[plan.label_dtype], int(plan.vec),
            hist.data_ptr(), torch.cuda.current_stream(hist.device).cuda_stream)
    _build.check(err, "confusion_matrix")
    _build.LAUNCHES["confusion_matrix"] += 1
    return hist
