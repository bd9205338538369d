"""Compute primitives: the bilinear and nearest resizes (each with its
backward), the confusion matrix, the 1x1 product with BatchNorm sums, the
row mix, the per-channel sums, the NP+ apply and the OC branch's fused
stage (``oc_stage``), each a hand-written CUDA kernel on CUDA tensors and a
plain PyTorch version on CPU tensors.
``LAUNCHES`` counts kernel launches per wrapper. Importing the package
registers ``mrfp::resize_bilinear`` (``ops/library.py``), the op through
which the bilinear forward runs, live and in an exported program."""

from mrfp_tpu_torch.ops._build import LAUNCHES, reset_launches
from mrfp_tpu_torch.ops.hist import confusion_matrix_update, fast_hist
from mrfp_tpu_torch.ops.resize import resize_bilinear_align_corners, resize_nearest
from mrfp_tpu_torch.ops import library  # noqa: F401  (registers the mrfp:: ops)

__all__ = ["LAUNCHES", "reset_launches", "confusion_matrix_update", "fast_hist",
           "resize_bilinear_align_corners", "resize_nearest"]
