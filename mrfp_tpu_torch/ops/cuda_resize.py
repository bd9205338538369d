"""Bilinear resize: the CUDA kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/resize_bilinear.cu``) replaces
mrfp_tpu/ops/pallas_resize.py::resize_bilinear_fused, forward only. On the
TPU that kernel serves only the ASPP image-pool broadcast; the decoder and
logit upsamples take einsum forms chosen for TPU lane padding. The function
is the same at all three sites, so on the card this one kernel serves them
all.

Both functions take the per-axis tap tables ``(idx0, idx1, frac)`` of
``ops.resize.bilinear_taps``, on ``x``'s device.
"""

from __future__ import annotations

import torch

from mrfp_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def resize_bilinear_plain(x: torch.Tensor, ty, tx) -> torch.Tensor:
    """Gather + lerp over the tap tables, in fp32, W-mix first then the H
    taps (the kernel's order), rounded once to ``x.dtype``."""
    iy0, iy1, fy = ty
    ix0, ix1, fx = tx
    xf = x.float()
    xw = xf[..., ix0.long()] * (1 - fx) + xf[..., ix1.long()] * fx
    fy = fy[:, None]
    out = xw[:, :, iy0.long()] * (1 - fy) + xw[:, :, iy1.long()] * fy
    return out.to(x.dtype)


def resize_bilinear_cuda(x: torch.Tensor, ty, tx) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor; raises if it cannot."""
    lib = _build.load_library()
    if not x.is_cuda:
        raise ValueError(f"resize_bilinear_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"resize_bilinear_cuda takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("resize_bilinear_cuda takes NCHW-contiguous input")
    iy0, iy1, fy = ty
    ix0, ix1, fx = tx
    n, c, h, w = x.shape
    oh, ow = iy0.numel(), ix0.numel()
    out = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.mrfp_resize_bilinear(
            x.data_ptr(), out.data_ptr(), iy0.data_ptr(), iy1.data_ptr(),
            fy.data_ptr(), ix0.data_ptr(), ix1.data_ptr(), fx.data_ptr(),
            n * c, h, w, oh, ow, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "resize_bilinear")
    _build.LAUNCHES["resize_bilinear"] += 1
    return out
