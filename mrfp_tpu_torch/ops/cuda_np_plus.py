"""The NP+ apply ``x * alpha + shift``: the CUDA kernel's wrapper and its
plain PyTorch version.

The kernel (``csrc/np_plus_apply.cu``) replaces
mrfp_tpu/ops/pallas_np_plus.py::np_plus_apply_pallas. Both versions take
NCHW ``x`` and (N, C, 1, 1) coefficients, multiply and add in fp32 (each
op rounded, no FMA), and round once to ``x.dtype``, so they agree bit for
bit. The kernel moves 16 bytes an access where ``np_plus_vector_width``
allows it, one value otherwise.
"""

from __future__ import annotations

import torch

from mrfp_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, alpha: torch.Tensor, shift: torch.Tensor) -> None:
    want = (x.shape[0], x.shape[1], 1, 1)
    if x.dim() != 4 or tuple(alpha.shape) != want or tuple(shift.shape) != want:
        raise ValueError(f"np_plus_apply takes NCHW x and (N, C, 1, 1) coefficients, got "
                         f"{tuple(x.shape)}, {tuple(alpha.shape)}, {tuple(shift.shape)}")


def np_plus_apply_plain(x: torch.Tensor, alpha: torch.Tensor,
                        shift: torch.Tensor) -> torch.Tensor:
    _check(x, alpha, shift)
    return (x.float() * alpha.float() + shift.float()).to(x.dtype)


def np_plus_vector_width(itemsize: int, hw: int, *ptrs: int) -> int:
    """Values of x one access of the kernel moves: 16 bytes' worth (the
    vector route) when a plane of ``hw`` values is a whole number of
    16-byte vectors and every pointer is 16-byte aligned, else 1 (the
    scalar route)."""
    vec = 16 // itemsize
    return vec if hw % vec == 0 and all(p % 16 == 0 for p in ptrs) else 1


def np_plus_apply_cuda(x: torch.Tensor, alpha: torch.Tensor,
                       shift: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises if it cannot."""
    lib = _build.load_library()
    if not (x.is_cuda and alpha.is_cuda and shift.is_cuda):
        raise ValueError("np_plus_apply_cuda needs CUDA tensors")
    if x.dtype not in _DTYPES:
        raise TypeError(f"np_plus_apply_cuda takes float32 or bfloat16, got {x.dtype}")
    _check(x, alpha, shift)
    x = x.contiguous()
    alpha = alpha.float().contiguous()
    shift = shift.float().contiguous()
    out = torch.empty_like(x)
    n, c, h, w = x.shape
    vec = np_plus_vector_width(x.element_size(), h * w, x.data_ptr(), out.data_ptr())
    with torch.cuda.device(x.device):
        err = lib.mrfp_np_plus_apply(
            x.data_ptr(), alpha.data_ptr(), shift.data_ptr(), out.data_ptr(), n * c, h * w,
            vec, _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "np_plus_apply")
    _build.LAUNCHES["np_plus_apply"] += 1
    return out
