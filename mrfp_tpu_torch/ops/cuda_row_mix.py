"""Row mix along H or W: the CUDA kernel's wrapper and its plain PyTorch
version.

The kernel (``csrc/row_mix.cu``) replaces
mrfp_tpu/ops/pallas_resize.py::row_mix_pallas. Both versions compute ``out =
P @ x`` along dim 2 (H) or dim 3 (W) of NCHW ``x`` for an fp32 (out, in)
``P``, summing in fp32 and rounding once to ``x.dtype``.
"""

from __future__ import annotations

import torch

from mrfp_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, p: torch.Tensor, dim: int) -> None:
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 (H) or 3 (W), got {dim}")
    if x.dim() != 4 or p.dim() != 2 or p.shape[1] != x.shape[dim]:
        raise ValueError(f"row_mix takes NCHW x and (out, x.shape[dim]) P, got "
                         f"{tuple(x.shape)}, {tuple(p.shape)}, dim {dim}")


def row_mix_plain(x: torch.Tensor, p: torch.Tensor, dim: int) -> torch.Tensor:
    """One fp32 ``torch.matmul`` (exact for a one-hot P when TF32 is off),
    rounded once to ``x.dtype``."""
    _check(x, p, dim)
    xf = x.float()
    out = torch.matmul(p, xf) if dim == 2 else torch.matmul(xf, p.t())
    return out.to(x.dtype)


def row_mix_cuda(x: torch.Tensor, p: torch.Tensor, dim: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises if it cannot."""
    lib = _build.load_library()
    if not (x.is_cuda and p.is_cuda):
        raise ValueError(f"row_mix_cuda needs CUDA tensors, got {x.device}, {p.device}")
    if x.dtype not in _DTYPES or p.dtype != torch.float32:
        raise TypeError(f"row_mix_cuda takes float32/bfloat16 x and float32 P, got "
                        f"{x.dtype}, {p.dtype}")
    _check(x, p, dim)
    x, p = x.contiguous(), p.contiguous()
    n, c, h, w = x.shape
    on, size_in = p.shape
    shape = (n, c, on, w) if dim == 2 else (n, c, h, on)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    idx = torch.empty((on, size_in), dtype=torch.int32, device=x.device)
    wt = torch.empty((on, size_in), dtype=torch.float32, device=x.device)
    cnt = torch.empty(on, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.mrfp_row_mix(
            x.data_ptr(), p.data_ptr(), out.data_ptr(), idx.data_ptr(), wt.data_ptr(),
            cnt.data_ptr(), n * c, h, w, on, dim, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "row_mix")
    _build.LAUNCHES["row_mix"] += 1
    return out
