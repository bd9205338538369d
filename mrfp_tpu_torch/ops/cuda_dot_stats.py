"""1x1 convolution with BatchNorm sums: the CUDA kernels' wrapper and its
plain PyTorch version.

The kernels (``csrc/dot_stats.cu``) replace
mrfp_tpu/ops/pallas_dot_stats.py::dot_with_stats: a tensor-core kernel for
bf16 whose rows are 16-byte aligned (``tensor_core_route``), and a CUDA-core
kernel for fp32 and every other bf16 shape. Both versions take NCHW
``x`` (N, Cin, H, W) and ``w`` (Cout, Cin) of one dtype, and return ``y =
w @ x`` per sample in that dtype (accumulated in fp32) with the per-channel
sums of the rounded ``y`` and of its square, taken in fp64 and rounded once
to fp32: so the two versions' sums agree bit for bit but for a rare last
bit, whatever order each adds in.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mrfp_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 2 or w.shape[1] != x.shape[1]:
        raise ValueError(f"dot_with_stats takes NCHW x and (Cout, Cin) w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")


def tensor_core_route(dtype: torch.dtype, cin: int, hw: int) -> bool:
    """Whether the tensor-core kernel takes this call: bf16, with ``Cin`` and
    ``H*W`` multiples of 8, so that every row of ``w``, ``x`` and ``y``
    starts 16-byte aligned as its tensor maps need. Decided before the
    launch, by dtype and shape alone."""
    return dtype == torch.bfloat16 and cin > 0 and cin % 8 == 0 and hw % 8 == 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, at a 16-byte aligned address (a copy if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def dot_with_stats_plain(x: torch.Tensor, w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``torch.matmul`` per sample (fp32 accumulation; fp32 stays fp32 when
    TF32 is off), rounded to ``x.dtype``; then two fp64 sums of the rounded
    output, rounded to fp32 (float64 stays float64)."""
    _check_shapes(x, w)
    n, cin, h, wd = x.shape
    y = torch.matmul(w, x.reshape(n, cin, h * wd)).reshape(n, w.shape[0], h, wd)
    yd = y.double()
    out = torch.promote_types(y.dtype, torch.float32)
    return y, yd.sum(dim=(0, 2, 3)).to(out), (yd * yd).sum(dim=(0, 2, 3)).to(out)


def dot_with_stats_cuda(x: torch.Tensor, w: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; raises if it cannot. A strided
    ``x`` (a stride-2 slice) is made contiguous first. The route is
    ``tensor_core_route``'s; both count in ``LAUNCHES["dot_with_stats"]``,
    the tensor-core one also in ``LAUNCHES["dot_with_stats_tc"]``."""
    lib = _build.load_library()
    if not (x.is_cuda and w.is_cuda):
        raise ValueError(f"dot_with_stats_cuda needs CUDA tensors, got {x.device}, {w.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"dot_with_stats_cuda takes float32 or bfloat16 of one dtype, got "
                        f"{x.dtype} and {w.dtype}")
    _check_shapes(x, w)
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    tc = tensor_core_route(x.dtype, cin, h * wd)
    x, w = (_aligned(x), _aligned(w)) if tc else (x.contiguous(), w.contiguous())
    y = torch.empty((n, cout, h, wd), dtype=x.dtype, device=x.device)
    s1 = torch.empty(cout, dtype=torch.float32, device=x.device)
    s2 = torch.empty(cout, dtype=torch.float32, device=x.device)
    parts = lib.mrfp_dot_with_stats_parts(n, cout, h * wd, int(tc))
    part = torch.empty((2, max(parts, 1), cout), dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.mrfp_dot_with_stats(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(), parts,
            s1.data_ptr(), s2.data_ptr(), n, cin, cout, h * wd, _DTYPES[x.dtype], int(tc),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dot_with_stats")
    _build.LAUNCHES["dot_with_stats"] += 1
    if tc:
        _build.LAUNCHES["dot_with_stats_tc"] += 1
    return y, s1, s2
