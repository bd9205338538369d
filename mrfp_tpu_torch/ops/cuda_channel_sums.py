"""Per-channel sums: the CUDA kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/channel_sums.cu``) replaces
mrfp_tpu/ops/pallas_stats.py::_channel_sums_pallas. Both versions return the
fp32 (sum of x, sum of x^2) per channel (dim 1) of ``x`` (N, C, ...), over
every other dim.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from mrfp_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCKS_PER_SM = 8    # how many times over the C x S blocks fill the card
_MIN_PER_SPLIT = 4096  # values a block sums at least


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x: torch.Tensor) -> None:
    if x.dim() < 2:
        raise ValueError(f"channel_sums takes (N, C, ...), got shape {tuple(x.shape)}")


def channel_sums_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two fp32 ``sum`` reductions over every dim but 1."""
    _check(x)
    xf = x.float()
    dims = (0,) + tuple(range(2, x.dim()))
    return xf.sum(dim=dims), (xf * xf).sum(dim=dims)


def channel_sums_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on a CUDA tensor; raises if it cannot."""
    lib = _build.load_library()
    if not x.is_cuda:
        raise ValueError(f"channel_sums_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"channel_sums_cuda takes float32 or bfloat16, got {x.dtype}")
    _check(x)
    x = x.contiguous()
    n, c = x.shape[0], x.shape[1]
    hw = x[0, 0].numel()
    per_channel = n * hw
    want = -(-_BLOCKS_PER_SM * _sm_count(x.device.index or 0) // max(c, 1))
    splits = max(1, min(want, -(-per_channel // _MIN_PER_SPLIT), 65535))
    s1 = torch.empty(c, dtype=torch.float32, device=x.device)
    s2 = torch.empty(c, dtype=torch.float32, device=x.device)
    part = torch.empty((2, splits, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.mrfp_channel_sums(
            x.data_ptr(), part.data_ptr(), splits, s1.data_ptr(), s2.data_ptr(), n, c, hw,
            _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "channel_sums")
    _build.LAUNCHES["channel_sums"] += 1
    return s1, s2
