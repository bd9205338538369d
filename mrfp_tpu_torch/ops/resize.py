"""Bilinear align_corners=True resize with PyTorch's semantics, NCHW.

The reference upsamples with ``F.interpolate(mode='bilinear',
align_corners=True)`` (network/mynn.py:114-119): source coordinate
``dst * (in-1)/(out-1)``. The tap tables are computed on the host in float64
numpy, with the JAX package's rule (mrfp_tpu/ops/resize.py:157-166), and
cached on the device per ``(in, out, device)``, so no call rebuilds them.

On a CUDA tensor every bilinear resize goes through the hand-written kernel
(``ops/cuda_resize.py``); on a CPU tensor through its plain PyTorch version.
Nearest resizes belong to the train path and are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mrfp_tpu_torch.ops import cuda_resize

Taps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@functools.lru_cache(maxsize=None)
def bilinear_ac_weights(in_size: int, out_size: int):
    """(idx0, idx1, frac) for align_corners=True bilinear along one axis."""
    if out_size == 1:
        src = np.zeros(1, dtype=np.float64)
    else:
        src = np.arange(out_size, dtype=np.float64) * ((in_size - 1) / (out_size - 1))
    idx0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    idx1 = np.minimum(idx0 + 1, in_size - 1)
    frac = (src - idx0).astype(np.float32)
    return idx0, idx1, frac


_TAPS: Dict[tuple, Taps] = {}


def bilinear_taps(in_size: int, out_size: int, device: torch.device) -> Taps:
    """Device tensors (idx0 int32, idx1 int32, frac float32), cached."""
    key = (in_size, out_size, str(device))
    taps = _TAPS.get(key)
    if taps is None:
        i0, i1, f = bilinear_ac_weights(in_size, out_size)
        taps = (torch.as_tensor(i0.astype(np.int32), device=device),
                torch.as_tensor(i1.astype(np.int32), device=device),
                torch.as_tensor(f, device=device))
        _TAPS[key] = taps
    return taps


def resize_bilinear_align_corners(x: torch.Tensor, size: Tuple[int, int],
                                  impl: Optional[str] = None) -> torch.Tensor:
    """Resize NCHW ``x`` to ``size`` = (oh, ow); returns ``x`` itself when the
    size is unchanged (as mrfp_tpu/ops/resize.py:195-196 does).

    ``impl="plain"`` forces the plain version on any device. It exists only
    so that tests and ``chip_smoke.py`` can hold the kernel against it.
    """
    if x.dim() != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    h, w = x.shape[2], x.shape[3]
    oh, ow = int(size[0]), int(size[1])
    if (h, w) == (oh, ow):
        return x
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    ty, tx = bilinear_taps(h, oh, x.device), bilinear_taps(w, ow, x.device)
    if impl == "plain" or x.device.type == "cpu":
        return cuda_resize.resize_bilinear_plain(x, ty, tx)
    return cuda_resize.resize_bilinear_cuda(x, ty, tx)
