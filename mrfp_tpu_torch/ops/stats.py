"""Per-channel sums and train-mode BatchNorm moments
(mrfp_tpu/ops/pallas_stats.py), NCHW.

``channel_sums(x)`` returns the fp32 (sum of x, sum of x^2) per channel of
``x`` (N, C, ...). The JAX package keeps its Pallas kernel beside a jnp
reduction and routes every call to the jnp one; the port has one public
function, the hand-written kernel on a CUDA tensor and its plain version on
a CPU tensor (``ops/cuda_channel_sums.py``), with the JAX package's custom
backward ``dx = g1 + 2 x g2``. Nothing on the train or eval path calls it:
the port's BatchNorm is torch's, and the fused path takes its sums from
``dot_with_stats``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from mrfp_tpu_torch.ops import cuda_channel_sums
from mrfp_tpu_torch.ops.resize import _use_kernel


class ChannelSums(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kernel: bool):
        ctx.save_for_backward(x)
        if kernel:
            return cuda_channel_sums.channel_sums_cuda(x)
        return cuda_channel_sums.channel_sums_plain(x)

    @staticmethod
    def backward(ctx, g1, g2):
        (x,) = ctx.saved_tensors
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dx = g1.float().reshape(shape) + 2.0 * x.float() * g2.float().reshape(shape)
        return dx.to(x.dtype), None


def channel_sums(x: torch.Tensor, impl: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (sum(x), sum(x*x)) per channel (dim 1) over every other dim."""
    return ChannelSums.apply(x, _use_kernel(x, impl))


def channel_stats(x: torch.Tensor, impl: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (mean, biased var) per channel: the train-mode BN moments, with
    the one-pass variance of the JAX package."""
    n = math.prod(x.shape) // x.shape[1]
    s1, s2 = channel_sums(x, impl)
    mean = s1 / n
    return mean, s2 / n - mean * mean
