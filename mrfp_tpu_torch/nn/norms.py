"""Norm layers and the per-block ``iw`` factory (network/Resnet.py:79-113).

torch's own layers have the semantics the JAX package copies
(mrfp_tpu/nn/norms.py): BatchNorm2d with eps 1e-5, momentum 0.1 and the
unbiased running variance; InstanceNorm2d with per-sample statistics and no
running buffers. The port covers iw codes 0 (none) and 4 (affine
InstanceNorm), the codes of the paper's model.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

IW_NONE, IW_IN_AFFINE = 0, 4


def batch_norm(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


def batch_norm_from_stats(bn: nn.BatchNorm2d, y: torch.Tensor, s1: torch.Tensor,
                          s2: torch.Tensor, n: int) -> torch.Tensor:
    """Train-mode ``bn`` on ``y`` with the moments taken from the fp32
    per-channel sums ``s1 = sum(y)``, ``s2 = sum(y^2)`` over ``n`` values
    (a producer's statistics epilogue, ``ops/dot_stats.py``), as the JAX
    package's ``BatchNorm(stats=...)`` does (mrfp_tpu/nn/norms.py:43-69):
    mean = s1/n and the one-pass var = s2/n - mean^2. The running statistics
    move as torch's do (momentum, unbiased var * n/(n-1),
    ``num_batches_tracked``), in ``bn``'s own buffers; the normalisation is
    fp32, cast to ``y``'s dtype. The gradient reaches ``y``, ``s1`` and
    ``s2``."""
    mean = s1 / n
    var = s2 / n - mean * mean
    if bn.track_running_stats:
        with torch.no_grad():
            bn.num_batches_tracked.add_(1)
            m = bn.momentum if bn.momentum is not None else 1.0 / float(bn.num_batches_tracked)
            bn.running_mean.mul_(1 - m).add_(mean, alpha=m)
            bn.running_var.mul_(1 - m).add_(var * (n / max(n - 1, 1)), alpha=m)
    inv = torch.rsqrt(var + bn.eps)
    shift = -mean * inv
    if bn.affine:
        inv = inv * bn.weight
        shift = bn.bias - mean * inv
    yf = y.to(torch.promote_types(y.dtype, torch.float32))
    out = yf * inv[None, :, None, None] + shift[None, :, None, None]
    return out.to(y.dtype)


def instance_norm_affine(features: int) -> nn.InstanceNorm2d:
    return nn.InstanceNorm2d(features, eps=1e-5, affine=True)


def make_iw_layer(iw: int, features: int) -> Optional[nn.Module]:
    """The post-residual layer for an iw code (0 -> None, 4 -> affine IN)."""
    if iw == IW_NONE:
        return None
    if iw == IW_IN_AFFINE:
        return instance_norm_affine(features)
    raise NotImplementedError(
        f"iw code {iw} (whitening / plain IN / SwitchWhiten) is not ported "
        f"yet: see ROADMAP item A12")
