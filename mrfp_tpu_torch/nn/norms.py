"""Norm layers and the per-block ``iw`` factory (network/Resnet.py:79-113).

torch's own layers have the semantics the JAX package copies
(mrfp_tpu/nn/norms.py): BatchNorm2d with eps 1e-5, momentum 0.1 and the
unbiased running variance; InstanceNorm2d with per-sample statistics and no
running buffers. The port covers iw codes 0 (none) and 4 (affine
InstanceNorm), the codes of the paper's model.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

IW_NONE, IW_IN_AFFINE = 0, 4


def batch_norm(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


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
