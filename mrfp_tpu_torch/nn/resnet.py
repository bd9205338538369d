"""ResNet-50 backbone with the reference's iw instrumentation, NCHW.

The D/D4/D16/D32 dilation surgery that the reference performs on built
modules (deepv3.py:184-189) is a constructor-time stride/dilation plan, as
in mrfp_tpu/nn/resnet.py. Module names follow the reference's state_dict
(``layer0.0``, ``layer1.0.conv1``, ``layer1.0.downsample.0``, ...), so the
paper's checkpoints load with ``strict=True``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from mrfp_tpu_torch.nn.layers import conv1x1_with_stats, conv2d, max_pool_3x3_s2
from mrfp_tpu_torch.nn.norms import batch_norm, batch_norm_from_stats, make_iw_layer
from mrfp_tpu_torch.ops.dot_stats import FUSION_OFF, bn_stats_fusion_impl

# variant -> {stage_index (0-based): (stride, dilation)} overrides
_VARIANT_PLAN = {
    "D":   {2: (1, 2), 3: (1, 4)},             # os 8
    "D4":  {1: (1, 2), 2: (1, 4), 3: (1, 8)},  # os 4
    "D16": {3: (1, 2)},                        # os 16
    "D32": {},                                 # os 32
}
_DEFAULT_STRIDES = (1, 2, 2, 2)


def variant_output_stride(variant: str) -> int:
    return {"D": 8, "D4": 4, "D16": 16, "D32": 32}.get(variant, 32)


def stage_plan(variant: str) -> List[Tuple[int, int]]:
    """Per-stage (stride, dilation), resolving the variant overrides."""
    over = _VARIANT_PLAN.get(variant, {})
    return [over.get(i, (_DEFAULT_STRIDES[i], 1)) for i in range(4)]


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride, dilation) -> 1x1 x4 (Resnet.py:148-227), with an
    optional iw layer after the residual add.

    ``inject``, the matchstick perturbation (Resnet.py:229-334;
    mrfp_tpu/nn/resnet.py:102-115), is an optional ``(site, value)`` added
    inside the block: site 1 adds ``value`` to conv1's input while the
    residual and the downsample read the unperturbed x; site 2 adds it to
    conv2's input."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False, iw: int = 0):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = conv2d(in_ch, planes, 1)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv2d(planes, planes, 3, stride, dilation, dilation)
        self.bn2 = batch_norm(planes)
        self.conv3 = conv2d(planes, out_ch, 1)
        self.bn3 = batch_norm(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(conv2d(in_ch, out_ch, 1, stride),
                                         batch_norm(out_ch))
                           if downsample else None)
        self.instance_norm_layer = make_iw_layer(iw, out_ch)

    def forward(self, x: torch.Tensor, inject: Optional[Tuple[int, torch.Tensor]] = None
                ) -> torch.Tensor:
        fused_impl = bn_stats_fusion_impl()
        if self.training and fused_impl is not FUSION_OFF:
            return self._forward_fused(x, fused_impl, inject)
        site, value = inject if inject is not None else (0, None)
        out = self.relu(self.bn1(self.conv1(x + value if site == 1 else x)))
        if site == 2:
            out = out + value
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self._finish(out + residual)

    def _forward_fused(self, x: torch.Tensor, impl,
                       inject: Optional[Tuple[int, torch.Tensor]] = None) -> torch.Tensor:
        """The train forward with ``cfg.train.fuse_bn_stats``: conv1/bn1,
        conv3/bn3 and the downsample pair take their BN moments from the
        1x1 product's own sums (mrfp_tpu/nn/resnet.py:130-143); the same
        modules and parameters, and the same ``inject``, as ``forward``."""
        site, value = inject if inject is not None else (0, None)
        conv1_in = x + value if site == 1 else x
        out = self.relu(batch_norm_from_stats(self.bn1,
                                              *conv1x1_with_stats(self.conv1, conv1_in, impl)))
        if site == 2:
            out = out + value
        out = self.relu(self.bn2(self.conv2(out)))
        out = batch_norm_from_stats(self.bn3, *conv1x1_with_stats(self.conv3, out, impl))
        residual = x
        if self.downsample is not None:
            conv, bn = self.downsample
            residual = batch_norm_from_stats(bn, *conv1x1_with_stats(conv, x, impl))
        return self._finish(out + residual)

    def _finish(self, out: torch.Tensor) -> torch.Tensor:
        if self.instance_norm_layer is not None:
            out = self.instance_norm_layer(out)
        return self.relu(out)


class Stage(nn.Sequential):
    """One residual stage, its blocks children ``0``, ``1``, ...; ``inject``
    is an optional ``(block, site, value)`` that routes a matchstick
    perturbation into one block (mrfp_tpu/nn/resnet.py:163-175,278-283)."""

    def forward(self, x: torch.Tensor,
                inject: Optional[Tuple[int, int, torch.Tensor]] = None) -> torch.Tensor:
        for i, block in enumerate(self):
            x = block(x, inject[1:] if inject is not None and inject[0] == i else None)
        return x


def _stage(in_ch: int, planes: int, blocks: int, stride: int, dilation: int,
           iw: int) -> Stage:
    """One residual stage; the iw code lands on the LAST block only
    (Resnet.py:579-584)."""
    out_ch = planes * Bottleneck.expansion
    layers = []
    for i in range(blocks):
        layers.append(Bottleneck(
            in_ch if i == 0 else out_ch, planes,
            stride=stride if i == 0 else 1, dilation=dilation,
            downsample=(i == 0 and (stride != 1 or in_ch != out_ch)),
            iw=iw if i == blocks - 1 else 0))
    return Stage(*layers)


class ResNet(nn.Module):
    """Stem (``layer0``) + four stages (``layer1``..``layer4``). A model
    takes them as its own children, the way the reference's DeepLabV3+
    takes them from its trunk (deepv3.py:170-189), so this class has no
    forward of its own. ``wt_layer[2]`` picks the stem norm and
    ``wt_layer[3:]`` the stages' iw codes; ``wt_layer[0:2]`` belong to the
    deep stem of resnet-101, which is not ported."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3),
                 wt_layer: Tuple[int, ...] = (0,) * 7, variant: str = "D16"):
        super().__init__()
        # stem norm selected by wt_layer[2] (Resnet.py:525-549)
        stem_norm = make_iw_layer(wt_layer[2], 64) if wt_layer[2] else batch_norm(64)
        self.layer0 = nn.Sequential(conv2d(3, 64, 7, 2, 3), stem_norm,
                                    nn.ReLU(inplace=True), max_pool_3x3_s2())
        in_ch = 64
        for i, (planes, (stride, dilation)) in enumerate(
                zip((64, 128, 256, 512), stage_plan(variant))):
            self.add_module(f"layer{i + 1}", _stage(
                in_ch, planes, layers[i], stride, dilation, wt_layer[3 + i]))
            in_ch = planes * Bottleneck.expansion


def resnet50(**kw) -> ResNet:
    return ResNet(layers=(3, 4, 6, 3), **kw)


_TRUNKS = {"resnet-50": resnet50}


def build_trunk(trunk: str, **kw) -> ResNet:
    if trunk not in _TRUNKS:
        raise NotImplementedError(f"trunk {trunk!r} is not ported yet (only "
                                  f"resnet-50): see ROADMAP item A12")
    return _TRUNKS[trunk](**kw)
