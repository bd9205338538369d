"""The ResNet family with the reference's iw instrumentation, NCHW
(mrfp_tpu/nn/resnet.py): resnet-18/34 (``BasicBlock``), resnet-50/101/152,
ResNeXt-50 32x4d and -101 32x8d (grouped 3x3) and Wide-ResNet-50/101
(``base_width`` 128), with torchvision's width rule; resnet-101 has the deep
3x3x3 stem (Resnet.py:338-512).

The D/D4/D16/D32 dilation surgery that the reference performs on built
modules (deepv3.py:184-189) is a constructor-time stride/dilation plan, as
in mrfp_tpu/nn/resnet.py. Module names follow the reference's state_dict
(``layer0.0``, ``layer1.0.conv1``, ``layer1.0.downsample.0``, ...; the deep
stem ``layer0.0/1/3/4/6/7``), so the paper's checkpoints load with
``strict=True``.

Whitening maps (iw codes 1 and 2) are collected only when a forward passes
a ``w_arr`` list: each instrumented norm appends its output, before the
ReLU, in the order the modules run (mrfp_tpu/nn/norms.py:250-260). No state
is kept on a module, so a ``torch.export`` trace of the eval forward, which
passes no list, leaves nothing behind.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mrfp_tpu_torch.nn.layers import conv1x1_with_stats, conv2d, max_pool_3x3_s2
from mrfp_tpu_torch.nn.norms import (IW_LAYERS, apply_iw, batch_norm, batch_norm_from_stats,
                                     collects_map, make_iw_layer)
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


def deepest_rows(h: int, variant: str) -> int:
    """The rows of the trunk's deepest map for an input of ``h`` rows: one
    stride-2 window op, ``(h - 1) // 2 + 1``, per halving of the output
    stride. It is the smallest map of the MRFP forward."""
    for _ in range(variant_output_stride(variant).bit_length() - 1):
        h = (h - 1) // 2 + 1
    return h


def stage_plan(variant: str) -> List[Tuple[int, int]]:
    """Per-stage (stride, dilation), resolving the variant overrides."""
    over = _VARIANT_PLAN.get(variant, {})
    return [over.get(i, (_DEFAULT_STRIDES[i], 1)) for i in range(4)]


def _finish(block: nn.Module, out: torch.Tensor, w_arr: Optional[list]) -> torch.Tensor:
    """A block's tail: the iw layer after the residual add, then the ReLU.
    A whitening map goes to ``w_arr`` and the ReLU then makes a new tensor,
    so the kept map is not overwritten."""
    layer = block.instance_norm_layer
    out = apply_iw(layer, out, w_arr)
    if w_arr is not None and collects_map(layer):
        return F.relu(out)
    return block.relu(out)


class BasicBlock(nn.Module):
    """Two 3x3 convs (Resnet.py:73-145), expansion 1. conv1 takes the
    stride and both take the dilation, the JAX package's DeepLab semantics
    (mrfp_tpu/nn/resnet.py:51-58): the reference's surgery, which rewrites
    only ``conv2`` and ``downsample.0``, would leave conv1's stride in a
    dilated stage. Matchstick ``inject`` is Bottleneck-only, as in JAX."""

    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, iw: int = 0):
        super().__init__()
        self.conv1 = conv2d(in_ch, planes, 3, stride, dilation, dilation)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv2d(planes, planes, 3, 1, dilation, dilation)
        self.bn2 = batch_norm(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(conv2d(in_ch, planes, 1, stride), batch_norm(planes))
                           if downsample else None)
        self.instance_norm_layer = make_iw_layer(iw, planes)

    def forward(self, x: torch.Tensor, inject: Optional[Tuple[int, torch.Tensor]] = None,
                w_arr: Optional[list] = None) -> torch.Tensor:
        if inject is not None:
            raise ValueError("the matchstick inject is Bottleneck-only, as in the JAX "
                             "package (mrfp_tpu/nn/resnet.py:163)")
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return _finish(self, out + residual, w_arr)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride, dilation) -> 1x1 x4 (Resnet.py:148-227), with an
    optional iw layer after the residual add. ``groups`` and
    ``base_width`` give ResNeXt and Wide-ResNet with torchvision's width
    rule, ``int(planes * base_width / 64) * groups`` for the inner convs
    (mrfp_tpu/nn/resnet.py:101); the 3x3 is grouped.

    ``inject``, the matchstick perturbation (Resnet.py:229-334;
    mrfp_tpu/nn/resnet.py:102-115), is an optional ``(site, value)`` added
    inside the block: site 1 adds ``value`` to conv1's input while the
    residual and the downsample read the unperturbed x; site 2 adds it to
    conv2's input."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False, iw: int = 0,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        out_ch = planes * self.expansion
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = conv2d(in_ch, width, 1)
        self.bn1 = batch_norm(width)
        self.conv2 = conv2d(width, width, 3, stride, dilation, dilation, groups=groups)
        self.bn2 = batch_norm(width)
        self.conv3 = conv2d(width, out_ch, 1)
        self.bn3 = batch_norm(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(conv2d(in_ch, out_ch, 1, stride),
                                         batch_norm(out_ch))
                           if downsample else None)
        self.instance_norm_layer = make_iw_layer(iw, out_ch)

    def forward(self, x: torch.Tensor, inject: Optional[Tuple[int, torch.Tensor]] = None,
                w_arr: Optional[list] = None) -> torch.Tensor:
        fused_impl = bn_stats_fusion_impl()
        if self.training and fused_impl is not FUSION_OFF:
            return self._forward_fused(x, fused_impl, inject, w_arr)
        site, value = inject if inject is not None else (0, None)
        out = self.relu(self.bn1(self.conv1(x + value if site == 1 else x)))
        if site == 2:
            out = out + value
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return _finish(self, out + residual, w_arr)

    def _forward_fused(self, x: torch.Tensor, impl,
                       inject: Optional[Tuple[int, torch.Tensor]] = None,
                       w_arr: Optional[list] = None) -> torch.Tensor:
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
        return _finish(self, out + residual, w_arr)


class Stage(nn.Sequential):
    """One residual stage, its blocks children ``0``, ``1``, ...; ``inject``
    is an optional ``(block, site, value)`` that routes a matchstick
    perturbation into one block (mrfp_tpu/nn/resnet.py:163-175,278-283);
    ``w_arr`` collects the whitening maps."""

    def forward(self, x: torch.Tensor,
                inject: Optional[Tuple[int, int, torch.Tensor]] = None,
                w_arr: Optional[list] = None) -> torch.Tensor:
        for i, block in enumerate(self):
            x = block(x, inject[1:] if inject is not None and inject[0] == i else None, w_arr)
        return x


class Stem(nn.Sequential):
    """``layer0``: conv(s), norm, ReLU, max pool, as the reference's
    Sequential (Resnet.py:587-598, 471-496). With ``w_arr``, a whitening
    norm's output is appended and its ReLU makes a new tensor."""

    def forward(self, x: torch.Tensor, w_arr: Optional[list] = None) -> torch.Tensor:
        kept = False
        for m in self:
            if kept and isinstance(m, nn.ReLU):
                x, kept = F.relu(x), False
                continue
            if isinstance(m, IW_LAYERS):
                x = apply_iw(m, x, w_arr)
                kept = w_arr is not None and collects_map(m)
            else:
                x = m(x)
        return x


def _stage(block_cls, in_ch: int, planes: int, blocks: int, stride: int, dilation: int,
           iw: int, **extra) -> Stage:
    """One residual stage; the iw code lands on the LAST block only
    (Resnet.py:579-584). ``extra`` (groups, base_width) goes to Bottleneck."""
    out_ch = planes * block_cls.expansion
    layers = []
    for i in range(blocks):
        layers.append(block_cls(
            in_ch if i == 0 else out_ch, planes,
            stride=stride if i == 0 else 1, dilation=dilation,
            downsample=(i == 0 and (stride != 1 or in_ch != out_ch)),
            iw=iw if i == blocks - 1 else 0, **extra))
    return Stage(*layers)


def _stem_norm(code: int, features: int) -> nn.Module:
    """A stem slot's norm: BatchNorm for code 0, else the iw layer
    (Resnet.py:525-549)."""
    return make_iw_layer(code, features) if code else batch_norm(features)


class ResNet(nn.Module):
    """Stem (``layer0``) + four stages (``layer1``..``layer4``). A model
    takes them as its own children, the way the reference's DeepLabV3+
    takes them from its trunk (deepv3.py:170-189), so this class has no
    forward of its own. ``block`` is ``"basic"`` or ``"bottleneck"``;
    ``layers`` the blocks a stage (the tests build every structural option
    at reduced depth). ``wt_layer[2]`` picks the stem norm and
    ``wt_layer[3:]`` the stages' iw codes; the deep stem (resnet-101) also
    reads ``wt_layer[0:2]`` for its first two norms and ends at 128
    channels. ``stem_channels`` and ``stage_channels`` are the widths a
    head reads."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3), block: str = "bottleneck",
                 wt_layer: Tuple[int, ...] = (0,) * 7, variant: str = "D16",
                 deep_stem: bool = False, groups: int = 1, base_width: int = 64):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"block must be 'basic' or 'bottleneck', got {block!r}")
        block_cls = Bottleneck if block == "bottleneck" else BasicBlock
        extra = dict(groups=groups, base_width=base_width) if block_cls is Bottleneck else {}
        relu = lambda: nn.ReLU(inplace=True)  # noqa: E731
        if deep_stem:
            self.layer0 = Stem(conv2d(3, 64, 3, 2, 1), _stem_norm(wt_layer[0], 64), relu(),
                               conv2d(64, 64, 3, 1, 1), _stem_norm(wt_layer[1], 64), relu(),
                               conv2d(64, 128, 3, 1, 1), _stem_norm(wt_layer[2], 128), relu(),
                               max_pool_3x3_s2())
            in_ch = 128
        else:
            self.layer0 = Stem(conv2d(3, 64, 7, 2, 3), _stem_norm(wt_layer[2], 64), relu(),
                               max_pool_3x3_s2())
            in_ch = 64
        self.stem_channels = in_ch
        for i, (planes, (stride, dilation)) in enumerate(
                zip((64, 128, 256, 512), stage_plan(variant))):
            self.add_module(f"layer{i + 1}", _stage(
                block_cls, in_ch, planes, layers[i], stride, dilation, wt_layer[3 + i],
                **extra))
            in_ch = planes * block_cls.expansion
        self.stage_channels = tuple(p * block_cls.expansion for p in (64, 128, 256, 512))


# trunk name -> ResNet arguments (mrfp_tpu/nn/resnet.py:297-343)
_TRUNKS = {
    "resnet-18": dict(block="basic", layers=(2, 2, 2, 2)),
    "resnet-34": dict(block="basic", layers=(3, 4, 6, 3)),
    "resnet-50": dict(block="bottleneck", layers=(3, 4, 6, 3)),
    "resnet-101": dict(block="bottleneck", layers=(3, 4, 23, 3), deep_stem=True),
    "resnet-152": dict(block="bottleneck", layers=(3, 8, 36, 3)),
    "resnext-50": dict(block="bottleneck", layers=(3, 4, 6, 3), groups=32, base_width=4),
    "resnext-101": dict(block="bottleneck", layers=(3, 4, 23, 3), groups=32, base_width=8),
    "wide_resnet-50": dict(block="bottleneck", layers=(3, 4, 6, 3), base_width=128),
    "wide_resnet-101": dict(block="bottleneck", layers=(3, 4, 23, 3), base_width=128),
}
RESNET_TRUNKS = tuple(_TRUNKS)


def check_trunk(trunk: str) -> None:
    """Raise ValueError for a trunk MRFP cannot carry: the zoo's other
    trunks with the JAX package's message (mrfp_tpu/models/mrfp.py:96-98),
    and a name neither package knows."""
    from mrfp_tpu_torch.models.deepv3_zoo import ZOO_TRUNKS  # the zoo builds on this module
    if trunk in _TRUNKS:
        return
    if trunk in ZOO_TRUNKS:
        raise ValueError(f"unsupported trunk {trunk!r} for MRFP "
                         f"(zoo trunks live in models.deepv3_zoo)")
    raise ValueError(f"unknown trunk {trunk!r}; have {sorted(RESNET_TRUNKS + tuple(ZOO_TRUNKS))}")


def build_trunk(trunk: str, **kw) -> ResNet:
    """One of the nine ResNet trunks by name; ``kw`` (wt_layer, variant)
    goes to ``ResNet``."""
    check_trunk(trunk)
    return ResNet(**_TRUNKS[trunk], **kw)
