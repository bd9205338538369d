"""MobileNetV2, the zoo's ``mobilenetv2`` trunk (network/Mobilenet.py;
mrfp_tpu/nn/mobilenet.py), NCHW, ReLU6.

The zoo wires torchvision's ``features`` into the DeepLab stages
(network/deepv3.py:259-287): ``layer0`` = features 0-1 (stride 2), then
features 2-6, 7-10, 11-17 and 18 (the last 1x1 ConvBNReLU6 to 1280).
Module names are the JAX package's (``layer1.feat2.expand.conv``, ...), so
``weights.state_dict_from_jax`` is a path walk.

iw codes land on inverted-residual blocks 1, 6, 10 and 17 (wt_layer slots
2-5, Mobilenet.py:230-240), after the residual add; slots 0, 1 and 6 are
read by no layer, in JAX too. The dilation surgery (deepv3.py:288-298)
rewrites only the blocks whose stride was 2: D dilates the second group
by 2 and the third by 4, D16 the third by 2; a later block of a dilated
group keeps dilation 1 and its residual, as in JAX.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import torch
from torch import nn

from mrfp_tpu_torch.nn.layers import ConvBN, NamedStage, conv2d
from mrfp_tpu_torch.nn.norms import apply_iw, batch_norm, make_iw_layer


class InvertedResidual(nn.Module):
    """MobileNetV2 block (Mobilenet.py:95-174): pw expand (unless the ratio
    is 1), dw 3x3 (the stride, or the dilation where the surgery hit), pw
    linear; the residual when stride and dilation are 1 and the widths
    match; the iw layer after."""

    def __init__(self, inp: int, features: int, stride: int = 1, expand_ratio: int = 6,
                 iw: int = 0, dilation: int = 1):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and dilation == 1 and inp == features
        self.expand = ConvBN(inp, hidden, 1, act="relu6") if expand_ratio != 1 else None
        self.dw = ConvBN(hidden, hidden, 3, stride, dilation, groups=hidden, act="relu6")
        self.project = conv2d(hidden, features, 1)
        self.project_bn = batch_norm(features)
        self.instance_norm_layer = make_iw_layer(iw, features)

    def forward(self, x: torch.Tensor, w_arr: Optional[list] = None) -> torch.Tensor:
        out = x if self.expand is None else self.expand(x)
        out = self.project_bn(self.project(self.dw(out)))
        if self.use_res:
            out = x + out
        return apply_iw(self.instance_norm_layer, out, w_arr)


# (t, c, n, s), Mobilenet.py:210-218
_SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
             (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
_LAST = 1 + sum(n for _t, _c, n, _s in _SETTINGS)  # the 1x1 head's feature index, 18
_IW_FEATURES = {1: 2, 6: 3, 10: 4, 17: 5}  # IR block (1-based) -> wt_layer slot
_GROUP_DILATION = {"D": {2: 2, 3: 4}, "D16": {3: 2}}  # layer -> dilation


def stage_of(name: str) -> Optional[int]:
    """The ``layer<k>`` that holds the JAX module ``name`` (``feat<n>``):
    features 0-1, 2-6, 7-10, 11-17 and the head (deepv3.py:259-287); None
    for a name that is no MobileNetV2 feature."""
    m = re.fullmatch(r"feat(\d+)", name)
    if m is None:
        return None
    n = int(m[1])
    return 0 if n < 2 else 1 if n < 7 else 2 if n < 11 else 3 if n < _LAST else 4


class MobileNetV2(nn.Module):
    """``layer0``..``layer4`` as the zoo groups ``features``; like
    ``nn.resnet.ResNet`` it has no forward of its own. ``stem_channels``
    and ``stage_channels`` are the widths a head reads."""

    def __init__(self, wt_layer: Tuple[int, ...] = (0,) * 7, variant: str = "D16"):
        super().__init__()
        grp_dil = _GROUP_DILATION.get(variant, {})
        ch = 32
        layers = [{"feat0": ConvBN(3, ch, 3, 2, act="relu6")}, {}, {}, {}, {}]
        widths = [ch] * 5  # each layer's output width
        idx = 1
        for t, out_ch, n, s in _SETTINGS:
            for i in range(n):
                layer = stage_of(f"feat{idx}")
                stride = s if i == 0 else 1
                dil = grp_dil.get(layer, 1)
                stride, dil = (1, dil) if stride == 2 and dil > 1 else (stride, 1)
                iw = wt_layer[_IW_FEATURES[idx]] if idx in _IW_FEATURES else 0
                layers[layer][f"feat{idx}"] = InvertedResidual(ch, out_ch, stride, t, iw, dil)
                widths[layer] = out_ch
                ch, idx = out_ch, idx + 1
        widths[4] = 1280
        layers[stage_of(f"feat{_LAST}")][f"feat{_LAST}"] = ConvBN(ch, 1280, 1, act="relu6")
        for k, children in enumerate(layers):
            setattr(self, f"layer{k}", NamedStage(children))
        self.stem_channels, self.stage_channels = widths[0], tuple(widths[1:])
