"""MNASNet 0.5 and 1.0, the zoo's ``mnasnet_05``/``mnasnet_10`` trunks
(torchvision's MNASNet as network/deepv3.py:210-257 groups it;
mrfp_tpu/nn/mnasnet.py), NCHW.

``layer0`` is the stem (conv 3x3 stride 2, dw 3x3, pw-linear to 16 x
alpha), ``layer1``..``layer3`` the inverted-residual stacks two by two,
``layer4`` the 1x1 head to 1280. Every BatchNorm takes torchvision's
momentum, 1 - 0.9997. Depths scale by alpha, rounded to multiples of 8.
Module names are the JAX package's (``layer1.stack0_block0.pw.conv``, ...).
The trunk has no iw instrumentation, upstream and in JAX: ``wt_layer`` is
not read (ROADMAP C12). The dilation surgery rewrites only the blocks whose
stride was 2 (deepv3.py:243-257): D dilates layer2 by 2 and layer3 by 4,
D16 layer3 by 2.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
from torch import nn

from mrfp_tpu_torch.nn.layers import ConvBN, NamedStage

# (kernel, stride, expansion, repeats, base width)
_STACKS = ((3, 2, 3, 3, 24), (5, 2, 3, 3, 40), (5, 2, 6, 3, 80),
           (3, 1, 6, 2, 96), (5, 2, 6, 4, 192), (3, 1, 6, 1, 320))
_BN_MOM = 1 - 0.9997  # torchvision's MNASNet BatchNorm momentum
_GROUP_DILATION = {"D": {1: 2, 2: 4}, "D16": {2: 2}}  # stack pair -> dilation


def stage_of(name: str) -> Optional[int]:
    """The ``layer<k>`` that holds the JAX module ``name``: the stem
    (``stem_conv``, ``stem_dw``, ``stem_pw``) 0, ``stack<s>_block<i>`` s // 2 + 1
    (the stacks two by two), ``head`` 4; None for a name of another trunk."""
    m = re.fullmatch(r"stack(\d)_block\d+", name)
    if m:
        return int(m[1]) // 2 + 1
    return {"stem_conv": 0, "stem_dw": 0, "stem_pw": 0, "head": 4}.get(name)


def _round8(v: float) -> int:
    new_v = max(8, int(v + 4) // 8 * 8)
    if new_v < 0.9 * v:
        new_v += 8
    return new_v


def _conv_bn(cin: int, cout: int, kernel_size: int = 1, stride: int = 1, dilation: int = 1,
             groups: int = 1, relu: bool = True) -> ConvBN:
    return ConvBN(cin, cout, kernel_size, stride, dilation, groups,
                  act="relu" if relu else None, momentum=_BN_MOM)


class InvertedResidual(nn.Module):
    """pw (x expansion) -> dw k x k (stride, or dilation) -> pw-linear; the
    residual when stride and dilation are 1 and the widths match."""

    def __init__(self, inp: int, features: int, kernel: int = 3, stride: int = 1,
                 expansion: int = 3, dilation: int = 1):
        super().__init__()
        mid = inp * expansion
        self.res = stride == 1 and dilation == 1 and inp == features
        self.pw = _conv_bn(inp, mid)
        self.dw = _conv_bn(mid, mid, kernel, stride, dilation, groups=mid)
        self.pw_linear = _conv_bn(mid, features, relu=False)

    def forward(self, x: torch.Tensor, w_arr: Optional[list] = None) -> torch.Tensor:
        out = self.pw_linear(self.dw(self.pw(x)))
        return x + out if self.res else out


class MNASNet(nn.Module):
    """``layer0``..``layer4``; no forward of its own (``nn.resnet.ResNet``
    says why)."""

    def __init__(self, alpha: float = 1.0, variant: str = "D16"):
        super().__init__()
        grp_dil = _GROUP_DILATION.get(variant, {})
        d = [_round8(c * alpha) for c in (32, 16)] + [_round8(s[4] * alpha) for s in _STACKS]
        self.layer0 = NamedStage({
            "stem_conv": _conv_bn(3, d[0], 3, 2),
            "stem_dw": _conv_bn(d[0], d[0], 3, 1, groups=d[0]),
            "stem_pw": _conv_bn(d[0], d[1], relu=False)})
        layers = {1: {}, 2: {}, 3: {}}
        inp = d[1]
        for si, (k, s, e, n, _c) in enumerate(_STACKS):
            layer = stage_of(f"stack{si}_block0")
            dil = grp_dil.get(layer - 1, 1)
            for i in range(n):
                stride = s if i == 0 else 1
                stride, bd = (1, dil) if stride == 2 and dil > 1 else (stride, 1)
                layers[layer][f"stack{si}_block{i}"] = InvertedResidual(
                    inp, d[2 + si], k, stride, e, bd)
                inp = d[2 + si]
        for i, blocks in layers.items():
            setattr(self, f"layer{i}", NamedStage(blocks))
        self.layer4 = NamedStage({"head": _conv_bn(inp, 1280)})
        self.stem_channels, self.stage_channels = d[1], (d[3], d[5], d[7], 1280)


def mnasnet0_5(**kw) -> MNASNet:
    return MNASNet(alpha=0.5, **kw)


def mnasnet1_0(**kw) -> MNASNet:
    return MNASNet(alpha=1.0, **kw)
