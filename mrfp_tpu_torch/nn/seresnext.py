"""SE-ResNeXt / SENet, the zoo's ``se_resnext-50``/``se_resnext-101``
trunks and ``senet154`` (network/SEresnext.py; mrfp_tpu/nn/seresnext.py),
NCHW.

``layer0`` is the stem (a 7x7 stride-2 conv, or three 3x3 convs for
``input_3x3``, each with BN and ReLU) and the Caffe-style 3x3 stride-2 max
pool with ``ceil_mode``; ``layer1``..``layer4`` hold the SE bottlenecks.
Module names are the JAX package's (``layer0.stem_conv1``,
``layer1.layer1_block0.se_module.fc1``, ...). The trunk takes no
``variant``, in JAX and upstream: layer4 runs at stride 32 whatever the
factory's variant says (ROADMAP C12), and it has no iw instrumentation.
"""

from __future__ import annotations

import math
import re
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mrfp_tpu_torch.nn.layers import NamedStage, avg_pool_global, conv2d, max_pool_ceil
from mrfp_tpu_torch.nn.norms import batch_norm


def stage_of(name: str) -> Optional[int]:
    """The ``layer<k>`` that holds the JAX module ``name``: the stem's
    ``stem_conv<i>``/``stem_bn<i>`` 0, ``layer<k>_block<i>`` k; None for a
    name of another trunk."""
    m = re.fullmatch(r"layer([1-4])_block\d+", name)
    if m:
        return int(m[1])
    return 0 if re.fullmatch(r"stem_(conv|bn)[1-3]", name) else None


class SEModule(nn.Module):
    """Squeeze-excitation (SEresnext.py:70-91): global mean, 1x1 ``fc1``
    with bias, ReLU, 1x1 ``fc2`` with bias, sigmoid, times the input."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = conv2d(channels, channels // reduction, 1, bias=True)
        self.fc2 = conv2d(channels // reduction, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc2(F.relu(self.fc1(avg_pool_global(x))))
        return x * torch.sigmoid(s)


class SEBottleneckBlock(nn.Module):
    """The three SE bottlenecks by ``kind`` (SEresnext.py:94-193): "senet"
    (widths 2p and 4p, the stride on the 3x3), "seresnet" (width p, the
    stride on conv1) and "seresnext" (``floor(p * base_width / 64) *
    groups``, the stride on the grouped 3x3). The SE module scales the
    branch before the residual add."""

    def __init__(self, inp: int, planes: int, kind: str = "seresnext", groups: int = 32,
                 reduction: int = 16, stride: int = 1, downsample_kernel: int = 1,
                 downsample_pad: int = 0, has_downsample: bool = False, base_width: int = 4):
        super().__init__()
        out_ch = planes * 4
        if kind == "senet":
            (w1, w2), (s1, s2) = (planes * 2, planes * 4), (1, stride)
        elif kind == "seresnet":
            (w1, w2), (s1, s2) = (planes, planes), (stride, 1)
        else:
            w1 = w2 = math.floor(planes * (base_width / 64)) * groups
            s1, s2 = 1, stride
        self.conv1 = conv2d(inp, w1, 1, s1)
        self.bn1 = batch_norm(w1)
        self.conv2 = conv2d(w1, w2, 3, s2, 1, groups=groups)
        self.bn2 = batch_norm(w2)
        self.conv3 = conv2d(w2, out_ch, 1)
        self.bn3 = batch_norm(out_ch)
        if has_downsample:
            self.downsample_conv = conv2d(inp, out_ch, downsample_kernel, stride,
                                          downsample_pad)
            self.downsample_bn = batch_norm(out_ch)
        self.has_downsample = has_downsample
        self.se_module = SEModule(out_ch, reduction)

    def forward(self, x: torch.Tensor, w_arr: Optional[list] = None) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return F.relu(self.se_module(out) + residual)


class SEStem(nn.Module):
    """``stem_conv1``/``stem_bn1`` (7x7 stride 2), or with ``input_3x3``
    three 3x3 convs (stride 2, 1, 1) with ``stem_bn1..3``, each followed by
    ReLU; then ``max_pool_ceil`` (SEresnext.py:330-333)."""

    def __init__(self, inplanes: int, input_3x3: bool):
        super().__init__()
        convs = ([(3, 64, 3, 2), (64, 64, 3, 1), (64, inplanes, 3, 1)] if input_3x3
                 else [(3, inplanes, 7, 2)])
        self.depth = len(convs)
        for i, (cin, cout, k, s) in enumerate(convs, 1):
            self.add_module(f"stem_conv{i}", conv2d(cin, cout, k, s, k // 2))
            self.add_module(f"stem_bn{i}", batch_norm(cout))
        self.pool = max_pool_ceil()

    def forward(self, x: torch.Tensor, w_arr: Optional[list] = None) -> torch.Tensor:
        for i in range(1, self.depth + 1):
            x = F.relu(getattr(self, f"stem_bn{i}")(getattr(self, f"stem_conv{i}")(x)))
        return self.pool(x)


class SENet(nn.Module):
    """The SENet trunk (SEresnext.py:194-363): ``layer0``..``layer4``, no
    forward of its own (``nn.resnet.ResNet`` says why). Layer1's downsample
    is a 1x1 whatever ``downsample_kernel`` says (SEresnext.py:276-283)."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3), kind: str = "seresnext",
                 groups: int = 32, reduction: int = 16, inplanes: int = 64,
                 input_3x3: bool = False, downsample_kernel: int = 1, downsample_pad: int = 0,
                 base_width: int = 4):
        super().__init__()
        self.layer0 = SEStem(inplanes, input_3x3)
        in_ch = inplanes
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stage = {}
            for b in range(blocks):
                stride = 1 if (i == 0 or b > 0) else 2
                stage[f"layer{i + 1}_block{b}"] = SEBottleneckBlock(
                    in_ch, planes, kind, groups, reduction, stride,
                    1 if i == 0 else downsample_kernel, 0 if i == 0 else downsample_pad,
                    has_downsample=b == 0 and (stride != 1 or in_ch != planes * 4),
                    base_width=base_width)
                in_ch = planes * 4
            setattr(self, f"layer{stage_of(f'layer{i + 1}_block0')}", NamedStage(stage))
        self.stem_channels, self.stage_channels = inplanes, (256, 512, 1024, 2048)


def se_resnext50_32x4d(**kw) -> SENet:
    return SENet(layers=(3, 4, 6, 3), kind="seresnext", groups=32, **kw)


def se_resnext101_32x4d(**kw) -> SENet:
    return SENet(layers=(3, 4, 23, 3), kind="seresnext", groups=32, **kw)


def senet154(**kw) -> SENet:
    return SENet(layers=(3, 8, 36, 3), kind="senet", groups=64, inplanes=128, input_3x3=True,
                 downsample_kernel=3, downsample_pad=1, **kw)
