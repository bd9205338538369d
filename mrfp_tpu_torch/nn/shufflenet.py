"""ShuffleNetV2, the zoo's ``shufflenetv2`` trunk at scale x1.0
(network/Shufflenet.py; mrfp_tpu/nn/shufflenet.py), NCHW.

``layer0`` is ``conv1`` (3x3 stride 2), its norm, ReLU and the 3x3 stride-2
max pool (stride 4); ``layer1``..``layer3`` are stages 2-4; ``layer4`` is
``conv5`` (1x1 to 1024), its norm and ReLU. Module names are the JAX
package's (``layer1.stage2_block0.b2_pw1.conv``, ``layer0.stem_bn``, ...).

iw placement (Shufflenet.py:136-161; the zoo's Layer0 and Layer4,
network/deepv3.py:129-157): a non-zero ``wt_layer[2]`` replaces the stem's
BatchNorm (``stem_iw``), ``wt_layer[3..5]`` go on the last unit of stages
2-4, a non-zero ``wt_layer[6]`` replaces conv5's BatchNorm (``conv5_iw``).
The dilation surgery (deepv3.py:194-202) rewrites only a stage's first,
strided unit: D dilates stage 3 by 2 and stage 4 by 4, D16 stage 4 by 2;
the later units keep dilation 1, as in JAX.

Under tensor parallelism (``core/mesh.py::channels``) the split, the
concatenation and the shuffle mix channels across the slices, so a unit
reads its input whole (gathered once; free where the previous unit's
output came from ``Channels.own``), splits it, gathers its branches'
outputs where their convs are cut, concatenates and shuffles the whole
map on every rank, and keeps its own slice where M divides the width
(Shufflenet.py:21-35 and :76-79 on the global channel order). A branch
conv that M does not divide (the 58 channels of stage 2 at M = 4) is
whole, as JAX's rule keeps it, and computes its whole map on every rank.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mrfp_tpu_torch.core.mesh import active_channels
from mrfp_tpu_torch.nn.layers import ConvBN, NamedStage, conv2d, max_pool_3x3_s2
from mrfp_tpu_torch.nn.norms import apply_iw, batch_norm, make_iw_layer

_REPEATS, _WIDTHS = (4, 8, 4), (24, 116, 232, 464, 1024)  # x1.0 (mrfp_tpu/nn/shufflenet.py:23)
_STAGE_DILATION = {"D": {1: 2, 2: 4}, "D16": {2: 2}}  # stage index (0 = stage 2)


def stage_of(name: str) -> Optional[int]:
    """The ``layer<k>`` that holds the JAX module ``name``: the stem
    (``conv1``, ``stem_bn``/``stem_iw``) 0, ``stage<s>_block<i>`` s - 1,
    ``conv5`` and its norm 4; None for a name of another trunk."""
    m = re.fullmatch(r"stage([234])_block\d+", name)
    if m:
        return int(m[1]) - 1
    return {"conv1": 0, "stem_bn": 0, "stem_iw": 0,
            "conv5": 4, "conv5_bn": 4, "conv5_iw": 4}.get(name)


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """The view/transpose shuffle of Shufflenet.py:21-35: channel ``g *
    (C / groups) + a`` moves to ``a * groups + g``."""
    n, c, h, w = x.shape
    return x.view(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)


class InvertedResidual(nn.Module):
    """The ShuffleNetV2 unit (Shufflenet.py:38-112). With stride and
    dilation 1 it splits the channels in two and runs branch 2 on the
    second half; otherwise both branches read the whole input (branch 1:
    dw 3x3, pw; branch 2: pw, dw 3x3, pw). Then concatenation, the shuffle
    and the iw layer."""

    def __init__(self, inp: int, features: int, stride: int = 1, dilation: int = 1,
                 iw: int = 0):
        super().__init__()
        self.inp, self.features = inp, features
        half = features // 2
        self.split = stride == 1 and dilation == 1
        if self.split:
            self.b2_pw1 = ConvBN(inp // 2, half, 1)
        else:
            self.b1_dw = ConvBN(inp, inp, 3, stride, dilation, groups=inp, act=None)
            self.b1_pw = ConvBN(inp, half, 1)
            self.b2_pw1 = ConvBN(inp, half, 1)
        self.b2_dw = ConvBN(half, half, 3, stride, dilation, groups=half, act=None)
        self.b2_pw2 = ConvBN(half, half, 1)
        self.instance_norm_layer = make_iw_layer(iw, features)

    def forward(self, x: torch.Tensor, w_arr: Optional[list] = None) -> torch.Tensor:
        chans = active_channels()
        if chans is not None:
            return self._forward_slices(x, w_arr, chans)
        if self.split:
            b1, b2 = x.chunk(2, dim=1)
        else:
            b1, b2 = self.b1_pw(self.b1_dw(x)), x
        out = torch.cat([b1, self.b2_pw2(self.b2_dw(self.b2_pw1(b2)))], dim=1)
        return apply_iw(self.instance_norm_layer, channel_shuffle(out, 2), w_arr)

    def _forward_slices(self, x: torch.Tensor, w_arr: Optional[list], chans) -> torch.Tensor:
        """The unit in a channel scope: the whole map's split, concatenation
        and shuffle on every rank, then this rank's slice where M divides
        the width. The convs take their own slice of a whole map, or gather
        a slice (``nn/layers.py::conv_input``)."""
        half = self.features // 2
        xw = chans.whole_of(x, self.inp)
        if self.split:
            b1, b2 = xw.chunk(2, dim=1)
        else:
            b1, b2 = chans.whole_of(self.b1_pw(self.b1_dw(x)), half), xw
        b2 = chans.whole_of(self.b2_pw2(self.b2_dw(self.b2_pw1(b2))), half)
        out = channel_shuffle(torch.cat([b1, b2], dim=1), 2)
        if self.features % chans.mp == 0:
            out = chans.own(out)
        return apply_iw(self.instance_norm_layer, out, w_arr)


class ConvNormReLU(nn.Module):
    """The stem (``conv1`` 3x3 stride 2, ``stem_bn`` or ``stem_iw``, ReLU,
    max pool) or the head (``conv5`` 1x1, ``conv5_bn`` or ``conv5_iw``,
    ReLU): the iw layer of ``code`` replaces the BatchNorm (deepv3.py:
    143-151), its map taken before the ReLU."""

    def __init__(self, conv: str, norm: str, cin: int, cout: int, kernel_size: int,
                 stride: int, code: int, pool: bool):
        super().__init__()
        self._names = (conv, f"{norm}_iw" if code else f"{norm}_bn")
        self.add_module(conv, conv2d(cin, cout, kernel_size, stride, (kernel_size - 1) // 2))
        self.add_module(self._names[1], make_iw_layer(code, cout) if code else batch_norm(cout))
        self.pool = max_pool_3x3_s2() if pool else None

    def forward(self, x: torch.Tensor, w_arr: Optional[list] = None) -> torch.Tensor:
        conv, norm = (getattr(self, n) for n in self._names)
        x = F.relu(apply_iw(norm, conv(x), w_arr))
        return x if self.pool is None else self.pool(x)


class ShuffleNetV2(nn.Module):
    """``layer0``..``layer4``; no forward of its own (``nn.resnet.ResNet``
    says why)."""

    def __init__(self, wt_layer: Tuple[int, ...] = (0,) * 7, variant: str = "D16"):
        super().__init__()
        stage_dil = _STAGE_DILATION.get(variant, {})
        self.layer0 = ConvNormReLU("conv1", "stem", 3, _WIDTHS[0], 3, 2, wt_layer[2], pool=True)
        inp = _WIDTHS[0]
        for si, n in enumerate(_REPEATS):
            dil = stage_dil.get(si, 1)
            blocks = {}
            for i in range(n):
                first = i == 0
                blocks[f"stage{si + 2}_block{i}"] = InvertedResidual(
                    inp, _WIDTHS[si + 1], stride=(1 if dil > 1 else 2) if first else 1,
                    dilation=dil if first else 1, iw=wt_layer[3 + si] if i == n - 1 else 0)
                inp = _WIDTHS[si + 1]
            setattr(self, f"layer{stage_of(f'stage{si + 2}_block0')}", NamedStage(blocks))
        self.layer4 = ConvNormReLU("conv5", "conv5", inp, _WIDTHS[4], 1, 1, wt_layer[6],
                                   pool=False)
        self.stem_channels, self.stage_channels = _WIDTHS[0], tuple(_WIDTHS[1:])
