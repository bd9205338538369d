"""WiderResNet and WiderResNetA2 (network/wider_resnet.py;
mrfp_tpu/nn/wider_resnet.py), NCHW, depths 16/20/38.

Pre-activation identity-residual blocks; the A2 variant max-pools only
after ``mod1`` and ``mod2`` and (with ``dilation``) takes one stride 2 in
mod4 and dilates mod5 by 2 and mod6/mod7 by 4 (output stride 8). The
bottlenecks of mod6/mod7 drop out at 0.3 and 0.5 element by element: the
JAX package's docstring says Dropout2d, its code is flax's element-wise
``nn.Dropout`` (wider_resnet.py:60-61,71-72), and the port does what the
code does. No factory of the zoo builds these trunks, in JAX either.
Module names are the JAX package's (``mod2_block1.bn1.bn``,
``mod1_conv1``, ``bn_out.bn``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mrfp_tpu_torch.nn.layers import conv2d, max_pool_3x3_s2
from mrfp_tpu_torch.nn.norms import batch_norm

_STRUCTURES = {16: (1, 1, 1, 1, 1, 1), 20: (1, 1, 1, 3, 1, 1), 38: (3, 3, 6, 3, 1, 1)}
_CHANNELS = ((128, 128), (256, 256), (512, 512), (512, 1024),
             (512, 1024, 2048), (1024, 2048, 4096))


class BNReLU(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.bn = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(x))


class IdentityResidualBlock(nn.Module):
    """Pre-activation residual (wider_resnet.py:64-185): ``bn1`` (BN, ReLU)
    feeds the convs, and the 1x1 ``proj_conv`` shortcut when the stride or
    the width changes; otherwise the shortcut is the raw input. Two 3x3s,
    or for three widths a 1x1 -> 3x3 -> 1x1 bottleneck; ``dropout`` before
    the last conv."""

    def __init__(self, inp: int, channels: Tuple[int, ...], stride: int = 1,
                 dilation: int = 1, dropout: Optional[float] = None):
        super().__init__()
        self.bn1 = BNReLU(inp)
        self.proj_conv = (conv2d(inp, channels[-1], 1, stride)
                          if stride != 1 or inp != channels[-1] else None)
        if len(channels) == 2:
            self.conv1 = conv2d(inp, channels[0], 3, stride, dilation, dilation)
            self.bn2 = BNReLU(channels[0])
            self.conv2 = conv2d(channels[0], channels[1], 3, 1, dilation, dilation)
        else:
            self.conv1 = conv2d(inp, channels[0], 1, stride)
            self.bn2 = BNReLU(channels[0])
            self.conv2 = conv2d(channels[0], channels[1], 3, 1, dilation, dilation)
            self.bn3 = BNReLU(channels[1])
            self.conv3 = conv2d(channels[1], channels[2], 1)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = self.bn1(x)
        shortcut = x if self.proj_conv is None else self.proj_conv(pre)
        out = self.bn2(self.conv1(pre))
        if hasattr(self, "conv3"):
            out = self.bn3(self.conv2(out))
            last = self.conv3
        else:
            last = self.conv2
        if self.dropout is not None:
            out = self.dropout(out)
        return last(out) + shortcut


def _blocks(structure, plan) -> Dict[str, nn.Module]:
    """The mods' blocks ``mod{m + 2}_block{b + 1}`` from ``plan(mod, block)
    -> (stride, dilation, dropout)``."""
    blocks, inp = {}, 64
    for mod_id, num in enumerate(structure):
        for block_id in range(num):
            stride, dil, drop = plan(mod_id, block_id)
            blocks[f"mod{mod_id + 2}_block{block_id + 1}"] = IdentityResidualBlock(
                inp, _CHANNELS[mod_id], stride, dil, drop)
            inp = _CHANNELS[mod_id][-1]
    return blocks


class WiderResNet(nn.Module):
    """wider_resnet.py:187-265: ``mod1_conv1`` (3x3, 64), then a 3x3
    stride-2 max pool before each of the six mods, then ``bn_out``."""

    def __init__(self, structure: Tuple[int, ...] = _STRUCTURES[38]):
        super().__init__()
        self._build(structure, lambda mod_id, block_id: (1, 1, None))

    def _build(self, structure, plan) -> None:
        self.structure = tuple(structure)
        self.mod1_conv1 = conv2d(3, 64, 3, 1, 1)
        for name, block in _blocks(structure, plan).items():
            self.add_module(name, block)
        self.bn_out = BNReLU(_CHANNELS[-1][-1])
        self.pool = max_pool_3x3_s2()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.mod1_conv1(x)
        for mod_id, num in enumerate(self.structure):
            out = self.pool(out)
            for b in range(num):
                out = getattr(self, f"mod{mod_id + 2}_block{b + 1}")(out)
        return self.bn_out(out)


class WiderResNetA2(WiderResNet):
    """wider_resnet.py:267-380: pools only before mod2 and mod3. The
    forward returns each mod's output (``mod2``..``mod7``) and ``out``,
    ``bn_out`` of the last."""

    def __init__(self, structure: Tuple[int, ...] = _STRUCTURES[38], dilation: bool = True):
        nn.Module.__init__(self)

        def plan(mod_id, block_id):
            if dilation:
                dil = 2 if mod_id == 3 else (4 if mod_id > 3 else 1)
                stride = 2 if block_id == 0 and mod_id == 2 else 1
            else:
                dil, stride = 1, 2 if block_id == 0 and 2 <= mod_id <= 4 else 1
            return stride, dil, 0.3 if mod_id == 4 else (0.5 if mod_id == 5 else None)

        self._build(structure, plan)
        self.stage_channels = (256, 512, 1024, 4096)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.mod1_conv1(x)
        feats = {}
        for mod_id, num in enumerate(self.structure):
            if mod_id < 2:
                out = self.pool(out)
            for b in range(num):
                out = getattr(self, f"mod{mod_id + 2}_block{b + 1}")(out)
            feats[f"mod{mod_id + 2}"] = out
        feats["out"] = self.bn_out(out)
        return feats


def wider_resnet38_a2(**kw) -> WiderResNetA2:
    return WiderResNetA2(structure=_STRUCTURES[38], **kw)


def wider_resnet20_a2(**kw) -> WiderResNetA2:
    return WiderResNetA2(structure=_STRUCTURES[20], **kw)


def wider_resnet16_a2(**kw) -> WiderResNetA2:
    return WiderResNetA2(structure=_STRUCTURES[16], **kw)
