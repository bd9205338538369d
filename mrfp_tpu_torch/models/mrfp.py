"""MRFP / MRFP+ eval forward — the plain DeepLabV3+ graph (deepv3.py:280-367).

In eval the reference skips every perturbation (the OC branch, NP+ and the
decoder injection are train-only), so the eval graph is the plain
DeepLabV3+ forward, as in mrfp_tpu/models/mrfp.py with ``train=False``.
The train forward is the next slice of the port (ROADMAP A4-A5).

Module names follow the reference's state_dict (``layer0.0``,
``layer1.0.conv1``, ``aspp.features.0.0``, ``aspp.img_conv.0``,
``bot_fine.0``, ``final1.0``, ``final2.0``), so the paper's ``.pth`` loads
with ``load_state_dict(strict=True)`` once its train-only ``OC*`` tensors
are dropped (``mrfp_tpu_torch.weights``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mrfp_tpu_torch.nn.deeplab import ASPP, DeepLabDecoder
from mrfp_tpu_torch.nn.layers import conv2d, init_random_
from mrfp_tpu_torch.nn.resnet import build_trunk, variant_output_stride
from mrfp_tpu_torch.ops.resize import resize_bilinear_align_corners


class MRFP(DeepLabDecoder):
    """DeepLabV3+ with the MRFP trunk plan, eval only.

    ``forward`` takes NCHW float images and returns NCHW logits (float32,
    also under a bf16 autocast). The model is built in eval mode; a forward
    in training mode raises.
    """

    def __init__(self, num_classes: int = 19, trunk: str = "resnet-50",
                 variant: str = "D16",
                 wt_layer: Tuple[int, ...] = (0, 0, 4, 4, 4, 0, 0)):
        super().__init__()
        self.variant = variant
        net = build_trunk(trunk, wt_layer=wt_layer, variant=variant)
        # the reference takes the trunk's stages as its own children
        # (deepv3.py:170-189), which puts them at the top of the state_dict
        self.layer0, self.layer1, self.layer2, self.layer3, self.layer4 = (
            net.layer0, net.layer1, net.layer2, net.layer3, net.layer4)
        self.aspp = ASPP(2048, 256, output_stride=variant_output_stride(variant))
        self.final2 = nn.Sequential(conv2d(256, num_classes, 1, bias=True))
        self.eval()

    def forward(self, x: torch.Tensor, valid_hw: Optional[Tuple[int, int]] = None,
                impl: Optional[str] = None) -> torch.Tensor:
        """``valid_hw`` = (vh, vw) in input pixels: the valid extent when
        ``x`` was bottom/right zero-padded to a shape bucket; restricts
        ASPP's image pooling to real pixels. ``impl="plain"`` routes every
        resize through its plain version (kernel-vs-plain checks only)."""
        if self.training:
            raise NotImplementedError(
                "the train-mode forward (perturbations, batch-stat BN) is the "
                "train slice of the port: see ROADMAP items A4-A5")
        h, w = x.shape[2], x.shape[3]
        x = self.layer0(x)
        low_level = x = self.layer1(x)
        x = self.layer4(self.layer3(self.layer2(x)))
        if valid_hw is not None:
            os_ = variant_output_stride(self.variant)
            valid_hw = tuple((int(v) + os_ - 1) // os_ for v in valid_hw)
        x = self.aspp(x, valid_hw=valid_hw, impl=impl)
        dec1 = self.decode(x, low_level, impl=impl)
        logits = resize_bilinear_align_corners(self.final2(dec1), (h, w), impl)
        return logits.float()


def build_mrfp(device, generator: Optional[torch.Generator] = None,
               **kw) -> MRFP:
    """An eval-mode MRFP on ``device``; with ``generator``, seeded random
    weights (drawn on the CPU, so the same on every device)."""
    model = MRFP(**kw)
    if generator is not None:
        init_random_(model, generator)
    return model.to(device)
