"""ASPP and the DeepLabV3+ decoder heads (deepv3.py:64-126,197-219), NCHW.

Concat order is load-bearing for checkpoint parity: ASPP output channels are
[image-pool(256), 1x1(256), d6(256), d12(256), d18(256)] -> 1280
(deepv3.py:114-126), and the decoder concat is [bot_fine(48), upsampled
bot_aspp(256)] -> 304 (deepv3.py:350-353). Module names follow the
reference's state_dict (``aspp.features.0.0``, ``aspp.img_conv.1``,
``bot_fine.0``, ``final1.3``, ``dsn.4``, ...).

Under spatial parallelism (``core/mesh.py``) every map is this rank's band
of rows: the ASPP image pool is a mean over the spatial group (its valid
rows intersected with the band), its 1x1 branch runs on the whole pooled
map on every rank (its BatchNorm over the data group), and its broadcast is
the band's slice of the bilinear resize from 1x1; the dilated convs fetch
their halos; the decoder upsample and the DSN dropout's keep mask are the
band's rows of the global ones.

Under tensor parallelism (``core/mesh.py::channels``) every branch is this
rank's slice of its channels. The ASPP reads layer4's output gathered once
for its four convs, and its image pool is the slice's pooled map,
gathered for ``img_conv`` (1/HW of the bytes). The concatenations put the
slices side by side and remember their blocks (``Channels.cat``), so the
map ``bot_aspp`` and ``final1`` gather is in the global channel order
(image pool, 1x1, d6, d12, d18; bot_fine, upsampled bot_aspp). The DSN
dropout's keep mask is this rank's channels of the global mask.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

import torch
from torch import nn

from mrfp_tpu_torch.core.mesh import active_bands, active_channels, current_mesh
from mrfp_tpu_torch.nn.layers import avg_pool_global, conv2d
from mrfp_tpu_torch.nn.norms import batch_norm
from mrfp_tpu_torch.ops.resize import resize_bilinear_align_corners


def aspp_rates(output_stride: int, rates: Tuple[int, ...] = (6, 12, 18)) -> Tuple[int, ...]:
    """Dilation rates scaled by output stride (deepv3.py:82-91)."""
    scale = {8: 2.0, 4: 4.0, 16: 1.0, 32: 0.5}.get(output_stride)
    if scale is None:
        raise ValueError(f"output stride {output_stride} not supported")
    return tuple(int(r * scale) for r in rates)


def conv_bn_relu(cin: int, cout: int, kernel_size: int = 1, padding: int = 0,
                 dilation: int = 1) -> list:
    """[conv, BatchNorm, ReLU], to splice into an ``nn.Sequential``."""
    return [conv2d(cin, cout, kernel_size, 1, padding, dilation),
            batch_norm(cout), nn.ReLU(inplace=True)]


class ConvBNReLU(nn.Sequential):
    """conv -> Norm2d -> ReLU; children ``0``, ``1``, ``2`` as in the reference."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1,
                 padding: int = 0, dilation: int = 1):
        super().__init__(*conv_bn_relu(cin, cout, kernel_size, padding, dilation))


class ASPP(nn.Module):
    """Atrous Spatial Pyramid Pooling (deepv3.py:64-126).

    ``valid_hw`` = (vh, vw), in this feature map's coordinates, restricts the
    image-level pooling to the valid region when the input was bottom/right
    zero-padded up to a shape bucket (train/evaluator.py).
    """

    def __init__(self, in_ch: int = 2048, reduction_dim: int = 256,
                 output_stride: int = 16):
        super().__init__()
        self.features = nn.ModuleList(
            [ConvBNReLU(in_ch, reduction_dim, 1)]
            + [ConvBNReLU(in_ch, reduction_dim, 3, padding=r, dilation=r)
               for r in aspp_rates(output_stride)])
        self.img_conv = ConvBNReLU(in_ch, 256, 1)

    def forward(self, x: torch.Tensor, valid_hw: Optional[Tuple[int, int]] = None,
                impl: Optional[str] = None) -> torch.Tensor:
        # image-level features first (deepv3.py:117-122)
        bands = active_bands()
        img = avg_pool_global(x, valid_hw)
        with bands.replicated_maps() if bands is not None else contextlib.nullcontext():
            img = self.img_conv(img)
        size = x.shape[2:] if bands is None else bands.global_hw(x)
        img = resize_bilinear_align_corners(img, size, impl, replicated=bands is not None)
        return _cat([img] + [f(x) for f in self.features])


class DeepLabDecoder(nn.Module):
    """bot_fine / bot_aspp / final1 of DeepLabV3+ (deepv3.py:200-216).

    A model subclasses it so that these heads sit at the top level of its
    state_dict, where the reference keeps them. ``decode`` returns dec1 at
    the low-level (H/4) resolution; the classifier belongs to the model.
    """

    def __init__(self, aspp_ch: int = 1280, low_ch: int = 256):
        super().__init__()
        self.bot_fine = ConvBNReLU(low_ch, 48, 1)
        self.bot_aspp = ConvBNReLU(aspp_ch, 256, 1)
        # one Sequential: 0 conv, 1 bn, 2 relu, 3 conv, 4 bn, 5 relu
        self.final1 = nn.Sequential(*conv_bn_relu(304, 256, 3, padding=1),
                                    *conv_bn_relu(256, 256, 3, padding=1))

    def decode(self, aspp_out: torch.Tensor, low_level: torch.Tensor,
               impl: Optional[str] = None) -> torch.Tensor:
        dec0_up = self.bot_aspp(aspp_out)
        dec0_fine = self.bot_fine(low_level)
        bands = active_bands()
        size = low_level.shape[2:] if bands is None else bands.global_hw(low_level)
        dec0_up = resize_bilinear_align_corners(dec0_up, size, impl)
        return self.final1(_cat([dec0_fine, dec0_up]))


def _cat(maps: list) -> torch.Tensor:
    """The channel concatenation of ``maps``; of their slices in a channel
    scope, with their blocks remembered for the gather."""
    chans = active_channels()
    return torch.cat(maps, dim=1) if chans is None else chans.cat(maps)


def dropout(x: torch.Tensor, rate: float,
            noise: Union[torch.Generator, torch.Tensor, None] = None) -> torch.Tensor:
    """flax ``nn.Dropout`` in train mode: a value is kept with probability
    ``1 - rate`` and divided by it, else zeroed. ``noise`` is the keep
    mask itself (bool, ``x``'s shape; the parity tests inject JAX's), or a
    generator on ``x``'s device to draw it from (None: torch's default
    generator). The generator draws the mask of the global batch (``x``'s
    batch times the data axis, ``core/mesh.py``) and of the whole map, and
    this rank keeps its own samples and, under spatial parallelism, its
    band of rows, and under tensor parallelism its slice of the channels
    (an injected mask of the whole map's channels is sliced too), so N
    ranks drop what one process drops on the same batch."""
    keep_prob = 1.0 - rate
    chans = active_channels()
    c0, c1, c = (0, x.shape[1], x.shape[1]) if chans is None else chans.span(x.shape[1])
    if isinstance(noise, torch.Tensor):
        keep = noise[:, c0:c1] if noise.shape[1] == c else noise
    else:
        mesh, bands = current_mesh(), active_bands()
        b, d = x.shape[0], mesh.data_index
        h = x.shape[2] if bands is None else bands.global_hw(x)[0]
        lo, hi = (0, h) if bands is None else bands.rows(h)
        u = torch.rand((b * mesh.dp, c, h, x.shape[3]), generator=noise, device=x.device)
        keep = u[d * b:(d + 1) * b, c0:c1, lo:hi] < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


class DSNHead(nn.Sequential):
    """The auxiliary DSN head on layer3 (network/deepv3.py:417-424;
    mrfp_tpu/nn/deeplab.py:115-128): a 3x3 conv with bias to 512 channels,
    BatchNorm, ReLU, Dropout(0.1), a 1x1 classifier with bias. Children
    ``0`` conv, ``1`` BN, ``4`` classifier: the reference's keys, the ones
    mrfp_tpu/train/import_torch.py:252-274 reads. ``forward``'s ``dropout``
    is the keep mask or its generator (``dropout`` above), read in train
    mode only."""

    def __init__(self, cin: int = 1024, num_classes: int = 19, rate: float = 0.1):
        super().__init__(conv2d(cin, 512, 3, 1, 1, 1, bias=True), batch_norm(512),
                         nn.ReLU(inplace=True), nn.Dropout(rate),
                         conv2d(512, num_classes, 1, bias=True))

    def forward(self, x: torch.Tensor,
                noise: Union[torch.Generator, torch.Tensor, None] = None) -> torch.Tensor:
        x = self[2](self[1](self[0](x)))
        if self.training:
            x = dropout(x, self[3].p, noise)
        return self[4](x)
