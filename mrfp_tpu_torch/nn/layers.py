"""Conv / pool / init helpers, NCHW.

torch's ``nn.Conv2d(padding=int)`` already pads symmetrically before
striding, which is the semantics the JAX package rebuilds by hand
(mrfp_tpu/nn/layers.py:26-56), so the helpers here are thin. Random init
mirrors the reference and takes an explicit ``torch.Generator``:
backbone convs kaiming-normal fan_out (network/Resnet.py:561-563), head convs
kaiming-normal fan_in (network/mynn.py:38-55), norms at weight 1, bias 0.

Under spatial parallelism (``core/mesh.py::bands``) a conv or a max pool
gets this rank's band of its input's rows and returns its band of the
output's: it fetches the rows the band's windows read, whatever the
stride, padding and dilation (``conv_rows``; a ceil-mode pool's last
window may reach past the bottom), pads only at the global top and bottom
(zeros for a conv, -inf for a pool), and runs the plain op on them with
no H padding. A 1x1 conv of stride 1 reads its own rows and runs as it
is; a strided one, also under ``fuse_bn_stats`` (``conv1x1_with_stats``),
fetches the global rows its stride keeps. ``avg_pool_global`` sums over
the group and divides by the global count.

Under tensor parallelism (``core/mesh.py::channels``) a conv that
``weights.shard_model`` cut computes its slice of output channels from the
whole input map (``conv_input``: a sliced map is gathered over the model
group once, however many convs read it, and the backward sums the ranks'
parts); a grouped conv (ResNeXt's, the depthwise convs of MobileNetV2,
MNASNet and ShuffleNetV2) runs on its own input slice with ``groups / M``
groups, which read exactly that slice (taken from a whole map where it is
handed one); a replicated conv (the classifiers, ShuffleNetV2's
58-channel branch convs at M = 4) reads the gathered map and makes a whole
one. Bands compose: the map is gathered first, then its halo rows are
fetched, both exact.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mrfp_tpu_torch.core.mesh import Bands, active_bands, active_channels
from mrfp_tpu_torch.nn.norms import batch_norm
from mrfp_tpu_torch.ops.dot_stats import dot_with_stats
from mrfp_tpu_torch.parallel.dist import all_reduce_sum_grad, rows_from_group


def _window_out(h: int, k: int, stride: int, pad: int, dilation: int = 1,
               ceil: bool = False) -> int:
    """The output length of a window op over ``h`` rows: floor mode, or
    torch's ceil mode, which drops a last window that would start in the
    bottom padding."""
    span = h + 2 * pad - dilation * (k - 1) - 1
    if not ceil:
        return span // stride + 1
    oh = -(-span // stride) + 1
    return oh - 1 if (oh - 1) * stride >= h + pad else oh


def conv_rows(bands: Bands, h: int, k: int, stride: int, pad: int,
              dilation: int, ceil: bool = False) -> Tuple[int, List[int], List[int]]:
    """The output height of a window op (kernel ``k``, ``stride``, ``pad``,
    ``dilation``, floor or ``ceil`` mode) over ``h`` rows, and for each
    rank the global input rows ``[lo, hi)`` that its band of the output
    reads (outside ``[0, h)``: padding; in ceil mode the last window may
    end past ``h + pad``)."""
    oh = _window_out(h, k, stride, pad, dilation, ceil)
    lo, hi = [], []
    for o0, o1 in bands.every(oh):
        lo.append(o0 * stride - pad)
        hi.append((o1 - 1) * stride - pad + dilation * (k - 1) + 1)
    return oh, lo, hi


def _band_window(x: torch.Tensor, bands: Bands, k: int, stride: int, pad: int,
                 dilation: int, fill: float, ceil: bool = False) -> Tuple[torch.Tensor, int]:
    """The rows this rank's band of a window op's output reads, fetched,
    the global top and bottom padded with ``fill``, and the output's
    global height."""
    h, w = bands.global_hw(x)
    oh, lo, hi = conv_rows(bands, h, k, stride, pad, dilation, ceil)
    xr = rows_from_group(x, h, lo, hi, bands.group, fill)
    return xr, oh


def conv2d_rows(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                stride=1, padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d``, on this rank's band in a spatial scope: the output
    band from the fetched rows, the H padding only at the global edges."""
    bands = active_bands()
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    k = weight.shape[2]
    if bands is None or (k == 1 and sh == 1 and ph == 0):
        return F.conv2d(x, weight, bias, (sh, sw), (ph, pw), (dh, dw), groups)
    xr, oh = _band_window(x, bands, k, sh, ph, dh, 0.0)
    out = F.conv2d(xr, weight, bias, (sh, sw), (0, pw), (dh, dw), groups)
    bands.add(oh, out.shape[3])
    return out


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv_input(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """What ``conv`` reads of ``x`` in a channel scope: a grouped conv of a
    sharded kernel its own slice (``Channels.own`` of a whole map); a conv
    of a sharded kernel the whole map as a shared input; a whole conv the
    whole map. ``x`` is a slice where it holds fewer channels than the
    conv's whole input (``conv.in_channels``, times M for a ``tp_local``
    conv, whose own slice it counts): a slice holds 1/M of them, so the two
    cannot be confused. ``x`` itself outside a scope."""
    chans = active_channels()
    if chans is None:
        return x
    if getattr(conv, "tp_local", False):
        return chans.own(x) if x.shape[1] == conv.in_channels * chans.mp else x
    sliced = x.shape[1] != conv.in_channels
    if getattr(conv, "tp_sharded", False):
        return chans.shared(x, sliced)
    return chans.whole(x) if sliced else x


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (its parameters and state_dict keys) that computes its
    band of rows in a spatial scope (``conv2d_rows``) and, in a channel
    scope, its slice of output channels (``conv_input``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_input(self, x)
        if active_bands() is None:
            return super().forward(x)
        return conv2d_rows(x, self.weight, self.bias, self.stride, self.padding,
                           self.dilation, self.groups)


class MaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d`` (floor or ceil mode) that computes its band of rows
    in a spatial scope, the fetched rows padded with -inf at the global
    edges. The fetched rows hold exactly the band's windows, so the pool
    over them gives the band's rows in either mode; ``ceil_mode`` still
    decides the width."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bands = active_bands()
        if bands is None:
            return super().forward(x)
        if self.dilation != 1:
            raise ValueError("spatial bands take max pools of dilation 1; no module has "
                             "another")
        k, s, p = (_pair(v)[0] for v in (self.kernel_size, self.stride, self.padding))
        xr, oh = _band_window(x, bands, k, s, p, 1, float("-inf"), self.ceil_mode)
        out = F.max_pool2d(xr, self.kernel_size, self.stride, (0, _pair(self.padding)[1]),
                           ceil_mode=self.ceil_mode)
        bands.add(oh, out.shape[3])
        return out


def conv2d(cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
           padding: int = 0, dilation: int = 1, bias: bool = False,
           groups: int = 1) -> nn.Conv2d:
    """``groups`` splits the channels as ``nn.Conv2d``'s does (ResNeXt's
    grouped 3x3; mrfp_tpu/nn/layers.py::conv2d ``feature_group_count``).
    The conv computes its band of rows under spatial parallelism
    (``Conv2d``)."""
    return Conv2d(cin, cout, kernel_size, stride=stride, padding=padding,
                  dilation=dilation, bias=bias, groups=groups)


def conv1x1_with_stats(conv: nn.Conv2d, x: torch.Tensor, impl: Optional[str] = None):
    """A bias-free 1x1 ``conv`` through ``dot_with_stats``: returns ``(y, s1,
    s2, n)``, the conv output and the fp32 sums of it and its square per
    channel over its ``n`` = N*H*W values (mrfp_tpu/nn/layers.py:94-124,
    ``DotConv1x1Stats``). It reads ``conv.weight`` as it is, so the state_dict
    and the checkpoints do not change. A strided conv reads only the kept
    pixels, so the stride is a slice first; on a band (``core/mesh.py``)
    the kept rows are the global rows ``stride * o`` of the output band,
    which need not lie in this rank's band nor share its parity, so they
    are fetched first (``conv_rows`` with ``k = 1``) and only the width is
    sliced. The sums are then the band's, which ``batch_norm_from_stats``
    sums over the replica group. Under tensor parallelism the kernel is
    this rank's rows ``(Cout / M, Cin)`` and ``x`` the whole map
    (``conv_input``): the product and its sums are this rank's slice of
    output channels. Under autocast, ``x`` and the weight are cast to
    the autocast dtype here, since the product is an autograd Function
    that autocast does not see."""
    if (conv.kernel_size != (1, 1) or conv.bias is not None or conv.groups != 1
            or conv.padding != (0, 0) or conv.dilation != (1, 1)):
        raise ValueError(f"conv1x1_with_stats takes a bias-free 1x1 conv, got {conv}")
    x = conv_input(conv, x)
    sy, sx = conv.stride
    bands = active_bands()
    if bands is not None and sy != 1:
        xr, oh = _band_window(x, bands, 1, sy, 0, 1, 0.0)
        x = xr[:, :, ::sy, ::sx]
        bands.add(oh, x.shape[3])
    elif (sy, sx) != (1, 1):
        x = x[:, :, ::sy, ::sx]
    w = conv.weight[:, :, 0, 0]
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        dtype = torch.get_autocast_dtype(dev)
    else:
        dtype = torch.promote_types(x.dtype, w.dtype)
    y, s1, s2 = dot_with_stats(x.to(dtype), w.to(dtype), impl)
    return y, s1, s2, y.shape[0] * y.shape[2] * y.shape[3]


def max_pool_3x3_s2() -> nn.MaxPool2d:
    """torch nn.MaxPool2d(kernel_size=3, stride=2, padding=1), computing its
    band of rows under spatial parallelism."""
    return MaxPool2d(kernel_size=3, stride=2, padding=1)


def max_pool_ceil() -> nn.MaxPool2d:
    """torch nn.MaxPool2d(3, 2, ceil_mode=True), SENet's Caffe-style stem
    pool (mrfp_tpu/nn/seresnext.py:23-32 pads bottom/right to the same
    windows), computing its band of rows under spatial parallelism."""
    return MaxPool2d(kernel_size=3, stride=2, ceil_mode=True)


def avg_pool_global(x: torch.Tensor, valid_hw: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """AdaptiveAvgPool2d(1): NCHW -> NC11; with ``valid_hw`` = (vh, vw), the
    mean over the top-left ``vh`` x ``vw`` pixels. In a spatial scope ``x``
    is this rank's band: the sum over its rows of the region, summed over
    the spatial group (differentiable), over the global count. Every rank
    gets the whole pooled map."""
    bands = active_bands()
    if bands is None:
        if valid_hw is not None:
            x = x[:, :, :int(valid_hw[0]), :int(valid_hw[1])]
        return x.mean(dim=(2, 3), keepdim=True)
    h, w = bands.global_hw(x)
    vh, vw = (h, w) if valid_hw is None else (int(valid_hw[0]), int(valid_hw[1]))
    lo, hi = bands.rows(h)
    part = x[:, :, :max(0, min(hi, vh) - lo), :vw]
    f = torch.promote_types(x.dtype, torch.float32)
    total = all_reduce_sum_grad(part.to(f).sum(dim=(2, 3), keepdim=True), bands.group)
    return (total / (vh * vw)).to(x.dtype)


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, 0), 6) (mrfp_tpu/nn/mobilenet.py:35)."""
    return torch.clamp(x, 0.0, 6.0)


class ConvBN(nn.Module):
    """conv (``conv``, no bias, padding ``(k - 1) // 2 * dilation``) ->
    BatchNorm (``bn``) -> ``act`` ("relu", "relu6" or None): the zoo
    trunks' ConvBN/ConvBNReLU(6) units, named as the JAX package's
    (mrfp_tpu/nn/mobilenet.py:38-52, shufflenet.py:38-53, mnasnet.py:
    40-56). ``w_arr`` is taken and ignored, as a stage's child."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1, stride: int = 1,
                 dilation: int = 1, groups: int = 1, act: Optional[str] = "relu",
                 momentum: float = 0.1):
        super().__init__()
        self.conv = conv2d(cin, cout, kernel_size, stride, (kernel_size - 1) // 2 * dilation,
                           dilation, groups=groups)
        self.bn = batch_norm(cout, momentum)
        self.act = act

    def forward(self, x: torch.Tensor, w_arr: Optional[list] = None) -> torch.Tensor:
        x = self.bn(self.conv(x))
        if self.act == "relu":
            return F.relu(x)
        return relu6(x) if self.act == "relu6" else x


class NamedStage(nn.Module):
    """One stage (``layer0``..``layer4``) of a zoo trunk: its children,
    named after the JAX package's modules, run in order, each called with
    ``(x, w_arr)``."""

    def __init__(self, children: Dict[str, nn.Module]):
        super().__init__()
        for name, m in children.items():
            self.add_module(name, m)

    def forward(self, x: torch.Tensor, w_arr: Optional[list] = None) -> torch.Tensor:
        for m in self.children():
            x = m(x, w_arr)
        return x


@torch.no_grad()
def kaiming_normal_(weight: torch.Tensor, mode: str,
                    generator: torch.Generator) -> None:
    """kaiming_normal_(nonlinearity='relu') drawn from ``generator`` on the
    CPU, then copied to ``weight``'s device (the same numbers on any device)."""
    o, i, kh, kw = weight.shape
    fan = (o if mode == "fan_out" else i) * kh * kw
    std = math.sqrt(2.0 / fan)
    draw = torch.randn(weight.shape, generator=generator, dtype=torch.float32)
    weight.copy_(draw * std)


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init of every conv and norm of ``model``, in module
    order. Convs of the backbone (``layer0``..``layer4``) take fan_out, the
    heads fan_in."""
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            mode = "fan_out" if name.startswith("layer") else "fan_in"
            kaiming_normal_(m.weight, mode, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.InstanceNorm2d)):
            if m.weight is not None:
                m.weight.fill_(1.0)
                m.bias.zero_()
            if getattr(m, "running_mean", None) is not None:
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model
