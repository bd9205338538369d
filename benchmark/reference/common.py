"""Plain PyTorch reference of DeepLabV3+ over ResNet-50, as the papers publish it.

The yardstick that decides ``correct``: plain ``torch`` operations in float32
(TF32 off), written from the published networks (MRFP's ``deepv3.py``,
RobustNet's ``network/deepv3.py`` and ``network/Resnet.py``), imported from
no other package. Module names follow the published checkpoints, so one
state_dict loads ``strict=True`` here and into the program alike.

- ResNet-50 with the D16 plan: layer3 at stride 2, layer4 at stride 1 and
  dilation 2 in every 3x3 (and its downsample at stride 1).
- ``wt_layer``'s slot 2 picks the stem's norm (0 BatchNorm, 2 a non-affine
  InstanceNorm whose map the whitening loss reads, 4 an affine
  InstanceNorm); slots 3-6 put that norm after the residual add of each
  stage's last block, before its ReLU.
- ASPP (image pool, 1x1, 3x3 at dilations 6, 12, 18), the decoder
  (``bot_fine`` 48 channels, ``bot_aspp`` 256, ``final1`` two 3x3 convs,
  ``final2`` the classifier) and the bilinear resizes with
  ``align_corners=True``.
- The nearest resizes with ``F.interpolate``'s rules, taken in float64:
  by scale ``src = floor(dst / s)`` and ``floor(in * s)`` outputs, by size
  ``src = floor(dst * in / out)``.

Two switches serve the benchmark and no model: ``recording()`` lists every
resize the forward makes (its shapes, whether its input takes a
gradient, and whether it resizes labels), which the resize roofline
reads; ``rounded(kind)`` runs every conv in a lower precision, the
control of the comparison, the reference in the precision just below the
configuration's: "tf32" rounds its input and weight to TF32 before the
fp32 product (TF32 for an fp32 configuration); "fp8" keeps its input,
weight and output in FP8 E4M3 and their gradients in E5M2, one scale a
tensor (FP8 for a bf16 autocast one, which keeps them in bf16). "bf16"
keeps them, and their gradients, in bfloat16, as autocast does: not a
control but a witness of what a bf16 configuration's convs alone move.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

_RESIZES: contextvars.ContextVar = contextvars.ContextVar("resizes", default=None)
_ROUNDING: contextvars.ContextVar = contextvars.ContextVar("rounding", default=None)


@contextlib.contextmanager
def recording():
    """Collect the forward's resizes: a list of dicts (kind, n, c, in_hw,
    out_hw, grad, labels). A resize to its own size is no resize."""
    calls: list = []
    token = _RESIZES.set(calls)
    try:
        yield calls
    finally:
        _RESIZES.reset(token)


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for convs and products inside (on the card both default to
    allowing it for convs), as the reference's fp32 requires."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def rounded(kind: Optional[str]):
    """Round conv operands to ``kind`` ("tf32", "fp8", "bf16" or None) inside."""
    token = _ROUNDING.set(kind)
    try:
        yield
    finally:
        _ROUNDING.reset(token)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 to the nearest TF32 (10 mantissa bits), ties to even."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def _round_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """fp32 through an FP8 type with one scale for the tensor (its amax to
    the type's largest value)."""
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Bf16(torch.autograd.Function):
    """A tensor stored in bfloat16, its gradient too."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class _Fp8(torch.autograd.Function):
    """A tensor stored in FP8 as FP8 training stores it: E4M3 on the way
    forward, its gradient in E5M2 on the way back."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2)


def _rounding(x: torch.Tensor) -> torch.Tensor:
    """A conv's input or weight as the control's arithmetic holds it: TF32
    rounds the operands (the product accumulates in fp32), FP8 rounds them
    and their gradients."""
    kind = _ROUNDING.get()
    if kind is None or x.device.type == "meta":
        return x
    if kind in _STORED:
        return _STORED[kind].apply(x)
    return x + (_round_tf32(x.detach()) - x).detach()


_STORED = {"fp8": _Fp8, "bf16": _Bf16}


def _stored(y: torch.Tensor) -> torch.Tensor:
    """A conv's output as the control keeps it: FP8 (and bf16) also store
    the product and its gradient, as bf16 autocast stores it in bf16; TF32
    keeps it in fp32."""
    kind = _ROUNDING.get()
    return _STORED[kind].apply(y) if kind in _STORED and y.device.type != "meta" else y


class Conv(nn.Conv2d):
    """``nn.Conv2d`` whose operands ``rounded`` may round."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _stored(F.conv2d(_rounding(x), _rounding(self.weight), self.bias, self.stride,
                                self.padding, self.dilation, self.groups))


def conv(cin: int, cout: int, k: int = 1, stride: int = 1, padding: int = 0,
         dilation: int = 1, bias: bool = False) -> Conv:
    return Conv(cin, cout, k, stride=stride, padding=padding, dilation=dilation, bias=bias)


def conv_fn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dilation: int
            ) -> torch.Tensor:
    """A 3x3 conv of given tensors, padding = dilation (the OC branch's)."""
    return _stored(F.conv2d(_rounding(x), _rounding(weight), bias, 1, dilation, dilation))


def bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _record(kind: str, x: torch.Tensor, out_hw: Sequence[int], labels: bool = False) -> None:
    calls = _RESIZES.get()
    if calls is not None:
        calls.append(dict(kind=kind, n=int(x.shape[0]), c=int(x.shape[1]),
                          in_hw=(int(x.shape[2]), int(x.shape[3])),
                          out_hw=(int(out_hw[0]), int(out_hw[1])),
                          grad=bool(x.requires_grad), labels=labels))


def upsample(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear, ``align_corners=True`` (network/mynn.py:114-119)."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[2:]) == size:
        return x
    _record("bilinear", x, size)
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


def _nearest_index(n_in: int, scale: Optional[float], n_out: Optional[int]) -> np.ndarray:
    if scale is not None:
        n_out = int(np.floor(n_in * scale))
        idx = np.floor(np.arange(n_out, dtype=np.float64) / np.float64(scale))
    else:
        idx = np.floor(np.arange(n_out, dtype=np.float64) * (n_in / n_out))
    return np.clip(idx.astype(np.int64), 0, n_in - 1)


def nearest(x: torch.Tensor, scale: Optional[float] = None,
            size: Optional[Sequence[int]] = None, labels: bool = False) -> torch.Tensor:
    """``F.interpolate(mode="nearest")`` by ``scale`` or ``size``."""
    h, w = int(x.shape[2]), int(x.shape[3])
    iy = _nearest_index(h, scale, None if size is None else int(size[0]))
    ix = _nearest_index(w, scale, None if size is None else int(size[1]))
    if (len(iy), len(ix)) == (h, w):
        return x
    _record("nearest", x, (len(iy), len(ix)), labels)
    iy_t = torch.from_numpy(iy).to(x.device)
    ix_t = torch.from_numpy(ix).to(x.device)
    return x.index_select(2, iy_t).index_select(3, ix_t)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 x4, the iw norm after the
    residual add (network/Resnet.py:148-227)."""

    def __init__(self, cin: int, planes: int, stride: int, dilation: int, iw: int):
        super().__init__()
        out = planes * 4
        self.conv1, self.bn1 = conv(cin, planes), bn(planes)
        self.conv2 = conv(planes, planes, 3, stride, dilation, dilation)
        self.bn2 = bn(planes)
        self.conv3, self.bn3 = conv(planes, out), bn(out)
        self.relu = nn.ReLU()
        self.downsample = (nn.Sequential(conv(cin, out, 1, stride), bn(out))
                           if stride != 1 or cin != out else None)
        self.instance_norm_layer = iw_norm(iw, out)
        self.iw = iw

    def forward(self, x: torch.Tensor, w_arr: Optional[list]) -> torch.Tensor:
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        out = out + (x if self.downsample is None else self.downsample(x))
        if self.instance_norm_layer is not None:
            out = self.instance_norm_layer(out)
            if self.iw in (1, 2) and w_arr is not None:
                w_arr.append(out)
        return self.relu(out)


def iw_norm(code: int, c: int) -> Optional[nn.Module]:
    """iw code -> None (0), InstanceNorm (1-3), affine InstanceNorm (4)."""
    if code == 0:
        return None
    if code in (1, 2, 3):
        return nn.InstanceNorm2d(c, eps=1e-5, affine=False)
    if code == 4:
        return nn.InstanceNorm2d(c, eps=1e-5, affine=True)
    raise ValueError(f"the reference has no iw code {code}")


class Stage(nn.ModuleList):
    def forward(self, x: torch.Tensor, w_arr: Optional[list] = None) -> torch.Tensor:
        for block in self:
            x = block(x, w_arr)
        return x


# D16: (stride, dilation) of layer1..layer4
D16_PLAN = ((1, 1), (2, 1), (2, 1), (1, 2))


class DeepLabV3Plus(nn.Module):
    """DeepLabV3+ over ResNet-50 D16 with the ``wt_layer`` plan; the
    subclasses add MRFP+'s perturbations or the ISW head and loss."""

    def __init__(self, num_classes: int, wt_layer: Sequence[int], blocks=(3, 4, 6, 3),
                 aspp_rates=(6, 12, 18), use_dsn: bool = False):
        super().__init__()
        stem_code = wt_layer[2]
        self.layer0 = nn.Sequential(conv(3, 64, 7, 2, 3),
                                    bn(64) if stem_code == 0 else iw_norm(stem_code, 64),
                                    nn.ReLU(), nn.MaxPool2d(3, 2, 1))
        self.stem_collects = stem_code in (1, 2)
        cin = 64
        for i, (planes, n, (stride, dilation)) in enumerate(
                zip((64, 128, 256, 512), blocks, D16_PLAN)):
            stage = Stage(Bottleneck(cin if b == 0 else planes * 4, planes,
                                     stride if b == 0 else 1, dilation,
                                     wt_layer[3 + i] if b == n - 1 else 0)
                          for b in range(n))
            self.add_module(f"layer{i + 1}", stage)
            cin = planes * 4
        self.aspp = ASPP(2048, 256, aspp_rates)
        self.bot_fine = nn.Sequential(conv(256, 48), bn(48), nn.ReLU())
        self.bot_aspp = nn.Sequential(conv(1280, 256), bn(256), nn.ReLU())
        self.final1 = nn.Sequential(conv(304, 256, 3, padding=1), bn(256), nn.ReLU(),
                                    conv(256, 256, 3, padding=1), bn(256), nn.ReLU())
        self.final2 = nn.Sequential(conv(256, num_classes, 1, bias=True))
        self.use_dsn = use_dsn
        if use_dsn:
            self.dsn = nn.Sequential(conv(1024, 512, 3, 1, 1, bias=True), bn(512), nn.ReLU(),
                                     nn.Dropout(0.1), conv(512, num_classes, 1, bias=True))
        self.checkpointing = False

    def stem(self, x: torch.Tensor, w_arr: Optional[list]) -> torch.Tensor:
        conv0, norm, relu, pool = self.layer0
        x = norm(conv0(x))
        if self.stem_collects and w_arr is not None:
            w_arr.append(x)
        return pool(relu(x))

    def run(self, fn, *args):
        """``fn(*args)``, recomputed in the backward when checkpointing (a
        reference that must fit beside nothing else at the timed batch)."""
        if self.checkpointing and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def decode(self, aspp_out: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
        up = upsample(self.bot_aspp(aspp_out), low.shape[2:])
        return self.final1(torch.cat([self.bot_fine(low), up], dim=1))

    def dsn_head(self, x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
        """Conv, BN, ReLU, dropout by the keep mask ``keep``, classifier."""
        x = self.dsn[2](self.dsn[1](self.dsn[0](x)))
        if self.training:
            rate = self.dsn[3].p
            x = torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                                device=x.device))
        return self.dsn[4](x)


class ASPP(nn.Module):
    """deepv3.py:64-126: [image pool, 1x1, d6, d12, d18] -> 1280 channels."""

    def __init__(self, cin: int, dim: int, rates: Sequence[int]):
        super().__init__()
        self.features = nn.ModuleList(
            [nn.Sequential(conv(cin, dim), bn(dim), nn.ReLU())]
            + [nn.Sequential(conv(cin, dim, 3, 1, r, r), bn(dim), nn.ReLU()) for r in rates])
        self.img_conv = nn.Sequential(conv(cin, 256), bn(256), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        img = self.img_conv(x.mean(dim=(2, 3), keepdim=True))
        img = upsample(img, x.shape[2:])
        return torch.cat([img] + [f(x) for f in self.features], dim=1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore: int = 255
                  ) -> torch.Tensor:
    """The mean over the pixels whose label is not ``ignore``."""
    return F.cross_entropy(logits.float(), labels.long(), ignore_index=ignore)


def dsn_labels(labels: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """The labels nearest-resized by size to the DSN logits' (deepv3.py:570-576)."""
    return nearest(labels[:, None].float(), size=size, labels=True)[:, 0].long()


def sgd_steps(model: nn.Module, batches, objective, lr: float, momentum: float,
              weight_decay: float, max_iter: int, power: float):
    """SGD with momentum and coupled weight decay, poly lr
    ``lr (1 - step / max_iter) ** power`` (main.py:826,832-839), one step a
    batch. Returns each step's objective parts, each leaf's gradient at the
    first step and its change after the last (fp32, on the host)."""
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    start = [p.detach().clone() for _, p in params]
    bufs: List[Optional[torch.Tensor]] = [None] * len(params)
    parts_per_step, grads = [], None
    for step, batch in enumerate(batches):
        for _, p in params:
            p.grad = None
        loss, parts = objective(model, step, batch)
        loss.backward()
        parts_per_step.append({k: float(v) for k, v in parts.items()})
        if step == 0:
            grads = {n: p.grad.detach().float().cpu() for n, p in params}
        rate = lr * (1.0 - min(step, max_iter) / max_iter) ** power
        with torch.no_grad():
            for i, (_, p) in enumerate(params):
                d = p.grad + weight_decay * p
                bufs[i] = d.clone() if bufs[i] is None else bufs[i].mul_(momentum).add_(d)
                p.add_(bufs[i], alpha=-rate)
        del loss
    change = {n: (p.detach() - s).float().cpu() for (n, p), s in zip(params, start)}
    return parts_per_step, grads, change


def count_work(model: nn.Module, objective, batch) -> Tuple[int, list]:
    """The FLOPs (``torch.utils.flop_counter``: convolutions and products,
    forward and backward) and the resizes of one step of ``objective`` on
    ``batch``, or of one forward where ``objective`` is None; run on
    meta tensors, so no memory and no arithmetic is spent."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter, recording() as calls:
        if objective is None:
            with torch.no_grad():
                model(batch)
        else:
            loss, _ = objective(model, 0, batch)
            loss.backward()
    return int(counter.get_total_flops()), calls
